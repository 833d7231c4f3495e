"""``mimic3-torch``: the ``mimic3`` CLI with synthesis on PyTorch.

Runs :func:`mimic3_tpu.cli.main` unchanged (same flags, same output) with
the port's engine bound in place of the reference engine for this process.

Usage: ``echo 'Hello.' | python -m mimic3_tpu_torch.cli --voice <voice> > out.wav``
"""

from __future__ import annotations

import typing


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    import mimic3_tpu.engine
    from mimic3_tpu import cli

    from .engine import Mimic3TextToSpeechSystem

    # mimic3_tpu.cli.main imports the engine class at call time
    mimic3_tpu.engine.Mimic3TextToSpeechSystem = Mimic3TextToSpeechSystem
    return cli.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
