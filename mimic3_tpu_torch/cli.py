"""``mimic3-torch``: the ``mimic3`` CLI with synthesis on PyTorch.

Runs :func:`mimic3_tpu.cli.main` unchanged (same flags, same output) with
the port's engine bound in place of the reference engine for this process.
One flag of its own, ``--device {cuda,cpu}`` (default ``cuda``): with no
card visible the default raises; the CPU is used only when named.

Usage: ``echo 'Hello.' | python -m mimic3_tpu_torch.cli --voice <voice> > out.wav``
"""

from __future__ import annotations

import argparse
import sys
import typing


def split_device_arg(
    argv: typing.Optional[typing.Sequence[str]],
) -> typing.Tuple[str, typing.List[str]]:
    """(``--device`` value, the remaining arguments for the reference
    parser)."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # (with no card visible, cuda raises when a voice loads or a server
    # starts: runtime/session.py resolve_device)
    args, rest = parser.parse_known_args(
        sys.argv[1:] if argv is None else list(argv)
    )
    return args.device, rest


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    import mimic3_tpu.engine
    from mimic3_tpu import cli

    from .engine import Mimic3TextToSpeechSystem

    device, argv = split_device_arg(argv)

    class _Engine(Mimic3TextToSpeechSystem):
        def __init__(self, settings=None):
            super().__init__(settings, device=device)

    # mimic3_tpu.cli.main imports the engine class at call time
    mimic3_tpu.engine.Mimic3TextToSpeechSystem = _Engine
    return cli.main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
