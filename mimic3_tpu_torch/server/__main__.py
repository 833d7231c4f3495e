"""``python -m mimic3_tpu_torch.server``: the ``mimic3-server`` on PyTorch.

The reference's flags (``mimic3_tpu/server/__main__.py``:
``build_arg_parser`` / ``config_from_args``) and run sequence — kill-safe
SIGTERM, preload and warmup, serve, shut down once no device call is in
flight — on :class:`~mimic3_tpu_torch.server.app.TorchTtsApp`.  One flag
of its own, ``--device {cuda,cpu}`` (default ``cuda``; with no card
visible it raises, the CPU is used only when named).  ``--dp`` above 1 is
refused: serving over several cards is not ported.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import typing

from mimic3_tpu.runtime.session import (
    graceful_shutdown_requested,
    install_kill_safe_sigterm,
    wait_device_idle,
)
from mimic3_tpu.server.__main__ import build_arg_parser, config_from_args

from ..cli import split_device_arg

_LOGGER = logging.getLogger(__name__)


def parse_args(
    argv: typing.Optional[typing.Sequence[str]] = None,
) -> typing.Tuple[argparse.Namespace, str]:
    """(the reference server's arguments, ``--device``); exits with a
    usage error for ``--dp`` above 1."""
    device, argv = split_device_arg(argv)
    parser = build_arg_parser()
    parser.prog = "python -m mimic3_tpu_torch.server"
    args = parser.parse_args(argv)
    if args.dp is not None and args.dp not in (0, 1):
        parser.error(
            f"--dp {args.dp}: serving over several cards is not ported; "
            "the port serves on one device"
        )
    return args, device


def create_app(argv: typing.Optional[typing.Sequence[str]] = None):
    """The app for these command-line arguments (not yet preloaded)."""
    from .app import TorchTtsApp

    args, device = parse_args(argv)
    return TorchTtsApp(config_from_args(args), device=device)


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    args, device = parse_args(argv)
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)

    from .app import TorchTtsApp, build_server

    config = config_from_args(args)
    app = TorchTtsApp(config, device=device)
    # SIGTERM defers while device calls are in flight, then unwinds like
    # Ctrl-C so the cleanup below runs (installed before the warmup)
    install_kill_safe_sigterm()
    try:
        app.preload()
        if graceful_shutdown_requested():
            return 0  # SIGTERM arrived during warmup
        server = build_server(app)
        asyncio.run(server.serve(config.host, config.port))
    except KeyboardInterrupt:
        pass
    finally:
        app.shutdown()
        if not wait_device_idle(timeout=1800):
            _LOGGER.error(
                "exiting with device calls still in flight after 1800s"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
