"""``python -m mimic3_tpu_torch.server``: the ``mimic3-server`` on PyTorch.

Flag-compatible with the reference server CLI
(reference: mimic3_http/args.py:24-111, default port 59125) plus the
serving knobs (--max-batch, --batch-delay-ms, --warmup) and
``--device {cuda,cpu}`` (default ``cuda``; with no card visible it
raises, the CPU is used only when named).  ``--dp N`` serves every voice
data parallel over N devices, as the reference does through
``MIMIC3_DP``: N cards (more than are visible raises when the voice
loads), or N replicas with ``--device cpu``.

Port copy of ``mimic3_tpu/server/__main__.py``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import typing
from dataclasses import dataclass, field

_LOGGER = logging.getLogger(__name__)

_MISSING = object()


@dataclass
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 59125
    voice: typing.Optional[str] = None
    speaker: typing.Optional[str] = None
    default_voice: typing.Optional[str] = None
    show_openapi: bool = True
    voices_dir: typing.Optional[typing.List[str]] = None
    preload_voice: typing.List[str] = field(default_factory=list)
    length_scale: typing.Optional[float] = None
    noise_scale: typing.Optional[float] = None
    noise_w: typing.Optional[float] = None
    cache_dir: typing.Optional[str] = None
    cache_dir_is_temp: bool = False  # auto-created: removed at shutdown
    max_text_length: typing.Optional[int] = None
    deterministic: bool = False
    no_download: bool = False
    play_program: str = "aplay -q -t wav"
    num_workers: int = 8
    max_batch: int = 16
    batch_delay_ms: float = 5.0
    batch_delay_max_ms: float = 25.0
    warmup: bool = False
    warmup_profile: typing.Optional[str] = None
    warmup_parallel: int = 4
    profile_dir: typing.Optional[str] = None


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="mimic3-server",
        description="Text-to-speech HTTP server on PyTorch "
        "(Mimic 3 API compatible)",
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=59125)
    parser.add_argument("--voice", help="Default voice")
    parser.add_argument(
        "--speaker",
        help="Default speaker (name or id) appended to the default "
        "voice when it has no #speaker suffix "
        "(reference: mimic3_http/args.py:42-44)",
    )
    parser.add_argument(
        "--default-voice",
        help="Default voice key to select in the web interface "
        "(reference: mimic3_http/args.py:91-94)",
    )
    parser.add_argument(
        "--no-show-openapi",
        action="store_true",
        help="Don't show the OpenAPI link in the web interface "
        "(reference: mimic3_http/args.py:98-100)",
    )
    parser.add_argument(
        "--version",
        action="store_true",
        help="Print version to console and exit",
    )
    parser.add_argument(
        "--voices-dir", action="append", help="Extra voice directories"
    )
    parser.add_argument(
        "--preload-voice", action="append", default=[],
        help="Load voice(s) at startup",
    )
    parser.add_argument("--length-scale", type=float)
    parser.add_argument("--noise-scale", type=float)
    parser.add_argument("--noise-w", type=float)
    parser.add_argument(
        "--cache-dir",
        nargs="?",
        const=None,
        default=_MISSING,
        help="Cache WAV files (no argument = temporary dir)",
    )
    parser.add_argument("--max-text-length", type=int)
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--no-download", action="store_true")
    parser.add_argument(
        "--play-program",
        default="aplay -q -t wav",
        help="Program for audioTarget=server playback",
    )
    parser.add_argument(
        "--num-threads",
        "--num-workers",
        dest="num_workers",
        type=int,
        default=8,
        help="Host-side synthesis workers (phonemization etc.)",
    )
    parser.add_argument(
        "--max-batch", type=int, default=16,
        help="Max requests packed into one device batch",
    )
    parser.add_argument(
        "--batch-delay-ms", type=float, default=5.0,
        help="Max wait to fill a device batch",
    )
    parser.add_argument(
        "--batch-delay-max-ms", type=float, default=25.0,
        help="Upper bound the batch window stretches to under load "
        "(unresolved requests + open streams promise more arrivals); "
        "a lone client never waits past --batch-delay-ms",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="Run every bucket signature of preloaded voices at startup",
    )
    parser.add_argument(
        "--warmup-profile",
        help="JSON traffic profile (a saved /api/stats payload, or a "
        "bare executable_hits table): --warmup runs only the "
        "executables named in it instead of the full bucket grid",
    )
    parser.add_argument(
        "--warmup-parallel", type=int, default=4,
        help="Concurrent voice loads during --warmup",
    )
    parser.add_argument(
        "--profile-dir",
        help="Directory for torch.profiler traces captured via "
        "POST /api/profile (Chrome trace JSON)",
    )
    parser.add_argument(
        "--dp", type=int, default=None,
        help="Data-parallel devices per voice (sets MIMIC3_DP; -1 = every "
        "visible card; 0/1 = one device)",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="Torch device to synthesize on (cuda raises without a card)",
    )
    parser.add_argument("--debug", action="store_true")
    return parser


def config_from_args(args: argparse.Namespace) -> ServerConfig:
    import tempfile

    cache_dir: typing.Optional[str]
    cache_dir_is_temp = False
    if args.cache_dir is _MISSING:
        cache_dir = None  # caching disabled
    elif args.cache_dir is None:
        cache_dir = tempfile.mkdtemp(prefix="mimic3_tpu_torch_cache_")
        cache_dir_is_temp = True
    else:
        cache_dir = args.cache_dir

    voice = args.voice
    if voice and args.speaker is not None and "#" not in voice:
        # ref semantics: default speaker rides on the default voice
        voice = f"{voice}#{args.speaker}"

    return ServerConfig(
        host=args.host,
        port=args.port,
        voice=voice,
        speaker=args.speaker,
        default_voice=args.default_voice,
        show_openapi=not args.no_show_openapi,
        voices_dir=args.voices_dir,
        preload_voice=args.preload_voice,
        length_scale=args.length_scale,
        noise_scale=args.noise_scale,
        noise_w=args.noise_w,
        cache_dir=cache_dir,
        cache_dir_is_temp=cache_dir_is_temp,
        max_text_length=args.max_text_length,
        deterministic=args.deterministic,
        no_download=args.no_download,
        play_program=args.play_program,
        num_workers=args.num_workers,
        max_batch=args.max_batch,
        batch_delay_ms=args.batch_delay_ms,
        batch_delay_max_ms=args.batch_delay_max_ms,
        warmup=args.warmup,
        warmup_profile=args.warmup_profile,
        warmup_parallel=args.warmup_parallel,
        profile_dir=args.profile_dir,
    )


def parse_args(
    argv: typing.Optional[typing.Sequence[str]] = None,
) -> typing.Tuple[argparse.Namespace, str]:
    """(the server's arguments, ``--device``)."""
    parser = build_arg_parser()
    parser.prog = "python -m mimic3_tpu_torch.server"
    args = parser.parse_args(argv)
    return args, args.device


def apply_dp(dp: typing.Optional[int]) -> None:
    """``--dp``: set ``MIMIC3_DP``, which voices read when they load
    (runtime/voice.py); 0 or 1 clears an inherited one."""
    import os

    if dp is None:
        return
    if dp in (0, 1):
        # an explicit single-device request overrides an inherited
        # MIMIC3_DP (the flag's documented semantics win)
        os.environ.pop("MIMIC3_DP", None)
    else:
        os.environ["MIMIC3_DP"] = str(dp)


def create_app(argv: typing.Optional[typing.Sequence[str]] = None):
    """The app for these command-line arguments (not yet preloaded)."""
    from .app import TtsApp

    args, device = parse_args(argv)
    return TtsApp(config_from_args(args), device=device)


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    args, device = parse_args(argv)
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    logging.basicConfig(level=logging.DEBUG if args.debug else logging.INFO)
    apply_dp(args.dp)

    from ..runtime.session import (
        graceful_shutdown_requested,
        install_kill_safe_sigterm,
        wait_device_idle,
    )
    from .app import TtsApp, build_server

    config = config_from_args(args)
    app = TtsApp(config, device=device)
    # systemd/docker stop via SIGTERM must unwind like Ctrl-C so the
    # finally-block cleanup (scheduler, auto-created cache dir) runs;
    # SIGTERM defers while device calls are in flight (installed before
    # the warmup)
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
