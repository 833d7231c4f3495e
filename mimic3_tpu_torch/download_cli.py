"""``mimic3-torch-download`` CLI: fetch voices by key or ``*`` wildcard.

Port copy of ``mimic3_tpu/download_cli.py``, flag-compatible with the
reference downloader CLI (reference: mimic3_tts/download.py:153-253).
Voices download as the registry ships them (``generator.onnx``); the
port converts them on first load (``runtime/convert.py``).
"""

from __future__ import annotations

import argparse
import logging
import sys
import typing

from .download import (
    default_voices_download_dir,
    download_voice_by_key,
    is_voice_downloaded,
)
from .utils import WILDCARD, wildcard_to_regex
from .voices_registry import get_voices_registry

_LOGGER = logging.getLogger(__name__)


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="mimic3-torch-download",
        description="Download mimic3 voices (supports * wildcards)",
    )
    parser.add_argument(
        "key", nargs="*", help="Voice key(s), e.g. en_UK/apope_low or en_US/*"
    )
    parser.add_argument(
        "--output-dir",
        default=str(default_voices_download_dir()),
        help="Directory to download voices into",
    )
    parser.add_argument(
        "--url-format",
        default=None,
        help="URL format string ({key}/{lang}/{name} placeholders); "
        "default: the registry's url_template",
    )
    parser.add_argument(
        "--redownload",
        action="store_true",
        help="Download even when files already exist",
    )
    parser.add_argument(
        "--list", action="store_true", help="List voice keys and exit"
    )
    parser.add_argument("--debug", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO
    )

    registry = get_voices_registry()

    if args.list or not args.key:
        for key in sorted(registry):
            status = (
                "[downloaded]"
                # presence/size only: hashing every installed voice
                # would read gigabytes just to print a listing
                if is_voice_downloaded(
                    key, args.output_dir, verify_hashes=False
                )
                else ""
            )
            print(key, status)
        return 0

    keys: typing.List[str] = []
    for pattern_str in args.key:
        if WILDCARD in pattern_str:
            pattern = wildcard_to_regex(pattern_str)
            matched = [k for k in registry if pattern.match(k)]
            if not matched:
                _LOGGER.warning("No voices match %s", pattern_str)
            keys.extend(matched)
        else:
            keys.append(pattern_str)

    failures = 0
    for key in keys:
        try:
            voice_dir = download_voice_by_key(
                key,
                voices_dir=args.output_dir,
                url_format=args.url_format,
                redownload=args.redownload,
            )
            print(f"{key}\t{voice_dir}")
        except Exception as e:
            failures += 1
            _LOGGER.error("Failed to download %s: %s", key, e)

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
