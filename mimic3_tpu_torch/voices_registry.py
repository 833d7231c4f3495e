"""Static voice catalog: 40 downloadable voices across 26 languages.

``registry.json`` is generated from the mimic3-voices release metadata
(file sizes + sha256 sums per voice file; the same data the reference
ships as mimic3_tts/voices.json and loads at import,
reference: mimic3_tts/_resources.py:50-51) restructured into a list
schema.  Entries are exposed in the reference's dict-of-dicts shape so
downstream code (downloader, engine, HTTP voices API) matches.

Port copy of ``mimic3_tpu/voices_registry.py``.
"""

from __future__ import annotations

import json
import typing
from functools import lru_cache
from pathlib import Path

DEFAULT_VOICE = "en_UK/apope_low"
DEFAULT_LANGUAGE = "en_UK"
DEFAULT_VOICES_URL_FORMAT = (
    "https://github.com/MycroftAI/mimic3-voices/raw/master/voices"
    "/{lang}/{name}"
)

_REGISTRY_PATH = Path(__file__).parent / "registry.json"


@lru_cache(maxsize=1)
def _registry() -> typing.Dict[str, typing.Any]:
    with open(_REGISTRY_PATH, "r", encoding="utf-8") as f:
        return json.load(f)


@lru_cache(maxsize=1)
def get_voices_registry() -> typing.Dict[str, typing.Dict[str, typing.Any]]:
    """Voice key -> metadata (files, version, speakers, aliases, props)."""
    out: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
    for voice in _registry()["voices"]:
        out[voice["key"]] = {
            "version": voice.get("version"),
            "aliases": voice.get("aliases") or [],
            "speakers": voice.get("speakers") or [],
            "properties": voice.get("properties") or {},
            "files": {
                f["path"]: {
                    "size_bytes": f.get("bytes"),
                    "sha256_sum": f.get("sha256"),
                }
                for f in voice.get("files", [])
            },
        }
    return out


def registry_url_template() -> str:
    return _registry().get("url_template", DEFAULT_VOICES_URL_FORMAT)
