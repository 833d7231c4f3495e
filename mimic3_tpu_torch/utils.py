"""Small host-side utilities (audio conversion, wildcard matching, hashing).

Behavior-compatible with the reference's mimic3_tts/utils.py:237-281.

Port copy of ``mimic3_tpu/utils.py``.
"""

from __future__ import annotations

import hashlib
import re
import typing
import unicodedata

import numpy as np

WILDCARD = "*"


def audio_float_to_int16(
    audio: np.ndarray, max_wav_value: float = 32767.0
) -> np.ndarray:
    """Peak-normalize float audio and convert to int16.

    Normalization is by the utterance's own max-abs (floored at 0.01), the
    same per-sentence convention as the reference
    (mimic3_tts/utils.py:237-244) — chunked streaming must therefore buffer
    per sentence to stay byte-compatible.

    Uses the native C++ single-pass kernel when available
    (native/mimic3_native.cpp), numpy otherwise.
    """
    audio = np.asarray(audio, dtype=np.float32)
    if audio.size:
        from .runtime import native

        fast = native.peak_normalize_i16(audio, max_wav_value)
        if fast is not None:
            return fast
    peak = max(0.01, float(np.max(np.abs(audio)))) if audio.size else 0.01
    audio_norm = audio * (max_wav_value / peak)
    audio_norm = np.clip(audio_norm, -max_wav_value, max_wav_value)
    return audio_norm.astype(np.int16)


def scale_int16_volume(audio_bytes: bytes, volume_0_100: float) -> bytes:
    """Scale 16-bit PCM by a [0, 100] volume.

    Replaces the reference's ``audioop.mul`` (mimic3_tts/tts.py:543);
    ``audioop`` was removed from the stdlib in Python 3.13.
    """
    factor = max(0.0, volume_0_100) / 100.0
    from .runtime import native

    fast = native.scale_i16(audio_bytes, factor)
    if fast is not None:
        return fast
    samples = np.frombuffer(audio_bytes, dtype=np.int16).astype(np.float32)
    # audioop.mul truncates toward zero after scaling and wraps on overflow;
    # we clip instead (safer, inaudible difference at volume <= 100).
    # float32 like the native path, so both produce identical bytes
    scaled = np.clip(
        np.trunc(samples * np.float32(factor)), -32768, 32767
    )
    return scaled.astype(np.int16).tobytes()


def wildcard_to_regex(template: str, wildcard: str = WILDCARD) -> re.Pattern:
    """Convert a ``*``-wildcard string into an anchored regex."""
    wildcard_escaped = re.escape(wildcard)
    parts = ["^"]
    for i, piece in enumerate(re.split(f"({wildcard_escaped})", template)):
        parts.append(".*" if (i % 2) == 1 else re.escape(piece))
    parts.append("$")
    return re.compile("".join(parts))


def file_sha256_sum(fp: typing.BinaryIO, block_bytes: int = 65536) -> str:
    """sha256 of a possibly-large file object."""
    h = hashlib.sha256()
    while True:
        block = fp.read(block_bytes)
        if not block:
            break
        h.update(block)
    return h.hexdigest()


def to_codepoints(s: str) -> typing.List[str]:
    """Split a string into NFC codepoints."""
    return list(unicodedata.normalize("NFC", s))
