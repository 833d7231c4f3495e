"""Loader for the native C++ host-audio library (ctypes).

Builds ``native/mimic3_native.cpp`` into a shared object on first use
(g++ -O3) and exposes the fast paths; every function has a numpy
fallback so the framework works without a compiler.

Port copy of ``mimic3_tpu/runtime/native.py``.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
import typing
from pathlib import Path

import numpy as np

_LOGGER = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).parent.parent.parent / "native"
_SRC = _NATIVE_DIR / "mimic3_native.cpp"
_SO = _NATIVE_DIR / "libmimic3_native.so"
_ABI = 1

_lock = threading.Lock()
_lib: typing.Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    import shutil

    gxx = shutil.which("g++")
    if gxx is None or not _SRC.is_file():
        return False
    cmd = [
        gxx, "-O3", "-shared", "-fPIC", "-march=native",
        str(_SRC), "-o", str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        _LOGGER.debug("native build failed: %s", e)
        return False


def get_lib() -> typing.Optional[ctypes.CDLL]:
    """The native library, building it on first call; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO.is_file() or (
            _SRC.is_file()
            and _SRC.stat().st_mtime > _SO.stat().st_mtime
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError as e:
            _LOGGER.debug("native load failed: %s", e)
            return None
        if lib.mimic3_native_abi() != _ABI:
            _LOGGER.warning("native ABI mismatch; rebuilding")
            if not _build():
                return None
            lib = ctypes.CDLL(str(_SO))

        lib.mimic3_peak_normalize_i16.restype = ctypes.c_float
        lib.mimic3_peak_normalize_i16.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_float,
        ]
        lib.mimic3_scale_i16.argtypes = [
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int64,
            ctypes.c_float,
        ]
        lib.mimic3_wav_header.restype = ctypes.c_int32
        lib.mimic3_wav_header.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint16,
            ctypes.c_uint16,
        ]
        _lib = lib
        _LOGGER.debug("native host-audio library loaded: %s", _SO)
        return _lib


def peak_normalize_i16(
    audio: np.ndarray, max_wav: float = 32767.0
) -> typing.Optional[np.ndarray]:
    """Native peak-normalize; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = np.empty(audio.shape, dtype=np.int16)
    lib.mimic3_peak_normalize_i16(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        audio.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_float(max_wav),
    )
    return out


def scale_i16(
    audio_bytes: bytes, factor: float
) -> typing.Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(audio_bytes, dtype=np.int16).copy()
    lib.mimic3_scale_i16(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        buf.size,
        ctypes.c_float(factor),
    )
    return buf.tobytes()


def wav_header(
    data_bytes: int,
    sample_rate: int = 22050,
    channels: int = 1,
    sample_width_bytes: int = 2,
) -> typing.Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    out = np.zeros(44, dtype=np.uint8)
    n = lib.mimic3_wav_header(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint32(data_bytes),
        ctypes.c_uint32(sample_rate),
        ctypes.c_uint16(channels),
        ctypes.c_uint16(sample_width_bytes),
    )
    return out[:n].tobytes()
