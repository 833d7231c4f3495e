"""The port against the JAX package at full width (the ``*_low`` widths of
real Mimic 3 voices: hidden 192, 6 layers, upsample 512), on the CPU, one
device and data parallel.

The reference's ``create_test_voice(full_size=True, seed=1234)``; both
engines deterministic (``noise_scale=0``, ``noise_w=0``, f32 decoder);
one sentence.  The port runs on one CPU device and, through
``MIMIC3_DP=2`` as the server's ``--dp 2`` sets it, over two CPU
replicas.  Bars: the same length, ``corr >= 0.999`` and at most 1 LSB
between the int16 WAVs (the north-star bar; the other port parity tests
use the small widths).
"""

import io
import wave

import numpy as np
import pytest
import torch

from mimic3_tpu.engine import Mimic3Settings, Mimic3TextToSpeechSystem
from mimic3_tpu.runtime.testvoice import create_test_voice
from mimic3_tpu_torch import engine as tengine

SENTENCE = "a rainbow is a meteorological phenomenon"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _samples(wav_bytes: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(wav_bytes)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _settings(cls, root):
    return cls(voice="en_US/full_low", voices_directories=[str(root)],
               no_download=True, noise_scale=0.0, noise_w=0.0,
               use_deterministic_compute=True)


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    root = tmp_path_factory.mktemp("full_width")
    create_test_voice(root / "en_US" / "full_low", full_size=True, seed=1234)
    jax_wav = _samples(Mimic3TextToSpeechSystem(
        _settings(Mimic3Settings, root)).text_to_wav(SENTENCE))
    return root, jax_wav


@pytest.mark.parametrize("dp", [None, 2], ids=["single", "dp2"])
def test_full_width_matches_jax(voices, dp, monkeypatch):
    root, want = voices
    if dp is None:
        monkeypatch.delenv("MIMIC3_DP", raising=False)
    else:
        monkeypatch.setenv("MIMIC3_DP", str(dp))
    tts = tengine.Mimic3TextToSpeechSystem(
        _settings(tengine.Mimic3Settings, root), device="cpu"
    )
    got = _samples(tts.text_to_wav(SENTENCE))
    session = next(iter(tts._loaded_voices.values())).session
    assert session.dp == (dp or 1)
    assert got.size == want.size == 11264
    corr = np.corrcoef(got.astype(np.float64), want.astype(np.float64))[0, 1]
    assert corr >= 0.999, corr
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
