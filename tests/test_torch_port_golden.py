"""The port against the checked-in golden sample, and the same phoneme ids
through a tensor-parallel session.

The port's counterpart of ``tests/test_golden_sample.py``: the voice the
JAX package's ``create_test_voice(full_size=False, seed=1234)`` writes,
the port's engine on the CPU in deterministic mode (``noise_scale=0``,
``noise_w=0``, f32 decoder) on the same sentence, against
``tests/data/golden_test_low.wav``.

Bars: the same length, ``corr >= 0.999`` and at most 1 LSB between the
int16 samples (the north-star bar).  The reference's other bar, at most
0.1% of samples differing, is not used: it holds one engine to itself
across machines, and the port, a second engine, differs from the golden
WAV by 1 LSB in about 0.36% of its samples.  Then the same phoneme ids
through the port's dp 1 x tp 2 CPU session give the one-device port
audio within ``atol=2e-5``.
"""

import io
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from mimic3_tpu.runtime.testvoice import create_test_voice
from mimic3_tpu_torch import engine as tengine
from mimic3_tpu_torch.parallel import make_mesh
from mimic3_tpu_torch.runtime.convert import load_pytree_npz
from mimic3_tpu_torch.runtime.session import TorchVitsSession

GOLDEN = Path(__file__).parent / "data" / "golden_test_low.wav"
SENTENCE = "a rainbow is a meteorological phenomenon"
KEY = "en_US/golden_low"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _samples(source) -> np.ndarray:
    with wave.open(source) as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    create_test_voice(root / "en_US" / "golden_low", full_size=False,
                      seed=1234)
    return root, tengine.Mimic3TextToSpeechSystem(
        tengine.Mimic3Settings(
            voice=KEY, voices_directories=[str(root)], no_download=True,
            noise_scale=0.0, noise_w=0.0, use_deterministic_compute=True,
        ),
        device="cpu",
    )


def test_port_matches_the_golden_sample(engine):
    _, engine = engine
    got = _samples(io.BytesIO(engine.text_to_wav(SENTENCE)))
    want = _samples(str(GOLDEN))
    assert got.size == want.size > 0
    corr = np.corrcoef(got.astype(np.float64), want.astype(np.float64))[0, 1]
    assert corr >= 0.999, corr
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1


def test_tp_session_matches_one_device_on_the_golden_ids(engine):
    root, engine = engine
    voice = engine._get_or_load_voice(KEY)
    ids = []
    for words, _ in voice.text_to_phonemes(SENTENCE):
        ids.extend(voice.phonemes_to_ids(words))
    single = voice.session
    tp = TorchVitsSession(
        single.config,
        load_pytree_npz(root / "en_US" / "golden_low" / "generator.npz"),
        deterministic=True,
        mesh=make_mesh(dp=1, tp=2, platform="cpu"), use_tp=True,
    )
    assert len(tp._replicas[0].devices) == 2
    kw = dict(noise_scale=0.0, noise_w=0.0)
    got = tp.synthesize_ids(ids, **kw)
    want = single.synthesize_ids(ids, **kw)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
