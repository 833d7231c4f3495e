"""The plain reference held to the program on the CPU at a small size:
the same voice files (written by the benchmark), the same ids and
seeds, through the program's normal load path and batch call, and
through its streaming path."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.tests import tiny
from benchmark.voice import write_voice

CONFIGS = ["vits_low_hifigan_bf16", "vits_low_mbistft_bf16"]
# float32 decoder: the same arithmetic in another order (the MB-iSTFT
# head's inverse DFT is a matrix product in the program, an FFT here)
F32_ERR = 1e-4
# bfloat16 decoder against float32, at this size
BF16_ERR = 0.02


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def voice(tmp_path, name, decoder_dtype):
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    config = json.loads((Path(__file__).parents[1] / "configs"
                         / f"{name}.json").read_text())
    config["model"].update(tiny.MODEL)
    config["tpu"] = dict(config["tpu"], decoder_dtype=decoder_dtype)
    d = write_voice(tmp_path / "voice", config, tiny.SEED, tiny.DEVICE)
    return d, load_from_directory(d, device="cpu", share_sessions=False)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype,limit", [("float32", F32_ERR),
                                         ("bfloat16", BF16_ERR)])
def test_batch_rows_match_the_reference(tmp_path, name, dtype, limit):
    d, v = voice(tmp_path, name, dtype)
    rng = np.random.default_rng(5)
    ids = [list(map(int, rng.integers(4, 49, n))) for n in (37, 20, 29)]
    seed = 2 ** 40 + 3
    out = v.session.synthesize_ids_batch(ids, length_scale=1.7,
                                         noise_scale=0.667, noise_w=0.8,
                                         seed=seed)
    answers = [check.Answer(got=a, ids=i, seed=seed, length_scale=1.7)
               for i, a in zip(ids, out)]
    numbers = check.judge(d, answers, tiny.DEVICE)
    assert numbers["length_bad"] == 0
    assert numbers["wave_err"] < limit


@pytest.mark.parametrize("name", CONFIGS)
def test_served_conversions_match_the_reference(tmp_path, name):
    """Text to ids by the voice's table, the whole-WAV peak normalization
    and the stream's windows at a fixed gain, at noise 0."""
    from mimic3_tpu_torch.utils import audio_float_to_int16

    d, v = voice(tmp_path, name, "float32")
    text = "the quick brown fox jumps over the lazy dog"
    ids = v.phonemes_to_ids(next(iter(v.text_to_phonemes(text)))[0])
    kwargs = dict(length_scale=2.0, noise_scale=0.0, noise_w=0.0)
    wav = audio_float_to_int16(v.session.synthesize_ids(ids, **kwargs))
    chunks = list(v.session.synthesize_ids_chunked(
        ids, chunk_frames=128, overlap=64, first_chunk_frames=32, **kwargs))
    stream = check.to_int16(np.concatenate(chunks), "stream")
    answers = [check.Answer(got=got, text=text, conversion=mode, **kwargs)
               for got, mode in ((wav, "wav"), (stream, "stream"))]
    numbers = check.judge(d, answers, tiny.DEVICE)
    assert numbers["length_bad"] == 0
    assert numbers["wave_err"] < F32_ERR * 10  # int16 rounding


def test_a_wrong_length_is_counted(tmp_path):
    d, v = voice(tmp_path, CONFIGS[0], "float32")
    ids = list(range(4, 30))
    a = v.session.synthesize_ids_batch([ids], seed=1)[0]
    numbers = check.judge(d, [check.Answer(got=a[:-256], ids=ids, seed=1)],
                          tiny.DEVICE)
    assert numbers["length_bad"] == 1


def test_ambiguous_durations_take_either_count():
    w = np.array([1.2, 2.99999, 3.0002, 4.5])
    base = list(np.ceil(w).astype(int))  # 2, 3, 4, 5 = 14
    sums = {int(d.sum()): list(d) for d in check._candidates(w, 13)}
    assert sums == {13: [2, 3, 3, 5]}
    assert [list(d) for d in check._candidates(w, 14)] in (
        [[2, 3, 4, 5], [2, 4, 3, 5]], [[2, 4, 3, 5], [2, 3, 4, 5]])
    assert not list(check._candidates(w, 16))
    assert sum(base) == 14
