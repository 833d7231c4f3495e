"""The port's multi-speaker path against the benchmark's plain reference
(``benchmark/reference/vits_speakers.py``) on the CPU at a tiny size:
the voice directory the benchmark writes, loaded through the normal load
path, a batch of rows with a speaker each, the speaker span and the
session's frame counters."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import speakers as spk
from benchmark.harness import Artifacts
from benchmark.metrics import synth_pad_share
from benchmark.reference.params import layout
from benchmark.reference.vits_speakers import layout_speakers
from benchmark.tests import tiny
from benchmark.voice import voice_config
from mimic3_tpu_torch import tracing
from mimic3_tpu_torch.runtime.voice import load_from_directory

CONFIG = (Path(__file__).resolve().parents[1] / "benchmark" / "configs"
          / "vits_vctk_low_hifigan_bf16.json")
SPEAKERS = dict(gin_channels=16, n_speakers=5)
SEED = 2 ** 33 + 17
CALL_SEED = 2 ** 40 + 9
LENGTH_SCALE = 1.7
# float32 decoder: the same arithmetic in another order
F32_ERR = 1e-4
# bfloat16 decoder (8 bits of mantissa, the speaker term added in bf16)
# against float32 at this size; the single-speaker voices read under 0.01
BF16_ERR = 0.02


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(decoder_dtype):
    config = json.loads(CONFIG.read_text())
    config["model"].update(tiny.MODEL, **SPEAKERS)
    config["tpu"] = dict(config["tpu"], decoder_dtype=decoder_dtype,
                         **tiny.TPU)
    return config


@pytest.fixture(scope="module")
def voices(tmp_path_factory):
    """(voice directory, loaded voice) for each decoder dtype, the same
    weights in both."""
    root = tmp_path_factory.mktemp("speakers")
    out = {}
    for dtype in ("float32", "bfloat16"):
        d = spk.write_voice(root / dtype, _config(dtype), SEED, tiny.DEVICE)
        out[dtype] = d, load_from_directory(d, device="cpu",
                                            share_sessions=False)
    return out


def _ids(n, length, seed=5):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(4, 49, length))) for _ in range(n)]


def test_layout_is_the_single_speaker_layout_and_the_speaker_leaves():
    model = voice_config(_config("bfloat16"))["model"]
    single = dict(model, n_speakers=1, gin_channels=0)
    leaves = layout_speakers(model)
    speaker = [leaf for leaf in leaves if leaf.name.startswith("emb_g.")
               or ".cond." in leaf.name or ".cond_layer." in leaf.name]
    assert [leaf for leaf in leaves if leaf not in speaker] == layout(single)
    assert {leaf.name for leaf in speaker} == {
        "emb_g.weight", "dp.cond.weight", "dp.cond.bias", "dec.cond.weight",
        "dec.cond.bias"} | {
        f"flow.flows.{2 * c}.enc.cond_layer.{k}" for c in range(4)
        for k in ("weight_v", "weight_g", "bias")}
    (emb,) = [leaf for leaf in speaker if leaf.name == "emb_g.weight"]
    assert emb.shape == (5, 16) and (emb.init, emb.scale) == ("normal", 1.0)


def test_voice_loads_as_a_multi_speaker_voice(voices):
    d, voice = voices["bfloat16"]
    assert voice.config.is_multispeaker
    assert (d / "speakers.txt").read_text().split() == [
        f"speaker_{i}" for i in range(5)]
    p = voice.session.params
    assert tuple(p["emb_g"]["weight"].shape) == (5, 16)
    assert "cond" in p["dp"] and "cond" in p["dec"]
    assert all("cond_layer" in p["flow"]["flows"][str(2 * c)]["enc"]
               for c in range(4))


@pytest.mark.parametrize("dtype,limit", [("float32", F32_ERR),
                                         ("bfloat16", BF16_ERR)])
def test_mixed_speaker_batch_matches_each_rows_reference(voices, dtype,
                                                         limit):
    d, voice = voices[dtype]
    ids = _ids(2, 23)
    who = [3, 1]
    out = voice.session.synthesize_ids_batch(
        ids, speaker_ids=who, length_scale=LENGTH_SCALE, seed=CALL_SEED)
    answers = [spk.Answer(got=a, ids=i, seed=CALL_SEED, speaker=w,
                          length_scale=LENGTH_SCALE)
               for i, w, a in zip(ids, who, out)]
    numbers = spk.judge(d, answers, tiny.DEVICE)
    assert numbers["length_bad"] == 0
    assert numbers["wave_err"] < limit
    # the same rows judged as another speaker's are far off
    wrong = [spk.Answer(got=a.got, ids=a.ids, seed=a.seed, speaker=4,
                        length_scale=LENGTH_SCALE) for a in answers]
    numbers = spk.judge(d, wrong, tiny.DEVICE)
    assert numbers["length_bad"] > 0 or numbers["wave_err"] > 0.1


def test_rows_of_one_call_differ_by_speaker(voices):
    _, voice = voices["float32"]
    row = _ids(1, 23, seed=7)[0]
    out = voice.session.synthesize_ids_batch(
        [row] * 3, speaker_ids=[2, 2, 0], length_scale=LENGTH_SCALE,
        seed=CALL_SEED)
    np.testing.assert_array_equal(out[0], out[1])
    n = min(len(out[0]), len(out[2]))
    diff = np.linalg.norm(out[0][:n] - out[2][:n]) / np.linalg.norm(
        out[0][:n])
    assert diff > 0.1


def test_speaker_span_under_a_profiler(voices):
    _, voice = voices["bfloat16"]
    ids = _ids(2, 20, seed=9)
    with profile(activities=[ProfilerActivity.CPU]):
        voice.session.synthesize_ids_batch(ids, speaker_ids=[4, 1], seed=3)
    records = tracing.spans()
    (call,) = [s for s in records if s.name == "session.call"]
    (speaker,) = [s for s in records if s.name == "model.speaker"]
    (prepare,) = [s for s in records if s.name == "session.prepare"]
    assert call.attrs["speakers"] == speaker.attrs["speakers"] == 2
    assert speaker.parent == prepare.id and prepare.parent == call.id
    with profile(activities=[ProfilerActivity.CPU]):
        voice.session.synthesize_ids_batch(ids, speaker_ids=[2, 2], seed=3)
    calls = [s for s in tracing.spans() if s.name == "session.call"]
    assert calls[-1].attrs["speakers"] == 1


def _decoded(session, hits0):
    """rows x frame bucket of the decodes dispatched since ``hits0``."""
    total = 0
    for key, n in session.stats.hits_snapshot().items():
        if key.startswith("decode:"):
            b, _, f = key.split(":")[1:]
            total += int(b[1:]) * int(f[1:]) * (n - hits0.get(key, 0))
    return total


def test_frame_counters_follow_the_buckets_and_rows(voices):
    _, voice = voices["bfloat16"]
    session = voice.session
    stats, hop = session.stats, session.model.hp.hop_length
    # a short call runs the 128-frame decode; a longer one then speculates
    # on it from a low estimate, falls back and decodes again
    for ids, scale, ema in ((_ids(2, 12, seed=1), 1.0, None),
                            (_ids(2, 30, seed=2), 4.0, 0.25)):
        if ema is not None:
            session._ema_frames_per_phoneme = ema
        hits0, spec0 = stats.hits_snapshot(), dict(session.speculation)
        decoded0, returned0 = stats.frames_decoded, stats.frames_returned
        out = session.synthesize_ids_batch(ids, speaker_ids=[1] * len(ids),
                                           length_scale=scale, seed=11)
        assert stats.frames_decoded - decoded0 == _decoded(session, hits0)
        assert stats.frames_returned - returned0 == sum(
            len(a) // hop for a in out)
    assert session.speculation["fell_back"] == spec0["fell_back"] + 1
    assert stats.frames_decoded - decoded0 == 2 * 128 + 2 * 256


def test_pad_share_reads_nothing_without_counters():
    def artifacts(**counters):
        return Artifacts(model={}, window_s=5.0, device_name="cpu",
                         counters=counters)

    assert synth_pad_share.read(artifacts(spec_used=3)) is None
    assert synth_pad_share.read(artifacts(frames_decoded=0,
                                          frames_returned=0)) is None
    assert synth_pad_share.read(artifacts(
        frames_decoded=4096, frames_returned=3072)) == 25.0
