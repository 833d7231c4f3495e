"""Data-parallel synthesis on the port over a dp=4 CPU mesh, against the
port's own single-device session and the JAX package's dp mesh.

The port's counterparts of ``tests/test_mesh_inference.py`` and
``tests/test_mesh_stage_kernel.py``: the session over
``make_mesh(dp=4, platform="cpu")`` (four replicas of the CPU device)
runs the duration pass and the decode per shard of rows, and must give
the single-device audio within ``atol=2e-5``, with noise and speakers
too; partial and oversized batches; batch buckets that divide dp;
streaming on replica 0; the (plain, on the CPU) fused stage run once per
shard; the batching scheduler packing multiples of dp; a tp mesh placing
its parts (and one that does not divide a ruled axis refused); a dp above
the visible cards refused.  One test
holds the port's dp=4 session to the JAX package's ``TpuVoice(dp=4)`` at
``corr >= 0.999`` with equal lengths (the north-star bar).
"""

import copy

import numpy as np
import pytest
import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime.testvoice import create_test_voice
from mimic3_tpu.runtime.voice import TpuVoice
from mimic3_tpu_torch.config import TrainingConfig as TTrainingConfig
from mimic3_tpu_torch.ops import stage as stage_mod
from mimic3_tpu_torch.parallel import Split, make_mesh
from mimic3_tpu_torch.runtime.convert import load_pytree_npz
from mimic3_tpu_torch.runtime.session import TorchVitsSession
from mimic3_tpu_torch.runtime.voice import load_from_directory

SEQS = [
    [1, 5, 9, 2, 7, 3],
    [4, 4, 8, 1],
    [2, 9, 9, 9, 5, 5, 6, 1, 3],
    [7, 1],
    [3, 3, 3, 8, 2, 6],
    [5, 2, 7],
    [6, 6, 1, 4, 9, 2, 8, 3],
    [9, 8, 7, 6, 5],
]
DP = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def voice_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_voices") / "en_US" / "test_low"
    create_test_voice(d, full_size=False, n_speakers=4)
    return d


def _load(voice_dir, **kwargs):
    # deterministic=True -> f32 decoder, so layouts are compared without
    # bf16 rounding
    return load_from_directory(
        voice_dir, share_sessions=False, deterministic=True, device="cpu",
        **kwargs,
    ).session


@pytest.fixture(scope="module")
def single(voice_dir):
    return _load(voice_dir)


@pytest.fixture(scope="module")
def dp4(voice_dir):
    return _load(voice_dir, dp=DP)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)


def test_mesh_session_spans_devices(dp4):
    assert dp4.mesh.shape == {"dp": DP, "tp": 1}
    assert dp4.dp == DP
    assert len(dp4._replicas) == DP
    # every batch bucket divides dp
    assert dp4.batch_buckets == (4, 8, 16)


def test_dp4_matches_single_deterministic(single, dp4):
    kw = dict(noise_scale=0.0, noise_w=0.0, seed=0)
    _assert_same(dp4.synthesize_ids_batch(SEQS, **kw),
                 single.synthesize_ids_batch(SEQS, **kw))


def test_dp4_matches_single_with_noise_and_speakers(single, dp4):
    kw = dict(speaker_ids=[0, 1, 2, 3, 0, 1, 2, 3], noise_scale=0.667,
              noise_w=0.8, seed=11)
    _assert_same(dp4.synthesize_ids_batch(SEQS, **kw),
                 single.synthesize_ids_batch(SEQS, **kw))


def test_partial_batch_pads_to_dp(single, dp4):
    """A 5-item batch on dp=4 pads to 8 rows and still matches."""
    kw = dict(noise_scale=0.0, noise_w=0.0, seed=0)
    got = dp4.synthesize_ids_batch(SEQS[:5], **kw)
    assert len(got) == 5
    _assert_same(got, single.synthesize_ids_batch(SEQS[:5], **kw))
    assert "duration:b8:t32" in dp4.stats.hits_snapshot()


def test_oversized_batch_splits(single, dp4):
    """A batch past the largest bucket (16) splits into bucket-sized
    calls and matches the single-device session row for row."""
    seqs = (SEQS * 3)[:20]
    kw = dict(noise_scale=0.0, noise_w=0.0, seed=0)
    got = dp4.synthesize_ids_batch(seqs, **kw)
    assert len(got) == 20
    _assert_same(got, single.synthesize_ids_batch(seqs, **kw))


def test_single_stream_on_mesh(single, dp4):
    """Batch-1 calls and streams run on the mesh (streams on replica 0)
    and give the single-device audio."""
    kw = dict(noise_scale=0.0, noise_w=0.0)
    _assert_same([dp4.synthesize_ids(SEQS[0], **kw)],
                 [single.synthesize_ids(SEQS[0], **kw)])
    stream = dict(chunk_frames=16, overlap=32, **kw)
    chunks = list(dp4.synthesize_ids_chunked(SEQS[2], **stream))
    want = list(single.synthesize_ids_chunked(SEQS[2], **stream))
    assert chunks and all(c.size for c in chunks)
    _assert_same(chunks, want)


def _kernel_session(voice_dir, mesh=None):
    """A session whose decoder routes every stage of <= 32 channels
    through ``hifigan_stage_fused`` (its plain version on the CPU)."""
    tc = TTrainingConfig.load_path(voice_dir / "config.json")
    tc = copy.deepcopy(tc)
    tc.tpu.pallas_stage_max_channels = 32
    tc.tpu.speculative_decode = False
    return TorchVitsSession(
        tc, load_pytree_npz(voice_dir / "generator.npz"),
        deterministic=True, device=None if mesh else "cpu", mesh=mesh,
    )


def test_plain_stage_runs_once_per_shard(voice_dir, monkeypatch):
    """Each shard's decode runs the fused stage on its own rows: dp x the
    single session's stage calls per batch call, each on a quarter of the
    rows, and the same audio."""
    calls = []
    real = stage_mod.hifigan_stage_plain

    def counting(resblock_params, x, *args, **kwargs):
        calls.append(x.shape[0])
        return real(resblock_params, x, *args, **kwargs)

    monkeypatch.setattr(stage_mod, "hifigan_stage_plain", counting)
    kw = dict(noise_scale=0.667, noise_w=0.8, seed=17)
    one = _kernel_session(voice_dir)
    want = one.synthesize_ids_batch(SEQS, **kw)
    n_single, rows_single = len(calls), set(calls)
    assert n_single >= 2, "no decoder stage took the fused path"
    calls.clear()
    mesh = _kernel_session(voice_dir, make_mesh(dp=DP, platform="cpu"))
    got = mesh.synthesize_ids_batch(SEQS, **kw)
    assert len(calls) == DP * n_single
    assert set(calls) == {r // DP for r in rows_single}
    _assert_same(got, want)


def test_tp_mesh_raises(voice_dir):
    """A tp mesh is accepted and places the parts (use_tp: each dp row
    splits the ruled leaves over its tp devices); what still raises is a
    tp that does not divide a ruled axis, never replicated instead."""
    tc = TTrainingConfig.load_path(voice_dir / "config.json")
    params = load_pytree_npz(voice_dir / "generator.npz")
    session = TorchVitsSession(
        tc, params, mesh=make_mesh(n_devices=8, tp=2, platform="cpu"),
        use_tp=True,
    )
    assert session.dp == 4
    assert [len(r.devices) for r in session._replicas] == [2] * 4
    ups = session.params["dec"]["ups"]["0"]["weight"]
    assert isinstance(ups, Split) and len(ups.parts) == 2
    with pytest.raises(ValueError, match="does not divide"):
        TorchVitsSession(
            tc, params, mesh=make_mesh(n_devices=3, tp=3, platform="cpu"),
            use_tp=True,
        )


def test_dp_above_the_visible_cards_raises(voice_dir, monkeypatch):
    """dp on the card never shrinks and never moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs that many cards"):
        load_from_directory(voice_dir, share_sessions=False, dp=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("MIMIC3_DP", "2")
    with pytest.raises(RuntimeError, match="1 visible"):
        load_from_directory(voice_dir, share_sessions=False)


def test_dp4_matches_the_jax_mesh(voice_dir, dp4):
    """The JAX package's dp=4 session (8 virtual CPU devices, conftest)
    and the port's dp=4 session on one deterministic batch."""
    tc = TrainingConfig.load_path(voice_dir / "config.json")
    assert tc.tpu.batch_buckets == tuple(dp4.config.tpu.batch_buckets)
    ref = TpuVoice.load_from_directory(
        voice_dir, share_sessions=False, deterministic=True, dp=DP
    ).session
    assert ref.dp == DP
    kw = dict(noise_scale=0.0, noise_w=0.0, seed=0)
    want = ref.synthesize_ids_batch(SEQS, **kw)
    got = dp4.synthesize_ids_batch(SEQS, **kw)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        corr = np.corrcoef(g.astype(np.float64), w.astype(np.float64))[0, 1]
        assert corr >= 0.999, corr


def test_scheduler_packs_multiples_of_dp(single, dp4, monkeypatch):
    """The batching scheduler caps a packed batch at a multiple of the
    session's dp (max_batch 6 on dp=4 packs at most 4), and the packed
    calls give the single-device audio."""
    from mimic3_tpu_torch.server.scheduler import BatchScheduler

    sizes = []
    real = dp4.synthesize_ids_batch

    def recording(id_sequences, **kwargs):
        sizes.append(len(id_sequences))
        return real(id_sequences, **kwargs)

    monkeypatch.setattr(dp4, "synthesize_ids_batch", recording)
    scheduler = BatchScheduler(max_batch=6, max_delay_ms=500.0)
    try:
        kw = dict(noise_scale=0.0, noise_w=0.0, seed=0)
        futures = [scheduler.submit(dp4, s, **kw) for s in SEQS[:6]]
        got = [f.result(timeout=120) for f in futures]
    finally:
        scheduler.shutdown()
    assert sum(sizes) == 6 and max(sizes) == 4, sizes
    _assert_same(got, [single.synthesize_ids(s, **kw) for s in SEQS[:6]])
