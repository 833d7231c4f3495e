"""Streaming synthesis of the port against the JAX reference.

The same tiny voice and phoneme ids go through ``VitsSession`` and
``TorchVitsSession`` (both on the CPU).  Deterministic mode
(``noise_scale=0, noise_w=0``): equal integer durations and waveform
correlation >= 0.999, as in tests/test_torch_port_slice.py.  Within the
port, with noise on: chunked, batched and driver-decoded streams equal the
unchunked, solo and per-row ones within ``atol=1e-5`` (float32; the
seams are exact up to convolution rounding because the prior noise is
frame-indexed).
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime.convert import load_pytree_npz
from mimic3_tpu.runtime.session import VitsSession
from mimic3_tpu.server.scheduler import BatchScheduler
from mimic3_tpu_torch.runtime import session as tsession
from mimic3_tpu_torch.runtime.session import TorchVitsSession
from mimic3_tpu_torch.runtime.testvoice import create_test_voice

IDS = [1, 4, 7, 12, 5, 30, 9, 2, 17, 22, 3, 14, 8, 11, 6, 25, 19, 2]
DET = dict(noise_scale=0.0, noise_w=0.0)
NOISY = dict(noise_scale=0.667, noise_w=0.8, seed=3)
GRID = dict(chunk_frames=16, overlap=48, first_chunk_frames=8)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and in
    a parallel test run (a process per core) more oversubscribe the CPU
    and slow every op by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    """(config, params) of a tiny voice whose durations vary (2-9 frames
    per phoneme) and whose flow acts: the weights of
    tests/test_torch_port_slice.py's single-speaker fixture."""
    d = create_test_voice(
        tmp_path_factory.mktemp("voice") / "v", full_size=False
    )
    config = TrainingConfig.load_path(d / "config.json")
    params = load_pytree_npz(d / "generator.npz")
    rng = np.random.RandomState(1)
    flows = params["dp"]["flows"]
    flows["0"]["m"] = np.array([-1.4, 0.0], np.float32)
    for i in ("1", "3", "5", "7"):
        w = flows[i]["proj"]["weight"]
        flows[i]["proj"]["weight"] = (rng.randn(*w.shape) * 0.3).astype(
            np.float32
        )
    for i in ("0", "2", "4", "6"):
        post = params["flow"]["flows"][i]["post"]
        post["weight"] = (rng.randn(*post["weight"].shape) * 0.1).astype(
            np.float32
        )
    return config, params


@pytest.fixture(scope="module")
def sessions(voice):
    config, params = voice
    ref = VitsSession(config, params, deterministic=True)
    port = TorchVitsSession(config, params, deterministic=True, device="cpu")
    return ref, port


def _port_session(voice, **kw):
    """A fresh port session with the float32 decoder (deterministic mode;
    noise stays on where a call passes a seed and noise scales)."""
    config, params = voice
    return TorchVitsSession(
        config, params, deterministic=True, device="cpu", **kw
    )


def _concat(gen):
    return np.concatenate(list(gen))


def test_stream_start_matches_jax(sessions):
    """Encoder once, durations, first window: the port's
    ``VitsModel.stream_start`` against the reference's."""
    ref, port = sessions
    ids = np.zeros((2, 32), np.int64)
    ids[0, : len(IDS)] = IDS
    ids[1, :9] = IDS[:9]
    lengths = np.array([len(IDS), 9])
    want = ref.model.stream_start(
        ref.params, jnp.asarray(ids, jnp.int32), jnp.asarray(lengths, jnp.int32),
        jax.random.PRNGKey(0), jnp.float32(1.0), jnp.float32(0.0),
        jnp.float32(0.0), 48,
    )
    got = port.model.stream_start(
        port.params, torch.from_numpy(ids), torch.from_numpy(lengths), 0,
        1.0, 0.0, 0.0, 48,
    )
    dur, tot, m_p, logs_p, audio0 = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(got[0].numpy(), dur)
    np.testing.assert_array_equal(got[1].numpy(), tot)
    assert len(set(dur[0].tolist())) > 2  # durations vary
    # encoder statistics: [B, C, T] in the port, [B, T, C] in JAX
    tol = dict(atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got[2].transpose(1, 2).numpy(), m_p, **tol)
    np.testing.assert_allclose(got[3].transpose(1, 2).numpy(), logs_p, **tol)
    for row in range(2):
        n = min(48, int(tot[row])) * 256
        a, b = got[4][row, :n].numpy(), audio0[row, :n]
        assert np.corrcoef(a, b)[0, 1] >= 0.999


def test_decode_frames_enc_stats_matches_jax(sessions):
    """A window at a frame offset decoded from the kept encoder
    statistics, on both sides; in the port it equals the decode that runs
    the encoder itself."""
    ref, port = sessions
    ids = np.zeros((1, 32), np.int64)
    ids[0, : len(IDS)] = IDS
    lengths = np.array([len(IDS)])
    ids_t, lengths_t = torch.from_numpy(ids), torch.from_numpy(lengths)
    dur, tot, m_p, logs_p, _ = port.model.stream_start(
        port.params, ids_t, lengths_t, 0, 1.0, 0.0, 0.0, 24
    )
    got, got_n = port.model.decode_frames(
        port.params, ids_t, lengths_t, dur, 40, 0, 0.0, frame_offset=16,
        enc_stats=(m_p, logs_p),
    )
    alone, _ = port.model.decode_frames(
        port.params, ids_t, lengths_t, dur, 40, 0, 0.0, frame_offset=16,
    )
    np.testing.assert_allclose(got.numpy(), alone.numpy(), atol=1e-6)

    jd, _, jm, jl, _ = ref.model.stream_start(
        ref.params, jnp.asarray(ids, jnp.int32),
        jnp.asarray(lengths, jnp.int32), jax.random.PRNGKey(0),
        jnp.float32(1.0), jnp.float32(0.0), jnp.float32(0.0), 24,
    )
    want, want_n = ref.model.decode_frames(
        ref.params, jnp.asarray(ids, jnp.int32),
        jnp.asarray(lengths, jnp.int32), jd, 40, jax.random.PRNGKey(0),
        jnp.float32(0.0), frame_offset=16, enc_stats=(jm, jl),
    )
    assert int(got_n[0]) == int(want_n[0]) == int(tot[0]) * 256
    valid = min(40, int(tot[0]) - 16) * 256
    assert np.corrcoef(got[0, :valid].numpy(),
                       np.asarray(want)[0, :valid])[0, 1] >= 0.999


def test_chunked_stream_matches_jax_session(sessions):
    """``synthesize_ids_chunked``: the same chunk grid, equal lengths,
    correlation >= 0.999; the hit table names the same signatures."""
    ref, port = sessions
    want = list(ref.synthesize_ids_chunked(IDS, **DET, **GRID))
    got = list(port.synthesize_ids_chunked(IDS, **DET, **GRID))
    assert [c.size for c in got] == [c.size for c in want]
    assert len(got) >= 3
    assert np.corrcoef(np.concatenate(got), np.concatenate(want))[0, 1] >= 0.999
    port_keys = {k for k in port.stats.hits_snapshot()
                 if k.startswith(("stream_start", "chunk"))}
    ref_keys = {k for k in ref.stats.hits_snapshot()
                if k.startswith(("stream_start", "chunk"))}
    assert port_keys == ref_keys == {
        "stream_start:b1:t32:f104", "chunk:b1:t32:f112",
    }


def test_chunked_matches_unchunked_with_noise(voice):
    port = _port_session(voice)
    full = port.synthesize_ids(IDS, **NOISY)
    stream = _concat(port.synthesize_ids_chunked(IDS, **NOISY, **GRID))
    assert stream.shape == full.shape
    np.testing.assert_allclose(stream, full, atol=ATOL)


def test_stream_truncates_at_frame_cap(voice):
    """Past the largest frame bucket a stream is cut there, as the batch
    path cuts the utterance: the first window is decoded again from the
    re-capped durations of its row.  The batch path's bucket ends at the
    cut, where the decoder sees zero padding; the stream's window goes on
    past it with masked frames, which conv_pre's bias turns nonzero; that
    reaches back about three frames, so the last four are left out."""
    config, params = voice
    config = TrainingConfig.from_dict(config.to_dict())
    config.tpu.frame_buckets = (8, 16)
    port = TorchVitsSession(config, params, deterministic=True, device="cpu")
    full = port.synthesize_ids(IDS, **NOISY)
    chunks = list(port.synthesize_ids_chunked(IDS, **NOISY, **GRID))
    assert full.shape == (16 * 256,)
    assert [c.size for c in chunks] == [8 * 256, 8 * 256]
    valid = (16 - 4) * 256
    np.testing.assert_allclose(
        np.concatenate(chunks)[:valid], full[:valid], atol=ATOL
    )


def test_batched_stream_start_matches_solo(voice):
    """One fused start for three streams; their continuations run on the
    batched driver; each equals the stream alone."""
    port = _port_session(voice)
    seqs = [IDS, IDS[:7], IDS[3:] + IDS[:9]]
    gens = port.stream_start_batch(seqs, **NOISY, **GRID)
    assert gens[0].__qualname__ == "_ContinuationDriver.row"
    for seq, gen in zip(seqs, gens):
        solo = _concat(port.synthesize_ids_chunked(seq, **NOISY, **GRID))
        got = _concat(gen)
        assert got.shape == solo.shape
        np.testing.assert_allclose(got, solo, atol=ATOL)


def test_continuation_driver_matches_per_row_and_is_demand_paced(voice):
    seqs = [IDS * 2, IDS]
    per_row = _port_session(voice)
    per_row.batched_continuations = False
    rows = per_row.stream_start_batch(seqs, **NOISY, **GRID)
    assert rows[0].__qualname__ == "TorchVitsSession._stream_row"
    want = [_concat(g) for g in rows]

    port = _port_session(voice)
    gens = port.stream_start_batch(seqs, **NOISY, **GRID)
    driver = gens[0].gi_frame.f_locals["self"]
    first = [next(g) for g in gens]
    time.sleep(0.5)
    # nothing past the first chunk consumed: at most PREFETCH windows
    assert driver.windows_produced <= driver.PREFETCH
    got = [np.concatenate([f] + list(g)) for f, g in zip(first, gens)]
    hop, cf = 256, GRID["chunk_frames"]
    longest = max(w.size for w in want) // hop
    assert driver.windows_produced == -(-(longest - 8) // cf)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_scheduler_batches_concurrent_streams(voice):
    """Concurrent ``synthesize_ids_chunked`` calls with a scheduler
    attached share fused stream starts and equal the solo streams."""
    port = _port_session(voice)
    seqs = [IDS, IDS[:11], IDS[5:]]
    solos = [_concat(port.synthesize_ids_chunked(s, **NOISY, **GRID))
             for s in seqs]
    scheduler = BatchScheduler(max_batch=8, max_delay_ms=200.0)
    port.batcher = scheduler
    results = [None] * len(seqs)
    try:
        barrier = threading.Barrier(len(seqs))

        def run(i):
            barrier.wait()
            results[i] = _concat(
                port.synthesize_ids_chunked(seqs[i], **NOISY, **GRID)
            )

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(seqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        port.batcher = None
        scheduler.shutdown()
    assert scheduler.stats.items == len(seqs)
    assert scheduler.stats.batches < len(seqs)
    for solo, got in zip(solos, results):
        assert got is not None and got.shape == solo.shape
        np.testing.assert_allclose(got, solo, atol=ATOL)


def test_warmup_then_fallback_recorded(voice):
    """After a warmup, requests whose natural buckets never ran round up
    to warmed ones (counted in ``bucket_fallbacks``), run no new
    signature, and give the same audio (padding is masked)."""
    port = _port_session(voice)
    alone = _port_session(voice)
    assert port.hot_path_compiles() == 0  # no warmup yet
    port.warmup(
        text_buckets=(64,), frame_buckets=(512,), batch_sizes=(1,),
        chunk_windows=(8 + 96, 16 + 96),
    )
    n = port.jit_executable_count()
    assert n == 5  # duration, decode, stream start and two chunk windows
    got = port.synthesize_ids(IDS, **DET)
    np.testing.assert_allclose(got, alone.synthesize_ids(IDS, **DET),
                               atol=ATOL)
    stream = _concat(port.synthesize_ids_chunked(IDS, **DET, **GRID))
    np.testing.assert_allclose(
        stream, _concat(alone.synthesize_ids_chunked(IDS, **DET, **GRID)),
        atol=ATOL,
    )
    fallbacks = port.stats.fallbacks_snapshot()
    assert fallbacks["duration:b1:t32->duration:b1:t64"] == 1
    assert fallbacks["stream_start:b1:t32:f104->stream_start:b1:t64:f104"] == 1
    assert any(
        k.startswith("decode:b1:t64:f") and k.endswith("->decode:b1:t64:f512")
        for k in fallbacks
    )
    assert port.jit_executable_count() == n
    assert port.hot_path_compiles() == 0
    # a batch bucket that was never warmed runs a new signature
    port.synthesize_ids_batch([IDS, IDS], **DET)
    assert port.hot_path_compiles() == 2  # duration and decode at b2


def test_warmup_profile_prunes_the_grid(voice):
    """``profile=`` warms only the named signatures, closed over the next
    frame bucket (``expand_profile_batches``), plus their durations."""
    port = _port_session(voice)
    port.warmup(batch_sizes=(1,), profile={"decode:b1:t32:f128"})
    assert port.jit_executable_count() == 3
    assert port.stats.compile_count == 3


def test_full_f32_convolutions_is_shared_across_threads():
    """Overlapping users on several threads: TF32 stays off until the
    last one leaves, then the previous setting comes back."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        entered, leave = threading.Event(), threading.Event()

        def hold():
            with tsession.full_f32_convolutions():
                entered.set()
                leave.wait(timeout=30)

        other = threading.Thread(target=hold)
        other.start()
        assert entered.wait(timeout=30)
        with tsession.full_f32_convolutions():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False  # still held
        leave.set()
        other.join(timeout=30)
        assert not other.is_alive()
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = previous
