"""Speculative decode on the port's session, against the JAX session.

The batch path enqueues the decode at a frame bucket predicted from a
running estimate of frames per phoneme before it waits for the duration
totals (``runtime/session.py``).  It is sound because the prior noise is
frame-indexed: a decode at any bucket that covers the utterance gives the
same valid samples.  The cases of ``tests/test_speculative_decode.py`` on
the port, and: the estimate equals the JAX session's after the same
calls, no speculative decode reaches a signature that has not run, and a
warmed session runs no signature first after its warmup.
"""

import copy
import logging

import numpy as np
import pytest
import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime.convert import load_pytree_npz
from mimic3_tpu.runtime.session import VitsSession
from mimic3_tpu_torch.runtime import session as session_mod
from mimic3_tpu_torch.runtime.session import TorchVitsSession
from mimic3_tpu_torch.runtime.testvoice import create_test_voice

IDS = [1, 4, 7, 12, 5, 30, 9, 2, 17, 22, 3, 14, 8, 11, 6, 25, 19, 2]
# f32, TF32 off: speculation must give the normal path's audio to this
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    """(config, params) of a tiny voice whose durations vary and whose
    flow acts (the weights of tests/test_torch_port_slice.py)."""
    d = create_test_voice(
        tmp_path_factory.mktemp("spec") / "v", full_size=False
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


def _session(voice, allow_bucket_growth=False, **tpu) -> TorchVitsSession:
    config, params = voice
    if tpu:
        config = copy.deepcopy(config)
        for k, v in tpu.items():
            setattr(config.tpu, k, v)
    return TorchVitsSession(config, params, deterministic=True, device="cpu",
                            allow_bucket_growth=allow_bucket_growth)


def test_noise_is_bucket_independent(voice):
    """Same seed at two frame buckets -> identical valid samples."""
    session = _session(voice)
    model, params = session.model, session.params
    ids = torch.tensor([IDS])
    lengths = torch.tensor([len(IDS)])
    durations, totals = model.infer_durations(
        params, ids, lengths, 5, 1.0, 0.0
    )
    total = int(totals[0])
    # the decoder's zero padding past a bucket's end reaches back about
    # three frames: both buckets end well past the utterance
    small, len_small = model.decode_frames(
        params, ids, lengths, durations, total + 8, 5, 0.8
    )
    big, len_big = model.decode_frames(
        params, ids, lengths, durations, 2 * total + 64, 5, 0.8
    )
    n = int(len_small[0])
    assert n == int(len_big[0]) == total * 256
    np.testing.assert_allclose(
        small[0, :n].numpy(), big[0, :n].numpy(), atol=ATOL, rtol=0
    )


def test_speculation_matches_normal_path(voice):
    on = _session(voice)
    off = _session(voice, speculative_decode=False)
    assert on.speculative_decode and not off.speculative_decode

    # the first call trains the estimate (no speculation); later calls
    # predict
    for s in (on, off):
        s.synthesize_ids(IDS, noise_scale=0.5, noise_w=0.0, seed=1)
    assert on._ema_frames_per_phoneme is not None
    assert off.speculation["dispatched"] == 0

    for seed, seqs in ((2, [IDS]), (3, [IDS, IDS[:9], IDS[4:]])):
        a = on.synthesize_ids_batch(seqs, noise_scale=0.5, noise_w=0.8,
                                    seed=seed)
        b = off.synthesize_ids_batch(seqs, noise_scale=0.5, noise_w=0.8,
                                     seed=seed)
        for x, y in zip(a, b):
            assert x.shape == y.shape
            np.testing.assert_allclose(x, y, atol=ATOL, rtol=0)
    assert on.speculation["used"] >= 1
    assert off.speculation == dict.fromkeys(off.speculation, 0)


def test_misprediction_falls_back(voice):
    session = _session(voice)
    # a short input runs the smallest decode bucket, so a prediction into
    # it is dispatched, not skipped
    session.synthesize_ids(IDS[:4], noise_scale=0.5, noise_w=0.0, seed=3)
    ref = session.synthesize_ids(IDS, noise_scale=0.5, noise_w=0.0, seed=3)
    # force an absurdly small prediction -> spec bucket too small
    with session._lock:
        session._ema_frames_per_phoneme = 0.25
    before = dict(session.speculation)
    got = session.synthesize_ids(IDS, noise_scale=0.5, noise_w=0.0, seed=3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert session.speculation["fell_back"] == before["fell_back"] + 1
    assert session.speculation["used"] == before["used"]


def test_chunked_agrees_with_batch_under_noise(voice):
    """Frame-indexed noise unifies the streamed and batch paths."""
    session = _session(voice)
    full = session.synthesize_ids(IDS, noise_scale=0.667, noise_w=0.0,
                                  seed=9)
    chunks = list(
        session.synthesize_ids_chunked(
            IDS, noise_scale=0.667, noise_w=0.0, seed=9,
            chunk_frames=16, overlap=48,
        )
    )
    stitched = np.concatenate(chunks)
    assert len(stitched) == len(full)
    err = np.abs(stitched - full)
    assert float(err.max()) < 5e-4, float(err.max())


def test_streaming_honors_speculation_flag(voice):
    """Streaming does not speculate: the flag changes nothing there."""
    session = _session(voice)
    kw = dict(noise_scale=0.5, noise_w=0.0, seed=4, chunk_frames=16,
              overlap=48)
    ref = np.concatenate(list(session.synthesize_ids_chunked(IDS, **kw)))
    session.speculative_decode = False
    got = np.concatenate(list(session.synthesize_ids_chunked(IDS, **kw)))
    np.testing.assert_array_equal(got, ref)
    assert session._ema_frames_per_phoneme is None


def test_ema_tracks_observations(voice):
    session = _session(voice)
    assert session._ema_frames_per_phoneme is None
    session.synthesize_ids(IDS, noise_scale=0.0, noise_w=0.0)
    first = session._ema_frames_per_phoneme
    assert first is not None and 0.25 <= first <= 64.0
    session.synthesize_ids(IDS * 2, noise_scale=0.0, noise_w=0.0)
    assert session._ema_frames_per_phoneme is not None


def test_ema_equals_jax_session(voice):
    """After the same deterministic calls the port's frames-per-phoneme
    estimate equals the JAX session's."""
    config, params = voice
    ref = VitsSession(config, params, deterministic=True)
    port = _session(voice)
    calls = [
        ([IDS], 1.0),
        ([IDS[:9]], 1.0),
        ([IDS], 1.3),
        ([IDS[5:], IDS[:12]], 0.8),
    ]
    for seqs, length_scale in calls:
        for s in (ref, port):
            s.synthesize_ids_batch(
                seqs, noise_scale=0.0, noise_w=0.0,
                length_scale=length_scale,
            )
        np.testing.assert_allclose(
            port._ema_frames_per_phoneme, ref._ema_frames_per_phoneme,
            rtol=1e-6,
        )


def test_speculation_only_reaches_signatures_that_ran(voice, monkeypatch):
    """A decode enqueued before the totals reach the host is always to a
    signature that already ran; an estimate that points at a new one
    skips speculation and the mandatory decode runs it first."""
    session = _session(voice, frame_buckets=(16, 32, 64, 128, 256))
    phase = {"before_totals": False}
    dispatched = []
    start_copy = session_mod._start_host_copy

    def tracking_copy(t):
        wait = start_copy(t)
        phase["before_totals"] = True

        def tracked_wait():
            phase["before_totals"] = False
            return wait()

        return tracked_wait

    decode = session.model.decode_frames

    def tracking_decode(params, ids, lengths, durations, num_frames, *a,
                        **kw):
        key = session_mod.hit_key("decode", ids.shape[0], ids.shape[1],
                                  num_frames)
        dispatched.append(
            (phase["before_totals"], key, key in session._run_keys)
        )
        return decode(params, ids, lengths, durations, num_frames, *a, **kw)

    monkeypatch.setattr(session_mod, "_start_host_copy", tracking_copy)
    monkeypatch.setattr(session.model, "decode_frames", tracking_decode)
    kw = dict(noise_scale=0.5, noise_w=0.0, seed=1)
    session.synthesize_ids(IDS, **kw)  # about 11 frames per phoneme
    # predicted 11 x 4 x 1.15 frames: a bucket that never ran
    session.synthesize_ids(IDS[:4], **kw)
    assert session.speculation["skipped"] == 1
    session.synthesize_ids(IDS, **kw)  # its bucket ran: speculate
    assert session.speculation["used"] == 1
    speculative = [d for d in dispatched if d[0]]
    assert speculative and all(ran for _, _, ran in speculative)
    mandatory = [d for d in dispatched if not d[0]]
    assert len(mandatory) == 2 and not any(ran for _, _, ran in mandatory)


def test_no_signature_first_runs_after_warmup(voice):
    session = _session(
        voice, text_buckets=(32, 64), frame_buckets=(64, 128, 256),
        batch_buckets=(1, 2),
    )
    session.warmup(batch_sizes=(1, 2))
    for i in range(4):
        session.synthesize_ids_batch(
            [IDS, IDS[i:]][: 1 + i % 2], noise_scale=0.667, noise_w=0.8,
            seed=i,
        )
    assert session.hot_path_compiles() == 0
    assert session.speculation["used"] >= 1
    assert session.speculation["skipped"] == 0


# -- the signatures that have run ------------------------------------------------

RUN_SET = dict(text_buckets=(16, 32, 64), frame_buckets=(128, 256, 512),
               batch_buckets=(1, 2))
DET = dict(noise_scale=0.0, noise_w=0.0)
# a stream's windows: 8 + 2 x 48 frames, then 16 + 2 x 48
STREAM = dict(chunk_frames=16, overlap=48, first_chunk_frames=8)


@pytest.mark.parametrize("growth,warm,calls,fallback,hot", [
    # IDS is in text bucket 32 and decodes at frame bucket 256; IDS[:9]
    # is in text bucket 16 and decodes at 128
    pytest.param(False, None, [[IDS], [IDS[:9]]], None, 0, id="no-warmup"),
    pytest.param(False, dict(text_buckets=(64,)), [[IDS]],
                 "duration:b1:t32->duration:b1:t64", 0, id="duration-text"),
    pytest.param(False, dict(text_buckets=(32, 64)), [[IDS[:9]]],
                 "duration:b1:t16->duration:b1:t32", 0, id="nearest-of-two"),
    pytest.param(False, dict(text_buckets=(64,), frame_buckets=(128,),
                             chunk_windows=(104, 112)), ["stream"],
                 "stream_start:b1:t32:f104->stream_start:b1:t64:f104", 0,
                 id="stream-start-text"),
    pytest.param(False, dict(text_buckets=(32,), frame_buckets=(512,)),
                 [[IDS]], "decode:b1:t32:f256->decode:b1:t32:f512", 0,
                 id="decode-frames"),
    pytest.param(False, dict(text_buckets=(16,)), [[IDS]], None, 2,
                 id="no-warmed-candidate"),
    pytest.param(True, dict(text_buckets=(64,)), [[IDS]], None, 2,
                 id="bucket-growth"),
    # a signature first run live after the warmup is a target too
    pytest.param(False, dict(text_buckets=(64,)),
                 [[IDS, IDS], [IDS[:9], IDS[:9]]],
                 "duration:b2:t16->duration:b2:t32", 2,
                 id="live-run-is-a-target"),
])
def test_bucket_rounds_up_to_a_signature_that_has_run(
        voice, growth, warm, calls, fallback, hot):
    """After a warmup a request whose natural bucket never ran rounds up
    to the nearest that has (one ``bucket_fallbacks`` entry); before one,
    with no such bucket, or with bucket growth allowed, it keeps its
    own."""
    session = _session(voice, allow_bucket_growth=growth, **RUN_SET)
    if warm is not None:
        session.warmup(batch_sizes=(1,), **warm)
    for rows in calls:
        if rows == "stream":
            list(session.synthesize_ids_chunked(IDS, **DET, **STREAM))
        else:
            session.synthesize_ids_batch(rows, **DET)
    fallbacks = session.stats.fallbacks_snapshot()
    if fallback is None:
        assert fallbacks == {}
    else:
        assert fallbacks[fallback] == 1
    assert session.hot_path_compiles() == hot
    if warm is None:
        # each call's own duration pass and decode
        assert session.jit_executable_count() == 2 * len(calls)


def test_a_signature_first_run_live_counts_once_until_a_rewarm(voice):
    session = _session(voice, **RUN_SET)
    warm = dict(batch_sizes=(1,), text_buckets=(32,), frame_buckets=(256,))
    session.warmup(**warm)
    assert session.hot_path_compiles() == 0
    for _ in range(2):  # a batch bucket the warmup left out
        session.synthesize_ids_batch([IDS, IDS], **DET)
        assert session.hot_path_compiles() == 2  # its duration and decode
    n = session.jit_executable_count()
    session.warmup(**warm)  # the baseline takes them in
    assert session.hot_path_compiles() == 0
    assert session.jit_executable_count() == n


def test_a_live_decode_becomes_a_speculation_target(voice):
    session = _session(voice, **RUN_SET)
    session.synthesize_ids(IDS, **DET)  # no estimate yet: no speculation
    assert session.speculation == dict.fromkeys(session.speculation, 0)
    session.synthesize_ids(IDS, **DET)  # its decode ran on the first call
    assert session.speculation["dispatched"] == 1
    assert session.speculation["skipped"] == 0
    assert session.speculation["used"] == 1


@pytest.mark.parametrize("path", ["batch", "stream"])
def test_rows_past_the_largest_text_bucket_are_truncated(
        voice, caplog, path):
    """Both paths cut a row to the largest text bucket (64 here), warn,
    and give the cut row's audio."""
    session = _session(voice, **RUN_SET)
    row = (IDS * 4)[:70]

    def synthesize(ids):
        if path == "batch":
            return session.synthesize_ids_batch(
                [ids], length_scale=0.5, **DET)[0]
        return np.concatenate(list(session.synthesize_ids_chunked(
            ids, length_scale=0.5, **DET, **STREAM)))

    with caplog.at_level(logging.WARNING, logger=session_mod.__name__):
        got = synthesize(row)
    assert any("Truncating 1 phoneme sequence(s)" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_allclose(got, synthesize(row[:64]), atol=ATOL, rtol=0)
