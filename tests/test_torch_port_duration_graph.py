"""The batch path's duration pass as CUDA graphs (``runtime/session.py``,
``_DurationGraphs``).

On the CPU a session never captures.  With the capture stubbed (a graph
that reruns the pass on its fixed buffers, writing its outputs in place
as a replay does) the CPU runs the rules: when a bucket is captured,
replayed or left eager, what each replay reads afresh, and what a graph
that raises leaves behind.  Marked ``gpu``, on the card: replays against
the eager pass, outputs that outlive the next replay, a capture beside a
stream's continuation driver, and a warmed server under a burst.  This
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_duration_graph.py
"""

import json
import logging
import sys
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mimic3_tpu_torch import tracing
from mimic3_tpu_torch.config import TrainingConfig
from mimic3_tpu_torch.parallel import make_mesh
from mimic3_tpu_torch.runtime import session as session_mod
from mimic3_tpu_torch.runtime.convert import load_pytree_npz
from mimic3_tpu_torch.runtime.session import (
    TorchVitsSession,
    device_work,
    duration_graphs_apply,
)
from mimic3_tpu_torch.runtime.testvoice import create_test_voice

TUNE = dict(text_buckets=(32, 64), frame_buckets=(128, 256, 512),
            batch_buckets=(1, 2, 4))
ROWS = [[5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [16, 17, 18, 19, 20]]
# (rows, seed, length_scale, noise_w): one bucket (b2, t32), every value
# but the bucket moving from call to call
CALLS = [
    (ROWS, 11, 1.0, 0.8),
    (ROWS, 12, 1.3, 0.5),
    ([ROWS[1], ROWS[0][:7]], 13, 0.9, 0.0),
    (ROWS, 2 ** 40 + 3, 2.1, 1.1),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _voice(root: Path, full_size: bool = False, n_speakers: int = 1):
    """(config, params) of a test voice whose durations follow its text,
    its speaker and the SDP noise (the flows' projections act)."""
    d = create_test_voice(root, full_size=full_size, n_speakers=n_speakers)
    config = TrainingConfig.load_path(d / "config.json")
    params = load_pytree_npz(d / "generator.npz")
    rng = np.random.RandomState(1)
    flows = params["dp"]["flows"]
    flows["0"]["m"] = np.array([-1.4, 0.0], np.float32)
    for i in ("1", "3", "5", "7"):
        w = flows[i]["proj"]["weight"]
        flows[i]["proj"]["weight"] = (rng.randn(*w.shape) * 0.3).astype(
            np.float32)
    return config, params


@pytest.fixture(scope="module")
def voice(tmp_path_factory):
    config, params = _voice(tmp_path_factory.mktemp("graphs") / "v")
    for k, v in TUNE.items():
        setattr(config.tpu, k, v)
    return config, params


def _session(voice, **kwargs) -> TorchVitsSession:
    config, params = voice
    return TorchVitsSession(config, params, deterministic=True,
                            device=kwargs.pop("device", "cpu"), **kwargs)


def _synthesize(session, call):
    rows, seed, length_scale, noise_w = call
    return session.synthesize_ids_batch(
        rows, length_scale=length_scale, noise_w=noise_w, noise_scale=0.5,
        seed=seed)


def _counts(session):
    return session.stats.duration_graph_snapshot()


def _graph_attrs(since_ns):
    """The ``graph`` of each ``session.duration`` span opened since."""
    return [s.attrs["graph"] for s in tracing.spans()
            if s.name == "session.duration" and s.start_ns >= since_ns]


class _ReplayOnCpu:
    """A graph's stand-in: a replay reruns the pass on the fixed buffers
    and writes the static outputs in place."""

    def __init__(self, entry):
        self.entry = entry

    def replay(self):
        for out, new in zip(self.entry.outputs, self.entry.run()):
            out.copy_(new)


@pytest.fixture
def stubbed(monkeypatch):
    """Graphs on for every session with no tp split, the CPU's included,
    and the capture stubbed; gives the shapes captured."""
    captured = []

    def capture(self, entry, device):
        captured.append(tuple(entry.ids.shape))
        out = entry.run()
        entry.outputs = entry.run()
        entry.graph = _ReplayOnCpu(entry)
        return out

    monkeypatch.setattr(session_mod, "duration_graphs_apply",
                        lambda device, tp: tp == 1)
    monkeypatch.setattr(session_mod._DurationGraphs, "_capture", capture)
    return captured


# -- the CPU --------------------------------------------------------------------


@pytest.mark.parametrize("device,tp,applies", [
    ("cuda", 1, True), ("cuda", 2, False), ("cpu", 1, False),
    ("cpu", 2, False),
])
def test_graphs_apply_on_a_card_without_a_tp_split(device, tp, applies):
    assert duration_graphs_apply(torch.device(device), tp) is applies


def test_a_cpu_session_never_captures(voice):
    session = _session(voice)
    assert not session._duration_graphs.enabled
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for call in CALLS[:3]:
            _synthesize(session, call)
    assert _graph_attrs(since) == ["eager"] * 3
    assert _counts(session) == dict(captured=0, replayed=0, eager=3,
                                    capture_failed=0)


def test_second_run_captures_then_replays_the_eager_answers(voice, stubbed):
    graphs, eager = _session(voice), _session(voice)
    eager._duration_graphs.enabled = False
    assert graphs._duration_graphs.enabled
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [_synthesize(graphs, call) for call in CALLS]
    assert _graph_attrs(since) == ["eager", "capture", "replay", "replay"]
    assert stubbed == [(2, 32)]
    assert _counts(graphs) == dict(captured=1, replayed=2, eager=1,
                                   capture_failed=0)
    for call, rows in zip(CALLS, got):
        want = _synthesize(eager, call)
        assert len(rows) == len(want)
        for a, b in zip(rows, want):
            np.testing.assert_array_equal(a, b)


def test_dp_rows_on_one_device_capture_at_the_next_call(voice, stubbed):
    """Two dp rows on one device share a bucket's graph: both shards run
    eagerly at the bucket's first call, the next call captures with its
    first shard and replays with its second."""
    graphs, eager = (
        _session(voice, device=None, mesh=make_mesh(dp=2, platform="cpu"))
        for _ in range(2))
    eager._duration_graphs.enabled = False
    since = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [_synthesize(graphs, call) for call in CALLS]
    assert _graph_attrs(since) == ["eager", "capture,replay", "replay",
                                   "replay"]
    assert stubbed == [(1, 32)]
    assert _counts(graphs) == dict(captured=1, replayed=5, eager=2,
                                   capture_failed=0)
    for call, rows in zip(CALLS, got):
        for a, b in zip(rows, _synthesize(eager, call)):
            np.testing.assert_array_equal(a, b)


def test_warmup_captures_every_warmed_bucket(voice, stubbed):
    session = _session(voice)
    session.warmup(batch_sizes=[1, 2], frame_buckets=[128])
    assert sorted(stubbed) == [(1, 32), (1, 64), (2, 32), (2, 64)]
    assert _counts(session)["captured"] == 4
    _synthesize(session, CALLS[0])
    assert _counts(session) == dict(captured=4, replayed=1, eager=0,
                                    capture_failed=0)


def test_a_tp_session_stays_eager(voice, stubbed):
    config, params = voice
    session = TorchVitsSession(config, params, deterministic=True,
                               mesh=make_mesh(dp=1, tp=2, platform="cpu"),
                               use_tp=True)
    assert not session._duration_graphs.enabled
    for call in CALLS[:3]:
        _synthesize(session, call)
    assert stubbed == []
    assert _counts(session) == dict(captured=0, replayed=0, eager=3,
                                    capture_failed=0)


@pytest.mark.parametrize("fails", ["capture", "replay"])
def test_a_graph_that_raises_leaves_its_bucket_eager(
        voice, stubbed, monkeypatch, caplog, fails):
    def refuse(*args, **kwargs):
        raise RuntimeError(f"{fails} refused")

    if fails == "capture":
        monkeypatch.setattr(session_mod._DurationGraphs, "_capture", refuse)
    else:
        monkeypatch.setattr(_ReplayOnCpu, "replay", refuse)
    graphs, eager = _session(voice), _session(voice)
    eager._duration_graphs.enabled = False
    with caplog.at_level(logging.WARNING, logger=session_mod.__name__):
        for call in CALLS:
            for a, b in zip(_synthesize(graphs, call),
                            _synthesize(eager, call)):
                np.testing.assert_array_equal(a, b)
    # the capture raised at the second call, or the replay at the third;
    # every later call of the bucket ran eagerly without trying again
    want = (dict(captured=0, replayed=0, eager=4, capture_failed=1)
            if fails == "capture"
            else dict(captured=1, replayed=0, eager=3, capture_failed=1))
    assert _counts(graphs) == want
    warned = [r for r in caplog.records if "runs eagerly" in r.message]
    assert len(warned) == 1 and f"{fails} refused" in warned[0].message


@pytest.mark.parametrize("length_scale,noise_w", [
    (1.0, 0.8), (4.75, 0.667), (0.37, 0.0), (2.2, 1.3)])
def test_scales_as_0d_tensors_give_the_floats_durations(
        voice, length_scale, noise_w):
    session = _session(voice)
    model, params = session.model, session.params
    ids = torch.tensor([ROWS[0], ROWS[1] + [0] * 6])
    lengths = torch.tensor([11, 5])
    with device_work():
        floats = model.infer_durations(params, ids, lengths, 7,
                                       length_scale, noise_w)
        tensors = model.infer_durations(
            params, ids, lengths, 7, torch.tensor(length_scale),
            torch.tensor(noise_w))
    assert floats[0].dtype == tensors[0].dtype == torch.int32
    for a, b in zip(floats, tensors):
        assert torch.equal(a, b)


def test_replayed_outputs_outlive_the_next_replay(voice, stubbed):
    session = _session(voice)
    graphs, rep = session._duration_graphs, session._replicas[0]
    ids = torch.tensor([ROWS[0], ROWS[1] + [0] * 6])
    lengths = torch.tensor([11, 5])
    with device_work():
        # the second pass is told its bucket has run, as the session does
        hows = [graphs.run(rep, ids, lengths, None, s, 1.0, 0.8,
                           capture=s > 1)[2] for s in (1, 2)]
        first = graphs.run(rep, ids, lengths, None, 3, 1.0, 0.8)
        kept = [t.clone() for t in first[:2]]
        second = graphs.run(rep, ids, lengths, None, 4, 2.5, 0.3)
        eager = [session.model.infer_durations(rep.params, ids, lengths, *v)
                 for v in ((3, 1.0, 0.8), (4, 2.5, 0.3))]
    assert hows + [first[2], second[2]] == ["eager", "capture", "replay",
                                             "replay"]
    for a, b in zip(first[:2], kept):
        assert torch.equal(a, b)
    assert not torch.equal(first[0], second[0])
    for got, want in zip((first, second), eager):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sole_device_call_sees_other_threads_and_holds_their_new_calls():
    busy, release = threading.Event(), threading.Event()

    def other_call():
        with device_work():
            busy.set()
            release.wait(30)

    other = threading.Thread(target=other_call)
    other.start()
    assert busy.wait(30)
    with device_work(), session_mod._sole_device_call() as sole:
        assert not sole  # another thread's call is in flight
    release.set()
    other.join(30)

    entered = threading.Event()

    def new_call():
        with device_work():
            entered.set()

    with device_work():
        with session_mod._sole_device_call() as sole:
            assert sole
            late = threading.Thread(target=new_call)
            late.start()
            assert not entered.wait(0.3)  # held at its start
            # this thread's own nested calls go through
            with device_work():
                pass
        assert entered.wait(30)
    late.join(30)


def test_sole_device_call_under_contention():
    """Threads beyond the cores enter device calls and try for the sole
    one at a fast switch interval: no thread starts a device call while
    another holds the sole one, and every thread gets through."""
    lock = threading.Lock()
    holder, broken, soles, done = [None], [], [0], []

    def worker(n):
        me, rng = threading.get_ident(), np.random.default_rng(n)
        for i in range(100):
            with device_work():
                with lock:
                    if holder[0] not in (None, me):
                        broken.append((me, holder[0]))
                if i % 4 == n % 4:
                    with session_mod._sole_device_call() as sole:
                        if sole:
                            with lock:
                                holder[0] = me
                                soles[0] += 1
                            time.sleep(0.002)  # others try to start
                            with lock:
                                holder[0] = None
            time.sleep(float(rng.random()) * 0.004)
        done.append(n)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(n,))
                   for n in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(16))
    assert not broken and soles[0] > 0
    assert session_mod.device_calls_in_flight() == 0


# -- the card -------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_voices(card, tmp_path_factory):
    """Full-width voices: one speaker, and the VCTK layout (gin 256)."""
    root = tmp_path_factory.mktemp("card")
    return {"single": _voice(root / "single", full_size=True),
            "speakers": _voice(root / "speakers", full_size=True,
                               n_speakers=5)}


def _card_inputs(session, rows, t, seed, speakers=None):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(t // 2, t + 1, rows)
    ids = np.zeros((rows, t), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(4, 40, n)
    ids_t = torch.from_numpy(ids).to(session.device)
    lengths_t = torch.from_numpy(lengths).to(session.device)
    g = None
    if speakers is not None:
        g = session.model.speaker_embedding(
            session.params, torch.tensor(speakers, device=session.device))
    return ids_t, lengths_t, g


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["single", "speakers"])
def test_card_replay_equals_the_eager_pass(card_voices, layout):
    session = TorchVitsSession(*card_voices[layout], device="cuda")
    graphs, rep = session._duration_graphs, session._replicas[0]
    assert graphs.enabled
    speakers = layout == "speakers"
    with device_work(session.deterministic):
        ids, lengths, g = _card_inputs(
            session, 16, 128, 0, [0] * 16 if speakers else None)
        hows = [graphs.run(rep, ids, lengths, g, s, 1.0, 0.8,
                           capture=s > 1)[2] for s in (1, 2)]
        assert hows == ["eager", "capture"]
        # every input but the bucket differs from the capture's
        for seed, length_scale, noise_w in ((3, 4.75, 0.667), (2 ** 35, 0.7,
                                            0.0), (9, 2.0, 1.3)):
            ids, lengths, g = _card_inputs(
                session, 16, 128, seed,
                list(np.arange(16) % 5) if speakers else None)
            d, tot, how = graphs.run(rep, ids, lengths, g, seed,
                                     length_scale, noise_w)
            want = session.model.infer_durations(
                rep.params, ids, lengths, seed, length_scale, noise_w, g=g)
            assert how == "replay"
            assert torch.equal(d, want[0]) and torch.equal(tot, want[1])
    assert _counts(session)["capture_failed"] == 0


@pytest.mark.gpu
def test_card_two_buckets_back_to_back_keep_their_outputs(card_voices):
    session = TorchVitsSession(*card_voices["single"], device="cuda")
    graphs, rep = session._duration_graphs, session._replicas[0]
    with device_work(session.deterministic):
        a = _card_inputs(session, 16, 128, 1)
        b = _card_inputs(session, 4, 64, 2)
        for inputs, ran in ((a, False), (a, True), (b, False), (b, True)):
            # eager, then captured once it has run, each bucket
            graphs.run(rep, *inputs, 0, 1.0, 0.8, capture=ran)
        first = graphs.run(rep, *a, 5, 4.75, 0.667)
        other = graphs.run(rep, *b, 6, 1.5, 0.8)
        again = graphs.run(rep, *a, 7, 3.0, 0.3)  # the same graph, anew
        torch.cuda.synchronize()
        assert [first[2], other[2], again[2]] == ["replay"] * 3
        for got, inputs, v in ((first, a, (5, 4.75, 0.667)),
                               (other, b, (6, 1.5, 0.8)),
                               (again, a, (7, 3.0, 0.3))):
            want = session.model.infer_durations(rep.params, *inputs[:2], *v)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    assert not torch.equal(first[0], again[0])


@pytest.mark.gpu
def test_card_lazy_capture_beside_a_continuation_driver(card_voices):
    """A bucket captured while a stream's continuation driver decodes:
    the driver's next window waits for the capture, and both answers are
    the ones each gives alone."""
    config, params = card_voices["single"]
    session = TorchVitsSession(config, params, device="cuda",
                               deterministic=True)
    stream_rows = [list(range(4, 40)) * 3, list(range(5, 41)) * 3]

    def stream():
        return session.stream_start_batch(
            stream_rows, length_scale=3.0, seed=21, chunk_frames=128,
            overlap=32)

    def drain(gen, out, pause):
        for chunk in gen:
            out.append(chunk)
            time.sleep(pause)  # a slow client: the driver waits between
            # windows, outside any device call

    # each alone first, which also does the shapes' first-call work (it
    # takes longer than a stream lasts): the stream, and the batch
    # bucket's first run, eager
    alone = [[], []]
    for gen, out in zip(stream(), alone):
        drain(gen, out, 0.0)
    calls = [(ROWS, 30 + i, 1.0 + 0.1 * i, 0.8) for i in range(40)]
    got = [_synthesize(session, calls[0])]

    streamed = [[], []]
    consumers = [threading.Thread(target=drain, args=(gen, out, 0.1))
                 for gen, out in zip(stream(), streamed)]
    for c in consumers:
        c.start()
    alive_at_capture = None
    for call in calls[1:]:
        got.append(_synthesize(session, call))
        counts = _counts(session)
        if alive_at_capture is None and counts["captured"]:
            alive_at_capture = any(c.is_alive() for c in consumers)
        elif counts["replayed"]:
            break
    for c in consumers:
        c.join(120)
    assert alive_at_capture
    assert _counts(session)["capture_failed"] == 0
    assert _counts(session)["replayed"] >= 1
    for a, b in zip(streamed, alone):
        np.testing.assert_allclose(np.concatenate(a), np.concatenate(b),
                                   atol=1e-5, rtol=0)
    session._duration_graphs.enabled = False
    for call, rows in zip(calls, got):
        for a, b in zip(rows, _synthesize(session, call)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_card_warmed_server_answers_a_burst_of_wavs_and_streams(
        card, tmp_path):
    from mimic3_tpu_torch.server.__main__ import create_app
    from test_torch_server_thread import ServerThread

    key = "en_US/graph_low"
    d = create_test_voice(tmp_path / key, full_size=True)
    config = json.loads((d / "config.json").read_text())
    config["tpu"].update(text_buckets=[32, 64, 128],
                         frame_buckets=[128, 256, 512, 1024],
                         batch_buckets=[1, 2, 4, 8])
    (d / "config.json").write_text(json.dumps(config))
    app = create_app([
        "--voices-dir", str(tmp_path), "--voice", key, "--preload-voice",
        key, "--warmup", "--max-batch", "8", "--batch-delay-ms", "20",
        "--device", "cuda",
    ])
    app.preload()
    srv = ServerThread(app).start()
    try:
        session = app.voice_stats_snapshot()[key]
        # a duration graph for each warmed (batch, text) bucket
        assert _counts(session)["captured"] == 4 * 3

        def get(query, text):
            req = urllib.request.Request(
                srv.base_url + query, data=text.encode(), method="POST",
                headers={"Content-Type": "text/plain"})
            with urllib.request.urlopen(req, timeout=300) as r:
                assert r.status == 200
                return r.read()

        stream = "/api/tts?" + urllib.parse.urlencode({
            "voice": key, "streaming": "true",
            "streamingMode": "low-latency"})
        texts = [("word " * (3 + 4 * i)).strip() + "." for i in range(16)]
        with ThreadPoolExecutor(20) as pool:
            wavs = [pool.submit(get, f"/api/tts?voice={key}&noCache=true", t)
                    for t in texts]
            streams = [pool.submit(get, stream, t) for t in texts[::4]]
            bodies = [f.result() for f in wavs + streams]
        assert all(len(b) > 44 for b in bodies)
        counts = _counts(session)
        assert counts["capture_failed"] == 0 and counts["replayed"] > 0
        assert counts["captured"] == 4 * 3  # none on the serving path
    finally:
        srv.stop()
        app.shutdown()
