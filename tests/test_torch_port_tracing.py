"""The port's spans and serving counters on the CPU: ``tracing.span`` off
and on, the store's stretch, the session's spans against the profiler's
Chrome trace, and the HTTP server's request identity, ``POST
/api/profile`` capture and ``/api/stats`` counters."""

import contextvars
import json
import threading
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from mimic3_tpu_torch import tracing
from mimic3_tpu_torch.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.runtime.voice import load_from_directory
from mimic3_tpu_torch.server.__main__ import create_app
from test_torch_server_thread import ServerThread

KEY = "en_US/tiny_low"
TUNE = dict(text_buckets=[32, 64], frame_buckets=[128, 256],
            batch_buckets=[1, 2, 4])
IDS = [[5, 6, 7, 8, 9, 10, 11, 12], [13, 14, 15, 16]]
SESSION_STEPS = ["session.prepare", "session.duration", "session.speculate",
                 "session.wait_totals", "session.decode",
                 "session.audio_to_host"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and
    in a parallel test run more oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _voice(root: Path) -> Path:
    d = create_test_voice(root / KEY, full_size=False)
    config = json.loads((d / "config.json").read_text())
    config["tpu"].update(TUNE)
    (d / "config.json").write_text(json.dumps(config))
    return d


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = _voice(tmp_path_factory.mktemp("voices"))
    return load_from_directory(d, device="cpu", share_sessions=False).session


def _capture():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_never_enters_record_function(
        monkeypatch, session):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with profiling off")

    before = tracing.spans()
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    with tracing.span("a", x=1) as a:
        a.set(y=2)
        tracing.span("b").end()
    session.synthesize_ids_batch(IDS, seed=1)
    assert tracing.spans() == before


def test_nesting_parents_and_thread_hops():
    with _capture():
        with tracing.span("outer") as outer:
            with tracing.span("inner", k=1) as inner:
                inner.set(k=2)
            handed = tracing.span("handed")
        done = threading.Thread(target=handed.end)
        done.start()
        done.join(timeout=30)
        assert not done.is_alive()
    got = {s.name: s for s in tracing.spans()}
    assert set(got) == {"outer", "inner", "handed"}
    assert got["outer"].parent is None
    assert got["inner"].parent == got["outer"].id
    assert got["inner"].attrs == {"k": 2}
    # opened inside outer, never a parent, ended on another thread
    assert got["handed"].parent == got["outer"].id
    assert got["handed"].thread == threading.current_thread().name
    assert all(s.start_ns <= s.end_ns for s in got.values())


def test_store_holds_the_latest_stretch_alone():
    with _capture():
        with tracing.span("first"):
            pass
    with tracing.span("untraced"):
        pass
    with _capture():
        with tracing.span("second"):
            pass
    assert [s.name for s in tracing.spans()] == ["second"]
    assert tracing.dropped() == 0


def test_session_spans_in_order_and_in_the_chrome_trace(session, tmp_path):
    """One batch call under a profiler: each session step once, in the
    order of the table in PERF.md §3, children of ``session.call``, and
    each a ``user_annotation`` of the exported trace within 1 ms of its
    record."""
    session.synthesize_ids_batch(IDS, seed=2)  # a decode bucket has run
    with _capture() as prof:
        out = session.synthesize_ids_batch(IDS, seed=3)
    assert len(out) == 2
    records = tracing.spans()
    call = [s for s in records if s.name == "session.call"]
    assert len(call) == 1
    call = call[0]
    assert call.attrs["batch"] == 2 and call.attrs["seed"] == 3
    assert call.attrs["speculation"] in {"used", "fell_back", "skipped"}
    steps = sorted((s for s in records if s.parent == call.id),
                   key=lambda s: s.start_ns)
    want = [n for n in SESSION_STEPS
            if n != "session.decode" or call.attrs["speculation"] != "used"]
    assert [s.name for s in steps] == want
    noise = [s for s in records if s.name == "model.noise"]
    assert noise and {s.parent for s in noise} <= {s.id for s in steps}
    assert all(call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
               for s in steps)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    events = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    for s in steps + [call]:
        (e,) = [e for e in events if e["name"] == s.name]
        assert abs(e["ts"] - (s.start_ns - base) / 1e3) < 1000
        assert abs(e["ts"] + e["dur"] - (s.end_ns - base) / 1e3) < 1000


def test_request_scope_survives_an_executor_hop():
    """A request set with ``tracing.serving`` goes with the work into a
    worker thread through ``contextvars.copy_context``."""

    class Req:
        id = 41

    def work():
        with tracing.span("on_worker") as s:
            return tracing.request(), s.id

    with _capture(), ThreadPoolExecutor(1) as pool:
        with tracing.serving(Req, tracing.span("root")):
            got, _ = pool.submit(contextvars.copy_context().run,
                                 work).result(timeout=30)
        assert tracing.request() is None
    assert got is Req
    (on_worker,) = [s for s in tracing.spans() if s.name == "on_worker"]
    assert on_worker.request == 41 and on_worker.thread != (
        threading.current_thread().name)


# -- the server --------------------------------------------------------------


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("served")
    _voice(root)
    app = create_app([
        "--voices-dir", str(root), "--voice", KEY, "--preload-voice", KEY,
        "--max-batch", "4", "--batch-delay-ms", "20",
        "--profile-dir", str(tmp_path_factory.mktemp("profile")),
        "--device", "cpu",
    ])
    app.preload()
    srv = ServerThread(app).start()
    yield app, srv.base_url
    srv.stop()
    app.shutdown()


def _get(base, path, data=None):
    req = urllib.request.Request(
        base + path, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "text/plain"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def _stream_query(text):
    return "/api/tts?" + urllib.parse.urlencode({
        "text": text, "voice": KEY, "streaming": "true",
        "streamingMode": "low-latency",
    })


def test_profile_capture_traces_workers_and_scheduler(server):
    """During ``POST /api/profile`` (``profile_all_threads``) the worker
    and scheduler threads see the profiler on: a request's spans carry
    its id from the handler through the worker pool and the scheduler's
    queue to ``scheduler.batch``, whose child is the ``session.call``,
    and each is a ``user_annotation`` of the written trace."""
    app, base = server
    _get(base, f"/api/tts?voice={KEY}&noCache=true", b"warm up.")
    captured = {}
    capture = threading.Thread(target=lambda: captured.update(json.loads(
        _get(base, "/api/profile?seconds=4", b""))))
    capture.start()
    # the capture has started once a span is opened anywhere
    for _ in range(200):
        if autograd_profiler._is_profiler_enabled:
            break
        threading.Event().wait(0.05)
    assert autograd_profiler._is_profiler_enabled
    _get(base, f"/api/tts?voice={KEY}&noCache=true", b"one sentence.")
    capture.join(timeout=120)
    assert not capture.is_alive()

    records = tracing.spans()
    (request,) = [s for s in records if s.name == "server.request"]
    rid = request.request
    assert rid is not None and request.attrs["mode"] == "wav"
    mine = {s.name: s for s in records if s.request == rid}
    assert {"server.request", "server.worker_wait", "server.frontend",
            "scheduler.queue_wait", "server.wav_encode"} <= set(mine)
    assert mine["server.frontend"].thread.startswith("tts-worker")
    assert mine["server.frontend"].parent == request.id
    (batch,) = [s for s in records if s.name == "scheduler.batch"
                and rid in s.attrs["requests"]]
    assert batch.thread == "tts-batch-scheduler"
    (call,) = [s for s in records if s.name == "session.call"
               and s.parent == batch.id]
    assert [s.name for s in records if s.name == "scheduler.collect"]

    (trace,) = Path(captured["profile_dir"]).glob("trace_*.json")
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"server.request", "server.frontend", "scheduler.batch",
            "session.call", "session.wait_totals"} <= names


def test_stats_count_requests_and_seconds(server):
    app, base = server
    before = json.loads(_get(base, "/api/stats"))
    texts = [f"request number {i}." for i in range(4)]
    with ThreadPoolExecutor(4) as pool:
        bodies = list(pool.map(lambda t: _get(
            base, f"/api/tts?voice={KEY}&noCache=true", t.encode()), texts))
        streams = list(pool.map(lambda t: _get(base, _stream_query(t)),
                                texts[:2]))
    assert all(bodies) and all(streams)
    after = json.loads(_get(base, "/api/stats"))

    req0, req1 = before["requests"], after["requests"]
    assert req1["wav"]["count"] - req0["wav"]["count"] == 4
    assert req1["stream"]["count"] - req0["stream"]["count"] == 2
    items = sum(req1[m]["items"] - req0[m]["items"] for m in req1)
    sched0, sched1 = before["scheduler"], after["scheduler"]
    assert items == sched1["items"] - sched0["items"] > 0
    for key in ("queue_wait_s", "collect_s", "device_s"):
        assert sched1[key] >= sched0[key] >= 0
    assert sched1["device_s"] > sched0["device_s"]
    for mode, m in req1.items():
        for key, value in m.items():
            assert value >= req0[mode][key] >= 0, (mode, key)
        assert m["total_s"] > req0[mode]["total_s"]
    assert req1["stream"]["first_chunk_s"] > req0["stream"]["first_chunk_s"]
    assert req1["wav"]["encode_s"] > req0["wav"]["encode_s"]

    voice = after["voices"][KEY]
    assert set(voice["speculation"]) == {
        "dispatched", "used", "fell_back", "skipped", "overlapped"}
    # the WAV requests' batch calls: decoded frames cover the returned ones
    assert voice["frames_decoded"] >= voice["frames_returned"] > 0
    # on the CPU every duration pass is issued eagerly
    graphs = voice["duration_graph"]
    assert graphs["eager"] > 0
    assert graphs["captured"] == graphs["replayed"] == 0
    assert graphs["capture_failed"] == 0
    assert "latency_p50_ms" not in voice and "latency_p99_ms" not in voice
    session = app.voice_stats_snapshot()[KEY]
    assert not hasattr(session.stats, "rtf_history")
    assert not hasattr(session.stats, "latency_history")
