"""The HTTP server on the port's session, in process, on the CPU.

``python -m mimic3_tpu_torch.server``'s app (``create_app`` with
``--device cpu``) is preloaded with warmup on a tiny voice and served on a
background thread; requests go through urllib as a client's would.  Also:
``--dp`` sets ``MIMIC3_DP``, nothing runs on the CPU unless it is named,
and the server runs with JAX blocked.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
import threading
import urllib.error
import urllib.parse
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime.convert import load_pytree_npz
from mimic3_tpu_torch import cli
from mimic3_tpu_torch.runtime.session import TorchVitsSession
from mimic3_tpu_torch.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.runtime.voice import load_from_directory
from mimic3_tpu_torch.server.__main__ import apply_dp, create_app, parse_args
from test_torch_server_thread import ServerThread

REPO = Path(__file__).resolve().parents[1]
KEY = "en_US/tiny_low"
TEXT = "a rather long sentence with quite a few words in it"
# the server's low-latency grid (mimic3_tpu/server/app.py)
GRID = dict(chunk_frames=128, overlap=64, first_chunk_frames=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread (the server's worker threads take the setting
    when they start): the tiny shapes gain nothing from more, and in a
    parallel test run more oversubscribe the CPU and slow every op by
    orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _voice(root: Path) -> Path:
    """A tiny voice with a serving bucket grid small enough for a quick
    warmup."""
    d = create_test_voice(root / KEY, full_size=False)
    config = json.loads((d / "config.json").read_text())
    config["tpu"].update(
        text_buckets=[32, 64, 128], frame_buckets=[128, 256],
        batch_buckets=[1, 2, 4],
    )
    (d / "config.json").write_text(json.dumps(config))
    return d


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("voices")
    _voice(root)
    profile_dir = tmp_path_factory.mktemp("profile")
    app = create_app([
        "--voices-dir", str(root), "--voice", KEY, "--preload-voice", KEY,
        "--warmup", "--deterministic", "--max-batch", "4",
        "--batch-delay-ms", "100", "--profile-dir", str(profile_dir),
        "--device", "cpu",
    ])
    app.preload()
    srv = ServerThread(app).start()
    yield app, srv.base_url
    srv.stop()
    app.shutdown()


def _request(base, path, data=None, content_type="text/plain"):
    req = urllib.request.Request(
        base + path, data=data, headers={"Content-Type": content_type},
        method="GET" if data is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read(), dict(r.headers)


def _wav(body: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (
            22050, 2, 1,
        )
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_tts_post_returns_wav(server):
    _, base = server
    status, body, headers = _request(base, f"/api/tts?voice={KEY}",
                                     b"Hello world.")
    assert status == 200 and headers["Content-Type"] == "audio/wav"
    assert _wav(body).size > 0


def test_tts_ssml(server):
    _, base = server
    ssml = b'<speak><s>one</s><break time="100ms"/><s>two</s></speak>'
    status, body, _ = _request(base, f"/api/tts?voice={KEY}", ssml,
                               "application/ssml+xml")
    assert status == 200 and _wav(body).size > 0


def test_low_latency_stream_matches_session_chunks(server):
    """``streamingMode=low-latency``: the PCM after the unknown-length
    header is the session's chunks at the server's fixed gain."""
    app, base = server
    query = urllib.parse.urlencode({
        "text": TEXT, "voice": KEY, "streaming": "true",
        "streamingMode": "low-latency",
    })
    status, blob, headers = _request(base, f"/api/tts?{query}")
    assert status == 200 and headers["Transfer-Encoding"] == "chunked"
    assert blob[:4] == b"RIFF"
    pcm = np.frombuffer(blob[44:], np.int16)

    voice = app._catalog._get_or_load_voice(KEY)
    chunks = [
        chunk
        for words, _ in voice.text_to_phonemes(TEXT)
        for chunk in voice.session.synthesize_ids_chunked(
            voice.phonemes_to_ids(words), noise_scale=0.0, noise_w=0.0,
            length_scale=voice.config.inference.length_scale, **GRID,
        )
    ]
    want = np.clip(np.concatenate(chunks) * 32767.0 * 0.7, -32767,
                   32767).astype(np.int16)
    assert pcm.shape == want.shape
    assert np.abs(pcm.astype(np.int32) - want).max() <= 1


def test_concurrent_requests_share_device_batches(server):
    _, base = server
    before = json.loads(_request(base, "/api/stats")[1])["scheduler"]
    texts = [f"request number {i}" for i in range(4)]
    with ThreadPoolExecutor(4) as pool:
        wavs = list(pool.map(
            lambda t: _wav(_request(
                base, f"/api/tts?voice={KEY}&noCache=true", t.encode()
            )[1]),
            texts,
        ))
    assert all(w.size > 0 for w in wavs)
    after = json.loads(_request(base, "/api/stats")[1])["scheduler"]
    items = after["items"] - before["items"]
    batches = after["batches"] - before["batches"]
    assert items == 4 and batches < items


def test_stats_counts_signatures_and_no_hot_path_run(server):
    """``/api/stats`` reads the session's ``jit_executable_count`` (the
    distinct signatures run) and ``hot_path_compiles`` (signatures first
    run after warmup): every request here stayed in the warmed set."""
    _, base = server
    _request(base, f"/api/tts?voice={KEY}&noCache=true", b"one more.")
    stats = json.loads(_request(base, "/api/stats")[1])
    voice = stats["voices"][KEY]
    assert voice["jit_executables"] > 0
    assert voice["hot_path_compiles"] == 0
    assert voice["bucket_fallbacks"] == {}
    assert any(k.startswith("decode:") for k in voice["executable_hits"])
    assert stats["device"]["calls_in_flight"] == 0


def test_profile_capture_writes_torch_trace(server):
    """``POST /api/profile`` records a torch.profiler Chrome trace into
    ``--profile-dir``; a second capture while one runs gets 409."""
    app, base = server
    assert app._profile_lock.acquire(blocking=False)  # a capture running
    try:
        with pytest.raises(urllib.error.HTTPError) as busy:
            _request(base, "/api/profile?seconds=0.1", b"")
        assert busy.value.code == 409
    finally:
        app._profile_lock.release()
    # requests during the capture: the trace records their ops
    traffic = threading.Thread(target=lambda: _request(
        base, f"/api/tts?voice={KEY}&noCache=true", b"profiled request."
    ))
    traffic.start()
    status, body, _ = _request(base, "/api/profile?seconds=1", b"")
    traffic.join(timeout=120)
    assert not traffic.is_alive()
    payload = json.loads(body)
    assert status == 200 and payload["seconds"] == 1.0
    traces = list(Path(payload["profile_dir"]).glob("trace_*.json"))
    assert traces
    assert "traceEvents" in json.loads(traces[0].read_text())


def test_dp_above_one_is_refused(tmp_path, monkeypatch):
    """``--dp N`` is taken and sets ``MIMIC3_DP`` as the reference's
    server does (0/1 clears it); a dp above the visible cards is refused
    when the voice loads, never shrunk or moved to the CPU."""
    monkeypatch.delenv("MIMIC3_DP", raising=False)
    args, device = parse_args(["--dp", "2", "--device", "cpu"])
    assert args.dp == 2 and device == "cpu"
    apply_dp(args.dp)
    assert os.environ["MIMIC3_DP"] == "2"
    args, _ = parse_args(["--dp", "1", "--device", "cpu"])
    apply_dp(args.dp)
    assert "MIMIC3_DP" not in os.environ
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs that many cards"):
        load_from_directory(_voice(tmp_path), share_sessions=False, dp=2)


def test_no_device_named_raises_without_card(tmp_path, monkeypatch):
    """With no card visible, the session, engine, CLI and server raise
    unless the CPU is named; naming it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = _voice(tmp_path)
    config = TrainingConfig.load_path(d / "config.json")
    params = load_pytree_npz(d / "generator.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchVitsSession(config, params)
    assert TorchVitsSession(config, params, device="cpu").device.type == "cpu"
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_app(["--voices-dir", str(tmp_path)] + device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--voices-dir", str(tmp_path), "--voice", KEY,
                  "--output-dir", str(tmp_path / "out"), "Hello."])


def test_server_runs_with_jax_blocked(tmp_path):
    """The port's server imports and answers with
    ``sys.modules['jax'] = None`` and ``sys.modules['mimic3_tpu'] =
    None``."""
    code = textwrap.dedent(
        f"""
        import io, sys, urllib.request, wave
        sys.modules["jax"] = None
        sys.modules["mimic3_tpu"] = None
        from mimic3_tpu_torch.runtime.testvoice import create_test_voice
        from mimic3_tpu_torch.server.__main__ import create_app
        from test_torch_server_thread import ServerThread

        root = {str(tmp_path)!r}
        create_test_voice(root + "/{KEY}", full_size=False)
        app = create_app(["--voices-dir", root, "--voice", "{KEY}",
                          "--preload-voice", "{KEY}", "--device", "cpu"])
        app.preload()
        srv = ServerThread(app).start()
        req = urllib.request.Request(srv.base_url + "/api/tts",
                                     data=b"Hello world.", method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            with wave.open(io.BytesIO(r.read())) as w:
                assert w.getframerate() == 22050 and w.getnframes() > 0
        srv.stop()
        app.shutdown()
        assert not any(
            m.split(".")[0] in ("jax", "mimic3_tpu") for m in sys.modules
            if sys.modules[m] is not None
        )
        print("ok")
        """
    )
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
