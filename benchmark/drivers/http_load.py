"""HTTP serving: the program's server as a subprocess, closed-loop clients.

Traffic parameters: ``wav_clients`` clients sending whole-WAV
``/api/tts`` requests and ``stream_clients`` sending
``streaming=true&streamingMode=low-latency``, each in a closed loop for
the whole window; texts from ``text`` (``textgen``); ``length_scale``,
``noise_scale`` and ``noise_w`` sent with every request; ``warm_set``, a
``--warmup-profile`` file in ``traffic/`` that the server warms;
``settle_requests`` per client before the window; ``check_wav`` and
``check_stream`` finished requests (drawn from the seed, with each
mode's longest) that the reference judges.

The server listens on a free port found by binding port 0, writes its
log and profiles under the run's temporary directory, and is stopped
before the run ends: SIGTERM to its process group, SIGKILL after
``STOP_GRACE_S``.  The weights are drawn on the host, so that the card
holds the server's process alone until it has stopped.

End-to-end: ``serve_p95_ms``, send to last byte over the whole-WAV
requests, and ``first_chunk_p95_ms``, send to the first audio byte past
the WAV header over the streams; a failed request counts as late by
the client's whole timeout.  With a trace, the
server's own ``POST /api/profile`` over the first ``TRACE_SECONDS`` of the
window, and ``/api/stats`` diffed across the same seconds.  The peak
memory is the server process's own (:class:`MemorySampler`).
"""

from __future__ import annotations

import io
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import typing
import urllib.error
import urllib.parse
import urllib.request
import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import check, textgen
from .. import trace as tracing
from ..harness import (BENCH_DIR, ROOT, TRACE_SECONDS, Artifacts, Context,
                       Outcome)
from ..voice import voice_config, write_voice

VOICE = "en_US/bench_low"
HEADER_BYTES = 44
HEALTH_TIMEOUT_S = 900
STOP_GRACE_S = 20
REQUEST_TIMEOUT_S = 120
MEMORY_EVERY_S = 5.0


@dataclass
class Request:
    mode: str  # "wav" or "stream"
    text: str
    sent: float
    first: float = math.nan
    done: float = math.nan
    pcm: typing.Optional[np.ndarray] = None
    error: str = ""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def percentile(values: typing.Sequence[float], pct: float) -> float:
    """Nearest rank."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(pct / 100 * len(ordered)) - 1)]


class Client:
    def __init__(self, base: str, tr: typing.Mapping[str, typing.Any]):
        self.base = base
        self.query = {"voice": VOICE,
                      "lengthScale": repr(float(tr["length_scale"])),
                      "noiseScale": repr(float(tr["noise_scale"])),
                      "noiseW": repr(float(tr["noise_w"]))}

    def get(self, path: str, timeout: float = 30) -> bytes:
        with urllib.request.urlopen(self.base + path, timeout=timeout) as r:
            return r.read()

    def post(self, path: str, timeout: float) -> bytes:
        req = urllib.request.Request(self.base + path, data=b"",
                                     method="POST")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()

    def stats(self) -> typing.Dict[str, typing.Any]:
        return json.loads(self.get("/api/stats"))

    def tts(self, mode: str, text: str) -> Request:
        q = dict(self.query, text=text)
        if mode == "stream":
            q.update(streaming="true", streamingMode="low-latency")
        req = Request(mode, text, time.perf_counter())
        try:
            with urllib.request.urlopen(
                    f"{self.base}/api/tts?{urllib.parse.urlencode(q)}",
                    timeout=REQUEST_TIMEOUT_S) as r:
                if mode == "stream":
                    header = r.read(HEADER_BYTES)
                    first = r.read(1)
                    req.first = time.perf_counter()
                    body = header + first + r.read()
                else:
                    body = r.read()
            req.done = time.perf_counter()
            req.pcm = self._pcm(mode, body)
        except (OSError, urllib.error.URLError, ValueError, wave.Error,
                EOFError) as err:
            req.error = f"{type(err).__name__}: {err}"
        return req

    @staticmethod
    def _pcm(mode: str, body: bytes) -> np.ndarray:
        if mode == "stream":
            if len(body) <= HEADER_BYTES or body[:4] != b"RIFF":
                raise ValueError("no audio after the stream's header")
            return np.frombuffer(body[HEADER_BYTES:], np.int16)
        with wave.open(io.BytesIO(body)) as w:
            if w.getsampwidth() != 2 or w.getnchannels() != 1:
                raise ValueError("not 16-bit mono")
            return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _start_server(ctx: Context, voices: Path, port: int) -> subprocess.Popen:
    tr = ctx.traffic
    log = open(ctx.workdir / "server.log", "wb")
    cmd = [sys.executable, "-m", "mimic3_tpu_torch.server",
           "--host", "127.0.0.1", "--port", str(port),
           "--voices-dir", str(voices), "--preload-voice", VOICE,
           "--no-download", "--device", ctx.device.type,
           "--profile-dir", str(ctx.workdir / "profile"),
           "--warmup", "--warmup-profile",
           str(BENCH_DIR / "traffic" / tr["warm_set"])]
    env = dict(os.environ, PYTHONUNBUFFERED="1", **ctx.env)
    try:
        return subprocess.Popen(cmd, cwd=str(ROOT), stdout=log,
                                stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)
    finally:
        log.close()


def _stop(server: subprocess.Popen) -> None:
    if server.poll() is not None:
        return
    os.killpg(server.pid, signal.SIGTERM)
    try:
        server.wait(STOP_GRACE_S)
    except subprocess.TimeoutExpired:
        os.killpg(server.pid, signal.SIGKILL)
        server.wait()


def _wait_healthy(client: Client, server: subprocess.Popen, log: Path):
    deadline = time.monotonic() + HEALTH_TIMEOUT_S
    while time.monotonic() < deadline:
        if server.poll() is not None:
            raise RuntimeError(f"server exited with {server.returncode}:\n"
                               + log.read_text(errors="replace")[-4000:])
        try:
            client.get("/api/healthcheck", timeout=5)
            return
        except OSError:
            time.sleep(0.5)
    raise TimeoutError("server not healthy in time")


class MemorySampler:
    """The server process's own device memory through the window: every
    ``MEMORY_EVERY_S`` seconds, and once at its close, ``nvidia-smi``'s
    list of compute processes (pid, card UUID, MiB used: the CUDA context
    and all the caching allocator holds).  :meth:`peak` keeps the rows of
    the server's pid; where the card's pids are not the container's, the
    largest process on the card this run uses."""

    def __init__(self):
        self.rows: typing.List[typing.Tuple[int, str, int]] = []
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def _sample(self) -> None:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,gpu_uuid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        for line in out.stdout.strip().splitlines():
            pid, uuid, mib = (f.strip() for f in line.split(","))
            self.rows.append((int(pid), uuid.lower().removeprefix("gpu-"),
                              int(float(mib)) * 2 ** 20))

    def _loop(self) -> None:
        while not self.stop.wait(MEMORY_EVERY_S):
            self._sample()

    def start(self) -> None:
        self.thread.start()

    def close(self) -> None:
        self.stop.set()
        self.thread.join()
        self._sample()

    def peak(self, pid: int, device: torch.device) -> int:
        mine = [b for p, _, b in self.rows if p == pid]
        how = f"the server's pid {pid}"
        if not mine:
            uuid = str(torch.cuda.get_device_properties(device).uuid)
            uuid = uuid.lower().removeprefix("gpu-")
            mine = [b for _, u, b in self.rows if u == uuid]
            how = f"pid {pid} not listed; the largest process on card {uuid}"
        print(f"memory: {len(self.rows)} rows sampled, peak read by {how}",
              file=sys.stderr)
        return max(mine, default=0)


def _load(client: Client, ctx: Context, modes: typing.Sequence[str],
          deadline: float, per_client: int = 0, stream: int = 0
          ) -> typing.List[Request]:
    """Each client in its own thread: requests back to back until the
    deadline (or ``per_client`` of them)."""
    done: typing.List[typing.List[Request]] = [[] for _ in modes]

    def loop(i: int, mode: str) -> None:
        texts = textgen.Cycle(ctx.seed, stream * 1000 + i,
                              ctx.traffic["text"])
        while True:
            done[i].append(client.tts(mode, texts.next()))
            if per_client and len(done[i]) >= per_client:
                return
            if not per_client and time.perf_counter() >= deadline:
                return

    threads = [threading.Thread(target=loop, args=(i, m), daemon=True)
               for i, m in enumerate(modes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r for rs in done for r in rs]


def _diff(before, after) -> typing.Dict[str, float]:
    sb, sa = before["scheduler"], after["scheduler"]
    vb = before["voices"].get(VOICE, {})
    va = after["voices"].get(VOICE, {})
    return {
        "batches": sa["batches"] - sb["batches"],
        "items": sa["items"] - sb["items"],
        "hot_path_compiles": (va.get("hot_path_compiles", 0)
                              - vb.get("hot_path_compiles", 0)),
    }


def run(ctx: Context) -> Outcome:
    tr = ctx.traffic
    model = voice_config(ctx.config)["model"]
    voices = ctx.workdir / "voices"
    write_voice(voices / VOICE, ctx.config, ctx.seed, torch.device("cpu"))
    port = free_port()
    client = Client(f"http://127.0.0.1:{port}", tr)
    modes = ["wav"] * tr["wav_clients"] + ["stream"] * tr["stream_clients"]
    server = _start_server(ctx, voices, port)
    profile = None
    memory = MemorySampler() if ctx.device.type == "cuda" else None
    try:
        _wait_healthy(client, server, ctx.workdir / "server.log")
        _load(client, ctx, modes, 0.0, per_client=tr["settle_requests"],
              stream=1)
        if ctx.trace:
            # the profiler's first start in a process takes seconds (the
            # device tracer's set-up), and the server's loop waits for it
            client.post("/api/profile?seconds=0.5", 600)
        before = client.stats()
        traced = min(TRACE_SECONDS, ctx.seconds)
        during: typing.List[typing.Dict[str, typing.Any]] = []
        if ctx.trace:
            profile = threading.Thread(target=client.post, args=(
                f"/api/profile?seconds={traced}", traced + 600),
                daemon=True)
            profile.start()
            snapshot = threading.Timer(
                traced, lambda: during.append(client.stats()))
            snapshot.start()
        if memory is not None:
            memory.start()
        start = time.perf_counter()
        requests = _load(client, ctx, modes, start + ctx.seconds, stream=2)
        if memory is not None:
            memory.close()
        if profile is not None:
            profile.join()
            snapshot.join()
        after = during[0] if during else client.stats()
    finally:
        _stop(server)
    trace = None
    traces = sorted((ctx.workdir / "profile").glob("*.json"))
    if ctx.trace and traces:
        trace = tracing.load(traces[-1], traced)
    if memory is not None:
        peak = memory.peak(server.pid, ctx.device)
        name = torch.cuda.get_device_name(ctx.device)
    else:
        peak, name = 0, "cpu"

    failed = sum(bool(r.error) for r in requests)
    # a failed request counts as waited for the client's whole timeout
    latency = {m: [((r.first if m == "stream" else r.done) - r.sent) * 1e3
                   if not r.error else REQUEST_TIMEOUT_S * 1e3
                   for r in requests if r.mode == m]
               for m in ("wav", "stream")}
    ok = [r for r in requests if not r.error]
    pick = textgen.rng(ctx.seed, 4)
    answers = []
    for mode, count in (("wav", tr["check_wav"]),
                        ("stream", tr["check_stream"])):
        pool = [r for r in ok if r.mode == mode]
        if not pool:
            continue
        longest = max(range(len(pool)), key=lambda i: len(pool[i].text))
        chosen = {longest, *map(int, pick.choice(
            len(pool), min(count, len(pool)), replace=False))}
        answers += [check.Answer(
            got=pool[i].pcm, text=pool[i].text, seed=0,
            length_scale=tr["length_scale"], noise_scale=tr["noise_scale"],
            noise_w=tr["noise_w"], conversion=mode) for i in sorted(chosen)]
    numbers = check.judge(voices / VOICE, answers, ctx.device)
    return Outcome(
        end_to_end={"serve_p95_ms": percentile(latency["wav"], 95),
                    "first_chunk_p95_ms": percentile(latency["stream"], 95)},
        first_call_at=start,
        artifacts=Artifacts(model=model, window_s=traced, device_name=name,
                            trace=trace, counters=_diff(before, after)),
        numbers={"length_bad": numbers["length_bad"],
                 "wave_err": numbers["wave_err"]},
        attempted=len(requests),
        failed=failed,
        memory_peak_bytes=peak,
    )
