#!/usr/bin/env python3
"""End-to-end HTTP serving load test of the port's server.

Port copy of ``scripts/serve_load_test.py``; the server is ``python -m
mimic3_tpu_torch.server --device D`` and the voice the full-width
``*_low`` test voice of ``python -m mimic3_tpu_torch.runtime.testvoice``
(random weights from seed 1234).  Two-phase by default:

- **Phase 0 (profiling)**: a server with NO warmup takes a small
  representative traffic sample; its /api/stats ``executable_hits``
  table is saved as the traffic profile (closed over the batch-bucket
  ladder, since the scheduler's realized batch sizes vary run to run).
- **Phase 1 (measurement)**: a fresh server starts with ``--warmup
  --warmup-profile``, running ONLY the profiled signatures.  Then the
  SLO phases run: concurrent /api/tts batch throughput + first-chunk
  latency at 1/4/16 streamers, with a zero-hot-path assertion.

PyTorch compiles nothing per shape: the port's "hot-path compile" is a
signature (kind, batch, text and frame bucket) first run after the
warmup (``TorchVitsSession.hot_path_compiles``), and the SLO stays zero.
The ``jit_executables`` snapshot is taken as soon as the server is
healthy, before the settle requests: they absorb the first call's
one-time costs (kernel libraries loaded from ``build/``, cuDNN's
heuristics), but a signature they run first still counts.  On a
violation the run prints the dispatched-but-unprofiled signatures and
exits 1.

``--full-warmup`` restores the single-phase full-grid behavior.  Runs
on the card unless ``--device cpu`` is given; without a card it raises
before starting a server.  The module constants below are the
reference's traffic; a test may patch them to cut the run to the CPU's
size (``VOICE_ARGS``/``VOICE_TPU`` make the voice and its bucket grid).

Usage: python -m mimic3_tpu_torch.scripts.serve_load_test [--full-warmup]
"""

import argparse
import io
import json
import subprocess
import sys
import tempfile
import time
import typing
import urllib.parse
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BATCH_LADDER = (1, 2, 4, 8, 16)

PORT = 59333
BASE = f"http://127.0.0.1:{PORT}"
N_REQUESTS = 48
CONCURRENCY = 16
TEXT = "the quick brown fox jumps over the lazy dog near the river."
VOICE = "en_US/test_low"
# concurrent streamers of the first-chunk latency sweep
STREAMERS = (1, 4, 16)
# extra testvoice arguments, and tpu settings written into the voice's
# config.json (defaults: the full-width voice, its own bucket grid)
VOICE_ARGS: typing.Tuple[str, ...] = ()
VOICE_TPU: typing.Dict[str, typing.Any] = {}


def wait_healthy(
    timeout: float, server: typing.Optional[subprocess.Popen] = None
) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if server is not None and server.poll() is not None:
            raise RuntimeError(
                f"server exited with rc={server.returncode} before it "
                "became healthy (see its log)"
            )
        try:
            with urllib.request.urlopen(
                f"{BASE}/api/healthcheck", timeout=5
            ) as r:
                if r.status == 200:
                    return
        except Exception:
            time.sleep(2)
    raise TimeoutError("server never became healthy")


def one_request(i: int) -> float:
    q = urllib.parse.urlencode({"text": TEXT, "voice": VOICE})
    with urllib.request.urlopen(
        f"{BASE}/api/tts?{q}", timeout=600
    ) as r:
        data = r.read()
    with wave.open(io.BytesIO(data)) as w:
        if w.getframerate() != 22050 or not w.getnframes():
            raise AssertionError(
                f"request {i}: {w.getnframes()} frames at "
                f"{w.getframerate()} Hz"
            )
        return w.getnframes() / w.getframerate()


def one_streaming_request(i: int) -> float:
    """First-chunk latency (seconds) of a low-latency streaming call."""
    q = urllib.parse.urlencode(
        {
            "text": TEXT,
            "voice": VOICE,
            "streaming": "true",
            "streamingMode": "low-latency",
        }
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(
        f"{BASE}/api/tts?{q}", timeout=600
    ) as r:
        first = r.read(1)  # returns on the first streamed byte
        latency = time.perf_counter() - t0
        assert first, "empty streaming response"
        r.read()  # drain
    return latency


def _percentile(values, pct: float) -> float:
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(pct / 100.0 * len(ordered)))
    return ordered[idx]


def first_chunk_latency_sweep() -> dict:
    """p50/p99 first-chunk latency at each count of concurrent
    streamers (``STREAMERS``: 1/4/16)."""
    out = {}
    for conc in STREAMERS:
        n = max(16, conc * 4)
        with ThreadPoolExecutor(max_workers=conc) as pool:
            lats = list(pool.map(one_streaming_request, range(n)))
        out[f"c{conc}"] = {
            "n": n,
            "p50_ms": round(_percentile(lats, 50) * 1000, 1),
            "p99_ms": round(_percentile(lats, 99) * 1000, 1),
        }
        print(f"first-chunk latency @ {conc} clients: {out[f'c{conc}']}",
              flush=True)
    return out


def fetch_stats() -> dict:
    with urllib.request.urlopen(f"{BASE}/api/stats", timeout=30) as r:
        return json.loads(r.read())


def jit_executables() -> int:
    """Distinct signatures the server's sessions have run, warmup
    included (the reference's name for its compiled executables)."""
    return sum(
        v.get("jit_executables", 0)
        for v in fetch_stats()["voices"].values()
    )


def batch_bucket_hits(stats: dict) -> typing.Dict[str, int]:
    """Duration passes dispatched so far per batch bucket (``bN``), from
    the voices' ``executable_hits``: one per batch the session ran."""
    out: typing.Dict[str, int] = {}
    for voice in stats["voices"].values():
        for key, count in voice.get("executable_hits", {}).items():
            kind, bucket = key.split(":")[:2]
            if kind == "duration":
                out[bucket] = out.get(bucket, 0) + count
    return dict(sorted(out.items(), key=lambda kv: int(kv[0][1:])))


def expand_profile(hits: dict) -> dict:
    """Close an observed hit table over the batch-bucket ladder.

    The scheduler's realized batch sizes depend on request arrival
    timing, so a short profiling run may observe e.g. b=5-packed
    batches (bucket 8) but never bucket 2 — which a later run WILL
    hit.  Every observed (kind, text, frames) signature is therefore
    expanded to all batch buckets; text/frame buckets stay exactly as
    observed (they are functions of the traffic's content, not of
    arrival timing).
    """
    keys = set()
    for key in hits:
        parts = key.split(":")  # kind : bN : tN [: fN]
        for b in BATCH_LADDER:
            parts[1] = f"b{b}"
            keys.add(":".join(parts))
    return {k: 1 for k in sorted(keys)}


def start_server(
    voices_root: Path, extra: list, log_name: str, device: str
) -> subprocess.Popen:
    server_log = open(voices_root / log_name, "wb")
    print(f"server log: {voices_root}/{log_name}", flush=True)
    return subprocess.Popen(
        [
            sys.executable, "-m", "mimic3_tpu_torch.server",
            "--port", str(PORT),
            "--voices-dir", str(voices_root),
            "--preload-voice", VOICE,
            "--no-download",
            "--device", device,
            *extra,
        ],
        stdout=server_log,
        stderr=subprocess.STDOUT,
    )


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def make_voice(voice_dir: Path) -> None:
    """The test voice (seed-derived random weights, made on the CPU),
    with ``VOICE_TPU`` written into its config."""
    subprocess.run(
        [
            sys.executable, "-m", "mimic3_tpu_torch.runtime.testvoice",
            str(voice_dir), *VOICE_ARGS,
        ],
        check=True,
        stdout=subprocess.DEVNULL,
    )
    if VOICE_TPU:
        path = voice_dir / "config.json"
        config = json.loads(path.read_text())
        config["tpu"].update(VOICE_TPU)
        path.write_text(json.dumps(config))


def profiling_phase(voices_root: Path, device: str) -> Path:
    """Phase 0: sample the traffic with no warmup; save the profile."""
    server = start_server(voices_root, [], "server_phase0.log", device)
    try:
        t0 = time.perf_counter()
        wait_healthy(timeout=1200, server=server)
        print(
            f"phase0 server up after {time.perf_counter() - t0:.0f}s "
            "(no warmup)",
            flush=True,
        )
        t0 = time.perf_counter()
        # representative sample of both phase-1 workloads
        with ThreadPoolExecutor(max_workers=8) as pool:
            list(pool.map(one_request, range(8)))
        one_streaming_request(-1)
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(one_streaming_request, range(4)))
        hits: dict = {}
        for voice in fetch_stats()["voices"].values():
            for key, count in voice.get(
                "executable_hits", {}
            ).items():
                hits[key] = hits.get(key, 0) + count
        print(
            f"phase0 traffic in {time.perf_counter() - t0:.0f}s; "
            f"{len(hits)} executable signatures observed: "
            f"{sorted(hits)}",
            flush=True,
        )
    finally:
        _graceful_stop(server)
    profile = expand_profile(hits)
    profile_path = voices_root / "traffic_profile.json"
    profile_path.write_text(json.dumps(profile, indent=1))
    print(
        f"profile: {len(profile)} signatures after batch-ladder "
        f"expansion -> {profile_path}",
        flush=True,
    )
    return profile_path


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--full-warmup", action="store_true",
        help="single-phase full-grid warmup (old behavior) instead of "
        "the profiled two-phase run",
    )
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="Device the servers run on (cuda raises without a card)",
    )
    args = parser.parse_args(argv)

    from ..runtime.session import resolve_device

    resolve_device(args.device)  # no card: raise before any server

    voices_root = Path(tempfile.mkdtemp(prefix="serve_load_"))
    make_voice(voices_root / VOICE)

    warmup_args = ["--warmup"]
    if not args.full_warmup:
        profile_path = profiling_phase(voices_root, args.device)
        warmup_args += ["--warmup-profile", str(profile_path)]

    server = start_server(voices_root, warmup_args, "server.log",
                          args.device)
    try:
        # The server binds only AFTER preload+warmup completes
        # (server/__main__.py), so healthy == fully warmed.
        t_start = time.perf_counter()
        print("waiting for warmup...", flush=True)
        wait_healthy(timeout=5400, server=server)
        warmup_wall_s = time.perf_counter() - t_start
        print(f"healthy after {warmup_wall_s:.0f}s", flush=True)
        # snapshot the signatures run: any growth from here on (settle
        # requests included) is a first run on the hot path (SLO: zero)
        executables_before = jit_executables()
        # settle requests: absorb the first call's one-time costs
        one_request(-1)
        one_streaming_request(-1)
        print(
            f"settled after {time.perf_counter() - t_start:.0f}s",
            flush=True,
        )

        hits_before = batch_bucket_hits(fetch_stats())
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CONCURRENCY) as pool:
            audio_secs = list(
                pool.map(one_request, range(N_REQUESTS))
            )
        elapsed = time.perf_counter() - t0
        hits_load = batch_bucket_hits(fetch_stats())
        histogram = {
            b: n - hits_before.get(b, 0) for b, n in hits_load.items()
            if n > hits_before.get(b, 0)
        }

        latency = first_chunk_latency_sweep()
        executables_after = jit_executables()
        stats = fetch_stats()

        hot_path_compiles = executables_after - executables_before
        print(
            json.dumps(
                {
                    "requests": N_REQUESTS,
                    "concurrency": CONCURRENCY,
                    "wall_s": round(elapsed, 2),
                    "audio_sec_total": round(sum(audio_secs), 1),
                    "served_audio_sec_per_sec": round(
                        sum(audio_secs) / elapsed, 1
                    ),
                    "mean_batch_size": stats["scheduler"][
                        "mean_batch_size"
                    ],
                    "batches": stats["scheduler"]["batches"],
                    # batch dispatches of the /api/tts phase per batch
                    # bucket (duration passes, from executable_hits)
                    "batch_bucket_histogram": histogram,
                    "first_chunk_latency": latency,
                    "hot_path_compiles": hot_path_compiles,
                    "warmup_wall_s": round(warmup_wall_s, 1),
                    "warmup_mode": (
                        "full-grid" if args.full_warmup
                        else "profiled"
                    ),
                    # name and power limit (nvidia-smi) of the servers'
                    # card; null on the CPU
                    "card": card_line() if args.device == "cuda" else None,
                }
            ),
            flush=True,
        )
        if hot_path_compiles:
            dispatched = set()
            for voice in stats["voices"].values():
                dispatched.update(voice.get("executable_hits", {}))
            missed = sorted(
                dispatched - set(expand_profile(dispatched))
            ) if args.full_warmup else sorted(
                dispatched
                - set(
                    json.loads(
                        (voices_root / "traffic_profile.json")
                        .read_text()
                    )
                )
            )
            print(
                f"SLO VIOLATION: {hot_path_compiles} signature(s) first "
                f"run on the serving hot path; dispatched-but-unprofiled "
                f"signatures: {missed}",
                flush=True,
            )
            return 1
    finally:
        _graceful_stop(server)
    return 0


def _graceful_stop(server: subprocess.Popen) -> None:
    """Stop the server once no device call is in flight: poll /api/stats
    until ``device.calls_in_flight`` is 0, SIGTERM (which the server
    itself defers while device work runs), and SIGKILL only after a long
    grace period."""
    deadline = time.time() + 1200
    while time.time() < deadline and server.poll() is None:
        try:
            stats = fetch_stats()
            in_flight = stats.get("device", {}).get("calls_in_flight", 0)
            if in_flight == 0:
                break
            print(
                f"drain: {in_flight} device call(s) in flight...",
                flush=True,
            )
        except Exception:
            # server not serving yet (warmup) or already gone; the
            # server-side SIGTERM deferral covers the warmup window
            break
        time.sleep(5)
    server.terminate()
    try:
        server.wait(timeout=120)
        return
    except subprocess.TimeoutExpired:
        pass
    print("server deferring SIGTERM; waiting for device work to drain",
          flush=True)
    try:
        server.wait(timeout=3600)
    except subprocess.TimeoutExpired:
        print("escalating to SIGKILL after 1h grace", flush=True)
        server.kill()
        server.wait(timeout=30)


if __name__ == "__main__":
    raise SystemExit(main())
