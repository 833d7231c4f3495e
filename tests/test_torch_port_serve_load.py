"""The port's two-phase server SLO load test, on the CPU.

``mimic3_tpu_torch/scripts/serve_load_test.py`` against
``scripts/serve_load_test.py`` (imported by path): the profile's
batch-ladder closure and the percentile are the reference's.  Then the
port's script runs both phases against real ``python -m
mimic3_tpu_torch.server --device cpu`` subprocesses, with a ``--tiny``
voice on a cut bucket grid and the traffic cut to the CPU's size: zero
signatures first run on the hot path; and a profile that lacks the
streaming continuation window's signature makes it exit 1 naming it.
"""

import json
import socket
import sys
from pathlib import Path

import numpy as np
import pytest

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))

import serve_load_test as ref  # noqa: E402

from mimic3_tpu_torch.scripts import serve_load_test as port  # noqa: E402

KINDS = ("duration", "decode", "stream_start", "chunk")


def _hits(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    hits = {}
    for _ in range(rng.randint(1, 12)):
        kind = KINDS[rng.randint(len(KINDS))]
        key = (f"{kind}:b{rng.choice([1, 2, 3, 4, 8, 16])}"
               f":t{rng.choice([32, 64, 128])}")
        if kind != "duration":
            key += f":f{rng.choice([128, 160, 256, 512])}"
        hits[key] = int(rng.randint(1, 9))
    return hits


@pytest.mark.parametrize("seed", range(4))
def test_expand_profile_matches_reference(seed):
    hits = _hits(seed)
    assert port.expand_profile(hits) == ref.expand_profile(hits)


@pytest.mark.parametrize("seed", range(4))
def test_percentile_matches_reference(seed):
    values = list(np.random.RandomState(seed).rand(1 + 7 * seed))
    for pct in (0, 50, 90, 99, 100):
        assert port._percentile(values, pct) == ref._percentile(values,
                                                                pct)


@pytest.fixture
def cpu_run(monkeypatch):
    """The script cut to the CPU: a tiny voice on a small bucket grid,
    8 requests at concurrency 4, streamers 1 and 2, a free port; the
    servers run one torch thread each."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    free = sock.getsockname()[1]
    sock.close()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(port, "PORT", free)
    monkeypatch.setattr(port, "BASE", f"http://127.0.0.1:{free}")
    monkeypatch.setattr(port, "N_REQUESTS", 8)
    monkeypatch.setattr(port, "CONCURRENCY", 4)
    monkeypatch.setattr(port, "STREAMERS", (1, 2))
    monkeypatch.setattr(port, "VOICE_ARGS", ("--tiny",))
    monkeypatch.setattr(port, "VOICE_TPU", dict(
        text_buckets=[64, 128], frame_buckets=[128, 256],
        batch_buckets=[1, 2, 4],
    ))
    return monkeypatch


def _result(out: str) -> dict:
    return next(json.loads(line) for line in reversed(out.splitlines())
                if line.startswith("{"))


def test_two_phase_run_has_no_hot_path_signature(cpu_run, capsys):
    assert port.main(["--device", "cpu"]) == 0
    result = _result(capsys.readouterr().out)
    assert result["hot_path_compiles"] == 0
    assert result["warmup_mode"] == "profiled"
    assert result["requests"] == 8 and result["audio_sec_total"] > 0
    assert result["mean_batch_size"] >= 1
    assert set(result["first_chunk_latency"]) == {"c1", "c2"}


def test_missing_profile_signature_exits_1_and_names_it(cpu_run, capsys):
    """Phase 0's profile without the streaming continuation window
    (``chunk:*``, the window no other warmed signature covers)."""
    expand = port.expand_profile
    cpu_run.setattr(port, "expand_profile", lambda hits: {
        k: v for k, v in expand(hits).items() if not k.startswith("chunk:")
    })
    assert port.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert _result(out)["hot_path_compiles"] >= 1
    violation = next(line for line in out.splitlines()
                     if line.startswith("SLO VIOLATION"))
    assert "'chunk:b1:t64:f256'" in violation
