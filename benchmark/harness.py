"""One run of one cell, driven by the files that ``BENCHMARK.json`` names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The harness reads ``configs/<config>.json`` (the model, its
source, its symbol table and settings), ``traffic/<traffic>.json`` (the
mix's parameters and the ``driver`` that offers it), and
``cells/<workload>.json`` (the limits of the numbers ``correct``
compares), then imports ``drivers/<driver>.py`` and calls its
``run(ctx)``.  The driver module makes the inputs from the seed, warms the
cell's shapes, measures for ``--seconds``, judges the answers against
the reference and returns an :class:`Outcome`.  With ``--trace 1`` each
per-layer metric of the cell is read by ``metrics/<metric>.py``'s
``read(artifacts)``, which returns a number or None (nothing to read:
the metric is left out of the line).

A later change adds a configuration, a mix or a metric by adding such
files and entries; no file here names one.
"""

from __future__ import annotations

import importlib
import json
import shutil
import sys
import tempfile
import typing
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mimic3_tpu")
# a traced run profiles the first seconds of its window: the per-layer
# metrics need a few seconds of steady load, and a whole window's trace
# would take hundreds of MB and minutes to write and read
TRACE_SECONDS = 5.0


@dataclass
class Artifacts:
    """What the per-layer readers read, all of the traced window (the
    first ``TRACE_SECONDS`` of the measured one)."""

    model: typing.Dict[str, typing.Any]
    window_s: float
    device_name: str
    trace: typing.Any = None  # trace.Trace
    counters: typing.Dict[str, typing.Any] = field(default_factory=dict)
    # (phonemes, frames) of every utterance the window returned
    utterances: typing.List[typing.Tuple[int, int]] = field(
        default_factory=list)


@dataclass
class Outcome:
    end_to_end: typing.Dict[str, float]
    first_call_at: float  # time.perf_counter() at the first timed call
    artifacts: Artifacts
    numbers: typing.Dict[str, float]  # what correct compares
    attempted: int
    failed: int
    memory_peak_bytes: int
    # the signatures the whole window dispatched, where the driver sees them
    signatures: typing.Dict[str, int] = field(default_factory=dict)


@dataclass
class Context:
    name: str
    config: typing.Dict[str, typing.Any]
    traffic: typing.Dict[str, typing.Any]
    seed: int
    seconds: float
    trace: bool
    device: typing.Any  # torch.device
    t0: float
    workdir: Path
    # extra environment for subprocesses a driver module starts (tests)
    env: typing.Dict[str, str] = field(default_factory=dict)


def read_json(path: Path) -> typing.Any:
    return json.loads(path.read_text(encoding="utf-8"))


def benchmark() -> typing.Dict[str, typing.Any]:
    return read_json(ROOT / "BENCHMARK.json")


def workload(bench, name: str) -> typing.Dict[str, typing.Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules() -> typing.List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, env: typing.Optional[typing.Dict[str, str]] = None
             ) -> typing.Dict[str, typing.Any]:
    """The result line of one run (``correct`` false when a compared
    number is over its limit)."""
    from . import check

    bench = benchmark()
    cell = workload(bench, name)
    config = read_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = read_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = read_json(BENCH_DIR / "cells" / f"{name}.json")["limits"]
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    workdir = Path(tempfile.mkdtemp(prefix="bench_"))
    try:
        ctx = Context(name, config, traffic, seed, seconds, trace, device,
                      t0, workdir, dict(env or {}))
        out = driver.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics: typing.Dict[str, typing.Dict[str, typing.Any]] = {}
    if not trace:
        values = dict(out.end_to_end, setup_s=out.first_call_at - t0)
        for m in bench["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if not applies(m, name):
                continue
            reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
            value = reader.read(out.artifacts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info: typing.Dict[str, typing.Any] = {
        "platform": "gpu" if getattr(device, "type", "") == "cuda" else "cpu",
        "kind": out.artifacts.device_name,
        "count": cell["chips"],
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    line: typing.Dict[str, typing.Any] = {}
    tr = out.artifacts.trace
    if trace and tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
    checks = check.held(dict(out.numbers, failed=out.failed), limits)
    line.update(correct=check.passes(checks), attempted=out.attempted,
                failed=out.failed, metrics=metrics, device=device_info)
    if trace and tr is not None:
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    if out.signatures:
        line["signatures"] = out.signatures
    line["checks"] = checks
    return line
