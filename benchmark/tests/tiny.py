"""The benchmark's cells cut to a size the CPU runs in seconds: the
model's widths (hidden 64, two encoder layers, decoder from 128
channels), fewer rows and ids per call, a few HTTP clients and small
buckets.  Only tests use it."""

from __future__ import annotations

import json
import typing
from pathlib import Path

import torch

from benchmark import harness

MODEL = dict(hidden_channels=64, inter_channels=64, filter_channels=128,
             n_layers=2, upsample_initial_channel=128)
TPU = {"text_buckets": [32, 64], "frame_buckets": [128, 256, 512],
       "batch_buckets": [1, 2]}
DEVICE = torch.device("cpu")
# seeds above 2**31, as the benchmark's are
SEED = 2 ** 31 + 12345


def warm_set(directory: Path) -> Path:
    keys = {}
    for t in TPU["text_buckets"]:
        keys[f"duration:b1:t{t}"] = 1
        for f in TPU["frame_buckets"]:
            keys[f"decode:b1:t{t}:f{f}"] = 1
        for w in (160, 256):
            keys[f"chunk:b1:t{t}:f{w}"] = 1
        keys[f"stream_start:b1:t{t}:f160"] = 1
    path = directory / "tiny.warm.json"
    path.write_text(json.dumps({"executable_hits": keys}))
    return path


def reader(directory: Path) -> typing.Callable[[Path], typing.Any]:
    """``harness.read_json`` with every configuration and mix cut."""
    original = harness.read_json
    warm = warm_set(directory)

    def read(path: Path) -> typing.Any:
        d = original(path)
        if path.parent.name == "configs":
            d["model"].update(MODEL)
            d["tpu"] = dict(d.get("tpu", {}), **TPU)
        elif path.parent.name == "traffic" and d["driver"] == "synth_batch":
            d.update(rows=min(d["rows"], 2), phonemes=24, length_scale=2.0,
                     warmup_calls=1, check_calls=2)
        elif path.parent.name == "traffic":
            d.update(wav_clients=2, stream_clients=1, settle_requests=1,
                     check_wav=2, check_stream=1, warm_set=str(warm))
            d["text"].update(median=20, min=10, max=40, pool=16)
        return d

    return read


def run(monkeypatch, tmp_path: Path, cell: str, trace: bool = False,
        seconds: float = 1.0, env=None) -> typing.Dict[str, typing.Any]:
    """One run of ``cell`` at the tiny size on the CPU, through the
    harness (all but its look for a card)."""
    monkeypatch.setattr(harness, "read_json", reader(tmp_path))
    return harness.run_cell(cell, SEED, seconds, trace, DEVICE, 0.0,
                            env={"OMP_NUM_THREADS": "1", **(env or {})})
