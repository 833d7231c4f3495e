"""Wall time of the batch path on the card, for A/B runs across trees.

Makes the full-width random HiFi-GAN test voice (seed 1234), loads it in
the default mode, warms it, then times
``synthesize_ids_batch`` at batch 1 (one sentence) and batch 4 (four),
alternating the two, each call ending in the host copy of its audio.
``--no-speculation`` turns ``tpu.speculative_decode`` off in the voice's
config; ``--deterministic`` loads the voice in deterministic mode (the f32
decoder).  Prints one JSON line: median, 10th and 90th percentile wall ms
per call for each batch size, the fused-stage kernel launches per call,
and the card's name and power limit.  ``--profile N`` adds, for N more
calls at each batch size under ``torch.profiler``, the host milliseconds
per call in each CUDA runtime call, the number of device operations per
call and their summed device milliseconds per call.

Only the port's public modules are used, so the script also times an
older tree: run it by path with that tree first on ``PYTHONPATH``::

    python mimic3_tpu_torch/scripts/time_synthesis.py --calls 30
    PYTHONPATH=/path/to/other/tree python /this/tree/mimic3_tpu_torch/\\
scripts/time_synthesis.py --calls 30 --label other
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
import typing
from pathlib import Path

import numpy as np
import torch

TEXTS = [
    "A rainbow is a meteorological phenomenon.",
    "It is caused by reflection, refraction and dispersion of light.",
    "The result is a spectrum of light appearing in the sky.",
    "It takes the form of a multicoloured circular arc.",
]


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--calls", type=int, default=30)
    parser.add_argument("--no-speculation", action="store_true")
    parser.add_argument("--deterministic", action="store_true")
    parser.add_argument("--label", default="")
    parser.add_argument("--profile", type=int, default=0)
    args = parser.parse_args(argv)

    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    with tempfile.TemporaryDirectory() as tmp:
        voice_dir = create_test_voice(Path(tmp) / "en_US" / "x_low",
                                      seed=1234)
        if args.no_speculation:
            config_path = voice_dir / "config.json"
            config = json.loads(config_path.read_text())
            config["tpu"]["speculative_decode"] = False
            config_path.write_text(json.dumps(config))
        voice = load_from_directory(voice_dir, share_sessions=False,
                                    deterministic=args.deterministic)
        session = voice.session
        ids = []
        for text in TEXTS:
            seq = []
            for words, _ in voice.text_to_phonemes(text):
                seq.extend(voice.phonemes_to_ids(words))
            ids.append(seq)
        batches = {1: ids[:1], 4: ids}
        for seqs in batches.values():  # warm, and the first observation
            for seed in range(3):
                session.synthesize_ids_batch(seqs, seed=seed)
        walls: typing.Dict[int, typing.List[float]] = {1: [], 4: []}
        launches = stage.launches
        for i in range(args.calls):
            for b, seqs in batches.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                session.synthesize_ids_batch(seqs, seed=100 + i)
                walls[b].append((time.perf_counter() - t0) * 1000)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        result = {
            "label": args.label,
            "speculation": not args.no_speculation,
            "deterministic": args.deterministic,
            "calls": args.calls,
            "stage_launches_per_call": (stage.launches - launches)
            / (2 * args.calls),
            "card": card,
            **{
                f"b{b}_ms": {
                    "p10": float(np.percentile(w, 10)),
                    "median": float(np.median(w)),
                    "p90": float(np.percentile(w, 90)),
                }
                for b, w in walls.items()
            },
            "speculation_counts": dict(getattr(session, "speculation", {})),
        }
        if args.profile:
            result["profile"] = {
                f"b{b}": _profile(session, seqs, args.profile)
                for b, seqs in batches.items()
            }
    print(json.dumps(result), flush=True)
    return result


def _profile(session, seqs, calls: int) -> dict:
    """Host ms per call in the six costliest CUDA runtime calls
    (``cuda*`` events), and device operations (kernels, copies) per call
    and their summed device ms per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        for i in range(calls):
            session.synthesize_ids_batch(seqs, seed=1000 + i)
    runtime = {}
    device_ops = 0
    device_us = 0.0
    for e in prof.key_averages():
        if e.key.startswith("cuda") and e.cpu_time_total > 0:
            runtime[e.key] = round(e.cpu_time_total / 1000.0 / calls, 3)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_ops += e.count
            device_us += e.self_device_time_total
    top = dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:6])
    return {"cuda_runtime_host_ms": top,
            "device_ops_per_call": device_ops / calls,
            "device_ms_per_call": device_us / 1000.0 / calls}


if __name__ == "__main__":
    main()
