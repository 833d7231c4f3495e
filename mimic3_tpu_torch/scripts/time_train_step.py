"""Time ``mimic3-torch-train``'s step on the card, for one checkout.

    python mimic3_tpu_torch/scripts/time_train_step.py [--checkout DIR] \
        [--steps N]

Runs the trainer of the ``mimic3_tpu_torch`` package found under
``--checkout`` (default: the checkout holding this script) in this
process, as ``chip_smoke.py``'s ``[train]`` phase runs it: the
full-width test voice made from seed 1234, ``chip_smoke.py``'s
32-utterance dataset, batch 16 x the config's 8192-sample segment,
``--log-every 1``.  Prints one JSON line: the step times after the first
(host clock between the trainer's per-step log lines, each written after
a fetch of the step's losses) and their median, the peak memory, whether
every tensor the trainer handed Adam was contiguous, the garbage
collector's passes during those steps and the objects it tracks, and the
card.

Run it by path, not with ``-m``, so that the checkout's package is the one
imported.  To compare two commits, unpack each (``git archive``) into a
directory and run them in turns in one call on one card: A, B, B, A.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--checkout", default=str(REPO),
                        help="directory holding the mimic3_tpu_torch to time")
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args()
    checkout = Path(args.checkout).resolve()
    sys.path.insert(0, str(checkout))
    sys.path.append(str(REPO))  # chip_smoke.py's dataset and step clock

    import numpy as np
    import torch

    import chip_smoke
    from mimic3_tpu_torch import train_cli
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    if not Path(train_cli.__file__).resolve().is_relative_to(checkout):
        raise RuntimeError(f"imported {train_cli.__file__}, not {checkout}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: this timing needs one")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    contiguous = []
    adam = torch.optim.Adam

    class Recording(adam):
        def __init__(self, params, *a, **kw):
            params = list(params)
            contiguous.append(all(p.is_contiguous() for p in params))
            super().__init__(params, *a, **kw)

    torch.optim.Adam = Recording
    clock = chip_smoke.StepClock()
    logger = logging.getLogger("mimic3_tpu_torch.train_cli")
    logger.setLevel(logging.INFO)
    logger.addHandler(clock)
    gc.callbacks.append(clock.gc_callback)
    root = Path(tempfile.mkdtemp(prefix="time_train_step_"))
    try:
        voice = create_test_voice(root / "en_US" / "train_low", seed=1234)
        metadata, wavs = chip_smoke.write_train_dataset(root / "train_data")
        torch.cuda.reset_peak_memory_stats()
        rc = train_cli.main([
            str(voice), "--metadata", str(metadata), "--audio-dir",
            str(wavs), "--batch-size", str(chip_smoke.TRAIN_BATCH),
            "--steps", str(args.steps), "--log-every", "1",
            "--checkpoint-dir", str(root / "ckpt"),
        ])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    step_ms = np.diff(clock.times) * 1000
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({
        "checkout": str(checkout),
        "rc": rc,
        "median_ms": float(np.median(step_ms)),
        "step_ms": [round(float(t), 2) for t in step_ms],
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "adam_leaves_contiguous": contiguous,
        "gc_steps_2_on": clock.collections_after_first_step(),
        "gc_objects": len(gc.get_objects()),
        "card": card,
    }), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
