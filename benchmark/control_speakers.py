"""The control of ``correct`` for a multi-speaker cell: the reference one
precision step below the configuration, put in the program's place, as
:mod:`.control` does for the single-speaker cells.

For a cell and a seed it writes the multi-speaker voice, takes the
answers a run judges from the cell's own inputs (the first calls of the
synthesis loop, each row with the speaker the driver gives it), computes
them with ``VitsSpeakers(precision="control")`` (TF32 up to the decoder,
float8 e4m3 decoder convolutions), and judges them with the float32
reference, each against its own speaker.  Every number it gives has to
fail its limit.

    python3 -m benchmark.control_speakers --workload <cell> --seed <n> \
        [--seed ...]

prints one JSON line per seed.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import typing
from pathlib import Path

import numpy as np
import torch

from . import check, control, harness
from . import speakers as spk
from .drivers.synth_speakers import speakers_of
from .reference import params as ref_params
from .reference.vits_speakers import VitsSpeakers


def numbers(cell: str, seed: int, device: torch.device,
            read_json=harness.read_json) -> typing.Dict[str, float]:
    """The control's numbers for ``cell`` on ``seed``."""
    w = harness.workload(harness.benchmark(), cell)
    config = read_json(harness.BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = read_json(harness.BENCH_DIR / "traffic"
                        / f"{w['traffic']}.json")
    workdir = Path(tempfile.mkdtemp(prefix="control_"))
    try:
        voice_dir = spk.write_voice(workdir / "voice", config, seed, device)
        model = json.loads((voice_dir / "config.json").read_text())["model"]
        reference = VitsSpeakers(model, ref_params.load(
            voice_dir / "generator.npz", device), device, "control")
        rows = traffic["rows"]
        # the synthesis loop's calls, a row after another
        inputs = control._inputs(cell, config,
                                 dict(traffic, driver="synth_batch"), seed)
        answers = []
        for i, a in enumerate(inputs):
            speaker = speakers_of(a.seed, rows, model["n_speakers"])[i % rows]
            bound = reference.with_speaker(speaker)
            wf, m_p, logs_p = bound.durations(a.ids, a.seed, a.length_scale,
                                              a.noise_w)
            audio = bound.decode(m_p, logs_p, np.ceil(wf).astype(int),
                                 a.seed, a.noise_scale, check.PAD_FRAMES)
            answers.append(spk.Answer(
                got=audio, ids=a.ids, seed=a.seed, speaker=speaker,
                length_scale=a.length_scale, noise_scale=a.noise_scale,
                noise_w=a.noise_w))
        del reference
        return spk.judge(voice_dir, answers, device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True)
    args = parser.parse_args(argv)
    device = torch.device("cuda")
    for seed in args.seed:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **numbers(args.workload, seed, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
