"""The control of ``correct``: the reference one precision step below the
configuration, put in the program's place.

For a cell and a seed it makes the voice and as many answers as a run
judges, from the cell's own inputs (the first calls of a synthesis
loop, or the first texts of each HTTP client), computes them with
``Vits(precision="control")`` (TF32 up to the decoder, float8 e4m3
decoder convolutions), and judges them with the float32 reference as a
run judges the program's.  Every number it gives has to fail its limit.

    python3 -m benchmark.control --workload <cell> --seed <n> [--seed ...]

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

from . import check, harness, textgen
from .reference import params as ref_params
from .reference import text as ref_text
from .reference.vits import Vits
from .voice import write_voice


def _inputs(cell, config, traffic, seed: int) -> typing.List[check.Answer]:
    """The cell's answers to judge, without ``got``."""
    tr = traffic
    common = dict(length_scale=tr["length_scale"],
                  noise_scale=tr["noise_scale"], noise_w=tr["noise_w"])
    if tr["driver"] == "synth_batch":
        from .drivers.synth_batch import calls

        ctx = harness.Context(cell, config, tr, seed, 0, False, None, 0.0,
                              Path("."))
        inputs = calls(ctx, 2, len(config["symbols"]))
        out = []
        for _ in range(tr["check_calls"]):
            ids, call_seed = next(inputs)
            out += [check.Answer(got=None, ids=row, seed=call_seed, **common)
                    for row in ids]
        return out
    out = []
    for mode, clients, count in (
            ("wav", range(tr["wav_clients"]), tr["check_wav"]),
            ("stream", range(tr["wav_clients"],
                             tr["wav_clients"] + tr["stream_clients"]),
             tr["check_stream"])):
        cycles = [textgen.Cycle(seed, 2000 + i, tr["text"]) for i in clients]
        for k in range(count):
            out.append(check.Answer(got=None,
                                    text=cycles[k % len(cycles)].next(),
                                    conversion=mode, **common))
    return out


def numbers(cell: str, seed: int, device: torch.device,
            read_json=harness.read_json) -> typing.Dict[str, float]:
    """The control's numbers for ``cell`` on ``seed``."""
    bench = harness.benchmark()
    w = harness.workload(bench, cell)
    config = read_json(harness.BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = read_json(harness.BENCH_DIR / "traffic"
                        / f"{w['traffic']}.json")
    workdir = Path(tempfile.mkdtemp(prefix="control_"))
    try:
        voice_dir = write_voice(workdir / "voice", config, seed, device)
        vc = json.loads((voice_dir / "config.json").read_text())
        control = Vits(vc["model"], ref_params.load(
            voice_dir / "generator.npz", device), device, "control")
        table = ref_text.load_table(voice_dir / "phonemes.txt")
        answers = _inputs(cell, config, traffic, seed)
        for a in answers:
            ids = a.ids if a.ids is not None else ref_text.text_to_ids(
                a.text, table, vc["phonemes"])
            wf, m_p, logs_p = control.durations(ids, a.seed, a.length_scale,
                                                a.noise_w)
            audio = control.decode(m_p, logs_p, np.ceil(wf).astype(int),
                                   a.seed, a.noise_scale, check.PAD_FRAMES)
            a.got = (audio if a.conversion == "float"
                     else check.to_int16(audio, a.conversion))
        del control
        return check.judge(voice_dir, answers, device)
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
