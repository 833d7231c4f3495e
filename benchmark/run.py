"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Without as many CUDA cards as the cell
asks for it exits 3 and prints no result; if JAX or the JAX package is
loaded once the window has closed it exits 4 and prints no result.  The
numbers ``correct`` compared, each beside its limit, are the last lines
on standard error and the ``checks`` key of the result, the last line of
standard output.
"""

import time

T0 = time.perf_counter()  # noqa: E402 — set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder: run as a script, the folder would
# shadow standard modules (``trace``)
sys.path[0] = str(ROOT)
# every cache of the program at a fixed path inside the checkout
CACHE = ROOT / "build" / "benchmark_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark import harness

    cell = harness.workload(harness.benchmark(), args.workload)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda"), T0)
    found = harness.forbidden_modules()
    if found:
        print(f"refused: loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
