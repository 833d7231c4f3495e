"""The control (the reference one precision step below the
configuration, in the program's place) comes out not correct in every
cell: at a tiny size on the CPU, and at the cell's own size on the card
(``-m gpu``)."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, control, harness
from benchmark.tests import tiny

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def fails(cell, numbers):
    limits = harness.read_json(harness.BENCH_DIR / "cells"
                               / f"{cell}.json")["limits"]
    checks = check.held(dict(numbers, failed=0), limits)
    return not check.passes(checks)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(tmp_path, cell):
    torch.set_num_threads(2)
    numbers = control.numbers(cell, tiny.SEED, tiny.DEVICE,
                              read_json=tiny.reader(tmp_path))
    assert fails(cell, numbers), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    numbers = control.numbers(cell, 2 ** 31 + 7, torch.device("cuda"))
    assert fails(cell, numbers), numbers
