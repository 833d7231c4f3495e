"""The multi-speaker cell on the CPU at a tiny size: a whole run reads
correct, and runs with the program's speaker path broken underneath (the
speaker ids forced to 0, the decoder's speaker term dropped) read not
correct, so the check sees the speaker path."""

from __future__ import annotations

import json
import typing
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

CELL = "synth_b16_vctk_low_hifigan"
# gin and speakers cut with the widths; rows, ids and calls as tiny's
SPEAKERS = dict(gin_channels=16, n_speakers=7)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reader(directory: Path) -> typing.Callable[[Path], typing.Any]:
    """``tiny.reader`` with the speaker mix and configuration cut too."""
    original = harness.read_json
    cut = tiny.reader(directory)

    def read(path: Path) -> typing.Any:
        d = original(path)
        if path.parent.name == "traffic" and d["driver"] == "synth_speakers":
            d.update(rows=2, phonemes=24, length_scale=2.0, warmup_calls=1,
                     check_calls=2)
            return d
        d = cut(path)
        if path.parent.name == "configs" and d["model"]["n_speakers"] > 1:
            d["model"].update(SPEAKERS)
        return d

    return read


def run(monkeypatch, tmp_path, trace=False):
    monkeypatch.setattr(harness, "read_json", reader(tmp_path))
    return harness.run_cell(CELL, tiny.SEED, 1.0, trace, tiny.DEVICE, 0.0,
                            env={"OMP_NUM_THREADS": "1"})


def expected(kind: str):
    return {m["name"] for m in harness.benchmark()[kind]
            if harness.applies(m, CELL)}


def test_cell_runs_end_to_end(monkeypatch, tmp_path):
    line = run(monkeypatch, tmp_path)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == expected("end_to_end")
    decodes = {k for k in line["signatures"] if k.startswith("decode:")}
    assert len(decodes) == 1, line["signatures"]
    json.dumps(line, allow_nan=False)


def test_traced_run_reads_its_layers(monkeypatch, tmp_path):
    line = run(monkeypatch, tmp_path, trace=True)
    assert line["correct"], line["checks"]
    # off the card no device metric is read
    device = {"synth_mfu", "stage_roofline", "synth_idle_share"}
    assert set(line["metrics"]) == expected("per_layer") - device
    assert 0 <= line["metrics"]["synth_pad_share"]["value"] < 100


def _speakers_to_zero(monkeypatch):
    from mimic3_tpu_torch.runtime.session import TorchVitsSession

    batch = TorchVitsSession.synthesize_ids_batch

    def broken(self, ids, speaker_ids=None, **kwargs):
        return batch(self, ids, speaker_ids=[0] * len(ids), **kwargs)

    monkeypatch.setattr(TorchVitsSession, "synthesize_ids_batch", broken)


def _decoder_cond_dropped(monkeypatch):
    from mimic3_tpu_torch.models.vits import hifigan

    generator = hifigan.hifigan_generator

    def broken(params, x, g=None, **kwargs):
        return generator(params, x, None, **kwargs)

    monkeypatch.setattr(hifigan, "hifigan_generator", broken)


@pytest.mark.parametrize("fault", [_speakers_to_zero, _decoder_cond_dropped])
def test_broken_speaker_path_is_not_correct(monkeypatch, tmp_path, fault):
    fault(monkeypatch)
    line = run(monkeypatch, tmp_path)
    assert not line["correct"], line["checks"]


def test_control_fails_on_the_cpu(tmp_path):
    """The control (``control_speakers``: the reference one precision
    step below the configuration, in the program's place) reads not
    correct."""
    from benchmark import check, control_speakers

    torch.set_num_threads(2)
    numbers = control_speakers.numbers(CELL, tiny.SEED, tiny.DEVICE,
                                       read_json=reader(tmp_path))
    limits = harness.read_json(harness.BENCH_DIR / "cells"
                               / f"{CELL}.json")["limits"]
    assert not check.passes(check.held(dict(numbers, failed=0), limits)), \
        numbers
