"""Rehearsals of whole runs on the CPU at a tiny size, and the runs with
the program broken underneath, which have to come out not correct."""

from __future__ import annotations

import json
import textwrap

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny

SYNTH = ["synth_b16_hifigan_low", "synth_b16_mbistft_low"]
SERVE = "serve_c16_hifigan_low"


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def expected(kind: str, cell: str):
    bench = harness.benchmark()
    return {m["name"] for m in bench[kind] if harness.applies(m, cell)}


def assert_line(line, cell):
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"length_bad", "wave_err", "failed"}
    assert line["device"]["count"] == 1
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", SYNTH + [SERVE])
def test_cell_runs_end_to_end(monkeypatch, tmp_path, cell):
    line = tiny.run(monkeypatch, tmp_path, cell)
    assert_line(line, cell)
    assert set(line["metrics"]) == expected("end_to_end", cell)
    assert all(m["value"] > 0 for m in line["metrics"].values())
    if cell in SYNTH:  # the whole window's decodes, all in one frame bucket
        decodes = {k for k in line["signatures"] if k.startswith("decode:")}
        assert len(decodes) == 1, line["signatures"]


@pytest.mark.parametrize("cell", [SYNTH[0], SERVE])
def test_traced_run_reads_its_layers(monkeypatch, tmp_path, cell):
    line = tiny.run(monkeypatch, tmp_path, cell, trace=True)
    assert_line(line, cell)
    # off the card no device metric is read: no MFU, roofline or idle
    # share; every other metric of the cell is read in every run
    device = {"synth_mfu", "stage_roofline", "synth_idle_share",
              "serve_idle_share"}
    assert set(line["metrics"]) == expected("per_layer", cell) - device
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _zero_a_segment(monkeypatch):
    """An answer altered where it is produced: every decode's audio loses
    a stretch of its samples."""
    from mimic3_tpu_torch.models.vits.model import VitsModel

    decode = VitsModel.decode_frames

    def broken(self, *args, **kwargs):
        audio, lengths = decode(self, *args, **kwargs)
        n = audio.shape[1]
        audio = audio.clone()
        audio[:, n // 8: n // 4] = 0
        return audio, lengths

    monkeypatch.setattr(VitsModel, "decode_frames", broken)


def _half_the_batch(monkeypatch):
    """Half of the batch left out: the first half of the rows computed,
    their answers given for the rest."""
    from mimic3_tpu_torch.runtime.session import TorchVitsSession

    batch = TorchVitsSession.synthesize_ids_batch

    def broken(self, ids, **kwargs):
        half = max(1, len(ids) // 2)
        out = batch(self, ids[:half], **kwargs)
        return (out * len(ids))[:len(ids)]

    monkeypatch.setattr(TorchVitsSession, "synthesize_ids_batch", broken)


@pytest.mark.parametrize("fault", [_zero_a_segment, _half_the_batch])
def test_broken_synthesis_is_not_correct(monkeypatch, tmp_path, fault):
    fault(monkeypatch)
    line = tiny.run(monkeypatch, tmp_path, "synth_b16_hifigan_low")
    assert not line["correct"], line["checks"]


SITE = """
import os
import sys

sys.path.insert(0, os.getcwd())  # the server runs from the checkout's root

from mimic3_tpu_torch.models.vits.model import VitsModel

_decode = VitsModel.decode_frames


def _broken(self, *args, **kwargs):
    audio, lengths = _decode(self, *args, **kwargs)
    n = audio.shape[1]
    audio = audio.clone()
    audio[:, n // 8: n // 4] = 0
    return audio, lengths


VitsModel.decode_frames = _broken
"""


def test_broken_server_is_not_correct(monkeypatch, tmp_path):
    """The server's process alters its answers (through a
    ``sitecustomize`` on its path): both modes come out not correct."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(textwrap.dedent(SITE))
    line = tiny.run(monkeypatch, tmp_path, SERVE,
                    env={"PYTHONPATH": str(site)})
    assert not line["correct"], line["checks"]
    assert line["checks"]["wave_err"]["value"] > 0.1
