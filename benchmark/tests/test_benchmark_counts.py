"""The closed-form FLOP counts against ``FlopCounterMode`` over the
reference's forward, and against the figure of the port's bench
(``mimic3_tpu_torch/scripts/bench.py``: 10.367 TFLOP for a 16 x
128-phoneme HiFi-GAN call at 1024 frames, 97.2% of it the decoder)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import params as ref_params
from benchmark.reference.vits import Vits
from benchmark.tests import tiny
from benchmark.voice import make_params, voice_config

CONFIGS = Path(__file__).parents[1] / "configs"


def model(name, small=True):
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    if small:
        config["model"].update(tiny.MODEL)
    return voice_config(config)["model"]


@pytest.mark.parametrize("name", ["vits_low_hifigan_bf16",
                                  "vits_low_mbistft_bf16"])
def test_closed_form_is_what_the_reference_computes(tmp_path, name):
    m = model(name)
    np.savez(tmp_path / "g.npz", **make_params(m, 3, tiny.DEVICE))
    ref = Vits(m, ref_params.load(tmp_path / "g.npz", tiny.DEVICE),
               tiny.DEVICE)
    ids = list(range(4, 41))
    with FlopCounterMode(display=False) as fc:
        w, m_p, logs_p = ref.durations(ids, 9, 1.5, 0.8)
        d = np.ceil(w).astype(int)
        ref.decode(m_p, logs_p, d, 9, 0.667, pad=0)
    got = fc.get_total_flops()
    want = counts.utterance(m, len(ids), int(d.sum()))["total"]
    # what the closed form counts and the reference computes elementwise
    # (so the counter misses it): the relative values' products, and the
    # inverse DFT that the reference runs as an FFT
    t, f = len(ids), int(d.sum())
    missed = m["n_layers"] * 2 * t * (2 * counts.REL_WINDOW + 1) * m[
        "hidden_channels"]
    if m["decoder_type"] == "mb-istft":
        bins = m["istft_n_fft"] // 2 + 1
        frames16 = f * int(np.prod(m["mb_upsample_rates"]))
        missed += 2 * m["subbands"] * frames16 * 2 * bins * m["istft_n_fft"]
    assert got == want - missed


def test_closed_form_against_the_ports_bench():
    """The bench's count ran the port's plain path at the call's shapes:
    the encoder twice (the duration pass and the decode pass) and
    relative attention over all 2T - 1 offsets.  With those two added
    the closed form gives its 10.367 TFLOP."""
    m = model("vits_low_hifigan_bf16", small=False)
    t, rows = 128, 16
    u = counts.utterance(m, t, 1024)
    full_window = m["n_layers"] * 2 * 2 * t * m["hidden_channels"] * (
        2 * t - 1 - (2 * counts.REL_WINDOW + 1))
    bench = rows * (u["total"] + u["encoder"] + 2 * full_window)
    assert round(bench / 1e12, 3) == 10.367
    assert round(rows * u["decoder"] / bench, 3) == 0.972
    assert 0.974 < u["decoder"] / u["total"] < 0.975


def test_stage_work_matches_the_kernel_table():
    """The last stage at 128 frames, one row: 0.0088 ms at the bf16 peak
    (``PERF.md``'s kernel table), bound by its operations."""
    m = model("vits_low_hifigan_bf16", small=False)
    flops, nbytes = counts.stage_work(m, 3, 1, 128)
    assert round(flops / counts.H100_BF16_FLOPS * 1e3, 4) == 0.0088
    assert flops / counts.H100_BF16_FLOPS > nbytes / counts.H100_HBM_BYTES_PER_S
    assert counts.stage_of_channels(m, 64) == 2


def test_peak_is_known_for_the_h100_sxm_only():
    assert counts.peak_for("NVIDIA H100 80GB HBM3") == 989e12
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(RuntimeError):
            counts.peak_for(name)
