"""The port's bench (``mimic3_tpu_torch/scripts/bench.py``) on the CPU, at
a tiny config (hidden 16, one encoder layer, upsample 64: the bench's
``MODEL_OVERRIDES``).

- Its timed synthesis against the JAX model: the bench's seeded weights
  and ids through ``mimic3_tpu``'s ``VitsModel.infer_durations`` +
  ``decode_frames`` (stage kernel off, bf16 decoder, as the bench's) and
  through the bench's :func:`synthesize`, deterministic noise: equal
  sample lengths, equal capped audio-seconds, correlation >= 0.999.
- Its FLOP count: the same with the stage gate at 64 and 0, and the
  decoder's part equal, exactly, to the closed-form sum over the
  generator's convolutions (``2 B T_out C_in C_out K / groups``) and
  transposed convolutions (``2 B T_in C_in C_out K``: each input sample
  meets all K taps).
- ``main`` on ``--device cpu``: one JSON line, every device field null,
  ``correct`` true, exit 0.
- The error paths: a failure inside a point, ``--device cuda`` with no
  card, a card that is not an H100 SXM, and the watchdog each print the
  error line and exit 2; none falls back.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic3_tpu.config import ModelConfig as RefConfig
from mimic3_tpu.models.vits import VitsModel as RefModel
from mimic3_tpu_torch.scripts import bench

REPO = Path(__file__).resolve().parents[1]
TINY = dict(hidden_channels=16, inter_channels=16, filter_channels=32,
            n_layers=1, upsample_initial_channel=64)
SHAPE = ["--batch", "2", "--phonemes", "8", "--frames", "32"]
# every field of a point that only a card can give
DEVICE_FIELDS = ("decode_ms_device", "device_time_throughput", "idle_share",
                 "mfu_vs_bf16_peak", "mfu_device_vs_bf16_peak")


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """The bench's model cut to the CPU's size, on one torch thread (a
    parallel test run has a process per core)."""
    monkeypatch.setattr(bench, "MODEL_OVERRIDES", TINY)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _point(decoder="hifigan", multispeaker=False, batch=2, phonemes=8,
           frames=32, gate=64):
    config = bench.model_config(decoder, multispeaker)
    params = bench.load_params(config, torch.device("cpu"))
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 130, (batch, phonemes))
    sid = rng.randint(0, config.n_speakers, (batch,)) if multispeaker else None
    return bench.make_point(config, params, ids, sid, frames, gate), ids, sid


@pytest.mark.parametrize("decoder,multispeaker", [
    ("hifigan", False), ("hifigan", True), ("mb-istft", False),
])
def test_bench_synthesis_matches_jax_model(decoder, multispeaker):
    point, ids, sid = _point(decoder, multispeaker)
    config = point.config
    ref = RefModel(RefConfig(**{
        f: getattr(config, f) for f in config.__dataclass_fields__
    }), decoder_dtype=jnp.bfloat16, pallas_stage_max_channels=0)
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(np.asarray(t)),
        bench.init_params(0, config),
    )
    ids_j = jnp.asarray(ids, jnp.int32)
    lengths_j = jnp.full((len(ids),), ids.shape[1], jnp.int32)
    sid_j = None if sid is None else jnp.asarray(sid, jnp.int32)
    key = jax.random.PRNGKey(0)
    durations, _ = ref.infer_durations(
        params, ids_j, lengths_j, key, point.length_scale, 0.0, sid=sid_j
    )
    want, want_len = ref.decode_frames(
        params, ids_j, lengths_j, durations, point.frames, key, 0.0,
        sid=sid_j,
    )
    got, got_len = bench.synthesize(point, 0, noise_scale=0.0, noise_w=0.0)
    got, got_len = got.numpy(), got_len.numpy()
    want, want_len = np.asarray(want), np.asarray(want_len)
    np.testing.assert_array_equal(got_len, want_len)
    cap = point.max_samples
    assert (np.minimum(got_len, cap).sum() / bench.SAMPLE_RATE
            == np.minimum(want_len, cap).sum() / bench.SAMPLE_RATE)
    valid = [slice(0, n) for n in np.minimum(got_len, cap)]
    a = np.concatenate([got[i, s] for i, s in enumerate(valid)])
    b = np.concatenate([want[i, s] for i, s in enumerate(valid)])
    assert np.isfinite(a).all()
    assert np.corrcoef(a, b)[0, 1] >= 0.999


def _closed_form_decoder_flops(config, batch, frames) -> int:
    """FLOPs of the HiFi-GAN generator's convolutions at ``frames``
    latent frames: conv_pre, the speaker conv (``cond``, on the speaker
    vector, added to every frame), per stage the upsampler and 3
    ResBlock1s of 2 convs per dilation, conv_post."""
    c = config.upsample_initial_channel
    t = frames
    flops = 2 * batch * t * config.inter_channels * c * 7
    if config.gin_channels:  # on the speaker vector: one frame
        flops += 2 * batch * 1 * config.gin_channels * c * 1
    for rate, k_up in zip(config.upsample_rates,
                          config.upsample_kernel_sizes):
        flops += 2 * batch * t * c * (c // 2) * k_up  # transposed: T_in
        c, t = c // 2, t * rate
        for k, dilations in zip(config.resblock_kernel_sizes,
                                config.resblock_dilation_sizes):
            flops += len(dilations) * 2 * (2 * batch * t * c * c * k)
    return flops + 2 * batch * t * c * 1 * 7


@pytest.mark.parametrize("multispeaker", [False, True],
                         ids=["single", "multi"])
def test_flop_count_is_the_closed_form_whatever_the_gate(multispeaker):
    kernel, _, _ = _point(multispeaker=multispeaker, gate=64)
    flops = bench.count_flops(kernel)
    assert flops == bench.count_flops(bench.with_model(kernel, 0))
    assert flops["decoder"] == _closed_form_decoder_flops(
        kernel.config, kernel.batch, kernel.frames)
    # the encoder, duration predictor and flow add their matmuls and convs
    assert flops["total"] > flops["decoder"] > 0


def _run(capsys, argv):
    rc = bench.main([*argv, "--watchdog-sec", "0"])
    lines = capsys.readouterr().out.splitlines()
    return rc, lines


def test_cpu_run_prints_one_line_with_device_fields_null(capsys):
    rc, lines = _run(capsys, [*SHAPE, "--iters", "2", "--warmup", "1",
                              "--device", "cpu"])
    assert rc == 0
    assert len(lines) == 1
    result = json.loads(lines[0])
    extra = result["extra"]
    assert result["unit"] == "audio-sec/sec/chip"
    assert result["vs_baseline"] is None
    assert result["value"] == extra["per_call_throughput"] > 0
    assert extra["correct"] is True
    assert set(extra["checks"]) == {"headline", "batch32",
                                    "throughput_mode", "single_stream"}
    assert all(c["correct"] for c in extra["checks"].values())
    for point in (extra, extra["batch32"], extra["throughput_mode"],
                  extra["single_stream"]):
        assert all(point[f] is None for f in DEVICE_FIELDS), point
        assert point["device_loop_throughput"] is None
        assert point["flops_per_pipeline"] > point["flops_decoder"] > 0
        assert point["wall_ms"]["n"] == point["iters"]
    assert extra["card"] is None and extra["peak_bf16_tflops"] is None
    ab = extra["stage_kernel_ab"]
    assert (ab["kernel"]["stage_max_channels"],
            ab["plain"]["stage_max_channels"]) == (64, 0)
    for side in ("kernel", "plain"):
        # CPU tensors take the plain version: no launch, no device time
        assert ab[side]["device_ms"] is None
        assert ab[side]["stage_launches_per_call"] == 0
        assert ab[side]["wall_ms"]["n"] == 2 * bench.AB_ROUNDS * bench.AB_CALLS
    assert extra["single_stream"]["iters"] == bench.SINGLE_STREAM_CALLS
    assert extra["p50_latency_ms"] == extra["single_stream"]["wall_ms"][
        "median"]
    # bench.py's valid-sample cap: at most frames x hop per row and call
    cap = 2 * 32 * 256 / bench.SAMPLE_RATE
    assert 0 < extra["audio_sec"] <= 2 * cap


def test_throughput_preset_runs_mb_istft_at_batch_32(capsys):
    rc, lines = _run(capsys, ["--throughput", "--phonemes", "8", "--frames",
                              "32", "--iters", "1", "--warmup", "0",
                              "--no-single-stream", "--device", "cpu"])
    assert rc == 0
    result = json.loads(lines[-1])
    assert "mb-istft decoder" in result["metric"]
    assert result["extra"]["batch"] == 32
    # no fused stage in MB-iSTFT: no A/B, and no second throughput point
    assert result["extra"]["stage_kernel_ab"] is None
    assert "throughput_mode" not in result["extra"]
    assert "batch32" not in result["extra"]


def _assert_error_line(rc, lines, text):
    assert rc == 2
    error = json.loads(lines[-1])
    assert error["value"] is None and error["unit"] == "audio-sec/sec/chip"
    assert text in error["extra"]["error"]


def test_failure_inside_a_point_prints_the_error_line(capsys, monkeypatch):
    def broken(point, seed):
        raise RuntimeError("injected failure")

    monkeypatch.setattr(bench, "timed_call", broken)
    rc, lines = _run(capsys, [*SHAPE, "--device", "cpu"])
    _assert_error_line(rc, lines, "RuntimeError: injected failure")
    assert len(lines) == 1


def test_incorrect_outputs_fail_the_run(capsys, monkeypatch):
    real = bench.synthesize

    def noisy(point, seed, noise_scale=bench.NOISE_SCALE,
              noise_w=bench.NOISE_W):
        audio, lengths = real(point, seed, noise_scale, noise_w)
        if point.model.decoder_dtype == torch.bfloat16:
            audio = torch.randn_like(audio)  # the path under test goes bad
        return audio, lengths

    monkeypatch.setattr(bench, "synthesize", noisy)
    rc, lines = _run(capsys, [*SHAPE, "--iters", "1", "--warmup", "0",
                              "--no-batch32", "--device", "cpu"])
    _assert_error_line(rc, lines, "outputs incorrect")
    extra = json.loads(lines[-1])["extra"]
    # the measurements stand beside the error; the failed checks are named
    assert extra["correct"] is False
    assert not extra["checks"]["headline"]["correct"]
    assert extra["checks"]["throughput_mode"]["correct"] is False
    assert '"headline"' in extra["error"]


def test_cuda_without_a_card_prints_the_error_line(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, lines = _run(capsys, [*SHAPE])
    _assert_error_line(rc, lines, "no CUDA device is visible")


@pytest.mark.parametrize("name", [
    "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA H100 NVL", "cpu",
])
def test_mfu_is_stated_against_the_h100_sxm_peak_only(name):
    assert bench.bf16_peak("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(RuntimeError, match="no published bf16 peak"):
        bench.bf16_peak(name)


def test_watchdog_prints_the_error_line_and_exits_2():
    """The full-size bench on the CPU cannot finish in 3 s."""
    out = subprocess.run(
        [sys.executable, "-m", "mimic3_tpu_torch.scripts.bench",
         "--device", "cpu", "--watchdog-sec", "3"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
    )
    _assert_error_line(out.returncode, out.stdout.splitlines(),
                       "watchdog: the bench was not done in 3 s")
    assert "Thread" in out.stderr  # every thread's stack


def test_model_config_is_bench_py_s():
    bench_cfg = {"num_symbols": 130, "decoder_type": "hifigan"}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "MODEL_OVERRIDES", {})
        full = bench.model_config()
        multi = bench.model_config("mb-istft", multispeaker=True)
    assert {k: getattr(full, k) for k in bench_cfg} == bench_cfg
    assert (full.hidden_channels, full.upsample_initial_channel,
            full.n_speakers) == (192, 512, 1)
    assert (multi.n_speakers, multi.gin_channels, multi.decoder_type) == (
        109, 256, "mb-istft")
    assert math.prod(full.upsample_rates) == 256
