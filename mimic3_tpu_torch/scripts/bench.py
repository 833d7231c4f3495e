"""Benchmark: batched synthesis throughput of the port on one card.

Counterpart of the JAX package's ``bench.py``.  Measures audio-seconds
generated per wall-second on the ``*_low`` VITS dimensions (the
architecture of Mimic 3 voices), checks the audio, and prints ONE JSON
line last::

    {"metric": ..., "value": N, "unit": "audio-sec/sec/chip",
     "vs_baseline": null, "extra": {...}}

The workload is ``bench.py``'s: ``ModelConfig(num_symbols=130)`` (with
``--multispeaker`` en_US/vctk_low's 109 speakers and gin 256), random
weights from ``init_params(0, config)`` (throughput depends on the
architecture, not the weight values), ``--batch`` x ``--phonemes`` ids
from ``np.random.RandomState(0)`` at full length, ``length_scale = frames
/ phonemes`` (random weights predict one frame per phoneme, trained voices
about eight: the scale fills the ``--frames`` decode with valid audio),
noise 0.667 / 0.8, the decoder in bf16 with the fused stage kernel at the
session's bf16 gate (``STAGE_MAX_CHANNELS``; ``--no-pallas-stage`` sets
it to 0).

One timed call is ``infer_durations`` then ``decode_frames`` at the fixed
frame count, enqueued whole, ending in a scalar checksum read to the host
(``.item()``), as ``bench.py``'s ``float(checksum)``.  ``value`` is the
per-call throughput of a closed loop of back-to-back calls: audio-seconds
of valid samples (capped at ``frames x hop`` per row) over host
wall-seconds.  ``vs_baseline`` is null: ``BASELINE.md``'s 1000
audio-s/s is a TPU v5e target.

``extra`` holds, for the headline point and for each other point
(``batch32``, ``throughput_mode``, the single stream):

- wall ms per call (median, quartiles, sample count), the warmup calls'
  seconds, and the stage kernel's launches per call;
- ``decode_ms_device``: ``torch.profiler``'s kernel sum per call over a
  few calls; ``device_time_throughput`` (audio-s per device-s) and
  ``idle_share`` (1 - device / median wall);
- ``flops_per_pipeline``: ``torch.utils.flop_counter.FlopCounterMode``
  over one call of the plain path (stage gate 0) at the same shapes, so
  the count is the same work whatever implements the stage (the kernel's
  ctypes launch is invisible to the counter).  It counts convolutions,
  transposed convolutions and matrix products, the tensor-core work, and
  no elementwise op and no STFT.  ``flops_decoder`` is the decoder's
  part.  ``mfu_vs_bf16_peak`` is that count over the median wall-s per
  call over the H100 SXM's published dense bf16 rate: the share of the
  whole call.  ``mfu_device_vs_bf16_peak`` is the same over device time.
  On a card whose name is not an H100 SXM's the run fails: it states no
  share against a guessed peak;
- ``correct``: one call with deterministic noise (``noise_scale=0,
  noise_w=0``) against the same weights and ids through the f32 plain
  decoder: equal sample lengths, finite audio and waveform correlation
  above 0.99 (the bar of the bf16 kernel path against the f32 decoder).
  An incorrect point fails the run: the error line then carries what was
  measured beside the error, and ``value`` is null;
- ``stage_kernel_ab`` (HiFi-GAN): wall and device ms per call with the
  stage gate at the session's bf16 value and at 0, in turns (ABBA), and
  each side's stage launches per call.

The card's name and power limit (``nvidia-smi``), torch's version and
its CUDA's stand beside the numbers.  On ``--device cpu`` (the tests)
every device field (device ms, idle share, both MFU shares, the card) is
null: a CPU number never stands under a device name.

Left out: ``--parallel-precompile`` and the compile-cache fields are XLA
only (PyTorch compiles nothing per shape; the kernels' one build falls in
the first warmup call).  ``device_loop_throughput``, an XLA ``fori_loop``
in ``bench.py``, would be a CUDA-graph replay here; it is null until
serving has one.  ``bench.py`` keeps its headline when the throughput-mode
point fails; here any failure fails the run: the error line (``extra.
error``) is printed last, the traceback goes to stderr, and the exit code
is 2, the watchdog's included.

    python -m mimic3_tpu_torch.scripts.bench [--multispeaker]
        [--throughput] [--no-pallas-stage] [--batch N] [--iters N] ...
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time
import traceback
import typing

import numpy as np
import torch

from ..config import ModelConfig
from ..models.vits.model import VitsModel, init_params
from ..ops import stage
from ..runtime.convert import to_torch_params
from ..runtime.session import STAGE_MAX_CHANNELS, device_work, resolve_device

SAMPLE_RATE = 22050
NOISE_SCALE = 0.667
NOISE_W = 0.8
UNIT = "audio-sec/sec/chip"
# NVIDIA's H100 SXM datasheet: dense bf16 tensor-core rate at 700 W
H100_PEAK_BF16 = 989e12
# the bf16 kernel path against the f32 plain decoder
CORRECT_CORR = 0.99
THROUGHPUT_BATCH = 32
SINGLE_STREAM_CALLS = 10
# calls per torch.profiler window
DEVICE_CALLS = 3
# the stage A/B: rounds of four turns (kernel, plain, plain, kernel) of
# AB_CALLS calls each
AB_ROUNDS = 3
AB_CALLS = 3
# ModelConfig fields laid over the *_low dimensions: none for the bench; a
# test may patch this to cut the model to the CPU's size
MODEL_OVERRIDES: typing.Dict[str, typing.Any] = {}


@dataclasses.dataclass(frozen=True)
class Point:
    """One configuration of the timed call: a model bound to its weights
    on one device, and its inputs."""

    config: ModelConfig
    model: VitsModel
    params: dict
    stage_weights: dict
    ids: torch.Tensor
    lengths: torch.Tensor
    sid: typing.Optional[torch.Tensor]
    frames: int
    length_scale: float

    @property
    def batch(self) -> int:
        return self.ids.shape[0]

    @property
    def max_samples(self) -> int:
        """Valid samples per row are capped at the decode's capacity."""
        return self.frames * self.model.hp.hop_length


def model_config(decoder: str = "hifigan",
                 multispeaker: bool = False) -> ModelConfig:
    """``bench.py``'s configurations: the ``*_low`` dimensions, with
    ``multispeaker`` en_US/vctk_low's (109 speakers, gin 256)."""
    fields: typing.Dict[str, typing.Any] = dict(
        num_symbols=130, decoder_type=decoder
    )
    if multispeaker:
        fields.update(n_speakers=109, gin_channels=256)
    return ModelConfig(**{**fields, **MODEL_OVERRIDES})


def load_params(config: ModelConfig, device: torch.device) -> dict:
    """The seeded random weights on ``device``, weight norm folded."""
    return to_torch_params(init_params(0, config), device)


def make_point(
    config: ModelConfig,
    params: dict,
    ids: np.ndarray,
    sid: typing.Optional[np.ndarray],
    frames: int,
    stage_max_channels: int,
    decoder_dtype: torch.dtype = torch.bfloat16,
) -> Point:
    """A point over ``ids`` [B, P] at full length, its stage weights
    packed once as the session packs them."""
    device = next(iter(params["dec"]["conv_pre"].values())).device
    model = VitsModel(config, decoder_dtype=decoder_dtype,
                      stage_max_channels=stage_max_channels)
    batch, phonemes = ids.shape
    return Point(
        config=config,
        model=model,
        params=params,
        stage_weights=model.pack_decoder(params["dec"], device),
        ids=torch.from_numpy(ids.astype(np.int32)).to(device),
        lengths=torch.full((batch,), phonemes, dtype=torch.int32,
                           device=device),
        sid=(None if sid is None
             else torch.from_numpy(sid.astype(np.int32)).to(device)),
        frames=frames,
        length_scale=float(frames) / phonemes,
    )


def with_model(point: Point, stage_max_channels: int,
               decoder_dtype: torch.dtype = torch.bfloat16) -> Point:
    """The same weights and inputs under another stage gate or decoder
    dtype."""
    model = VitsModel(point.config, decoder_dtype=decoder_dtype,
                      stage_max_channels=stage_max_channels)
    return dataclasses.replace(
        point, model=model,
        stage_weights=model.pack_decoder(point.params["dec"],
                                         point.ids.device),
    )


def first_rows(point: Point, n: int) -> Point:
    return dataclasses.replace(
        point, ids=point.ids[:n], lengths=point.lengths[:n],
        sid=None if point.sid is None else point.sid[:n],
    )


def synthesize(
    point: Point, seed: int, noise_scale: float = NOISE_SCALE,
    noise_w: float = NOISE_W,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """One pipeline call, enqueued whole: the durations, then the decode at
    the point's frame count.  Returns device tensors (audio [B, frames x
    hop] float32, sample lengths [B])."""
    model, params = point.model, point.params
    with device_work():
        durations, _ = model.infer_durations(
            params, point.ids, point.lengths, seed, point.length_scale,
            noise_w, sid=point.sid,
        )
        return model.decode_frames(
            params, point.ids, point.lengths, durations, point.frames, seed,
            noise_scale, sid=point.sid, stage_weights=point.stage_weights,
        )


def timed_call(point: Point, seed: int) -> float:
    """One timed call: :func:`synthesize`, then one host read of a
    checksum and the valid sample count, which waits for the decode.
    Returns the call's valid audio-seconds."""
    audio, lengths = synthesize(point, seed)
    _, samples = torch.stack((
        audio[:, ::4096].double().sum(),
        lengths.clamp(max=point.max_samples).sum().double(),
    )).tolist()
    return samples / SAMPLE_RATE


def time_calls(
    point: Point, calls: int, seed: int
) -> typing.Tuple[typing.List[float], float]:
    """Wall seconds of each of ``calls`` back-to-back timed calls, and
    their audio-seconds in all."""
    walls, audio = [], 0.0
    for i in range(calls):
        t0 = time.perf_counter()
        audio += timed_call(point, seed + i)
        walls.append(time.perf_counter() - t0)
    return walls, audio


def device_ms_per_call(point: Point, calls: int = DEVICE_CALLS,
                       seed: int = 5000) -> typing.Optional[float]:
    """Kernel time on the card per timed call: the sum of the device times
    ``torch.profiler`` records over ``calls`` calls (one stream, so few
    overlap).  None off the card."""
    if point.ids.device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            timed_call(point, seed + i)
    return sum(e.self_device_time_total for e in prof.key_averages()) / (
        1000.0 * calls
    )


def count_flops(point: Point) -> typing.Dict[str, int]:
    """FLOPs of one call as ``FlopCounterMode`` counts them (convolutions,
    transposed convolutions, matrix products), on the plain path at the
    point's shapes and decoder dtype: the whole call, and the decoder's
    part (the decoder alone on a latent of the call's shape)."""
    from torch.utils.flop_counter import FlopCounterMode

    plain = with_model(point, 0, point.model.decoder_dtype)
    with FlopCounterMode(display=False) as whole:
        synthesize(plain, 0)
    z = torch.zeros(point.batch, plain.model.hp.inter_channels, point.frames,
                    device=point.ids.device)
    with device_work(), FlopCounterMode(display=False) as decoder:
        plain.model.decode_waveform(
            plain.params["dec"], z,
            g=plain.model.speaker_embedding(plain.params, plain.sid),
        )
    return {"total": whole.get_total_flops(),
            "decoder": decoder.get_total_flops()}


def check_outputs(point: Point) -> dict:
    """One call with deterministic noise against the same weights and ids
    through the f32 plain decoder: the sample lengths must be equal, the
    audio finite, and the valid samples must correlate above
    :data:`CORRECT_CORR` (all rows at once; the lowest row's correlation
    is reported beside it)."""
    reference = with_model(point, 0, torch.float32)
    got, got_len = (t.cpu().numpy() for t in synthesize(point, 0, 0.0, 0.0))
    want, want_len = (t.cpu().numpy()
                      for t in synthesize(reference, 0, 0.0, 0.0))
    valid = np.minimum(np.minimum(got_len, want_len), point.max_samples)
    rows = [(got[i, :n].astype(np.float64), want[i, :n].astype(np.float64))
            for i, n in enumerate(valid)]
    corr = _corr(np.concatenate([g for g, _ in rows]),
                 np.concatenate([w for _, w in rows]))
    finite = bool(np.isfinite(got).all())
    lengths_equal = bool(np.array_equal(got_len, want_len))
    return {
        "correct": finite and lengths_equal and corr > CORRECT_CORR,
        "corr_vs_f32_plain": corr,
        "min_row_corr": min(_corr(g, w) for g, w in rows),
        "sample_lengths_equal": lengths_equal,
        "finite": finite,
    }


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def stats(values: typing.Sequence[float]) -> dict:
    """Median, quartiles and sample count."""
    return {
        "median": float(np.median(values)),
        "p25": float(np.percentile(values, 25)),
        "p75": float(np.percentile(values, 75)),
        "n": len(values),
    }


class IncorrectOutputs(RuntimeError):
    """A run whose outputs failed their check, with what it measured."""

    def __init__(self, extra: dict):
        failed = {k: c for k, c in extra["checks"].items()
                  if not c["correct"]}
        super().__init__(f"outputs incorrect: {json.dumps(failed)}")
        self.extra = extra


def measure(point: Point, iters: int, warmup: int,
            peak: typing.Optional[float], seed: int = 1000) -> dict:
    """Everything the bench reports of one point: its output check,
    warmup, ``iters`` timed calls, device time, FLOPs and both MFU shares
    (null without ``peak``, i.e. off the card)."""
    check = check_outputs(point)
    warm, _ = time_calls(point, warmup, 0)
    before = stage.launches
    walls, audio = time_calls(point, iters, seed)
    launches = (stage.launches - before) / iters
    device_ms = device_ms_per_call(point)
    flops = count_flops(point)
    wall_s = float(np.median(walls))
    audio_per_call = audio / iters
    on_card = device_ms is not None and peak is not None
    return {
        "per_call_throughput": audio / sum(walls),
        "wall_ms": stats([w * 1000 for w in walls]),
        "elapsed_sec": sum(walls),
        "audio_sec": audio,
        "iters": iters,
        "warmup_iters_sec": warm,
        "stage_launches_per_call": launches,
        "decode_ms_device": device_ms,
        "device_time_throughput": (
            audio_per_call / (device_ms / 1000) if on_card else None
        ),
        "idle_share": 1 - device_ms / 1000 / wall_s if on_card else None,
        "device_loop_throughput": None,
        "flops_per_pipeline": flops["total"],
        "flops_decoder": flops["decoder"],
        "mfu_vs_bf16_peak": flops["total"] / wall_s / peak if on_card
        else None,
        "mfu_device_vs_bf16_peak": (
            flops["total"] / (device_ms / 1000) / peak if on_card else None
        ),
        "correct": check,
    }


def stage_ab(point: Point, rounds: int = AB_ROUNDS,
             calls: int = AB_CALLS) -> dict:
    """Wall and device ms per call with the stage gate at the session's
    bf16 value (``kernel``) and at 0 (``plain``), in turns: ``rounds``
    rounds of kernel, plain, plain, kernel, each turn ``calls`` timed
    calls and, after the wall turns, one profiled window per turn."""
    sides = {
        "kernel": with_model(point, STAGE_MAX_CHANNELS[torch.bfloat16]),
        "plain": with_model(point, 0),
    }
    order = ("kernel", "plain", "plain", "kernel") * rounds
    walls: typing.Dict[str, typing.List[float]] = {k: [] for k in sides}
    device: typing.Dict[str, typing.List[float]] = {k: [] for k in sides}
    launches = dict.fromkeys(sides, 0)
    for side in sides.values():
        time_calls(side, 1, 0)  # warm: cuDNN's heuristics, the packs
    for turn, name in enumerate(order):
        before = stage.launches
        w, _ = time_calls(sides[name], calls, 3000 + turn * calls)
        launches[name] += stage.launches - before
        walls[name] += [x * 1000 for x in w]
    for name in order:
        ms = device_ms_per_call(sides[name])
        if ms is not None:
            device[name].append(ms)
    out: typing.Dict[str, typing.Any] = {
        "order": "ABBA",
        "rounds": rounds,
        "calls_per_turn": calls,
    }
    for name, side in sides.items():
        out[name] = {
            "stage_max_channels": side.model.stage_max_channels,
            "wall_ms": stats(walls[name]),
            "device_ms": stats(device[name]) if device[name] else None,
            "stage_launches_per_call": launches[name] / len(walls[name]),
        }
    out["kernel_over_plain_wall"] = (
        out["kernel"]["wall_ms"]["median"] / out["plain"]["wall_ms"]["median"]
    )
    out["kernel_over_plain_device"] = (
        out["kernel"]["device_ms"]["median"]
        / out["plain"]["device_ms"]["median"]
        if device["kernel"] else None
    )
    return out


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bf16_peak(device_name: str) -> float:
    """The published dense bf16 rate the MFU shares are stated against:
    the H100 SXM's.  Any other card raises (the PCIe and NVL parts have
    other rates)."""
    if "H100" not in device_name or any(
        part in device_name for part in ("PCIe", "NVL")
    ):
        raise RuntimeError(
            f"no published bf16 peak for {device_name!r}: the MFU shares "
            "are stated against the H100 SXM's 989 TFLOP/s only"
        )
    return H100_PEAK_BF16


def run(args: argparse.Namespace) -> dict:
    """The bench's result line.  Raises on any failure: an output check
    that fails raises :class:`IncorrectOutputs` once every point is
    measured."""
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        torch.zeros(1, device=device)  # the context, before any timing
        device_name = torch.cuda.get_device_name(device)
        peak: typing.Optional[float] = bf16_peak(device_name)
    else:
        device_name, peak = "cpu", None
    device_init_sec = time.perf_counter() - t0
    gate = 0 if args.no_pallas_stage else STAGE_MAX_CHANNELS[torch.bfloat16]
    hifigan = args.decoder == "hifigan"

    t0 = time.perf_counter()
    config = model_config(args.decoder, args.multispeaker)
    params = load_params(config, device)
    params_init_sec = time.perf_counter() - t0

    rng = np.random.RandomState(0)

    def point_at(batch: int, cfg=config, weights=params) -> Point:
        ids = rng.randint(1, 130, (batch, args.phonemes))
        sid = (rng.randint(0, cfg.n_speakers, (batch,))
               if args.multispeaker else None)
        return make_point(cfg, weights, ids, sid, args.frames, gate)

    point = point_at(args.batch)
    head = measure(point, args.iters, args.warmup, peak)
    tag = "" if hifigan else f", {args.decoder} decoder"
    if args.multispeaker:
        tag += ", multispeaker vctk dims"
    extra: typing.Dict[str, typing.Any] = {
        "device": device_name,
        "card": card_line() if on_card else None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "peak_bf16_tflops": None if peak is None else peak / 1e12,
        "peak_source": None if peak is None
        else "NVIDIA H100 SXM datasheet, dense bf16, 700 W",
        "stage_max_channels": gate,
        "batch": args.batch,
        "phonemes": args.phonemes,
        "frames": args.frames,
        **{k: v for k, v in head.items() if k != "correct"},
        "device_loop_throughput_note": (
            "a CUDA-graph replay of the pipeline; not built until serving "
            "captures graphs"
        ),
        "warmup_breakdown": {
            "device_init_sec": device_init_sec,
            "params_init_sec": params_init_sec,
            "warmup_iters_sec": head["warmup_iters_sec"],
        },
    }
    checks = {"headline": head["correct"]}
    extra["stage_kernel_ab"] = stage_ab(point) if hifigan else None

    if args.batch32 and args.batch != 32:
        extra["batch32"] = measure(point_at(32), args.iters, args.warmup,
                                   peak)
        checks["batch32"] = extra["batch32"].pop("correct")

    if hifigan and not args.multispeaker:
        # the throughput-mode recipe point: MB-iSTFT at batch 32
        config_tm = model_config("mb-istft", False)
        tm = measure(
            point_at(THROUGHPUT_BATCH, config_tm,
                     load_params(config_tm, device)),
            args.iters, args.warmup, peak,
        )
        checks["throughput_mode"] = tm.pop("correct")
        extra["throughput_mode"] = {
            "config": "mb-istft decoder, batch 32 (bench --throughput)",
            **tm,
        }

    if args.single_stream:
        one = measure(first_rows(point, 1), SINGLE_STREAM_CALLS, 1, peak)
        checks["single_stream"] = one.pop("correct")
        extra["single_stream_x_realtime_mean"] = one["per_call_throughput"]
        extra["single_stream_x_realtime_p50"] = (
            one["audio_sec"] / one["iters"] / (one["wall_ms"]["median"] / 1000)
        )
        extra["p50_latency_ms"] = one["wall_ms"]["median"]
        extra["single_stream"] = one

    extra["checks"] = checks
    extra["correct"] = all(c["correct"] for c in checks.values())
    if not extra["correct"]:
        raise IncorrectOutputs(extra)
    return {
        "metric": "batched synthesis throughput (VITS *_low, "
        f"batch={args.batch}, {args.phonemes} phonemes{tag})",
        "value": head["per_call_throughput"],
        "unit": UNIT,
        "vs_baseline": None,
        "extra": extra,
    }


def error_line(message: str) -> dict:
    return {
        "metric": "batched synthesis throughput (VITS *_low)",
        "value": None,
        "unit": UNIT,
        "vs_baseline": None,
        "extra": {"error": message},
    }


def start_watchdog(seconds: int) -> typing.Optional[threading.Timer]:
    """After ``seconds``, print the error line and every thread's stack,
    and end the process with code 2."""
    if seconds <= 0:
        return None

    def fire() -> None:
        print(json.dumps(error_line(
            f"watchdog: the bench was not done in {seconds} s")), flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        os._exit(2)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


def parse_args(
    argv: typing.Optional[typing.Sequence[str]] = None,
) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--phonemes", type=int, default=128)
    parser.add_argument("--frames", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument(
        "--single-stream", action=argparse.BooleanOptionalAction,
        default=True, help="Report the single-stream point (batch 1)",
    )
    parser.add_argument(
        "--batch32", action=argparse.BooleanOptionalAction, default=True,
        help="Report a batch-32 point",
    )
    parser.add_argument(
        "--multispeaker", action="store_true",
        help="Sweep speaker ids across the batch (vctk-style config)",
    )
    parser.add_argument(
        "--decoder", choices=("hifigan", "mb-istft"), default="hifigan",
        help="Decoder family",
    )
    parser.add_argument(
        "--no-pallas-stage", action="store_true",
        help="Stage gate 0: every decoder stage on the plain path (the "
        "name is bench.py's)",
    )
    parser.add_argument(
        "--throughput", action="store_true",
        help="Throughput-mode preset: MB-iSTFT decoder at batch 32",
    )
    parser.add_argument(
        "--watchdog-sec", type=int, default=3300,
        help="Print the error line and exit 2 if not done in time (0: off)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (raises without a card) or cpu (the tests)",
    )
    args = parser.parse_args(argv)
    if args.throughput:
        args.batch = THROUGHPUT_BATCH
        args.decoder = "mb-istft"
        args.batch32 = False
    return args


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    args = parse_args(argv)
    timer = start_watchdog(args.watchdog_sec)
    try:
        result = run(args)
    except Exception as err:  # noqa: BLE001 — the last line must parse
        line = error_line(f"{type(err).__name__}: {err}")
        if isinstance(err, IncorrectOutputs):
            # what was measured stands beside the error, never as a value
            line["extra"] = {**err.extra, **line["extra"]}
        print(json.dumps(line), flush=True)
        traceback.print_exc(file=sys.stderr)
        return 2
    finally:
        if timer is not None:
            timer.cancel()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
