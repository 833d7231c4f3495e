"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernels from this checkout (one nvcc per source,
started together), checks in their SASS that both run on tensor cores
(HMMA/HGMMA) and that every f32 instantiation runs TF32 HMMAs, and holds
each against its plain PyTorch version at the shapes its path gives it,
f32 (three TF32 passes) and bf16 (tensor cores), and at C = 8 (FFMA) in
both, timed in turns with CUDA events; the stage is also swept in both
dtypes over the decoder's fusable stages (the sweep that sets each
dtype's stage gate, held to the session's within a noise band).  Then
drives the port's paths on a full-width ``*_low`` voice with random
weights made from a seed, each with the kernel launch counts set to 0
just before it and read just after:

- the main path: engine -> voice -> session -> VITS -> WAV, in process
  and through the CLI, deterministic (f32 decoder: bitwise-equal WAVs
  from two calls, the f32 stage launches per call) and default (bf16);
- the resblock profiling entry point
  (``python -m mimic3_tpu_torch.scripts.profile_resblock``);
- streaming: ``synthesize_ids_chunked`` and ``stream_start_batch``;
- the HTTP server, in process on a background thread: preload with
  warmup, a WAV, a low-latency stream, a burst of concurrent requests, a
  profile capture, and no signature first run after the warmup;
- a voice that ships only ``generator.onnx``, a real ``torch.onnx.export``
  of the independent torch oracle (``tests/torch_oracle.py``) at the same
  widths: converted on first load, held to the oracle;
- an MB-iSTFT voice (``decoder_type: "mb-istft"``): card against CPU,
  bf16 against f32, no stage launch, timed in turns with HiFi-GAN;
- speculative decode on and off: the same audio, and the host's wait on
  the duration totals against the speculative decode queued behind them;
- training: ``mimic3-torch-train`` on the full-width voice at batch 16
  (step times, memory, busy share, a breakdown), the card against the CPU
  on one step, no kernel launched while training, then the exported
  ``generator.npz`` served on the card;
- data parallel: a session over every visible card, or over two replicas
  of the one card, against the single-device session (the stage kernel
  launched per shard), a dp above the visible cards refused, and
  ``mimic3-torch-train`` in as many ranks under ``torch.distributed.run``
  against the one-process run's first 3 steps, with the ranks'
  parameters compared after them;
- tensor parallel: ``use_tp`` sessions over a dp 1 and a dp 2 mesh of tp
  2 on repeats of the one card (or the visible cards in rows of two)
  against one device, f32 and bf16, a stream's first chunk, the gathers
  and reductions per call, no stage launch (the reference turns the
  kernel off under tp), and the time per call;
- tensor-parallel training: the GAN train step on a dp 1 x tp 2 mesh in
  one process (repeats of the one card, or two cards) from ``[train]``'s
  weights and data, against the same steps on one device: losses,
  parameters, collectives per step, step time and peak memory;
- tp rows across processes: this script's rank worker
  (``--tp-mp-worker``, not for use by hand) under
  ``torch.distributed.run`` over ``make_global_mesh(tp=2)``, two gloo
  ranks on one card or dp 2 x tp 2 over NCCL on four: serving against one
  device, the time in the row's collectives, and train steps against one
  process with the ranks' parameters compared;
- the teacher -> student round trip
  (``python -m mimic3_tpu_torch.scripts.train_roundtrip``) at a cut depth:
  training and export, held-out sentences and a deterministic double-run
  through the CLI (byte-equal across processes), then the student in
  process through the engine, byte-equal to the CLI and launching the f32
  stage kernel;
- the two-phase server SLO load test
  (``python -m mimic3_tpu_torch.scripts.serve_load_test``) at the
  reference's traffic on the full-width voice: no signature first run on
  the hot path, mean batch above 1, first-chunk latency at 1/4/16
  streamers (its launches, in the server's process, are not counted).

    python3 chip_smoke.py

Prints one line per phase, then a JSON line with each kernel's launches,
error, times, bound and tensor-core instruction counts (and its f32
path's times, both f32 bounds and the f32 stage gate), then
``{"ok": true, "device": {...}}`` as the last line.  Exits non-zero,
printing no result, when any phase fails or no card is visible.  Needs no
network, no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import ast
import gc
import hashlib
import io
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import typing
import urllib.parse
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
TEXT = "A rainbow is a meteorological phenomenon."
BATCH_TEXTS = [
    TEXT,
    "It is caused by reflection, refraction and dispersion of light.",
    "The result is a spectrum of light appearing in the sky.",
    "It takes the form of a multicoloured circular arc.",
]
# one long sentence: several streaming windows at about one frame per
# phoneme (the random voice's durations)
STREAM_TEXT = (
    "A rainbow is a meteorological phenomenon that is caused by "
    "reflection, refraction and dispersion of light in water droplets "
    "resulting in a spectrum of light appearing in the sky, and it takes "
    "the form of a multicoloured circular arc"
)
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
# frame buckets of the kernel checks: 128 is the one the random voice's
# sentences decode in (about one frame per phoneme), 256 a longer sentence
FRAME_BUCKETS = (128, 256)
# the server's low-latency streaming grid (mimic3_tpu/server/app.py)
STREAM_GRID = dict(chunk_frames=128, overlap=64, first_chunk_frames=32)
F32_BAR = "2e-4 + 1e-3*|ref|"
# bf16 bars: the correlation of the outputs, and, for a residual step
# (out = x + branch), of the branches out - x, which a dropped bias or
# tap moves far more than it moves the output
BF16_CORR = 0.999
# the stage gate sweep's noise band on kernel/plain: cuDNN's plain time of
# one shape (f32 last stage, 128 frames, B=1) read 2.191 and 1.473 ms in
# two runs on one H100 (1.49x; PERF.md)
GATE_NOISE = 1.5
BF16_BRANCH_CORR = 0.9999
# published H100 SXM peaks (NVIDIA's H100 datasheet): the bound of a
# kernel is the larger of its operations over the peak of their type and
# its bytes over the memory rate.  The f32 kernels run three TF32 passes
# (495 TFLOP/s dense) per f32 product: an f32-equivalent ceiling of 165;
# FFMA (67) stays beside it.
TF32X3 = "tf32x3"
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
              TF32X3: 495e12 / 3}
PEAK_BYTES = 3.35e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def tensor_corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.corrcoef(torch.stack([a.ravel(), b.ravel()]))[0, 1])


def bound(flops: float, nbytes: float, peak) -> tuple:
    """(least ms the card could take, what bounds it) at the peak of
    ``PEAK_FLOPS[peak]``."""
    compute, memory = flops / PEAK_FLOPS[peak], nbytes / PEAK_BYTES
    return max(compute, memory) * 1e3, (
        "operations" if compute >= memory else "bytes"
    )


class Check(typing.NamedTuple):
    """A kernel held against plain: its error and times; the bound of its
    path (bf16 or three TF32 passes on tensor cores, FFMA at C = 8) and,
    in f32, the FFMA bound."""

    err: float
    ms: float
    plain_ms: float
    bound_ms: float
    bound_by: str
    ffma_bound_ms: typing.Optional[float] = None


def checked(name, dtype, work, err, ms, plain_ms,
            tensor_cores=True) -> Check:
    """The bounds of one check, printed as a ``[bound]`` line; a kernel
    off the tensor cores (C = 8, either dtype) is bound by FFMA."""
    if not tensor_cores:
        f_ms, f_by = bound(*work, torch.float32)
        say("bound", f"{name} {str(dtype)[6:]} (FFMA): bound {f_ms:.4f} ms "
            f"({f_by}), kernel at {f_ms / ms:.1%} of it")
        return Check(err, ms, plain_ms, f_ms, f_by, f_ms)
    if dtype != torch.float32:
        b_ms, b_by = bound(*work, dtype)
        say("bound", f"{name} {str(dtype)[6:]}: bound {b_ms:.4f} ms "
            f"({b_by}), kernel at {b_ms / ms:.1%} of it")
        return Check(err, ms, plain_ms, b_ms, b_by)
    b_ms, b_by = bound(*work, TF32X3)
    f_ms, f_by = bound(*work, torch.float32)
    say("bound", f"{name} float32: three-pass TF32 bound {b_ms:.4f} ms "
        f"({b_by}), kernel at {b_ms / ms:.1%} of it; FFMA bound "
        f"{f_ms:.4f} ms ({f_by}), kernel at {f_ms / ms:.1%} of it")
    return Check(err, ms, plain_ms, b_ms, b_by, f_ms)


def stage_work(weights, batch, t_in, t_out, dtype):
    """(FLOPs, bytes) of one stage launch: 2*C*C*K per sample for every
    resblock conv (2*C^2*126 for kernels 3/7/11, 3 dilations), the
    upsampler's 2*Cin*C*K/stride and conv_post's 2*C*K per output sample;
    the input read and the output written once, and the weights."""
    c = weights.channels
    flops = sum(2 * c * c * k for k, _ in weights.convs) * batch * t_out
    if weights.ups_kernel:
        flops += (2 * weights.in_channels * c * weights.ups_kernel
                  / weights.ups_stride * batch * t_out)
    if weights.has_post:
        flops += 2 * c * weights.post_kernel * batch * t_out
    elt = torch.finfo(dtype).bits // 8
    out_bytes = batch * t_out * (4 if weights.has_post else c * elt)
    w_bytes = weights.b.numel() * 4 + (
        weights.fragments.numel() * 4
        if dtype == torch.bfloat16 and weights.fragments is not None
        else weights.w.numel() * 4
    )
    return flops, batch * weights.in_channels * t_in * elt + out_bytes + w_bytes


def resblock_work(c, t, b, k, dtype):
    """(FLOPs, bytes) of one resblock step: 4*C*C*K per sample; x read and
    out written once, and both convs' weights."""
    elt = torch.finfo(dtype).bits // 8
    return 4 * c * c * k * b * t, 2 * b * c * t * elt + 2 * c * c * k * elt


def sass_counts(lib_path: Path) -> dict:
    """Tensor-core instructions per kernel of a built library, from
    ``cuobjdump -sass``: {kernel: {"HMMA": n, "HGMMA": m, "TF32": t}},
    ``t`` the HMMAs on TF32 operands."""
    from mimic3_tpu_torch.ops import build

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
        check=True, timeout=300,
    ).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = pretty_kernel(head.group(1))
            counts[name] = {"HMMA": 0, "HGMMA": 0, "TF32": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
            if re.search(r"\bHMMA\.\S*TF32", line):
                counts[name]["TF32"] += 1
    return counts


def is_f32_kernel(name: str) -> bool:
    """The f32 tensor-core instantiations (``pretty_kernel`` names)."""
    return name.startswith("stage_tf32_kernel<") or (
        name.startswith("subblock_mma_kernel<") and name.endswith(",float>")
    )


def pretty_kernel(mangled: str) -> str:
    """``subblock_mma_kernel<4,float>`` from its mangled name."""
    m = re.search(r"\d+((?:stage|subblock)(?:_mma|_tf32)?_kernel)I(.*?)EEv",
                  mangled)
    if not m:
        return mangled
    args = re.findall(r"Li(\d+)E|(13__nv_bfloat16)|(f)", m.group(2))
    names = [n or ("bf16" if b else "float") for n, b, _ in args]
    return f"{m.group(1)}<{','.join(names)}>"


def compare(name, got, ref, dtype, kernel, plain, iters=20, residual=None):
    """Hold a kernel's output against plain; time both in turns (plain,
    kernel, kernel, plain).  For a residual step, ``residual`` is its
    input x.  Returns (max_abs_err, ms, plain_ms)."""
    got, ref = got.float(), ref.float()
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        if not bool(((got - ref).abs() <= 2e-4 + 1e-3 * ref.abs()).all()):
            raise AssertionError(f"{name}: max abs diff {err} over the bar")
        agree = f"max_abs_err={err:.3g} (bar {F32_BAR})"
    else:
        c = tensor_corr(got, ref)
        if not c > BF16_CORR:
            raise AssertionError(f"{name}: bf16 correlation {c}")
        agree = f"corr={c:.6f} max_abs_err={err:.3g}"
        if residual is not None:
            x = residual.float()
            cb = tensor_corr(got - x, ref - x)
            if not cb > BF16_BRANCH_CORR:
                raise AssertionError(f"{name}: bf16 branch correlation {cb}")
            agree += f" branch_corr={cb:.6f} (bar {BF16_BRANCH_CORR})"
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say("kernel", f"{name} {str(dtype)[6:]}: {agree}; kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


# ---------------------------------------------------------------------------
# phase 3: the stage kernel
# ---------------------------------------------------------------------------


def stage_inputs(rng, c, c_in, post, device):
    """Random stage parameters in the port's layout (+ ups / post)."""
    from mimic3_tpu_torch.runtime.convert import to_torch_params

    tree = {"resblocks": {
        str(r): {
            key: {
                str(j): {
                    "weight": rng.randn(k, c, c).astype(np.float32) * 0.1,
                    "bias": rng.randn(c).astype(np.float32) * 0.1,
                }
                for j in range(3)
            }
            for key in ("convs1", "convs2")
        }
        for r, k in enumerate(KERNELS)
    }}
    if c_in:
        tree["ups"] = {"0": {
            "weight": rng.randn(4, c_in, c).astype(np.float32) * 0.1,
            "bias": rng.randn(c).astype(np.float32) * 0.1,
        }}
    if post:
        tree["conv_post"] = {
            "weight": rng.randn(7, c, 1).astype(np.float32) * 0.1
        }
    port = to_torch_params(tree, device)
    kw = {}
    if c_in:
        kw.update(ups_params=port["ups"]["0"], ups_stride=2, ups_padding=1)
    if post:
        kw["post_params"] = port["conv_post"]
    return [port["resblocks"][str(r)] for r in range(3)], kw


def check_stage(name, rng, c, c_in, post, batch, t, dtype):
    """Kernel against plain (a :class:`Check`)."""
    from mimic3_tpu_torch.ops import stage

    dev = torch.device("cuda")
    rb, kw = stage_inputs(rng, c, c_in, post, dev)
    weights = stage.pack_stage_weights(rb, KERNELS, DILATIONS, device=dev,
                                       dtype=dtype, **kw)
    x = torch.from_numpy(
        rng.randn(batch, c_in or c, t).astype(np.float32)
    ).to(dev, dtype)

    def kernel():
        return stage.hifigan_stage_fused(
            rb, x, KERNELS, DILATIONS, weights=weights, **kw
        )

    def plain():
        return stage.hifigan_stage_plain(rb, x, KERNELS, DILATIONS, **kw)

    out = kernel()
    t_out = out.shape[-1]
    err, ms, plain_ms = compare(f"stage: {name} x={tuple(x.shape)}", out,
                                plain(), dtype, kernel, plain)
    return checked(f"stage: {name}", dtype,
                   stage_work(weights, batch, t, t_out, dtype), err, ms,
                   plain_ms, stage.uses_mma(c, dtype))


# ---------------------------------------------------------------------------
# phase 4: the resblock kernel
# ---------------------------------------------------------------------------


def check_resblock(rng, c, t, b, k, d, dtype, bias=True, iters=20):
    from mimic3_tpu_torch.ops import resblock

    dev = torch.device("cuda")
    scale = 1.0 / np.sqrt(c * k)

    def uniform(*shape):
        return torch.from_numpy(
            rng.uniform(-scale, scale, shape).astype(np.float32)
        ).to(dev)

    w1, w2 = uniform(c, c, k), uniform(c, c, k)
    b1, b2 = (uniform(c), uniform(c)) if bias else (None, None)
    x = torch.from_numpy(rng.randn(b, c, t).astype(np.float32)).to(dev, dtype)
    packed = resblock.pack_subblock_weights(w1, b1, w2, b2, dtype, dev)
    kw = dict(kernel_size=k, dilation=d)

    def kernel():
        return resblock.fused_resblock_subblock(
            x, w1, b1, w2, b2, weights=packed, **kw
        )

    def plain():
        return resblock.resblock_subblock_plain(x, w1, b1, w2, b2, **kw)

    name = (f"resblock: x={tuple(x.shape)} K={k} d={d}"
            + ("" if bias else " no bias"))
    err, ms, plain_ms = compare(name, kernel(), plain(), dtype, kernel,
                                plain, iters, residual=x)
    return checked(name, dtype, resblock_work(c, t, b, k, dtype), err, ms,
                   plain_ms, resblock.uses_mma(c, dtype))


# ---------------------------------------------------------------------------
# helpers of the paths
# ---------------------------------------------------------------------------


def parse_wav(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as f:
        if (f.getframerate(), f.getsampwidth(), f.getnchannels()) != (
            22050, 2, 1,
        ):
            raise AssertionError(f"unexpected WAV format {f.getparams()}")
        audio = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    if audio.size == 0 or not np.any(audio):
        raise AssertionError("empty or silent WAV")
    return audio


def voice_copy(voice: Path, dest: Path, **tpu) -> Path:
    """A voice directory sharing ``voice``'s weights with other ``tpu``
    settings in its config."""
    dest.mkdir(parents=True)
    for name in ("phonemes.txt", "VERSION"):
        shutil.copy(voice / name, dest / name)
    os.symlink(voice / "generator.npz", dest / "generator.npz")
    config = json.loads((voice / "config.json").read_text())
    config["tpu"].update(tpu)
    (dest / "config.json").write_text(json.dumps(config))
    return dest


def make_voices(root: Path):
    """The full-width test voice; a copy whose decoder stages all take
    the plain path (the end-to-end reference); a copy that also decodes
    in f32 (the reference both bf16 paths are held to); and a copy with a
    serving bucket grid cut to what the server phase sends, so its warmup
    runs dozens of signatures rather than hundreds."""
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    voice = create_test_voice(root / "en_US" / "test_low", seed=1234)
    plain = voice_copy(voice, root / "en_US" / "plain_low",
                       pallas_stage_max_channels=0)
    voice_copy(voice, root / "en_US" / "f32_low",
               pallas_stage_max_channels=0, decoder_dtype="float32")
    voice_copy(voice, root / "en_US" / "serve_low",
               text_buckets=[32, 64, 128, 256], frame_buckets=[128, 256, 512],
               batch_buckets=[1, 2, 4])
    return voice, plain


def phoneme_ids(voice, text: str):
    ids = []
    for words, _ in voice.text_to_phonemes(text):
        ids.extend(voice.phonemes_to_ids(words))
    return ids


def corr(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a.astype(np.float64), b.astype(np.float64))[0, 1])


def time_session(session, batches, runs: int):
    """Median wall seconds per call (ends in a host copy) and audio s/s."""
    session.synthesize_ids_batch(batches)  # warm
    walls, audio_sec = [], 0.0
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = session.synthesize_ids_batch(batches)
        walls.append(time.perf_counter() - t0)
        audio_sec = sum(a.size for a in out) / 22050
    wall = float(np.median(walls))
    return wall, audio_sec / wall


def device_ms_per_call(session, batches, calls: int = 3) -> float:
    """Kernel time on the card per ``synthesize_ids_batch`` call: the sum
    of the device times ``torch.profiler`` records over ``calls`` calls
    (overlaps counted twice; one stream, so there are few)."""
    from torch.profiler import ProfilerActivity, profile

    session.synthesize_ids_batch(batches)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            session.synthesize_ids_batch(batches)
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / (
        1000.0 * calls
    )


def http(base, path, data=None, timeout=300):
    req = urllib.request.Request(
        base + path, data=data, method="POST" if data is not None else "GET"
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.status != 200:
            raise AssertionError(f"{path}: HTTP {r.status}")
        return r.read()


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------


def main_path(root, voice_dir, plain_dir, card_line):
    """Engine, batch and CLI (phases 6-8).  Returns (the stage launches,
    the f32 stage launches of one deterministic call)."""
    from mimic3_tpu_torch.engine import Mimic3Settings, Mimic3TextToSpeechSystem
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    stage.launches = 0
    det = Mimic3TextToSpeechSystem(Mimic3Settings(
        voices_directories=[str(root)], use_deterministic_compute=True,
        noise_scale=0.0, noise_w=0.0,
    ))
    det.voice = "en_US/test_low"
    det_wav = parse_wav(det.text_to_wav(TEXT))
    n_det = stage.launches
    # two more calls: the first set the session's frame estimate, so these
    # two take the same decode path; the f32 kernel has no atomics and a
    # fixed summation order, so their WAVs agree bit for bit
    wavs, per_call = [], []
    for _ in range(2):
        before = stage.launches
        wavs.append(det.text_to_wav(TEXT))
        per_call.append(stage.launches - before)
    fused = len(load_from_directory(voice_dir,
                                    deterministic=True).session.stage_weights)
    first = parse_wav(wavs[0]).tobytes() == det_wav.tobytes()
    say("main", f"deterministic (f32 decoder): two more calls "
        f"{'bitwise equal' if wavs[0] == wavs[1] else 'DIFFER'} "
        f"({len(wavs[0])} WAV bytes; the first call "
        f"{'equal' if first else 'not equal'}); f32 stage launches per "
        f"call {per_call}, fused f32 stages at the gate {fused}")
    if wavs[0] != wavs[1]:
        raise AssertionError("two deterministic calls gave different WAVs")
    if per_call != [fused, fused] or fused < 1:
        raise AssertionError("f32 stage launches per call do not match "
                             "the gate")
    default = Mimic3TextToSpeechSystem(
        Mimic3Settings(voices_directories=[str(root)], seed=7)
    )
    default.voice = "en_US/test_low"
    def_wav = parse_wav(default.text_to_wav(TEXT))
    n_default = stage.launches - n_det - sum(per_call)
    voice = load_from_directory(voice_dir)
    batch_ids = [phoneme_ids(voice, t) for t in BATCH_TEXTS]
    before = stage.launches
    batch_out = voice.session.synthesize_ids_batch(batch_ids, seed=7)
    n_batch = stage.launches - before
    launches = stage.launches
    say("main", f"deterministic WAV {det_wav.size} samples "
        f"({n_det} launches), default bf16 WAV {def_wav.size} samples "
        f"({n_default} launches), batch of 4 {[a.size for a in batch_out]}"
        f" ({n_batch} launches)")
    if min(n_det, n_default, n_batch) < 1:
        raise AssertionError("the main path did not launch the stage kernel")
    if not all(a.size and np.isfinite(a).all() for a in batch_out):
        raise AssertionError("batch output empty or not finite")

    # the same utterances with every stage on the plain path
    ref_det = Mimic3TextToSpeechSystem(Mimic3Settings(
        voices_directories=[str(root)], use_deterministic_compute=True,
        noise_scale=0.0, noise_w=0.0,
    ))
    ref_det.voice = "en_US/plain_low"
    ref_wav = parse_wav(ref_det.text_to_wav(TEXT))
    plain_voice = load_from_directory(plain_dir)
    plain_batch = plain_voice.session.synthesize_ids_batch(batch_ids, seed=7)
    # the same noise and durations with an f32 decoder: the reference
    # that both bf16 decoders approximate (the plain bf16 path rounds
    # every op's output; the kernels keep f32 sums inside a stage)
    f32_batch = load_from_directory(
        root / "en_US" / "f32_low"
    ).session.synthesize_ids_batch(batch_ids, seed=7)
    c_det = corr(det_wav, ref_wav)
    c_batch = min(corr(a, b) for a, b in zip(batch_out, plain_batch))
    c_kernel = min(corr(a, b) for a, b in zip(batch_out, f32_batch))
    c_plain = min(corr(a, b) for a, b in zip(plain_batch, f32_batch))
    say("check", f"kernel path vs plain path: deterministic f32 corr "
        f"{c_det:.6f}, bf16 batch min corr {c_batch:.6f}; against the f32 "
        f"decoder: bf16 kernel path {c_kernel:.6f}, bf16 plain path "
        f"{c_plain:.6f}")
    if det_wav.size != ref_wav.size or not c_det >= 0.999:
        raise AssertionError("deterministic audio disagrees with plain")
    if not ([a.size for a in batch_out] == [a.size for a in plain_batch]
            == [a.size for a in f32_batch]):
        raise AssertionError("batch lengths disagree with plain")
    if not (c_kernel > 0.99 and c_kernel >= c_plain):
        raise AssertionError("bf16 batch audio strays from the f32 decoder")

    proc = subprocess.run(
        [sys.executable, "-m", "mimic3_tpu_torch.cli",
         "--voices-dir", str(root), "--voice", "en_US/test_low",
         "--deterministic"],
        input=(TEXT + "\n").encode(), capture_output=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=600,
    )
    if proc.returncode != 0:
        raise AssertionError(f"CLI failed:\n{proc.stderr.decode()[-3000:]}")
    cli_wav = parse_wav(proc.stdout)
    say("cli", f"WAV {cli_wav.size} samples at 22050 Hz, corr with the "
        f"in-process WAV {corr(cli_wav, det_wav):.6f}")
    if cli_wav.size != det_wav.size:
        raise AssertionError("CLI WAV length differs from in-process")

    for label, v in (("kernel", voice), ("plain", plain_voice)):
        for batch in (1, 4):
            wall, rate = time_session(v.session, batch_ids[:batch], 5)
            say("time", f"{label} path, default mode, batch {batch}: "
                f"{wall * 1000:.1f} ms per call, {rate:.1f} audio-s/s "
                f"({card_line})")
    # deterministic mode: the f32 decoder, its last stage on the TF32
    # kernel (kernel path) or on cuDNN (plain path)
    for label, d in (("kernel", voice_dir), ("plain", plain_dir)):
        session = load_from_directory(d, deterministic=True).session
        for batch in (1, 4):
            wall, rate = time_session(session, batch_ids[:batch], 5)
            dev_ms = device_ms_per_call(session, batch_ids[:batch])
            say("time", f"{label} path, deterministic mode (f32 decoder), "
                f"batch {batch}: {wall * 1000:.1f} ms per call, {rate:.1f} "
                f"audio-s/s, device {dev_ms:.2f} ms per call ({card_line})")
    return launches, fused


def profile_path():
    """The resblock profiling entry point (phase 9).  Returns (launches,
    its result)."""
    from mimic3_tpu_torch.ops import resblock
    from mimic3_tpu_torch.scripts import profile_resblock

    resblock.launches = 0
    result = profile_resblock.main(["--loops", "4"])
    launches = resblock.launches
    check = result["check"]
    say("profile", f"B=16 T=65536 C=128 K=3 d=5 bf16: {launches} launches; "
        f"kernel {result['kernel']['ms_per_subblock']:.3f} ms "
        f"({result['kernel']['tflops']:.1f} TFLOP/s), plain "
        f"{result['plain']['ms_per_subblock']:.3f} ms "
        f"({result['plain']['tflops']:.1f} TFLOP/s); corr "
        f"{check['corr']:.6f}, branch corr {check['branch_corr']:.6f}")
    if launches < 1:
        raise AssertionError("the profiling entry point did not launch")
    if not (check["finite"] and check["corr"] > BF16_CORR
            and check["branch_corr"] > BF16_BRANCH_CORR):
        raise AssertionError(f"profiling entry point disagrees: {check}")
    return launches, result


def streaming_path(voice_dir, card_line):
    """Chunked and batched streaming (phase 10).  Returns the stage
    launches."""
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    voice = load_from_directory(voice_dir, deterministic=True)
    session = voice.session
    ids = phoneme_ids(voice, STREAM_TEXT)
    batch_ids = [phoneme_ids(voice, t) for t in BATCH_TEXTS]
    full = session.synthesize_ids(ids, noise_scale=0.0, noise_w=0.0)

    def timed_stream():
        """(chunks, ms to the first chunk, ms to the last)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen = session.synthesize_ids_chunked(
            ids, noise_scale=0.0, noise_w=0.0, **STREAM_GRID
        )
        chunks = [next(gen)]
        first_ms = (time.perf_counter() - t0) * 1000
        chunks.extend(gen)
        return chunks, first_ms, (time.perf_counter() - t0) * 1000

    stage.launches = 0
    chunks, cold_first, cold_total = timed_stream()
    n_chunked = stage.launches
    warm = [timed_stream()[1:] for _ in range(5)]
    stream = np.concatenate(chunks)
    c = corr(stream, full)
    say("stream", f"{len(ids)} phonemes, {len(chunks)} chunks, "
        f"{stream.size} samples (unchunked {full.size}); corr {c:.6f}, "
        f"max abs diff {np.abs(stream - full).max():.3g} "
        f"({n_chunked} stage launches)")
    say("stream", f"time to first chunk {cold_first:.1f} ms on the first "
        f"stream, median {np.median([w[0] for w in warm]):.1f} ms of the "
        f"next 5; whole stream {cold_total:.1f} ms, then median "
        f"{np.median([w[1] for w in warm]):.1f} ms ({card_line})")
    if len(chunks) < 2 or stream.size != full.size or not c >= 0.999:
        raise AssertionError("chunked stream disagrees with unchunked")

    kw = dict(noise_scale=0.667, noise_w=0.8, seed=7, **STREAM_GRID)
    before = stage.launches
    batched = [np.concatenate(list(g))
               for g in session.stream_start_batch(batch_ids, **kw)]
    n_batched = stage.launches - before
    worst = 1.0
    for seq, got in zip(batch_ids, batched):
        solo = np.concatenate(list(session.synthesize_ids_chunked(seq, **kw)))
        if got.size != solo.size:
            raise AssertionError("batched stream length differs from solo")
        worst = min(worst, corr(got, solo))
    say("stream", f"stream_start_batch of 4 against each alone: lengths "
        f"{[a.size for a in batched]}, min corr {worst:.6f} "
        f"({n_batched} stage launches)")
    if not worst >= 0.999:
        raise AssertionError("batched streams disagree with solo streams")
    if min(n_chunked, n_batched) < 1:
        raise AssertionError("streaming did not launch the stage kernel")
    launches = stage.launches

    # the warmed-bucket fallback: padded text and frame buckets against the
    # natural ones (cuDNN may pick other algorithms for the padded shapes)
    padded = load_from_directory(voice_dir, deterministic=True,
                                 share_sessions=False).session
    padded.warmup(text_buckets=(512,), frame_buckets=(512,))
    got = padded.synthesize_ids(ids, noise_scale=0.0, noise_w=0.0)
    fallbacks = padded.stats.fallbacks_snapshot()
    diff = float(np.abs(got - full).max()) if got.size == full.size else None
    say("stream", f"warmed-bucket fallback {sorted(fallbacks)}: max abs "
        f"diff against the natural buckets {diff}")
    if len(fallbacks) != 2 or diff is None or diff > 1e-4:
        raise AssertionError("padded buckets disagree with natural ones")
    return launches


def server_path(root, card_line):
    """The HTTP server in process (phase 11).  Returns the stage
    launches of its requests (warmup and this script's own session calls
    not counted)."""
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.server.__main__ import create_app

    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_server_thread import ServerThread

    key = "en_US/serve_low"
    profile_dir = root / "profile"
    app = create_app([
        "--voices-dir", str(root), "--voice", key, "--preload-voice", key,
        "--warmup", "--deterministic", "--max-batch", "4",
        "--batch-delay-ms", "30", "--profile-dir", str(profile_dir),
    ])
    try:
        stage.launches = 0
        t0 = time.perf_counter()
        app.preload()
        say("server", f"preload + warmup {time.perf_counter() - t0:.1f} s "
            f"({stage.launches} stage launches)")
        # the session's chunks for each sentence, as the server's
        # low-latency path asks for them, to hold the stream against
        voice = app._catalog._get_or_load_voice(key)
        expected = np.concatenate([
            chunk
            for words, _ in voice.text_to_phonemes(STREAM_TEXT)
            for chunk in voice.session.synthesize_ids_chunked(
                voice.phonemes_to_ids(words), noise_scale=0.0,
                noise_w=0.0,
                length_scale=voice.config.inference.length_scale,
                **STREAM_GRID,
            )
        ])
        expected = np.clip(expected * 32767.0 * 0.7, -32767,
                           32767).astype(np.int16)
        srv = ServerThread(app).start()
        try:
            stage.launches = 0
            base = srv.base_url
            t0 = time.perf_counter()
            wav = parse_wav(http(base, f"/api/tts?voice={key}",
                                 TEXT.encode()))
            tts_ms = (time.perf_counter() - t0) * 1000
            walls = []
            for i in range(5):
                t0 = time.perf_counter()
                http(base, f"/api/tts?voice={key}&noCache=true",
                     f"{TEXT} {i}".encode())
                walls.append((time.perf_counter() - t0) * 1000)
            say("server", f"POST /api/tts: WAV {wav.size} samples at 22050 "
                f"Hz; first request {tts_ms:.1f} ms, median of the next 5 "
                f"{np.median(walls):.1f} ms (batching window 30 ms; "
                f"{card_line})")

            query = urllib.parse.urlencode({
                "text": STREAM_TEXT, "voice": key, "streaming": "true",
                "streamingMode": "low-latency",
            })
            blob = http(base, f"/api/tts?{query}")
            if blob[:4] != b"RIFF":
                raise AssertionError("low-latency stream has no WAV header")
            pcm = np.frombuffer(blob[44:], np.int16)
            diff = int(np.abs(pcm.astype(np.int32) - expected).max()) \
                if pcm.size == expected.size else None
            say("server", f"GET low-latency stream: {pcm.size} samples "
                f"(session chunks {expected.size}), max diff {diff} LSB")
            if diff is None or diff > 1:
                raise AssertionError("streamed PCM differs from the session's")

            stats0 = json.loads(http(base, "/api/stats"))["scheduler"]
            texts = [f"{t} Request {i}." for i, t in enumerate(BATCH_TEXTS)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as pool:
                wavs = list(pool.map(
                    lambda t: parse_wav(http(
                        base, f"/api/tts?voice={key}&noCache=true",
                        t.encode(),
                    )),
                    texts,
                ))
            burst_ms = (time.perf_counter() - t0) * 1000
            stats = json.loads(http(base, "/api/stats"))
            batches = stats["scheduler"]["batches"] - stats0["batches"]
            items = stats["scheduler"]["items"] - stats0["items"]
            say("server", f"4 concurrent requests in {burst_ms:.1f} ms: "
                f"{items} items in {batches} device batches "
                f"({[w.size for w in wavs]} samples; {card_line})")
            if items < 4 or not items > batches:
                raise AssertionError("the concurrent burst was not batched")

            # a capture with requests in flight: the trace holds kernels
            traffic = threading.Thread(target=lambda: [
                http(base, f"/api/tts?voice={key}&noCache=true",
                     t.encode()) for t in texts
            ])
            traffic.start()
            reply = json.loads(http(base, "/api/profile?seconds=1", b""))
            traffic.join(timeout=300)
            if traffic.is_alive():
                raise AssertionError("requests during the capture hung")
            # every request that synthesizes has been answered
            launches = stage.launches
            traces = sorted(Path(reply["profile_dir"]).glob("*.json"))
            if not traces:
                raise AssertionError("POST /api/profile wrote no trace")
            events = json.loads(traces[-1].read_text())["traceEvents"]
            n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
            say("server", f"POST /api/profile?seconds=1: {traces[-1].name}, "
                f"{len(events)} events, {n_kernels} CUDA kernels")
            if n_kernels < 1:
                raise AssertionError("the profile holds no CUDA kernel")

            voice_stats = json.loads(http(base, "/api/stats"))["voices"][key]
            say("server", f"/api/stats: {voice_stats['jit_executables']} "
                f"signatures run, hot_path_compiles "
                f"{voice_stats['hot_path_compiles']}, bucket_fallbacks "
                f"{voice_stats['bucket_fallbacks']}")
            if voice_stats["hot_path_compiles"] != 0:
                raise AssertionError("a signature ran first after warmup")
        finally:
            srv.stop()
    finally:
        app.shutdown()
    say("server", f"{launches} stage launches by the requests")
    if launches < 1:
        raise AssertionError("the requests did not launch the stage kernel")
    return launches


# ---------------------------------------------------------------------------
# the voices the port serves beside the HiFi-GAN test voice
# ---------------------------------------------------------------------------


def install_onnx_stub() -> None:
    """torch's TorchScript ONNX exporter imports the ``onnx`` package only
    to scan the finished model for custom functions (there are none); the
    card's machine has no ``onnx``, so a stub answers that scan (as
    tests/test_onnx_export_real.py does)."""
    import types

    if "onnx" in sys.modules:
        return
    stub = types.ModuleType("onnx")

    class _Graph:
        node = ()

    class _Model:
        graph = _Graph()
        functions = []

    stub.load_model_from_string = lambda _b: _Model()
    sys.modules["onnx"] = stub


def export_oracle_voice(voice_dir: Path, num_symbols: int):
    """``generator.onnx`` of the independent torch oracle at the ``*_low``
    widths, exported for real (weight-norm initializers anonymized).  Its
    duration flows and coupling posts get weights so durations vary
    (about 4 frames per phoneme, like real voices) and the flow acts.
    Returns the oracle (f32, on the CPU)."""
    sys.path.insert(0, str(REPO / "tests"))
    import torch_oracle as oracle

    torch.manual_seed(1234)
    net = oracle.SynthesizerTrn(num_symbols).eval()
    gen = torch.Generator().manual_seed(1234)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name == "dp.flows.0.m":
                p.copy_(torch.tensor([[-1.4], [0.0]]))
            elif re.fullmatch(r"dp\.flows\.\d+\.proj\.weight", name):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
            elif re.fullmatch(r"flow\.flows\.\d+\.post\.weight", name):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)

    class Wrap(torch.nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self, ids, lengths, dur_noise, prior_noise):
            return self.net.infer(
                ids, lengths, noise_scale=0.667, length_scale=1.0,
                noise_w=0.8, dur_noise=dur_noise, prior_noise=prior_noise,
            )

    install_onnx_stub()
    t_text, frames = 9, 1000  # prior noise longer than any trace output
    torch.onnx.export(
        Wrap(net),
        (torch.randint(1, num_symbols, (1, t_text),
                       generator=torch.Generator().manual_seed(2)),
         torch.tensor([t_text]), torch.zeros(1, 2, t_text),
         torch.zeros(1, 192, frames)),
        str(voice_dir / "generator.onnx"),
        input_names=["input", "input_lengths", "dur_noise", "prior_noise"],
        output_names=["output", "y_lengths", "w_ceil"],
        do_constant_folding=True, opset_version=17, dynamo=False,
    )
    return net


def onnx_path(root):
    """A voice that ships only generator.onnx (phase 12): converted on
    first load, the npz taken on the second, then held to the torch
    oracle it was exported from.  Returns the stage launches."""
    from mimic3_tpu_torch.engine import Mimic3Settings, Mimic3TextToSpeechSystem
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.convert import flatten_pytree, load_pytree_npz
    from mimic3_tpu_torch.runtime.session import device_work
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    # the test voice's config.json (ModelConfig defaults = the *_low
    # widths) and phonemes.txt; its weights replaced by an ONNX export
    voice_dir = create_test_voice(root / "en_US" / "onnx_low", seed=1234)
    (voice_dir / "generator.npz").unlink()
    n_symbols = len((voice_dir / "phonemes.txt").read_text().splitlines())
    t0 = time.perf_counter()
    net = export_oracle_voice(voice_dir, n_symbols)
    onnx_mb = (voice_dir / "generator.onnx").stat().st_size / 1e6
    say("onnx", f"torch.onnx.export of the *_low oracle on the CPU: "
        f"{onnx_mb:.1f} MB in {time.perf_counter() - t0:.1f} s")

    stage.launches = 0
    key = "en_US/onnx_low"
    det = Mimic3TextToSpeechSystem(Mimic3Settings(
        voices_directories=[str(root)], use_deterministic_compute=True,
        noise_scale=0.0, noise_w=0.0,
    ))
    t0 = time.perf_counter()
    det.preload_voice(key)
    first_s = time.perf_counter() - t0
    flat = flatten_pytree(load_pytree_npz(voice_dir / "generator.npz"))
    n_params = int(sum(v.size for v in flat.values()))
    t0 = time.perf_counter()
    again = load_from_directory(voice_dir, deterministic=True,
                                share_sessions=False)
    second_s = time.perf_counter() - t0
    say("onnx", f"engine load converting generator.onnx: {first_s:.2f} s "
        f"({len(flat)} tensors, {n_params} parameters); second load from "
        f"generator.npz: {second_s:.2f} s")
    del again

    voice = det.preloaded_voice(key)
    ids = phoneme_ids(voice, TEXT)
    with torch.no_grad():
        want, want_frames, w_ceil = net.infer(
            torch.tensor([ids]), torch.tensor([len(ids)]), noise_scale=0.0,
            length_scale=1.0, noise_w=0.0,
        )
    # the oracle decodes exactly its frames; the session's frame bucket
    # pads past them, which moves the last few frames (as in the JAX
    # package): hold the model at the oracle's frame count, then run the
    # session's own path
    session = voice.session
    with device_work():
        ids_t = torch.tensor([ids], device="cuda")
        len_t = torch.tensor([len(ids)], device="cuda")
        got_dur, totals = session.model.infer_durations(
            session.params, ids_t, len_t, 0, 1.0, 0.0
        )
        frames = int(totals[0])
        audio, n = session.model.decode_frames(
            session.params, ids_t, len_t, got_dur, frames, 0, 0.0,
            stage_weights=session.stage_weights,
        )
        got = audio[0, : int(n[0])].float().cpu().numpy()
    oracle_dur = w_ceil[0, 0].long().numpy()
    want = want[0].numpy()
    equal = bool(np.array_equal(got_dur[0].cpu().numpy(), oracle_dur))
    c = corr(got, want) if got.size == want.size else None
    wav = session.synthesize_ids(ids, noise_scale=0.0, noise_w=0.0)
    say("onnx", f"deterministic f32 on the card against the torch oracle "
        f"(f32, CPU): {len(ids)} phonemes, durations equal {equal} "
        f"({int(oracle_dur.sum())} frames), corr {c}, max abs diff "
        f"{np.abs(got - want).max() if c is not None else None}; the "
        f"session's bucketed call: {wav.size} samples")
    if not equal or c is None or not c >= 0.999 or wav.size != want.size:
        raise AssertionError("the converted voice disagrees with its oracle")
    n_det = stage.launches

    default = Mimic3TextToSpeechSystem(
        Mimic3Settings(voices_directories=[str(root)], seed=7)
    )
    default.voice = key
    wav = parse_wav(default.text_to_wav(TEXT))
    n_default = stage.launches - n_det
    say("onnx", f"default bf16 mode: WAV {wav.size} samples, {n_default} "
        f"stage launches ({n_det} deterministic)")
    if min(n_det, n_default) < 1:
        raise AssertionError("the ONNX voice did not launch the stage kernel")
    return stage.launches


def mbistft_path(root, voice_dir, card_line):
    """An MB-iSTFT voice (phase 13): card against the port's own CPU
    output, two deterministic calls bitwise equal, bf16 against f32, no
    stage launch, and its time in turns with the HiFi-GAN voice.  Returns
    the stage launches (0)."""
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    mb_dir = create_test_voice(root / "en_US" / "mb_low", seed=1234,
                               decoder_type="mb-istft")
    mb_f32_dir = voice_copy(mb_dir, root / "en_US" / "mb_f32_low",
                            decoder_dtype="float32")
    stage.launches = 0
    card_det = load_from_directory(mb_dir, deterministic=True)
    cpu_det = load_from_directory(mb_dir, deterministic=True, device="cpu")
    ids = phoneme_ids(card_det, TEXT)
    batch_ids = [phoneme_ids(card_det, t) for t in BATCH_TEXTS]
    got = card_det.session.synthesize_ids(ids, noise_scale=0.0, noise_w=0.0)
    again = card_det.session.synthesize_ids(ids, noise_scale=0.0,
                                            noise_w=0.0)
    want = cpu_det.session.synthesize_ids(ids, noise_scale=0.0, noise_w=0.0)
    c_cpu = corr(got, want) if got.size == want.size else None
    bf16 = load_from_directory(mb_dir).session.synthesize_ids_batch(
        batch_ids, seed=7)
    f32 = load_from_directory(mb_f32_dir).session.synthesize_ids_batch(
        batch_ids, seed=7)
    same = [a.size for a in bf16] == [a.size for a in f32]
    c_bf16 = min(corr(a, b) for a, b in zip(bf16, f32)) if same else None
    launches = stage.launches
    repeat = got.tobytes() == again.tobytes()
    say("mbistft", f"full-width MB-iSTFT voice: deterministic card vs CPU "
        f"{got.size} / {want.size} samples, corr {c_cpu}; two deterministic "
        f"card calls {'bitwise equal' if repeat else 'DIFFER'}; bf16 vs f32 "
        f"decoder, batch of 4, min corr {c_bf16}; {launches} stage launches")
    if c_cpu is None or not c_cpu >= 0.999:
        raise AssertionError("MB-iSTFT on the card disagrees with the CPU")
    if not repeat:
        raise AssertionError("two deterministic MB-iSTFT calls differ")
    if c_bf16 is None or not c_bf16 > 0.99:
        raise AssertionError("MB-iSTFT bf16 strays from its f32 decoder")
    if launches != 0:
        raise AssertionError("the MB-iSTFT path launched the stage kernel")

    hifigan = load_from_directory(voice_dir).session
    mb = load_from_directory(mb_dir).session
    times = {}
    for batch in (1, 4):
        seqs = [ids] if batch == 1 else batch_ids
        h1 = time_session(hifigan, seqs, 5)
        m1 = time_session(mb, seqs, 5)
        m2 = time_session(mb, seqs, 5)
        h2 = time_session(hifigan, seqs, 5)
        for name, (a, b) in (("hifigan", (h1, h2)), ("mb-istft", (m1, m2))):
            times[(name, batch)] = ((a[0] + b[0]) / 2, (a[1] + b[1]) / 2)
        (hw, hr), (mw, mr) = times[("hifigan", batch)], times[("mb-istft",
                                                               batch)]
        say("time", f"default mode, batch {batch}: HiFi-GAN {hw * 1000:.1f} "
            f"ms per call, {hr:.1f} audio-s/s; MB-iSTFT {mw * 1000:.1f} ms, "
            f"{mr:.1f} audio-s/s; ratio {hw / mw:.2f} ({card_line})")
        say("time", f"device time per call (torch.profiler, sum of "
            f"kernels), batch {batch}: HiFi-GAN "
            f"{device_ms_per_call(hifigan, seqs):.2f} ms, MB-iSTFT "
            f"{device_ms_per_call(mb, seqs):.2f} ms")
    return launches


def speculate_path(root, voice_dir, card_line):
    """Speculative decode on and off (phase 14): the same audio, how often
    the prediction held, the wall time both ways, and whether the host
    had the totals before the speculative decode finished.  Returns the
    stage launches of the timed calls."""
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    off_dir = voice_copy(voice_dir, root / "en_US" / "nospec_low",
                         speculative_decode=False)
    on = load_from_directory(voice_dir, deterministic=True,
                             share_sessions=False)
    off = load_from_directory(off_dir, deterministic=True,
                              share_sessions=False)
    batches = {1: [phoneme_ids(on, TEXT)],
               4: [phoneme_ids(on, t) for t in BATCH_TEXTS]}
    warm = dict(text_buckets=(32, 64, 128), frame_buckets=(128, 256, 512),
                batch_sizes=(1, 4))
    for v in (on, off):
        v.session.warmup(**warm)
        for seqs in batches.values():  # the estimate's first observation
            v.session.synthesize_ids_batch(seqs, seed=1)
    stage.launches = 0
    walls = {(name, b): [] for name in ("on", "off") for b in batches}
    worst = 0.0
    for rnd in range(5):
        for b, seqs in batches.items():
            outs = {}
            for name, v in (("on", on), ("off", off)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = v.session.synthesize_ids_batch(
                    seqs, seed=100 + rnd
                )
                walls[(name, b)].append(time.perf_counter() - t0)
            if [a.size for a in outs["on"]] != [a.size for a in outs["off"]]:
                raise AssertionError("speculation changed the lengths")
            worst = max(worst, max(float(np.abs(x - y).max())
                                   for x, y in zip(outs["on"], outs["off"])))
    launches = stage.launches
    spec = on.session.speculation
    say("speculate", f"20 calls in turns, f32 deterministic voice: max abs "
        f"diff on vs off {worst:.3g} (bar 1e-5); speculative decodes "
        f"{spec['dispatched']}: used {spec['used']}, fell back "
        f"{spec['fell_back']}, skipped {spec['skipped']}; totals on the "
        f"host before the speculative decode finished in "
        f"{spec['overlapped']} of them; {launches} stage launches")
    for b in batches:
        say("time", f"speculation on / off, batch {b}: "
            f"{np.median(walls[('on', b)]) * 1000:.1f} / "
            f"{np.median(walls[('off', b)]) * 1000:.1f} ms per call, "
            f"median of 5 ({card_line})")
    for name, v in (("on", on), ("off", off)):
        hits = {k: n for k, n in v.session.stats.hits_snapshot().items()
                if k.startswith("decode")}
        say("speculate", f"decode dispatches with speculation {name} "
            f"(warmup not counted): {hits}")

    # the host's cost of the noise a speculative decode needs before the
    # sync: the frame-indexed prior noise of the bucket, made on the CPU
    # and staged to the card through pinned memory
    from mimic3_tpu_torch.models.vits.model import indexed_noise, upload

    dev = torch.device("cuda")
    for frames in (128, 256, 512):
        host_ms = []
        for i in range(20):
            t0 = time.perf_counter()
            upload(indexed_noise(i, 1, 0, frames, 192), dev)
            host_ms.append((time.perf_counter() - t0) * 1000)
        say("speculate", f"prior noise for a {frames}-frame bucket: "
            f"{np.median(host_ms):.3f} ms of host time (median of 20)")
    if worst > 1e-5:
        raise AssertionError("speculation changed the audio")
    if spec["used"] < 1 or off.session.speculation["dispatched"]:
        raise AssertionError("speculation did not run as configured")
    if on.session.hot_path_compiles() or off.session.hot_path_compiles():
        raise AssertionError("a signature ran first after warmup")

    # one profiled call: the host's return from the totals wait against
    # the speculative decode's end on the device
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        before = dict(spec)
        on.session.synthesize_ids_batch(batches[4], seed=999)
    overlapped = spec["overlapped"] - before["overlapped"]
    say("time", f"device time per call, batch 4: speculation on "
        f"{device_ms_per_call(on.session, batches[4]):.2f} ms, off "
        f"{device_ms_per_call(off.session, batches[4]):.2f} ms")
    say("speculate", f"profiled call (batch 4): speculative decode "
        f"{'used' if spec['used'] > before['used'] else 'not used'}; the "
        f"host returned from the totals wait "
        f"{'before' if overlapped else 'after'} the speculative decode "
        f"finished")
    return launches


# ---------------------------------------------------------------------------
# training: mimic3-torch-train, then serve what it exported
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16  # as the JAX package's on-chip train smoke
# the attention key bias: softmax ignores a shift shared by a row, so its
# gradient is zero in exact arithmetic and float32 rounding noise on
# either device (tests/torch_train_reference.py)
ZERO_GRADIENT_SUFFIX = "conv_k.bias"
TRAIN_WORDS = ("a rainbow is meteorological phenomenon that caused by "
               "reflection refraction and dispersion of light in water "
               "droplets resulting spectrum appearing the sky").split()


def write_train_dataset(root: Path, n: int = 32, seed: int = 0):
    """An LJSpeech-style dataset: ``n`` utterances of 1-3 s at 22050 Hz
    (tones under noise, made from a seed) with texts for the symbols
    phonemizer.  Returns (metadata.csv, the WAV directory)."""
    rng = np.random.RandomState(seed)
    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    rows = []
    for i in range(n):
        samples = int(22050 * rng.uniform(1.0, 3.0))
        t = np.arange(samples) / 22050
        audio = 0.05 * rng.randn(samples)
        for f in rng.uniform(100, 4000, 4):
            audio += 0.1 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6.3))
        with wave.open(str(wavs / f"utt{i:03d}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(22050)
            w.writeframes((np.clip(audio, -1, 1) * 32767).astype(
                np.int16).tobytes())
        words = rng.choice(TRAIN_WORDS, size=rng.randint(4, 12))
        rows.append(f"utt{i:03d}|{' '.join(words)}.")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return root / "metadata.csv", wavs


class StepClock(logging.Handler):
    """Host time of each ``step N`` line the trainer logs (with
    ``--log-every 1`` each follows a fetch of the step's losses, so the
    card has finished the step), and, while :meth:`gc_callback` is in
    ``gc.callbacks``, the garbage collector's passes: the step is
    host-bound, and a full pass over a large process's objects takes as
    long as part of a step."""

    def __init__(self):
        super().__init__()
        self.times, self.metrics, self.collections = [], [], []
        self._gc_start = None

    def emit(self, record):
        if record.getMessage().startswith("step "):
            self.times.append(time.perf_counter())
            self.metrics.append(record.args[1])

    def gc_callback(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._gc_start = now
        elif self._gc_start is not None:
            self.collections.append((self._gc_start, now, info["generation"]))

    def collections_after_first_step(self) -> str:
        """The collector's passes between the first and the last step
        line, by generation: passes and ms."""
        by_gen = {g: [0, 0.0] for g in range(3)}
        for start, end, gen in self.collections:
            if self.times[0] <= start <= self.times[-1]:
                by_gen[gen][0] += 1
                by_gen[gen][1] += (end - start) * 1000
        return ", ".join(f"gen {g}: {n} passes, {ms:.1f} ms"
                         for g, (n, ms) in by_gen.items())


def busy_share(trace: Path) -> tuple:
    """(device busy share, window ms) of a ``torch.profiler`` Chrome
    trace: the union of its kernel, memcpy and memset intervals over the
    window from its first event to its last."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset"))
    if not device:
        raise AssertionError("the profiled step holds no device work")
    start = min(e["ts"] for e in events)
    end = max(e["ts"] + e["dur"] for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in device:
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    return busy / (end - start), (end - start) / 1000


def train_path(root: Path, card_line: str):
    """mimic3-torch-train on the full-width test voice (phase 15):
    ``TRAIN_BATCH`` x the config's 8192-sample segment, MPD + MSD; step
    times, memory, busy share and a breakdown; every loss finite and every
    parameter with a gradient moved; the card against the CPU on one step;
    then the exported generator.npz served by the engine on the card.
    Returns (kernel launches while training, stage launches serving)."""
    from mimic3_tpu_torch import train_cli
    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.engine import Mimic3Settings, Mimic3TextToSpeechSystem
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.ops import resblock, stage
    from mimic3_tpu_torch.runtime.convert import to_torch_train_params
    from mimic3_tpu_torch.runtime.dataset import (
        batches, load_metadata, make_frontend,
    )
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    voice_dir = create_test_voice(root / "en_US" / "train_low", seed=1234)
    config = TrainingConfig.load_path(voice_dir / "config.json")
    metadata, wavs = write_train_dataset(root / "train_data")
    ckpt = root / "train_ckpt"
    dev = torch.device("cuda")

    stage.launches = resblock.launches = 0
    clock = StepClock()
    logger = logging.getLogger("mimic3_tpu_torch.train_cli")
    logger.setLevel(logging.INFO)
    logger.addHandler(clock)
    gc.callbacks.append(clock.gc_callback)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([
            str(voice_dir), "--metadata", str(metadata), "--audio-dir",
            str(wavs), "--batch-size", str(TRAIN_BATCH), "--steps", "6",
            "--log-every", "1", "--checkpoint-dir", str(ckpt), "--export",
        ])
    finally:
        logger.removeHandler(clock)
        gc.callbacks.remove(clock.gc_callback)
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if rc != 0 or len(clock.times) != 6:
        raise AssertionError(f"mimic3-torch-train failed (rc {rc})")
    step_ms = np.diff(clock.times) * 1000  # the 5 steps after the first
    seg_s = TRAIN_BATCH * config.segment_size / config.audio.sample_rate
    med = float(np.median(step_ms))
    say("train", f"mimic3-torch-train, full-width voice, batch "
        f"{TRAIN_BATCH} x {config.segment_size} samples, 6 steps in "
        f"{total_s:.1f} s (init, data and export included); steps 2-6: "
        f"median {med:.1f} ms, min {step_ms.min():.1f}, max "
        f"{step_ms.max():.1f} ({[round(float(x), 1) for x in step_ms]}); "
        f"{1000 / med:.2f} steps/s, {seg_s * 1000 / med:.1f} segment "
        f"audio-s/s; peak memory {peak_gb:.2f} GB ({card_line})")
    for m in clock.metrics:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"a loss is not finite: {m}")
    say("train", f"losses, step 1: {clock.metrics[0]}; step 6: "
        f"{clock.metrics[-1]}")
    say("train", f"garbage collector during steps 2-6: "
        f"{clock.collections_after_first_step()} ({len(gc.get_objects())} "
        f"objects tracked in this process)")
    # the same trainer and steps in a fresh process, right after: what
    # this process's state after the earlier phases costs the host-bound
    # step (the trainer alone runs as the fresh process does)
    fresh = subprocess.run(
        [sys.executable, str(REPO / "mimic3_tpu_torch" / "scripts"
                             / "time_train_step.py")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=300,
    )
    fresh_line = [ln for ln in fresh.stdout.splitlines()
                  if ln.startswith("{")]
    if fresh.returncode != 0 or not fresh_line:
        raise AssertionError("the fresh-process trainer failed:\n"
                             + (fresh.stdout + fresh.stderr)[-2000:])
    fresh_run = json.loads(fresh_line[-1])
    say("train", f"the same trainer in a fresh process, right after: steps "
        f"2-6 median {fresh_run['median_ms']:.1f} ms "
        f"({fresh_run['step_ms']}), peak memory {fresh_run['peak_gb']:.2f} "
        f"GB; this process: median {med:.1f} ms")

    # one more step from the final checkpoint, timed part by part, then
    # one profiled
    state = train_cli.load_checkpoint(ckpt / "6", config, dev)
    frontend = make_frontend(voice_dir)
    utts = load_metadata(metadata, wavs, frontend)
    data = batches(utts, config, TRAIN_BATCH, seed=config.seed)
    step = T.make_train_step(config, max(1, len(utts) // TRAIN_BATCH))
    gen = torch.Generator(dev).manual_seed(7)
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    batch = next(data).to(dev)
    step(state, batch, generator=gen)  # the batch's shapes warm
    before = [t.detach().clone() for _, t in state.g_leaves + state.d_leaves]
    marks.clear()
    state, metrics = step(state, batch, generator=gen, mark=mark)
    torch.cuda.synchronize()
    parts = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        parts[name] = parts.get(name, 0.0) + a.elapsed_time(b)
    whole = sum(parts.values())
    say("train", "breakdown of one step (CUDA events, ms): " + ", ".join(
        f"{k} {v:.1f} ({v / whole:.0%})" for k, v in parts.items())
        + f"; sum {whole:.1f}")
    leaves = state.g_leaves + state.d_leaves
    no_grad = [n for n, t in leaves if not t.grad.any()]
    stuck = [n for (n, t), b in zip(leaves, before)
             if t.grad.any() and torch.equal(t.detach(), b)]
    say("train", f"{len(leaves)} parameter tensors "
        f"({sum(t.numel() for _, t in leaves) / 1e6:.1f} M parameters: "
        f"G {sum(t.numel() for _, t in state.g_leaves) / 1e6:.1f} M, D "
        f"{sum(t.numel() for _, t in state.d_leaves) / 1e6:.1f} M); "
        f"{len(no_grad)} had no gradient; {len(stuck)} with a gradient "
        f"did not move")
    if stuck or not all(torch.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"parameters did not move: {stuck[:5]}")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, generator=gen)
        torch.cuda.synchronize()
    trace = root / "train_step_trace.json"
    prof.export_chrome_trace(str(trace))
    share, window = busy_share(trace)
    say("train", f"profiled step: device busy {share:.3f} of "
        f"{window:.1f} ms (idle share {1 - share:.3f})")
    n_train = stage.launches + resblock.launches
    say("train", f"kernel launches while training: stage "
        f"{stage.launches}, resblock {resblock.launches}")
    if n_train:
        raise AssertionError("training launched a kernel")
    del state, before

    # the card against the port's own CPU path on one step: the same
    # carried init (decoder gains x10 as in tests/torch_train_reference.py,
    # where the mel loss's gradient is well conditioned), the same draws,
    # batch 2, and a zero learning rate so both take the generator's
    # gradients against the same discriminators
    one = TrainingConfig.load_path(voice_dir / "config.json")
    one.learning_rate = 0.0
    params, disc = T.init_training_params(5, one)
    for name, t in T.tree_leaves(params["dec"]):
        if name.endswith("weight_g"):
            t.mul_(10.0)
    small = next(batches(utts, one, 2, seed=1))
    cpu_gen = torch.Generator().manual_seed(11)
    t_spec = small.audio.shape[1] // one.audio.hop_length
    noise = T.TrainNoise(
        posterior=torch.randn(2, one.model.inter_channels, t_spec,
                              generator=cpu_gen),
        duration=torch.randn(2, 2, small.phoneme_ids.shape[1],
                             generator=cpu_gen),
        starts=T.random_segments(
            torch.zeros(2, 1, t_spec), small.spec_lengths,
            one.segment_size // one.audio.hop_length, generator=cpu_gen,
        )[1],
    )
    sides = {}
    for device in ("cpu", "cuda"):
        st = T.init_train_state(to_torch_train_params(params, device),
                                to_torch_train_params(disc, device), one)
        t0 = time.perf_counter()
        st, m = T.make_train_step(one)(
            st, small.to(device), noise=T.TrainNoise(
                *(x.to(device) for x in (noise.posterior, noise.duration,
                                         noise.starts))),
        )
        sides[device] = ({k: float(v) for k, v in m.items()},
                         {n: t.grad.cpu() for n, t in st.g_leaves
                          + st.d_leaves}, time.perf_counter() - t0)
    (m_cpu, g_cpu, s_cpu), (m_gpu, g_gpu, s_gpu) = sides["cpu"], sides["cuda"]
    loss_err = max(abs(m_gpu[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    worst, worst_name, noise = 0.0, None, 0.0
    for n, g in g_cpu.items():
        if n.endswith(ZERO_GRADIENT_SUFFIX):
            # zero in exact arithmetic: rounding noise on both devices
            noise = max(noise, float(g.abs().max()),
                        float(g_gpu[n].abs().max()))
            continue
        norm = float(g.norm())
        err = float((g_gpu[n] - g).norm()) / norm if norm else float(
            g_gpu[n].abs().max())
        if err > worst:
            worst, worst_name = err, n
    say("train", f"card vs CPU, one step at batch 2 x "
        f"{one.segment_size} samples (CPU {s_cpu:.1f} s, card "
        f"{s_gpu * 1000:.0f} ms): losses max rel err {loss_err:.2e} "
        f"(bar 1e-3); gradients max rel L2 {worst:.2e} at {worst_name} "
        f"(bar 1e-3); the attention key biases' gradients (zero in exact "
        f"arithmetic) at most {noise / scale:.1e} of the largest gradient "
        f"(bar 1e-6)")
    if not (loss_err <= 1e-3 and worst <= 1e-3 and noise <= 1e-6 * scale):
        raise AssertionError("the card's train step disagrees with the CPU")

    # serve what the trainer exported
    stage.launches = 0
    tts = Mimic3TextToSpeechSystem(
        Mimic3Settings(voices_directories=[str(root)], seed=7)
    )
    tts.voice = "en_US/train_low"
    wav = parse_wav(tts.text_to_wav(TEXT))
    n_serve = stage.launches
    say("train", f"exported generator.npz served on the card (bf16 "
        f"decoder): WAV {wav.size} samples, {n_serve} stage launches")
    if n_serve < 1:
        raise AssertionError("serving the trained voice launched no stage")
    return n_train, n_serve, clock.metrics


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------

DP_TEXTS = BATCH_TEXTS + [
    "Rainbows can be full circles.",
    "However, the observer normally sees only an arc.",
    "The arc is formed by illuminated droplets above the ground.",
    "It is centred on a line from the sun to the eye of the observer.",
]
DP_TRAIN_STEPS = 3
# the data-parallel run's losses against the one-process run's: step 1
# (the forward pass, the global normalizers and draws), then steps 2-3,
# which follow the all-reduced updates.  The trainer logs 7 significant
# digits; on an H100 steps 2-3 agreed within 3.7e-07 (PERF.md), and
# the later bar is set about 27x above that reading
DP_STEP1_RTOL = 1e-4
DP_LATER_RTOL = 1e-5


def run_group(argv, timeout):
    """Run ``argv`` in a session of its own; on a timeout, kill the whole
    group (the launcher and its ranks).  Returns (returncode, output)."""
    proc = subprocess.Popen(
        argv, cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True,
    )
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        raise AssertionError(f"{argv[:6]} timed out:\n{out[-3000:]}")
    return proc.returncode, out


def dp_serving(root, voice_dir, card_line, devices):
    """A session over ``devices`` (f32, no speculation, so every call runs
    one decode per shard) against one device: audio within 2e-5 for 8
    sequences and a partial batch of 5, the stage kernel launched once per
    shard, bf16 corr > 0.999, and the wall time per call of each."""
    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.parallel import make_mesh
    from mimic3_tpu_torch.runtime.convert import load_pytree_npz
    from mimic3_tpu_torch.runtime.session import TorchVitsSession
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    dp_dir = root / "en_US" / "dp_low"
    if not dp_dir.exists():
        voice_copy(voice_dir, dp_dir, speculative_decode=False)
    config = TrainingConfig.load_path(dp_dir / "config.json")
    params = load_pytree_npz(dp_dir / "generator.npz")
    voice = load_from_directory(dp_dir, share_sessions=False,
                                deterministic=True)
    seqs = [phoneme_ids(voice, t) for t in DP_TEXTS]
    mesh = make_mesh(devices=devices)
    n = len(devices)
    name = f"dp{n}"
    where = (f"{n} replicas sharing one card: the overhead of sharding, "
             "not scaling" if len(set(devices)) == 1 else f"{n} cards")
    sessions = {
        "single": voice.session,
        name: TorchVitsSession(config, params, deterministic=True,
                               mesh=mesh),
    }
    out, per_call = {}, {}
    for key, session in sessions.items():
        before = stage.launches
        out[key] = (session.synthesize_ids_batch(seqs, seed=3),
                    session.synthesize_ids_batch(seqs[:5], seed=3))
        per_call[key] = (stage.launches - before) / 2
    err = max(float(np.abs(a - b).max()) if a.shape == b.shape else np.inf
              for full, part in zip(out[name], out["single"])
              for a, b in zip(full, part))
    say("dp", f"{name} over {[str(d) for d in devices]} (f32, "
        f"deterministic) against one device: 8 sequences, then a partial "
        f"batch of 5: max abs err {err:.3e} (bar 2e-5); stage launches "
        f"per call: {name} {per_call[name]:g}, single "
        f"{per_call['single']:g}")
    if not err <= 2e-5:
        raise AssertionError(f"{name} audio disagrees with one device")
    if not (per_call["single"] >= 1
            and per_call[name] == n * per_call["single"]):
        raise AssertionError("the stage kernel did not run once per shard")
    bf16 = [
        TorchVitsSession(config, params, device="cuda:0"),
        TorchVitsSession(config, params, mesh=mesh),
    ]
    got = [s.synthesize_ids_batch(seqs, seed=5) for s in bf16]
    c_bf16 = min(corr(a, b) for a, b in zip(*got))
    say("dp", f"bf16 decoder, {name} against one device: min corr "
        f"{c_bf16:.7f} (bar > 0.999)")
    if not c_bf16 > 0.999:
        raise AssertionError(f"bf16 {name} audio strays from one device")
    for key, session in sessions.items():
        on = "one device" if key == "single" else where
        for rows in (8, 16):
            wall, rate = time_session(session, (seqs * 2)[:rows], 5)
            say("time", f"{key} ({on}), {rows} sequences per call, f32: "
                f"{wall * 1000:.1f} ms per call, {rate:.1f} audio-s/s "
                f"({card_line})")
    return dp_dir


def dp_training(root, card_line, nproc, train_steps, backend):
    """``mimic3-torch-train`` in ``nproc`` ranks under
    ``torch.distributed.run`` from the weights and data ``[train]`` starts
    from, ``DP_TRAIN_STEPS`` steps at the global batch ``TRAIN_BATCH``:
    the ``backend`` it must choose, each step's losses against the
    one-process run's ``train_steps`` (step 1 within ``DP_STEP1_RTOL``,
    the later ones within ``DP_LATER_RTOL``), the ranks' parameter digests
    equal."""
    import ast

    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    train_dir = create_test_voice(
        root / "en_US" / f"dp{nproc}_train_low", seed=1234)
    logs = root / f"dp{nproc}_train_logs"
    t0 = time.perf_counter()
    rc, text = run_group([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(nproc), "--redirects", "3", "--log-dir",
        str(logs), "-m", "mimic3_tpu_torch.train_cli", str(train_dir),
        "--metadata", str(root / "train_data" / "metadata.csv"),
        "--audio-dir", str(root / "train_data" / "wavs"), "--batch-size",
        str(TRAIN_BATCH), "--steps", str(DP_TRAIN_STEPS), "--log-every",
        "1", "--checkpoint-dir", str(root / f"dp{nproc}_train_ckpt"),
    ], timeout=600)
    wall = time.perf_counter() - t0
    ranks = {p.parent.name: p.read_text()
             for p in logs.rglob("stderr.log")}
    if rc != 0 or set(ranks) != {str(r) for r in range(nproc)}:
        raise AssertionError(f"{nproc}-rank training failed (rc {rc}):\n"
                             + text[-2000:] + "".join(
                                 t[-2000:] for t in ranks.values()))
    steps, digests, backends = {}, {}, set()
    for rank, log in ranks.items():
        for line in log.splitlines():
            m = re.search(r"step (\d+) (\{.*\}) \(([\d.]+) steps/s\)", line)
            if m:
                steps[(rank, int(m[1]))] = (ast.literal_eval(m[2]),
                                            float(m[3]))
            m = re.search(r"parameter digest \(rank \d+\): (\w+)", line)
            if m:
                digests[rank] = m[1]
            m = re.search(r"backend (\w+) for", line)
            if m:
                backends.add(m[1])
    n = DP_TRAIN_STEPS
    rel = [max(abs(steps[("0", i)][0][k] - want[k]) / abs(want[k])
               for k in want)
           for i, want in enumerate(train_steps[:n], 1)]
    # the trainer logs its rate since the first step began: steps 2..n
    # took n / rate_n - 1 / rate_1 seconds
    step_ms = (n / steps[("0", n)][1] - 1 / steps[("0", 1)][1]) / (n - 1)
    say("dp", f"mimic3-torch-train, {nproc} ranks, backend "
        f"{'/'.join(sorted(backends))}, global batch {TRAIN_BATCH} x 8192 "
        f"samples, {n} steps in {wall:.1f} s (launch, init and data "
        f"included); steps 2-{n}: {step_ms * 1000:.1f} ms per step "
        f"({card_line})")
    say("dp", f"step 1 losses, {nproc} ranks: {steps[('0', 1)][0]}; one "
        f"process: {train_steps[0]}")
    say("dp", f"losses, {nproc} ranks against one process, max rel diff "
        f"per step 1-{n}: {', '.join(f'{r:.3e}' for r in rel)} (bars: step "
        f"1 {DP_STEP1_RTOL:g}, later {DP_LATER_RTOL:g})")
    say("dp", f"parameter digests after {n} steps: " + ", ".join(
        f"rank {r} {d[:16]}" for r, d in sorted(digests.items())))
    if any(steps[(r, i)][0] != steps[("0", i)][0]
           for r in ranks for i in range(1, n + 1)):
        raise AssertionError("the ranks logged different losses")
    if not (rel[0] <= DP_STEP1_RTOL
            and all(r <= DP_LATER_RTOL for r in rel[1:])):
        raise AssertionError(f"{nproc}-rank losses disagree with one "
                             "process")
    if len(digests) != nproc or len(set(digests.values())) != 1:
        raise AssertionError("the ranks' parameters differ")
    if backends != {backend}:
        raise AssertionError(f"expected backend {backend}, got {backends}")


def dp_path(root, voice_dir, card_line, train_steps):
    """Data parallel (phase 16) over every visible card, or over two
    replicas of the one card: serving against one device, ``dp=-1`` taking
    every card, a dp above the visible cards refused, then as many
    training ranks (``nccl`` with a card each, ``gloo`` when they share
    one).  Returns the phase's stage launches."""
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.parallel.distributed import backend_for
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    devices = ([f"cuda:{i}" for i in range(cards)] if cards > 1
               else ["cuda:0", "cuda:0"])
    stage.launches = 0
    dp_dir = dp_serving(root, voice_dir, card_line, devices)
    every = load_from_directory(dp_dir, share_sessions=False, dp=-1)
    say("dp", f"dp=-1 serves over {every.session.dp} card(s)")
    if every.session.dp != cards:
        raise AssertionError("dp=-1 did not take every card")
    try:
        load_from_directory(dp_dir, share_sessions=False, dp=cards + 1)
    except RuntimeError as refusal:
        say("dp", f"dp={cards + 1} with {cards} card(s) visible refused: "
            f"{refusal}")
    else:
        raise AssertionError(f"dp={cards + 1} was not refused")
    nproc = len(devices)
    dp_training(root, card_line, nproc, train_steps,
                backend_for(torch.device("cuda", 0), local_world=nproc))
    say("dp", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return stage.launches


# ---------------------------------------------------------------------------
# tensor parallel
# ---------------------------------------------------------------------------


def tp_meshes() -> typing.List[typing.List[str]]:
    """The device lists of the ``[tp]`` phase (tp 2): on one card a dp 1
    and a dp 2 mesh of repeats of ``cuda:0``, else the visible cards as
    dp = cards // 2 rows of two."""
    cards = torch.cuda.device_count()
    if cards == 1:
        return [["cuda:0"] * 2, ["cuda:0"] * 4]
    return [[f"cuda:{i}" for i in range(cards // 2 * 2)]]


def tp_bf16_witness(one, split, seqs, **kw) -> str:
    """Where the bf16 drift of a tp session comes from (phase 17; printed,
    no bar).  ``one`` is a one-device session and ``split`` a ``use_tp``
    session of the same weights and dtype, speculation off; in the
    decoder only the upsamplers are split.  Each synthesizes ``seqs``
    once with the decoder's input latents captured; then the whole decoder on the split
    session's latent (the encoder's and flow's f32 differences alone),
    the split decoder on the one-device latent (the split upsamplers
    alone) and both (the session's drift), each against the whole
    decoder on the one-device latent; each upsampler's split output
    against the same channels of the whole conv (the same products summed
    at another shape) in the decoder's dtype and in f32; and a control
    with no split: row 0 of the whole decoder against the same row
    decoded alone."""
    from mimic3_tpu_torch.models.vits.layers import conv_transpose1d
    from mimic3_tpu_torch.runtime.session import full_f32_convolutions

    latents = []
    for session in (one, split):
        model, seen = session.model, []

        def grab(dec, z, g=None, stage_weights=None, _decode=(
                model.decode_waveform), _seen=seen):
            _seen.append((z.clone(), g))
            return _decode(dec, z, g=g, stage_weights=stage_weights)

        model.decode_waveform = grab
        try:
            session.synthesize_ids_batch(seqs, **kw)
        finally:
            del model.decode_waveform
        # one latent per dp row, in row order: the batch's rows
        latents.append((torch.cat([z.to(seen[0][0].device)
                                   for z, _ in seen]), seen[0][1]))
    (z_one, g), (z_split, _) = latents
    dec_one = one._replicas[0].params["dec"]
    dec_split = split._replicas[0].params["dec"]

    def audio(session, dec, z):
        return session.model.decode_waveform(dec, z, g=g).float().cpu()

    def min_corr(a, b):
        return min(corr(x, y) for x, y in zip(a.numpy(), b.numpy()))

    hp = one.model.hp
    with torch.inference_mode(), full_f32_convolutions():
        want = audio(one, dec_one, z_one)
        z_diff = float((z_one - z_split.to(z_one.device)).abs().max())
        out = [
            f"latent max abs diff {z_diff:.3e} (f32); against the whole "
            f"decoder on the one-device latent, min corr: whole decoder on "
            f"the tp latent {min_corr(want, audio(one, dec_one, z_split)):.7f}"
            f", upsamplers split on the one-device latent "
            f"{min_corr(want, audio(split, dec_split, z_one)):.7f}, both "
            f"{min_corr(want, audio(split, dec_split, z_split)):.7f}; no "
            f"split, row 0 at B={z_one.shape[0]} against B=1: corr "
            f"{corr(want[0].numpy(), audio(one, dec_one, z_one[:1])[0].numpy()):.7f}"
        ]
        gen = torch.Generator().manual_seed(7)
        for i, (u, k) in enumerate(zip(hp.upsample_rates,
                                       hp.upsample_kernel_sizes)):
            cin = dec_one["ups"][str(i)]["weight"].shape[0]
            x = torch.randn(4, cin, 256, generator=gen).to(z_one.device)
            row = []
            for dtype in (one.model.decoder_dtype, torch.float32):
                conv = dict(stride=u, padding=(k - u) // 2, dtype=dtype)
                a = conv_transpose1d(x, dec_one["ups"][str(i)], **conv)
                b = conv_transpose1d(x, dec_split["ups"][str(i)], **conv)
                diff = (a.float() - b.to(a.device).float()).abs()
                row.append(
                    f"{str(dtype)[6:]} max abs diff {float(diff.max()):.3e} "
                    f"({float((diff > 0).float().mean()) * 100:.2f}% of "
                    f"outputs differ, max |out| {float(a.abs().max()):.3g})")
            out.append(f"ups {i} ({cin} -> {cin // 2}): " + ", ".join(row))
    return "; ".join(out)


def tp_path(root, voice_dir, card_line):
    """Tensor parallel (phase 17): ``use_tp`` sessions over each of
    :func:`tp_meshes` (f32, no speculation, so each call runs one duration
    pass and one decode per dp row) against one device: audio within 2e-5
    of the one-device session with the kernel off and equal durations,
    corr >= 0.999 with the default one-device session (the f32 stage
    kernel on), bf16 corr > 0.999 with the one-device bf16 session with
    the kernel off, an equal first stream chunk, no stage launch, the
    gathers and reductions per call, and the wall and device time per
    call at B = 1 and 4; on the first mesh, :func:`tp_bf16_witness`.
    Returns the phase's stage launches."""
    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.parallel import make_mesh
    from mimic3_tpu_torch.parallel import tensor as tpt
    from mimic3_tpu_torch.runtime.convert import load_pytree_npz
    from mimic3_tpu_torch.runtime.session import TorchVitsSession
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    t_phase = time.perf_counter()
    tp_dir = voice_copy(voice_dir, root / "en_US" / "tp_low",
                        speculative_decode=False)
    plain_dir = voice_copy(voice_dir, root / "en_US" / "tp_plain_low",
                           speculative_decode=False,
                           pallas_stage_max_channels=0)
    config = TrainingConfig.load_path(tp_dir / "config.json")
    params = load_pytree_npz(tp_dir / "generator.npz")
    voice = load_from_directory(plain_dir, share_sessions=False,
                                deterministic=True)
    seqs = [phoneme_ids(voice, t) for t in DP_TEXTS]
    stream_ids = phoneme_ids(voice, STREAM_TEXT)
    det = dict(noise_scale=0.0, noise_w=0.0, seed=3)
    # the one-device references, before the counted window
    plain = voice.session
    plain_bf16 = load_from_directory(plain_dir, share_sessions=False).session
    default = TorchVitsSession(config, params, deterministic=True,
                               device="cuda:0")
    want = plain.synthesize_ids_batch(seqs, **det)
    want_default = default.synthesize_ids_batch(seqs, **det)
    want_bf16 = plain_bf16.synthesize_ids_batch(seqs, seed=5)
    want_chunk = next(iter(plain.synthesize_ids_chunked(
        stream_ids, noise_scale=0.0, noise_w=0.0, **STREAM_GRID)))
    padded = plain._pad(seqs, None, "duration")

    def durations(session):
        ids, lengths, sid = padded
        rep = session._replicas[0]
        d, _ = session.model.infer_durations(
            rep.params, session._put(ids, rep.device),
            session._put(lengths, rep.device), 3, 1.0, 0.0,
            sid=session._sid(sid, rep.device))
        return d.cpu().numpy()

    want_durations = durations(plain)
    hp = plain.model.hp
    stage.launches = 0
    timings = []
    for devices in tp_meshes():
        mesh = make_mesh(devices=devices, tp=2)
        name = f"dp{mesh.shape['dp']}xtp2"
        session = TorchVitsSession(config, params, deterministic=True,
                                   mesh=mesh, use_tp=True)
        if session.model.stage_max_channels != 0 or any(
                r.stage_weights for r in session._replicas):
            raise AssertionError(f"{name}: the stage gate is not 0")
        tpt.gathers = tpt.reductions = 0
        got = session.synthesize_ids_batch(seqs, **det)
        per_call = (tpt.reductions, tpt.gathers)
        # per dp row: the encoder's FFNs in the duration pass and again in
        # the decode pass, and the upsamplers
        expect = (mesh.shape["dp"] * 2 * hp.n_layers,
                  mesh.shape["dp"] * len(hp.upsample_rates))
        err = max(float(np.abs(a - b).max()) if a.shape == b.shape
                  else np.inf for a, b in zip(got, want))
        same_durations = bool(np.array_equal(durations(session),
                                             want_durations))
        c_default = min(corr(a, b) if a.shape == b.shape else -1.0
                        for a, b in zip(got, want_default))
        say("tp", f"{name} over {devices} (f32, deterministic) against "
            f"one device, kernel off: max abs err {err:.3e} (bar 2e-5), "
            f"durations equal: {same_durations}; against the default "
            f"one-device session (f32 stage kernel on): min corr "
            f"{c_default:.7f} (bar 0.999); per call {per_call[0]} "
            f"reductions, {per_call[1]} gathers (expected {expect[0]}, "
            f"{expect[1]})")
        if not (err <= 2e-5 and same_durations and c_default >= 0.999):
            raise AssertionError(f"{name} audio disagrees with one device")
        if per_call != expect:
            raise AssertionError(f"{name}: collectives per call {per_call}")
        bf16 = TorchVitsSession(config, params, mesh=mesh, use_tp=True)
        c_bf16 = min(corr(a, b) if a.shape == b.shape else -1.0
                     for a, b in zip(
                         bf16.synthesize_ids_batch(seqs, seed=5), want_bf16))
        chunk = next(iter(session.synthesize_ids_chunked(
            stream_ids, noise_scale=0.0, noise_w=0.0, **STREAM_GRID)))
        chunk_err = (float(np.abs(chunk - want_chunk).max())
                     if chunk.shape == want_chunk.shape else np.inf)
        say("tp", f"{name}: bf16 against the one-device bf16 session, "
            f"kernel off: min corr {c_bf16:.7f} (bar > 0.999); first "
            f"stream chunk ({chunk.size} samples) max abs err "
            f"{chunk_err:.3e} (bar 2e-5)")
        if not (c_bf16 > 0.999 and chunk_err <= 2e-5):
            raise AssertionError(f"{name}: bf16 or stream disagrees")
        if not timings:
            say("tp", f"{name} bf16 witness: "
                + tp_bf16_witness(plain_bf16, bf16, seqs, seed=5))
        timings.append((name, session))
    for name, session in timings:
        for rows in (1, 4):
            wall, _ = time_session(session, seqs[:rows], 5)
            dev = device_ms_per_call(session, seqs[:rows])
            say("time", f"{name} (tp), {rows} sequence(s) per call, f32: "
                f"wall {wall * 1000:.1f} ms, device {dev:.2f} ms per call "
                f"({card_line})")
    launches = stage.launches
    say("tp", f"stage launches during the tp sessions' calls: {launches} "
        "(must be 0)")
    if launches != 0:
        raise AssertionError("a tp session launched the stage kernel")
    for rows in (1, 4):
        wall, _ = time_session(plain, seqs[:rows], 5)
        dev = device_ms_per_call(plain, seqs[:rows])
        say("time", f"one device, kernel off, {rows} sequence(s) per call, "
            f"f32: wall {wall * 1000:.1f} ms, device {dev:.2f} ms per call "
            f"({card_line})")
    say("tp", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# tensor-parallel training, and tp rows across processes
# ---------------------------------------------------------------------------

TP_TRAIN_STEPS = 3
TP_MP_DET = dict(noise_scale=0.0, noise_w=0.0, seed=3)


def train_inputs(root: Path):
    """The ``[train]`` phase's starting point for a run of its own: the
    full-width voice made again from seed 1234 (``[train]`` exported over
    its generator.npz), its config, the initial trees as
    ``mimic3-torch-train`` builds them (JAX layout), and the utterances of
    ``root/train_data``.  Returns (voice dir, config, params, disc,
    utterances)."""
    from mimic3_tpu_torch import train_cli
    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.runtime.convert import load_pytree_npz
    from mimic3_tpu_torch.runtime.dataset import load_metadata, make_frontend
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    voice_dir = root / "en_US" / "tp_train_low"
    if not voice_dir.exists():
        create_test_voice(voice_dir, seed=1234)
    config = TrainingConfig.load_path(voice_dir / "config.json")
    params, disc = T.init_training_params(config.seed, config)
    params = train_cli.merge_pretrained(
        params, load_pytree_npz(voice_dir / "generator.npz"))
    data = root / "train_data"
    utts = load_metadata(data / "metadata.csv", data / "wavs",
                         make_frontend(voice_dir))
    return voice_dir, config, params, disc, utts


def run_steps(state, config, utts, device, local=None):
    """``TP_TRAIN_STEPS`` steps of ``state`` as ``mimic3-torch-train``
    takes them (the seeded batch stream of ``TRAIN_BATCH`` rows, this
    process's ``local`` (start, size) of each, each step's generator
    seeded from (seed, step)).  Returns (each step's losses, each step's
    host ms, ending in a fetch of its losses)."""
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.models.vits.model import mix_seed
    from mimic3_tpu_torch.runtime.dataset import batches

    step = T.make_train_step(config, max(1, len(utts) // TRAIN_BATCH))
    data = batches(utts, config, TRAIN_BATCH, seed=config.seed)
    start, size = local or (0, TRAIN_BATCH)
    gen = torch.Generator(device)
    losses, times = [], []
    for i in range(TP_TRAIN_STEPS):
        batch = next(data)
        batch = T.TrainBatch(*(
            None if t is None else t[start:start + size].to(device)
            for t in (batch.phoneme_ids, batch.text_lengths, batch.audio,
                      batch.spec_lengths, batch.speaker_ids)))
        gen.manual_seed(mix_seed(config.seed + 1, i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, generator=gen)
        losses.append({k: float(v) for k, v in metrics.items()})
        times.append((time.perf_counter() - t0) * 1000)
    return losses, times


def loss_errors(got, want) -> typing.List[float]:
    """Each step's largest relative difference of the losses."""
    return [max(abs(g[k] - w[k]) / abs(w[k]) for k in w)
            for g, w in zip(got, want)]


def tp_train_path(root: Path, card_line: str):
    """The GAN train step on a dp 1 x tp 2 mesh in one process (phase 18):
    ``[cuda:0]x2``, or ``cuda:0,1`` with two cards, from ``[train]``'s
    weights and data, ``TP_TRAIN_STEPS`` steps at batch ``TRAIN_BATCH``
    against the same steps on one device: losses within ``DP_STEP1_RTOL``
    (step 1) and ``DP_LATER_RTOL`` (later), the gathered parameters within
    2 lr per step, the reductions and gathers per step, step time and
    peak memory.  Returns (kernel launches, the one-device run's
    losses)."""
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.ops import resblock, stage
    from mimic3_tpu_torch.parallel import gather_params, make_mesh
    from mimic3_tpu_torch.parallel import tensor as tpt
    from mimic3_tpu_torch.runtime.convert import to_torch_train_params

    t_phase = time.perf_counter()
    _, config, params, disc, utts = train_inputs(root)
    cards = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if cards > 1 else ["cuda:0"] * 2
    dev = torch.device("cuda:0")
    stage.launches = resblock.launches = 0

    def peak_gb():
        return [torch.cuda.max_memory_allocated(d) / 1e9
                for d in sorted(set(devices))]

    def reset_peak():
        torch.cuda.synchronize()
        for d in sorted(set(devices)):
            torch.cuda.reset_peak_memory_stats(d)

    reset_peak()
    one = T.init_train_state(to_torch_train_params(params, dev),
                             to_torch_train_params(disc, dev), config)
    one_losses, one_ms = run_steps(one, config, utts, dev)
    one_peak = peak_gb()
    def named(st, params):
        return {f"{k}.{n}": t.detach().cpu() for k, tree in (
            ("g", params), ("d", st.disc_params))
            for n, t in T.tree_leaves(tree)}

    want = named(one, one.params)
    del one
    torch.cuda.empty_cache()

    reset_peak()
    mesh = make_mesh(devices=devices, tp=2)
    state = T.init_train_state(to_torch_train_params(params),
                               to_torch_train_params(disc), config,
                               mesh=mesh, use_tp=True)
    tpt.gathers = tpt.reductions = 0
    tp_losses, tp_ms = run_steps(state, config, utts, dev)
    per_step = (tpt.reductions / TP_TRAIN_STEPS,
                tpt.gathers / TP_TRAIN_STEPS)
    tp_peak = peak_gb()
    got = named(state, gather_params(state.params))
    hp = T.VitsModel(config.model).hp
    expect = (hp.n_layers, len(hp.upsample_rates))
    rel = loss_errors(tp_losses, one_losses)
    drift = max(float((got[n] - w).abs().max()) for n, w in want.items())
    bound = 2 * config.learning_rate * TP_TRAIN_STEPS
    n_kernels = stage.launches + resblock.launches
    say("tp_train", f"dp1xtp2 over {devices}, {TP_TRAIN_STEPS} steps at "
        f"batch {TRAIN_BATCH} x {config.segment_size} samples against one "
        f"device: losses max rel diff per step "
        f"{', '.join(f'{r:.3e}' for r in rel)} (bars: step 1 "
        f"{DP_STEP1_RTOL:g}, later {DP_LATER_RTOL:g}); gathered parameters "
        f"max abs diff {drift:.3e} (bar 2 lr per step: {bound:g})")
    say("tp_train", f"per step {per_step[0]:g} reductions, {per_step[1]:g} "
        f"gathers (expected {expect[0]}, {expect[1]}); step ms (steps "
        f"1-{TP_TRAIN_STEPS}): tp {[round(t, 1) for t in tp_ms]}, one "
        f"device {[round(t, 1) for t in one_ms]}; peak memory GB: tp "
        f"{[round(g, 2) for g in tp_peak]}, one device "
        f"{[round(g, 2) for g in one_peak]}; kernel launches {n_kernels} "
        f"({card_line})")
    say("tp_train", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    if not (rel[0] <= DP_STEP1_RTOL
            and all(r <= DP_LATER_RTOL for r in rel[1:])):
        raise AssertionError("the tp train step's losses disagree with one "
                             "device")
    if not drift <= bound:
        raise AssertionError("the tp-trained parameters stray from one "
                             "device's")
    if per_step != expect:
        raise AssertionError(f"collectives per tp train step {per_step}")
    if n_kernels:
        raise AssertionError("the tp train step launched a kernel")
    return n_kernels, one_losses


def tp_mp_path(root: Path, voice_dir: Path, card_line: str, one_losses):
    """tp rows across processes (phase 19): this script's
    :func:`tp_mp_worker` in as many ranks under ``torch.distributed.run``
    over ``make_global_mesh(tp=2)``: on one card 2 gloo ranks on cuda:0
    (dp 1 x tp 2; NCCL refuses two ranks on one device), on four cards dp
    2 x tp 2 over NCCL on cuda:0..3.  Serving: every rank gets every row
    within 2e-5 of the one-device kernel-off session with equal durations;
    training: ``TP_TRAIN_STEPS`` steps whose losses are held to the
    one-process run's at the ``DP_*`` bars, and every parameter leaf or
    part bitwise equal on the ranks that hold it.  Returns the ranks'
    kernel launches."""
    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.parallel.distributed import backend_for
    from mimic3_tpu_torch.runtime.convert import load_pytree_npz
    from mimic3_tpu_torch.runtime.session import TorchVitsSession
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    nproc = 4 if cards >= 4 else 2
    backend = backend_for(torch.device("cuda", 0), local_world=nproc)
    work = root / "tp_mp"
    work.mkdir()
    serve_dir = voice_copy(voice_dir, root / "en_US" / "tp_mp_low",
                           speculative_decode=False,
                           pallas_stage_max_channels=0)
    voice = load_from_directory(serve_dir, share_sessions=False,
                                deterministic=True)
    seqs = [phoneme_ids(voice, t) for t in DP_TEXTS]
    (work / "in.json").write_text(json.dumps(dict(
        serve_dir=str(serve_dir), seqs=seqs, root=str(root))))
    config = TrainingConfig.load_path(serve_dir / "config.json")
    single = TorchVitsSession(config,
                              load_pytree_npz(serve_dir / "generator.npz"),
                              deterministic=True, device="cuda:0")
    want = single.synthesize_ids_batch(seqs, **TP_MP_DET)
    want_durations = replica_durations(single, seqs)
    hp = single.model.hp
    logs = work / "logs"
    del single, voice
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc, text = run_group([
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(nproc), "--redirects", "3", "--log-dir",
        str(logs), str(REPO / "chip_smoke.py"), "--tp-mp-worker", str(work),
    ], timeout=600)
    wall = time.perf_counter() - t0
    ranks = sorted(work.glob("out_*.json"))
    if rc != 0 or len(ranks) != nproc:
        raise AssertionError(f"{nproc}-rank tp run failed (rc {rc}):\n"
                             + text[-3000:] + "".join(
                                 p.read_text()[-3000:]
                                 for p in logs.rglob("stderr.log")))
    outs = [json.loads((work / f"out_{r}.json").read_text())
            for r in range(nproc)]
    errs = []
    for r in range(nproc):
        got = np.load(work / f"infer_{r}.npz")
        audio = [got[f"arr_{i}"] for i in range(len(seqs))]
        errs.append(max(float(np.abs(a - b).max()) if a.shape == b.shape
                        else np.inf for a, b in zip(audio, want)))
        if not np.array_equal(got["durations"], want_durations):
            errs[-1] = np.inf
    expect = [2 * hp.n_layers, len(hp.upsample_rates)]
    o = outs[0]
    say("tp_mp", f"{nproc} ranks, backend {o['backend']}, mesh "
        f"{o['shape']} over {[x['device'] for x in outs]}, run wall "
        f"{wall:.1f} s (launch, init, serving and training included)")
    say("tp_mp", f"serving (f32, deterministic) against one device, kernel "
        f"off: max abs err per rank {', '.join(f'{e:.3e}' for e in errs)} "
        f"(bar 2e-5, durations equal); per call "
        f"{[x['collectives'] for x in outs]} reductions, gathers (expected "
        f"{expect} per rank); wall ms per call at B=1 / 4: "
        f"{[x['wall_ms'] for x in outs]}; in collectives: "
        f"{[x['collective_ms'] for x in outs]} ms per call at B=4 "
        f"({card_line})")
    rel = loss_errors(o["losses"], one_losses)
    say("tp_mp", f"training, {TP_TRAIN_STEPS} steps at global batch "
        f"{TRAIN_BATCH}: losses against one process, max rel diff per "
        f"step {', '.join(f'{r:.3e}' for r in rel)} (bars: step 1 "
        f"{DP_STEP1_RTOL:g}, later {DP_LATER_RTOL:g}); step ms per rank "
        f"{[[round(t, 1) for t in x['step_ms']] for x in outs]}")
    holders: typing.Dict[str, typing.Set[str]] = {}
    for x in outs:
        for name, digest in x["digests"].items():
            holders.setdefault(name, set()).add(digest)
    split = [n for n in holders if n.endswith("]")]
    differ = [n for n, d in holders.items() if len(d) != 1]
    say("tp_mp", f"parameters after {TP_TRAIN_STEPS} steps: {len(holders)} "
        f"leaves and parts ({len(split)} parts), {len(differ)} differing "
        f"between the ranks that hold them; kernel launches "
        f"{sum(x['launches'] for x in outs)}")
    say("tp_mp", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    if o["backend"] != backend or any(x["backend"] != backend for x in outs):
        raise AssertionError(f"expected backend {backend}")
    if not all(e <= 2e-5 for e in errs):
        raise AssertionError("tp across processes: audio disagrees with one "
                             "device")
    if any(x["collectives"] != expect for x in outs):
        raise AssertionError("tp across processes: collectives per call")
    if any(x["losses"] != o["losses"] for x in outs):
        raise AssertionError("the ranks logged different losses")
    if not (rel[0] <= DP_STEP1_RTOL
            and all(r <= DP_LATER_RTOL for r in rel[1:])):
        raise AssertionError("tp across processes: losses disagree with one "
                             "process")
    if differ or not split:
        raise AssertionError(f"ranks differ on {differ[:5]}")
    n = sum(x["launches"] for x in outs)
    if n:
        raise AssertionError("the tp ranks launched a kernel")
    return n


def replica_durations(session, seqs) -> np.ndarray:
    """Replica 0's integer durations for ``seqs`` padded as the session
    pads them (every rank of a tp row that spans processes calls this)."""
    ids, lengths, sid = session._pad(seqs, None, "duration")
    rep = session._replicas[0]
    durations, _ = session.model.infer_durations(
        rep.params, session._put(ids, rep.device),
        session._put(lengths, rep.device), 3, 1.0, 0.0,
        sid=session._sid(sid, rep.device))
    return durations.cpu().numpy()


def tp_mp_worker(work: Path) -> int:
    """One rank of :func:`tp_mp_path`, under ``torch.distributed.run``:
    serves the inputs of ``work/in.json`` over ``make_global_mesh(tp=2)``
    (the wall per call, and the time spent in the row's collectives,
    synchronised one by one), trains ``TP_TRAIN_STEPS`` steps on its dp
    row's rows, and writes ``out_RANK.json`` and ``infer_RANK.npz``."""
    import hashlib

    import torch.distributed as dist

    from mimic3_tpu_torch.config import TrainingConfig
    from mimic3_tpu_torch.models.vits import train as T
    from mimic3_tpu_torch.ops import resblock, stage
    from mimic3_tpu_torch.parallel import (
        initialize_distributed,
        make_global_mesh,
        process_local_batch_slice,
    )
    from mimic3_tpu_torch.parallel import tensor as tpt
    from mimic3_tpu_torch.parallel.distributed import local_device
    from mimic3_tpu_torch.runtime.convert import (
        load_pytree_npz,
        to_torch_train_params,
    )
    from mimic3_tpu_torch.runtime.session import TorchVitsSession

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = json.loads((work / "in.json").read_text())
    initialize_distributed()
    rank = dist.get_rank()
    device = local_device()
    mesh = make_global_mesh(tp=2)
    stage.launches = resblock.launches = 0
    out = dict(backend=dist.get_backend(), shape=mesh.shape,
               device=str(device))

    serve_dir = Path(inp["serve_dir"])
    seqs = inp["seqs"]
    session = TorchVitsSession(
        TrainingConfig.load_path(serve_dir / "config.json"),
        load_pytree_npz(serve_dir / "generator.npz"), deterministic=True,
        mesh=mesh, use_tp=True)
    tpt.gathers = tpt.reductions = 0
    audio = session.synthesize_ids_batch(seqs, **TP_MP_DET)
    out["collectives"] = [tpt.reductions, tpt.gathers]
    np.savez(work / f"infer_{rank}.npz", *audio,
             durations=replica_durations(session, seqs))
    out["wall_ms"] = [round(time_session(session, seqs[:rows], 5)[0] * 1000,
                            1) for rows in (1, 4)]
    # the time of each of the row's collectives in one call at B=4
    spent = []
    real = tpt._all_reduce, tpt._all_gather

    def timed(fn):
        def run(*args):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            result = fn(*args)
            torch.cuda.synchronize(device)
            spent.append(time.perf_counter() - t0)
            return result
        return run

    tpt._all_reduce, tpt._all_gather = map(timed, real)
    try:
        session.synthesize_ids_batch(seqs[:4])
    finally:
        tpt._all_reduce, tpt._all_gather = real
    out["collective_ms"] = [round(sum(spent) * 1000, 2), len(spent)]

    smoke_root = Path(inp["root"])
    _, config, params, disc, utts = train_inputs(smoke_root)
    state = T.init_train_state(to_torch_train_params(params),
                               to_torch_train_params(disc), config,
                               mesh=mesh, use_tp=True)
    out["losses"], out["step_ms"] = run_steps(
        state, config, utts, device,
        process_local_batch_slice(TRAIN_BATCH, mesh))
    out["digests"] = {
        f"{tree}.{name}": hashlib.sha256(
            t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
        for tree, leaves in (("g", state.g_leaves), ("d", state.d_leaves))
        for name, t in leaves
    }
    out["launches"] = stage.launches + resblock.launches
    (work / f"out_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the end-to-end proofs: the teacher -> student round trip, the server SLO
# ---------------------------------------------------------------------------

# [roundtrip]'s depth: two milestones (the second resumes from the first's
# checkpoint), two held-out sentences; the reference protocol's student,
# batch and data otherwise
ROUNDTRIP_EVAL_AT = "100,200"
ROUNDTRIP_HELDOUT = 2
ROUNDTRIP_TRAIN = 72  # the script's default --n-train
# the trainer's log line: step N {metrics} (R steps/s)
TRAIN_LOG = re.compile(r"step (\d+) (\{[^}]*\}) \(([\d.]+) steps/s\)")


def roundtrip_path(root: Path, card_line: str) -> int:
    """The port's teacher -> student round trip on the card (phase 20):
    ``python -m mimic3_tpu_torch.scripts.train_roundtrip`` in its own
    process at ``ROUNDTRIP_EVAL_AT`` (training through mimic3-torch-train,
    export, the held-out sentences and the deterministic double-run
    through the CLI, one process each); then the exported student in
    process through the engine, deterministic, against a third CLI
    process's WAV.  At the last milestone every held-out sentence must
    correlate with the teacher better than unrelated text does (the
    baseline); the reference's 0.72 bar on the mean is for its 3000
    steps.  Returns the stage launches of the in-process call."""
    from mimic3_tpu_torch.engine import Mimic3Settings, Mimic3TextToSpeechSystem
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.voice import load_from_directory
    from mimic3_tpu_torch.scripts.train_roundtrip import _texts, synth_cli

    work = root / "roundtrip"
    t0 = time.perf_counter()
    rc, out = run_group(
        [sys.executable, "-m", "mimic3_tpu_torch.scripts.train_roundtrip",
         "--eval-at", ROUNDTRIP_EVAL_AT, "--n-heldout",
         str(ROUNDTRIP_HELDOUT), "--threshold", "-1", "--workdir",
         str(work), "--keep", "--device", "cuda"],
        timeout=900,
    )
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"train_roundtrip failed (rc={rc}):\n"
                             f"{out[-3000:]}")
    result = next(json.loads(line) for line in reversed(out.splitlines())
                  if line.startswith('{"steps"') and "curve" in line)
    logged = [(int(m[1]), ast.literal_eval(m[2]), float(m[3]))
              for m in TRAIN_LOG.finditer(out)]
    voices = work / "voices"
    student = voices / "en_US" / "student_low"
    milestones = [int(s) for s in ROUNDTRIP_EVAL_AT.split(",")]
    if not (student / "generator.npz").is_file():
        raise AssertionError("the round trip exported no generator.npz")
    if [p["steps"] for p in result["curve"]] != milestones:
        raise AssertionError(f"curve points {result['curve']}")
    if not result["deterministic_hash"]:
        raise AssertionError("two CLI processes gave different WAVs")
    if [s for s, _, _ in logged] != milestones:
        raise AssertionError(f"trainer log steps {[s for s, _, _ in logged]}")
    for point in result["curve"]:
        say("roundtrip", f"{point['steps']} steps: held-out mel corr "
            f"{point['mean_corr']} mean / {point['min_corr']} min over "
            f"{ROUNDTRIP_HELDOUT} sentences (CLI on the card), unrelated-"
            f"text baseline {result['baseline_cross_corr']}")
    if not result["curve"][-1]["min_corr"] > result["baseline_cross_corr"]:
        raise AssertionError("a held-out sentence is no closer to the "
                             "teacher than unrelated text")
    say("roundtrip", f"loss_mel step {logged[0][0]} "
        f"{logged[0][1]['loss_mel']:.4f} -> step {logged[-1][0]} "
        f"{logged[-1][1]['loss_mel']:.4f}; "
        + ", ".join(f"{r:.2f} steps/s to step {s}" for s, _, r in logged)
        + f" (batch 8, {card_line}); two CLI processes byte-equal "
        f"(sha256 {result['sha256_heldout0'][:16]}); phase wall {wall:.1f} s")

    # the exported student in process, as the CLI runs it
    text = _texts(ROUNDTRIP_TRAIN + ROUNDTRIP_HELDOUT)[ROUNDTRIP_TRAIN]
    tts = Mimic3TextToSpeechSystem(Mimic3Settings(
        voices_directories=[str(voices)], use_deterministic_compute=True,
        noise_scale=0.0, noise_w=0.0, seed=0,
    ), device="cuda")
    tts.voice = "en_US/student_low"
    stage.launches = 0
    wav = tts.text_to_wav(text)
    launches = stage.launches
    fused = sorted(load_from_directory(
        student, deterministic=True).session.stage_weights)
    width = json.loads((student / "config.json").read_text())["model"][
        "upsample_initial_channel"]
    _, cli_wav = synth_cli(voices, "en_US/student_low", text)
    same_cli = hashlib.sha256(cli_wav).hexdigest() == result["sha256_heldout0"]
    lsb = int(np.abs(parse_wav(wav).astype(np.int32)
                     - parse_wav(cli_wav).astype(np.int32)).max())
    say("roundtrip", f"in-process engine WAV "
        f"{'byte-equal to' if wav == cli_wav else 'DIFFERS from'} the "
        f"CLI's ({len(wav)} bytes, max {lsb} LSB); a third CLI process "
        f"{'equal to' if same_cli else 'DIFFERS from'} the double-run; "
        f"f32 stage launches {launches}, fused stages at C = "
        f"{[width >> (i + 1) for i in fused]} (TF32 from 16, FFMA at 8)")
    if wav != cli_wav or not same_cli:
        raise AssertionError("the in-process student WAV differs from the "
                             "CLI's")
    if launches < 1:
        raise AssertionError("the student's synthesis launched no stage "
                             "kernel")
    return launches


def serve_load_path(card_line: str) -> None:
    """The port's two-phase server SLO load test on the card (phase 21):
    ``python -m mimic3_tpu_torch.scripts.serve_load_test`` at the
    reference's traffic (48 /api/tts requests at concurrency 16, first
    chunks at 1/4/16 streamers) against ``python -m
    mimic3_tpu_torch.server`` subprocesses on the full-width voice, the
    second warmed from the first's traffic profile.  Every WAV parses at
    22050 Hz (the script fails otherwise), no signature is first run on
    the hot path, and the scheduler batches (mean batch above 1).  The
    kernel runs in the server's process, where this script cannot count
    it: returns None."""
    t0 = time.perf_counter()
    rc, out = run_group(
        [sys.executable, "-m", "mimic3_tpu_torch.scripts.serve_load_test",
         "--device", "cuda"],
        timeout=900,
    )
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"serve_load_test failed (rc={rc}):\n"
                             f"{out[-3000:]}")
    result = next(json.loads(line) for line in reversed(out.splitlines())
                  if line.startswith('{"requests"'))
    lat = result["first_chunk_latency"]
    say("serve_load", f"{result['requests']} requests at concurrency "
        f"{result['concurrency']}: {result['served_audio_sec_per_sec']} "
        f"audio-s/s ({result['audio_sec_total']} s of audio in "
        f"{result['wall_s']} s), mean batch {result['mean_batch_size']:.3f} "
        f"over {result['batches']} batches, batch buckets "
        f"{result['batch_bucket_histogram']}; first chunk p50/p99 "
        + ", ".join(f"{k}: {v['p50_ms']}/{v['p99_ms']} ms"
                    for k, v in lat.items())
        + f"; warmup {result['warmup_wall_s']} s (profiled); hot-path "
        f"signatures {result['hot_path_compiles']} ({card_line}); phase "
        f"wall {wall:.1f} s")
    if result["requests"] != 48 or result["hot_path_compiles"] != 0:
        raise AssertionError("signatures first run on the hot path")
    if not result["mean_batch_size"] > 1:
        raise AssertionError("the scheduler never batched requests")
    return None


def host_probe(after: str, n: int = 4000) -> None:
    """The host's state after a phase: wall microseconds per tiny CUDA op
    (an add to a 1-element tensor, queued back to back), the Python
    threads alive, the objects the garbage collector tracks and one full
    collection's ms, and whether an autograd profiler is on.  The
    synthesis and train paths are host-bound (PERF.md), so what the
    earlier phases leave in the process shows in later phases' times."""
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x = x + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x = x + 1
    torch.cuda.synchronize()
    per_op = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1000
    say("host", f"after {after}: {per_op:.2f} us per op, "
        f"{threading.active_count()} threads "
        f"({sorted({t.name.split('-')[0] for t in threading.enumerate()})}), "
        f"{len(gc.get_objects())} objects tracked, full collection "
        f"{gc_ms:.1f} ms, autograd profiler on: "
        f"{torch.autograd.profiler._is_profiler_enabled}")


def main() -> int:
    # -- 1. environment ------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: this smoke run needs one")
    from mimic3_tpu_torch.ops import build, resblock, stage
    from mimic3_tpu_torch.runtime.session import STAGE_MAX_CHANNELS

    card_line = card()
    nvcc = subprocess.run(
        [build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {nvcc}")
    print(card_line, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build, one nvcc per source, together ---------------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda m: m.build_library(), (stage, resblock)))
    say("build", f"both kernels in {time.perf_counter() - t0:.1f} s")
    sass = {}
    for module in (stage, resblock):
        log = module.library_path().with_suffix(".log")
        regs = sorted({ln.split(":", 1)[1].strip() for ln in
                       log.read_text().splitlines() if "registers" in ln})
        say("build", f"{module.library_path().relative_to(REPO)} ptxas: "
            + " | ".join(regs))
        counts = sass_counts(module.library_path())
        say("sass", f"{module.library_path().name}: " + "; ".join(
            f"{k}: HMMA {v['HMMA']} (TF32 {v['TF32']}), HGMMA {v['HGMMA']}"
            for k, v in sorted(counts.items())
        ))
        sass[module] = {op: sum(v[op] for v in counts.values())
                        for op in ("HMMA", "HGMMA", "TF32")}
        if not sass[module]["HMMA"] + sass[module]["HGMMA"]:
            raise AssertionError(
                f"{module.library_path().name} has no tensor-core "
                "instruction"
            )
        # the f32 paths must run on TF32 tensor cores, not fall to FFMA
        f32_kernels = [k for k in counts if is_f32_kernel(k)]
        if not f32_kernels or any(counts[k]["TF32"] == 0
                                  for k in f32_kernels):
            raise AssertionError(
                f"{module.library_path().name}: an f32 instantiation has no "
                f"TF32 HMMA ({f32_kernels})"
            )

    # -- 3. stage kernel against plain ---------------------------------------------
    rng = np.random.RandomState(0)
    stage_results = {}
    for frames in FRAME_BUCKETS:
        t_in = frames * 128  # the 64-channel input of the last stage
        for dtype in (torch.float32, torch.bfloat16):
            for batch in (1, 4):
                stage_results[(32, frames, batch, dtype)] = check_stage(
                    f"last stage ups+stage+post, {frames} frames, B={batch}",
                    rng, 32, 64, True, batch, t_in, dtype,
                )
    # the gate sweep: the C=64 stage with its upsampler 128 -> 64
    for dtype in (torch.float32, torch.bfloat16):
        for frames in FRAME_BUCKETS:
            for batch in (1, 4):
                stage_results[(64, frames, batch, dtype)] = check_stage(
                    f"C=64 stage ups 128->64, {frames} frames, B={batch}",
                    rng, 64, 128, False, batch, frames * 64, dtype,
                )
    for dtype in (torch.float32, torch.bfloat16):
        check_stage("C=64 stage alone, 256 frames, B=1", rng, 64, None,
                    False, 1, 256 * 128, dtype)
    for dtype in (torch.float32, torch.bfloat16):
        check_stage("last stage, ragged length", rng, 32, 64, True, 1, 12345,
                    dtype)
        # C = 8, under the MMA depth: the FFMA kernel (stage_kernel), as
        # a voice with a narrow last stage gives it, then a ragged length
        check_stage("C=8 last stage ups 16->8+stage+post", rng, 8, 16, True,
                    1, 128 * 128, dtype)
        check_stage("C=8 last stage, ragged length", rng, 8, 16, True, 2,
                    12345, dtype)
    # each dtype's gate: the widest C at which the kernel is no slower
    # than plain at B=1 and B=4 in both frame buckets.  cuDNN's plain
    # times move between runs, so the session's gate is held to the sweep
    # within GATE_NOISE: it fails only if the kernel loses by more than
    # that at or below the gate, or wins by more than that in every case
    # one stage above it
    gates = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        gates[dtype] = 0
        held = STAGE_MAX_CHANNELS[dtype]
        all_won = True  # at every swept C so far
        for c in (32, 64):
            ratios = [stage_results[(c, f, b, dtype)].ms
                      / stage_results[(c, f, b, dtype)].plain_ms
                      for f in FRAME_BUCKETS for b in (1, 4)]
            wins = sum(r <= 1 for r in ratios)
            say("gate", f"{name} C={c}: kernel no slower than plain in "
                f"{wins} of {len(ratios)} cases (128/256 frames x B=1/4; "
                "kernel/plain " + ", ".join(f"{r:.3f}" for r in ratios)
                + ")")
            all_won = all_won and wins == len(ratios)
            if all_won:
                gates[dtype] = c
            if c <= held and max(ratios) > GATE_NOISE:
                raise AssertionError(
                    f"the {name} stage gate {held} engages C={c}, where the "
                    f"kernel loses to plain by more than {GATE_NOISE}x")
            if c > held and max(ratios) * GATE_NOISE < 1:
                raise AssertionError(
                    f"the {name} stage gate {held} leaves out C={c}, where "
                    f"the kernel beats plain by more than {GATE_NOISE}x")
        say("gate", f"{name} stage_max_channels from this sweep: "
            f"{gates[dtype]} (the session's default: {held}; held to the "
            f"sweep within {GATE_NOISE}x)")

    # -- 4. resblock kernel against plain -------------------------------------------
    # the cases of tests/test_pallas_ops.py, a ragged T, no bias, then C
    # at the decoder's stage lengths of a 256-frame bucket with the
    # largest halo (K=11, d=5), then the profiling shape
    for dtype in (torch.float32, torch.bfloat16):
        for c, t, b, k, d in ((8, 64, 1, 3, 1), (16, 256, 2, 3, 5),
                              (32, 256, 1, 11, 5), (16, 128, 2, 7, 3),
                              (32, 12345, 2, 7, 3)):
            check_resblock(rng, c, t, b, k, d, dtype)
        check_resblock(rng, 64, 1000, 2, 7, 3, dtype, bias=False)
        for c, t in ((32, 65536), (64, 32768), (128, 16384), (256, 2048)):
            check_resblock(rng, c, t, 1, 11, 5, dtype)
    res_results = {
        dtype: check_resblock(rng, 128, 65536, 16, 3, 5, dtype, iters=5)
        for dtype in (torch.float32, torch.bfloat16)
    }

    # -- 5-21. the paths -------------------------------------------------------------
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        voice_dir, plain_dir = make_voices(root)
        say("voice", f"full-width *_low test voice (random weights, seed "
            f"1234) in {time.perf_counter() - t0:.1f} s")
        launches = {}
        host_probe("start")
        launches["main"], det_launches = main_path(root, voice_dir,
                                                   plain_dir, card_line)
        res_launches, _ = profile_path()
        launches["streaming"] = streaming_path(voice_dir, card_line)
        launches["server"] = server_path(root, card_line)
        launches["onnx"] = onnx_path(root)
        launches["mbistft"] = mbistft_path(root, voice_dir, card_line)
        launches["speculate"] = speculate_path(root, voice_dir, card_line)
        host_probe("speculate, before train")
        launches["train"], launches["train_serve"], train_steps = (
            train_path(root, card_line))
        launches["dp"] = dp_path(root, voice_dir, card_line, train_steps)
        launches["tp"] = tp_path(root, voice_dir, card_line)
        launches["tp_train"], one_losses = tp_train_path(root, card_line)
        launches["tp_mp"] = tp_mp_path(root, voice_dir, card_line,
                                       one_losses)
        launches["roundtrip"] = roundtrip_path(root, card_line)
        launches["serve_load"] = serve_load_path(card_line)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the default (bf16) main path's last stage: 128 frames, B=1; the
    # deterministic (f32) main path's the same shape in f32
    rows = []
    for module, name, source, replaces, n, row, f32_row in (
        (stage, "hifigan_stage_fused", "stage.cu", "stage.py:399",
         sum(n for n in launches.values() if n is not None),
         stage_results[(32, 128, 1, torch.bfloat16)],
         stage_results[(32, 128, 1, torch.float32)]),
        (resblock, "fused_resblock_subblock", "resblock.cu",
         "resblock.py:136", res_launches, res_results[torch.bfloat16],
         res_results[torch.float32]),
    ):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"mimic3_tpu_torch/csrc/{source}",
            "replaces": f"mimic3_tpu/ops/{replaces}",
            "launches": n,
            "max_abs_err": row.err,
            "ms": row.ms,
            "plain_ms": row.plain_ms,
            "bound_ms": row.bound_ms,
            "bound_by": row.bound_by,
            "bound_share": row.bound_ms / row.ms,
            # no single PyTorch call computes either function: the plain
            # version's cuDNN chain is the library yardstick
            "library_ms": row.plain_ms,
            "tensor_core_instructions": sass[module],
            # the f32 path (three TF32 passes) at the same shape
            "f32_ms": f32_row.ms,
            "f32_plain_ms": f32_row.plain_ms,
            "f32_max_abs_err": f32_row.err,
            "f32_bound_ms": f32_row.bound_ms,
            "f32_ffma_bound_ms": f32_row.ffma_bound_ms,
            "f32_stage_gate": gates[torch.float32],
        })
    rows[0]["launches_by_path"] = launches
    # null counts: the kernel ran in a process this script cannot read
    rows[0]["launches_not_counted"] = {"serve_load": "server subprocess"}
    rows[0]["bf16_stage_gate"] = gates[torch.bfloat16]
    rows[0]["f32_launches_per_deterministic_call"] = det_launches
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--tp-mp-worker"]:
            sys.exit(tp_mp_worker(Path(sys.argv[2])))
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report and fail the run
        traceback.print_exc()
        sys.exit(1)
