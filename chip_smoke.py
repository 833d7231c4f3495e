"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the port's CUDA kernel from this checkout, holds it against its
plain PyTorch version at the decoder's shapes, then drives the port's main
path — engine -> voice -> session -> VITS -> WAV, in process and through
the CLI — on a full-width ``*_low`` voice with random weights made from a
seed, and checks that the path went through the kernel.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line with each kernel's launches,
error and times, then ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero, printing no result, when any phase fails or no card is
visible.  Needs no network and no JAX.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import wave
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
KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
# frame buckets of the kernel checks: 128 is the one the random voice's
# sentences decode in (about one frame per phoneme), 256 a longer sentence
FRAME_BUCKETS = (128, 256)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers
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


def check_kernel(name, rng, c, c_in, post, batch, t, dtype):
    """Kernel vs plain on the card; returns (max_abs_err, ms, plain_ms)."""
    from mimic3_tpu_torch.ops import stage

    dev = torch.device("cuda")
    rb, kw = stage_inputs(rng, c, c_in, post, dev)
    weights = stage.pack_stage_weights(rb, KERNELS, DILATIONS, device=dev, **kw)
    x = torch.from_numpy(
        rng.randn(batch, c_in or c, t).astype(np.float32)
    ).to(dev, dtype)

    def kernel():
        return stage.hifigan_stage_fused(
            rb, x, KERNELS, DILATIONS, weights=weights, **kw
        )

    def plain():
        return stage.hifigan_stage_plain(rb, x, KERNELS, DILATIONS, **kw)

    got = kernel().float()
    ref = plain().float()
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        bound = 2e-4 + 1e-3 * ref.abs()
        if not bool(((got - ref).abs() <= bound).all()):
            raise AssertionError(f"{name}: max abs diff {err} over the bar")
        agree = f"max_abs_err={err:.3g} (bar 2e-4 + 1e-3*|ref|)"
    else:
        corr = float(np.corrcoef(got.cpu().numpy().ravel(),
                                 ref.cpu().numpy().ravel())[0, 1])
        if not corr > 0.999:
            raise AssertionError(f"{name}: bf16 correlation {corr}")
        agree = f"corr={corr:.6f} max_abs_err={err:.3g}"
    # in turns: plain, kernel, kernel, plain
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kernel)
    k2 = cuda_ms(kernel)
    p2 = cuda_ms(plain)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    say("kernel", f"{name} x={tuple(x.shape)} {str(dtype)[6:]}: {agree}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


# ---------------------------------------------------------------------------
# phases 4-7 helpers
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


def make_voices(root: Path):
    """Full-width test voice, plus a copy whose config keeps every decoder
    stage on the plain path (the end-to-end reference)."""
    from mimic3_tpu_torch.runtime.testvoice import create_test_voice

    voice = create_test_voice(root / "en_US" / "test_low", seed=1234)
    plain = root / "en_US" / "plain_low"
    plain.mkdir(parents=True)
    for name in ("phonemes.txt", "VERSION"):
        shutil.copy(voice / name, plain / name)
    os.symlink(voice / "generator.npz", plain / "generator.npz")
    config = json.loads((voice / "config.json").read_text())
    config["tpu"]["pallas_stage_max_channels"] = 0
    (plain / "config.json").write_text(json.dumps(config))
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


def main() -> int:
    # -- 1. environment ------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: this smoke run needs one")
    from mimic3_tpu_torch.engine import Mimic3Settings, Mimic3TextToSpeechSystem
    from mimic3_tpu_torch.ops import stage
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    card_line = card()
    nvcc = subprocess.run(
        [stage._find_nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    say("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {nvcc}")
    print(card_line, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    stage.build_library()
    say("build", f"{stage.library_path().relative_to(REPO)} in "
        f"{time.perf_counter() - t0:.1f} s")
    log = stage.library_path().with_suffix(".log")
    regs = sorted({ln.split(":", 1)[1].strip() for ln in
                   log.read_text().splitlines() if "registers" in ln})
    say("build", "ptxas: " + " | ".join(regs))

    # -- 3. kernel against plain, on the card ----------------------------------
    rng = np.random.RandomState(0)
    results = {}
    for frames in FRAME_BUCKETS:
        t_in = frames * 128  # the 64-channel input of the last stage
        for dtype in (torch.float32, torch.bfloat16):
            for batch in (1, 4):
                results[(frames, batch, dtype)] = check_kernel(
                    f"last stage ups+stage+post, {frames} frames, B={batch}",
                    rng, 32, 64, True, batch, t_in, dtype,
                )
    for dtype in (torch.float32, torch.bfloat16):
        check_kernel("C=64 stage alone, 256 frames, B=1", rng, 64, None,
                     False, 1, 256 * 128, dtype)
    check_kernel("last stage, ragged length", rng, 32, 64, True, 1, 12345,
                 torch.float32)

    # -- 4. voice ----------------------------------------------------------------
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        t0 = time.perf_counter()
        voice_dir, plain_dir = make_voices(root)
        say("voice", f"full-width *_low test voice (random weights, seed "
            f"1234) in {time.perf_counter() - t0:.1f} s")

        # -- 5. main path, in process ------------------------------------------
        stage.launches = 0
        det = Mimic3TextToSpeechSystem(Mimic3Settings(
            voices_directories=[str(root)], use_deterministic_compute=True,
            noise_scale=0.0, noise_w=0.0,
        ))
        det.voice = "en_US/test_low"
        det_wav = parse_wav(det.text_to_wav(TEXT))
        n_det = stage.launches
        default = Mimic3TextToSpeechSystem(
            Mimic3Settings(voices_directories=[str(root)], seed=7)
        )
        default.voice = "en_US/test_low"
        def_wav = parse_wav(default.text_to_wav(TEXT))
        n_default = stage.launches - n_det
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
            raise AssertionError("the main path did not launch the kernel")
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
        c_det = corr(det_wav, ref_wav)
        c_batch = min(corr(a, b) for a, b in zip(batch_out, plain_batch))
        say("check", f"kernel path vs plain path: deterministic f32 corr "
            f"{c_det:.6f}, bf16 batch min corr {c_batch:.6f}")
        if det_wav.size != ref_wav.size or not c_det >= 0.999:
            raise AssertionError("deterministic audio disagrees with plain")
        if [a.size for a in batch_out] != [a.size for a in plain_batch]:
            raise AssertionError("batch lengths disagree with plain")
        if not c_batch > 0.99:
            raise AssertionError("bf16 batch audio disagrees with plain")

        # -- 6. main path, CLI ---------------------------------------------------
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

        # -- 7. times (informative) ------------------------------------------------
        for label, v in (("kernel", voice), ("plain", plain_voice)):
            for batch in (1, 4):
                wall, rate = time_session(v.session, batch_ids[:batch], 5)
                say("time", f"{label} path, default mode, batch {batch}: "
                    f"{wall * 1000:.1f} ms per call, {rate:.1f} audio-s/s "
                    f"({card_line})")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the deterministic CLI path's shape and dtype: 128 frames, B=1, f32
    err, ms, plain_ms = results[(128, 1, torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "hifigan_stage_fused",
        "route": "cuda",
        "source": "mimic3_tpu_torch/csrc/stage.cu",
        "replaces": "mimic3_tpu/ops/stage.py:399",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — report and fail the run
        traceback.print_exc()
        sys.exit(1)
