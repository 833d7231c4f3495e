"""Fused resblock step on one card: the CUDA kernel against plain PyTorch.

Counterpart of ``scripts/profile_resblock.py`` (Pallas against XLA on a
TPU).  Same shape and dtype, the HiFi-GAN stage-2 activation of a batch
of 16 x 1024 frames: x ``[B=16, C=128, T=65536]`` bf16, K=3, d=5, with
random weights made with numpy from seed 0.  Each side runs ``--loops``
launches between two CUDA events, in turns (plain, kernel, kernel,
plain); FLOPs count both convs, ``2*2*B*T*C*C*K`` per call.

    python -m mimic3_tpu_torch.scripts.profile_resblock [--loops 16]

Prints the card, one JSON line per side
(``{"plain": {"ms_per_subblock": ..., "tflops": ...}}``, then
``{"kernel": ...}``) and one line holding the two outputs' agreement.
Needs an NVIDIA card: without one it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import typing

import numpy as np
import torch

from ..ops import resblock


def _cuda_ms(fn: typing.Callable[[], torch.Tensor], loops: int) -> float:
    """Milliseconds per call over ``loops`` calls, after one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(loops):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / loops


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--loops", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: this profile needs one")

    dev = torch.device("cuda")
    dtype = torch.bfloat16
    b, t, c, k, d = 16, 65536, 128, 3, 5
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(b, c, t).astype(np.float32)).to(dev, dtype)
    bound = 1.0 / math.sqrt(c * k)  # torch Conv1d's default init range

    def uniform(*shape):
        return torch.from_numpy(
            rng.uniform(-bound, bound, shape).astype(np.float32)
        ).to(dev)

    w1, b1, w2, b2 = uniform(c, c, k), uniform(c), uniform(c, c, k), uniform(c)
    packed = resblock.pack_subblock_weights(w1, b1, w2, b2, dtype, dev)
    kw = dict(kernel_size=k, dilation=d)

    def plain() -> torch.Tensor:
        return resblock.resblock_subblock_plain(x, w1, b1, w2, b2, **kw)

    def kernel() -> torch.Tensor:
        return resblock.fused_resblock_subblock(
            x, w1, b1, w2, b2, weights=packed, **kw
        )

    def corr(a: torch.Tensor, b: torch.Tensor) -> float:
        return float(torch.corrcoef(torch.stack([a.ravel(), b.ravel()]))[0, 1])

    got, ref = kernel().float(), plain().float()
    torch.cuda.synchronize()
    check = {
        "max_abs_err": float((got - ref).abs().max()),
        "corr": corr(got, ref),
        # the branches out - x: the output is mostly x itself, so a fault
        # in the convs shows far more here
        "branch_corr": corr(got - x.float(), ref - x.float()),
        "finite": bool(torch.isfinite(got).all()),
    }
    del got, ref

    flops = 2 * 2 * b * t * c * c * k
    p1 = _cuda_ms(plain, args.loops)
    k1 = _cuda_ms(kernel, args.loops)
    k2 = _cuda_ms(kernel, args.loops)
    p2 = _cuda_ms(plain, args.loops)
    result = {"check": check}
    for name, ms in (("plain", (p1 + p2) / 2), ("kernel", (k1 + k2) / 2)):
        result[name] = {
            "ms_per_subblock": ms,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        print(json.dumps({name: result[name]}), flush=True)
    print(json.dumps({"check": check}), flush=True)
    return result


if __name__ == "__main__":
    main()
