"""Where the tensor-core stage kernel's time goes, on one card.

No profiler that looks inside a kernel runs on the card's machine, so this
builds variants of ``csrc/stage.cu`` with one part taken out (their
outputs are wrong; only their times count) or with another warp count,
and times each beside the unchanged kernel, in bf16 at the decoder's two
widest fused stages in the 256-frame bucket, B=4: the last stage (ups
64->32 + stage + post) and the C=64 stage with its upsampler 128->64.
Random weights made with numpy from seed 0.

    python -m mimic3_tpu_torch.scripts.ablate_stage [--loops 20]

Prints the card, then one JSON line per shape: ms per call of each
variant (CUDA events, after warm calls).  Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import shutil
import typing
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import build, stage
from ..runtime.convert import to_torch_params

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
_WARPS = "constexpr int kMmaWarps = C <= 32 ? 16 : 12;"
# variant -> (text patches of csrc/stage.cu, warps of a block or None)
VARIANTS: typing.Dict[str, typing.Tuple[typing.List[typing.Tuple[str, str]],
                                        typing.Optional[int]]] = {
    "kernel": ([], None),
    "no_mma": ([
        ("          if (half == 0)\n            conv_tile::conv_mma<",
         "          if (false)\n            conv_tile::conv_mma<"),
        ("          else\n            conv_tile::conv_mma<",
         "          else if (false)\n            conv_tile::conv_mma<"),
    ], None),
    "no_upsampler_fma": ([
        ("          const float* xr = xin + ci * lin + r;",
         "          if (ci >= 0) continue;\n"
         "          const float* xr = xin + ci * lin + r;"),
    ], None),
    "no_weight_staging": ([
        ("            wsm[i] = __ldg(wf + i);", "            ;"),
    ], None),
    "no_fragment_lrelu": ([
        ("conv_tile::conv_mma<1, NW, true,", "conv_tile::conv_mma<1, NW, false,"),
    ], None),
    "warps_8": ([(_WARPS, "constexpr int kMmaWarps = 8;")], 8),
    "warps_16": ([(_WARPS, "constexpr int kMmaWarps = 16;")], 16),
}


def build_variants() -> typing.Dict[str, ctypes.CDLL]:
    """Each variant's source, patched and built (one nvcc each, together)
    under the build directory beside a copy of its headers."""
    source = stage.SOURCE.read_text()
    root = stage.BUILD_DIR / "ablate"
    root.mkdir(parents=True, exist_ok=True)
    for header in build.source_files(stage.SOURCE)[1:]:
        shutil.copy(header, root / header.name)
    jobs = {}
    for name, (patches, _) in VARIANTS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the patch no longer applies")
            text = text.replace(old, new)
        path = root / f"stage_{name}.cu"
        path.write_text(text)
        jobs[name] = path

    def compile_one(path):
        out = build.library_path(path, root)
        build.compile_library(path, out)
        return out

    with ThreadPoolExecutor(len(jobs)) as pool:
        outs = dict(zip(jobs, pool.map(compile_one, jobs.values())))
    return {n: stage.bind(ctypes.CDLL(str(p))) for n, p in outs.items()}


@contextlib.contextmanager
def using(lib: ctypes.CDLL, warps: typing.Optional[int]):
    """Route ``hifigan_stage_fused`` to ``lib`` (and its warp count)."""
    saved = stage._LIB, stage.mma_warps
    stage._LIB = lib
    if warps is not None:
        stage.mma_warps = lambda channels: warps
    stage._pick_mma_rows_cached.cache_clear()
    try:
        yield
    finally:
        stage._LIB, stage.mma_warps = saved
        stage._pick_mma_rows_cached.cache_clear()


def _cuda_ms(fn: typing.Callable[[], torch.Tensor], loops: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(loops):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / loops


def _stage(rng, c, c_in, post, device):
    tree = {"resblocks": {
        str(r): {key: {str(j): {
            "weight": rng.randn(k, c, c).astype(np.float32) * 0.1,
            "bias": rng.randn(c).astype(np.float32) * 0.1,
        } for j in range(3)} for key in ("convs1", "convs2")}
        for r, k in enumerate(KERNELS)
    }}
    tree["ups"] = {"0": {
        "weight": rng.randn(4, c_in, c).astype(np.float32) * 0.1,
        "bias": rng.randn(c).astype(np.float32) * 0.1,
    }}
    if post:
        tree["conv_post"] = {
            "weight": rng.randn(7, c, 1).astype(np.float32) * 0.1
        }
    port = to_torch_params(tree, device)
    kw = dict(ups_params=port["ups"]["0"], ups_stride=2, ups_padding=1)
    if post:
        kw["post_params"] = port["conv_post"]
    return [port["resblocks"][str(r)] for r in range(3)], kw


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--loops", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: this profile needs one")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    libs = build_variants()
    rng = np.random.RandomState(0)
    result = {}
    for name, c, c_in, post, t_in in (
        ("last stage, 256 frames, B=4", 32, 64, True, 256 * 128),
        ("C=64 stage + ups, 256 frames, B=4", 64, 128, False, 256 * 64),
    ):
        rb, kw = _stage(rng, c, c_in, post, dev)
        weights = stage.pack_stage_weights(rb, KERNELS, DILATIONS,
                                           device=dev, **kw)
        x = torch.from_numpy(
            rng.randn(4, c_in, t_in).astype(np.float32)
        ).to(dev, torch.bfloat16)
        times = {}
        for variant, lib in libs.items():
            with using(lib, VARIANTS[variant][1]):
                times[variant] = _cuda_ms(
                    lambda: stage.hifigan_stage_fused(
                        rb, x, KERNELS, DILATIONS, weights=weights, **kw
                    ),
                    args.loops,
                )
        result[name] = times
        print(json.dumps({name: times}), flush=True)
    return result


if __name__ == "__main__":
    main()
