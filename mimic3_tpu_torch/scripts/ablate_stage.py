"""Where the tensor-core stage kernel's time goes, on one card.

No profiler that looks inside a kernel runs on the card's machine, so this
builds variants of ``csrc/stage.cu`` (and of the tile it includes) with
one part taken out (their outputs are wrong; only their times count), with
another warp or warpgroup count, or with another design choice, and times
each beside the unchanged kernel at the decoder's fused stages:

- bf16 (the warpgroup MMA): both stages at the synth cells' 16 rows x
  1024 frames (the C=64 stage with its upsampler 128->64, the last stage
  ups 64->32 + stage + post) and the last stage at 128 frames, B=1;
- f32 (three TF32 passes): the last stage at 128 frames, B=1 (the
  deterministic main path) and at 256 frames, B=4, and the C=64 stage
  alone at 256 frames, B=1 (the widest f32 stage, the one where a single
  MMA accumulator misses the f32 bar).  The f32 variants also
  report how far each lands from the plain float32 path and from the
  plain path in float64 (its f32 ``conv_post`` head aside), as the
  largest share of the port's bar ``2e-4 + 1e-3 |ref|`` (the flush
  variants move precision, not only time).

Random weights made with numpy from seed 0.

    python -m mimic3_tpu_torch.scripts.ablate_stage [--loops 20]
        [--dtype bfloat16|float32]

Prints the card, then one JSON line per shape: ms per call of each
variant (CUDA events, after warm calls) and, in f32, its shares of the
bar against plain f32 (``bar_share``) and float64 (``bar_share_f64``).
Needs an NVIDIA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import typing
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import build, stage
from ..runtime.convert import to_torch_params

KERNELS = (3, 7, 11)
DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
# the bf16 stage's MMA issue (stage.cu wgmma_pass); step is -1 in the
# upsampler's passes alone
_WGMMA = "          wgmma_rs(acc[s], ak[s][0], b_desc(wb + kc * (C / 8) * 256));"
_WARPGROUPS = "constexpr int kWarpgroups = 3;"
_WG_SLOTS = "constexpr int kSlots = C == 64 ? 2 : C == 32 ? 4 : 6;"
# the ring's consumer side (stage.cu Ring::acquire) and its producer
_ACQUIRE = """    const int slot = next % R;
    mbar_wait(full + slot, (next / R) & 1);
    __syncwarp();
    ++next;
    return conv_tile::smem_addr(slots + (size_t)slot * C * C * 2);"""
_SYNC_ACQUIRE = """    const int slot = next % R;
    uint4* dst = (uint4*)(slots + (size_t)slot * C * C * 2);
    const uint4* blk = src + (size_t)next * (C * C / 8);
    for (int i = threadIdx.x; i < C * C / 8; i += nthreads)
      dst[i] = __ldg(blk + i);
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\\n" :: "r"(nthreads) : "memory");
    ++next;
    return conv_tile::smem_addr(slots + (size_t)slot * C * C * 2);"""
_TF32_WARPS = "constexpr int kTf32Warps = C <= 32 ? 16 : 8;"
_TF32_SLOTS = "constexpr int kTf32Slots = 2;"
# the shipped TF32 tile (conv_tile.cuh tap_tf32): each K chunk's three
# passes into a fresh accumulator, added into the sum after the chunk
_CHUNK_PART = ("    float part[MW][NW][4];  // this K chunk's three passes\n"
               "    zero(part);\n")
_CHUNK_LOOP = ("#pragma unroll 2\n  for (int kc = 0; kc < kcs; ++kc) {\n"
               "    uint32_t hi[MW][4]")
_CHUNK_ADD = "    add_into(acc, part);\n  }\n}\n"
# the cp.async ring: two shared-memory slots of one tap's TF32 fragments
# each, tap g + 1 landing while the MMAs of tap g run, one barrier per tap
_RING_HELPERS = r"""__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(conv_tile::smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

"""
_RING_PREFETCH = """  int n_taps = 0;  // tap blocks of the resblock convs
  for (int m = 0; m < 2 * n_res * n_steps; ++m) n_taps += plan[conv + m].z;
  // block 0 lands while the stage input is computed
  for (int i = threadIdx.x; i < kTap; i += kThreads)
    cp_async16(ring + i, frags + i);
  cp_async_commit();
"""
_RING_TAP = """          // block g has landed and every warp is done with block g - 1:
          // its slot takes block g + 1
          cp_async_wait_all();
          __syncthreads();
          if (g + 1 < n_taps) {
            uint4* slot = ring + ((g + 1) & 1) * kTap;
            const uint4* next = frags + (size_t)(g + 1) * kTap;
            for (int i = threadIdx.x; i < kTap; i += kThreads)
              cp_async16(slot + i, next + i);
          }
          cp_async_commit();
          const uint4* wt = ring + (g & 1) * kTap;
"""
_STAGE_INPUT_F32 = "  stage_input<C, kThreads>(x, x0, p.ld, s, w, b, plan[0]"
_PLAN_F32 = "  const StagePlan p(C, tile, halo, post_pad, 4, 0);\n"


def _warpgroups(wgs: int, slots: typing.Dict[int, int]) -> "Variant":
    return Variant([
        ("stage.cu", _WARPGROUPS, f"constexpr int kWarpgroups = {wgs};"),
        ("stage.cu", _WG_SLOTS,
         f"constexpr int kSlots = C == 64 ? {slots[64]} : C == 32 ? "
         f"{slots[32]} : {slots[16]};"),
    ], wgs=(wgs, slots))


def _tf32_shape(warps: int, slots: int) -> typing.List[typing.Tuple[str, str,
                                                                  str]]:
    return [("stage.cu", _TF32_WARPS, f"constexpr int kTf32Warps = {warps};"),
            ("stage.cu", _TF32_SLOTS, f"constexpr int kTf32Slots = {slots};")]


class Variant(typing.NamedTuple):
    """Text patches (file under csrc/, old, new), applied in order, each
    to exactly one place; the warps of a TF32 block the wrapper must plan
    for (None: unchanged); in f32, whether the TF32 fragments go through
    the cp.async ring (the block plan then counts its two slots), and the
    M-tile slots of a warp (None: unchanged); in bf16, the consumer
    warpgroups of a block and the 64-row M tiles each holds per pass, by
    C, that the wrapper must plan for (None: unchanged)."""

    patches: typing.List[typing.Tuple[str, str, str]]
    warps: typing.Optional[int] = None
    ring: bool = False
    slots: typing.Optional[int] = None
    wgs: typing.Optional[typing.Tuple[int, typing.Dict[int, int]]] = None


BF16_VARIANTS: typing.Dict[str, Variant] = {
    "kernel": Variant([]),
    # every MMA of the stage (the ring still streams, the epilogues run)
    "no_mma": Variant([("stage.cu", _WGMMA, "          if (false)\n  " + _WGMMA)]),
    "no_upsampler_mma": Variant([
        ("stage.cu", _WGMMA, "          if (step != -1)\n  " + _WGMMA)]),
    # the ring replaced by synchronous staging: the consumers copy each
    # block themselves, then meet at a barrier; no producer copies
    "sync_staging": Variant([
        ("stage.cu", "  int next = 0;  // blocks taken so far\n",
         "  int next = 0;  // blocks taken so far\n"
         "  const uint4* src;\n  int nthreads;\n"),
        ("stage.cu", _ACQUIRE, _SYNC_ACQUIRE),
        ("stage.cu", "  Ring<C, R> ring{slots, full, empty};",
         "  Ring<C, R> ring{slots, full, empty, 0,\n"
         "                  reinterpret_cast<const uint4*>(blocks), "
         "kThreads};"),
        ("stage.cu", "    if (threadIdx.x == kThreads) {", "    if (false) {"),
    ]),
    # the passes' epilogues (bias, activation, residual, sum) left out;
    # each accumulator still feeds a sum that is almost never stored, or
    # the compiler would drop the MMAs whose results go unread
    "no_epilogue": Variant([
        ("stage.cu", "  float bb[C / 8][2];\n",
         "  float sink = 0.f;\n  float bb[C / 8][2];\n"),
        ("stage.cu", "      for (int j = 0; j < C / 8; ++j)\n"
         "        f(r, conv_tile::acc_col(j, 0),",
         "      for (int j = 0; j < C / 8; ++j) {\n"
         "        sink += acc[s][j][2 * h] + acc[s][j][2 * h + 1];\n"
         "        if (false) f(r, conv_tile::acc_col(j, 0),"),
        ("stage.cu", "          acc[s][j][2 * h + 1] + bb[j][1]);\n    }\n  }\n}",
         "          acc[s][j][2 * h + 1] + bb[j][1]);\n      }\n    }\n  }\n"
         "  if (sink == 1.2345e-30f) f(0, 0, sink, sink);\n}"),
    ]),
    # one or two consumer warpgroups (three shipped), each holding more
    # M tiles so that a pass still covers the rows the wrapper plans
    "wgs_1": _warpgroups(1, {16: 12, 32: 8, 64: 4}),
    "wgs_2": _warpgroups(2, {16: 8, 32: 5, 64: 3}),
}
F32_VARIANTS: typing.Dict[str, Variant] = {
    "kernel": Variant([]),
    "no_mma": Variant([
        ("stage.cu", "          if (half == 0)\n            conv_tile::tap_tf32<",
         "          if (false)\n            conv_tile::tap_tf32<"),
        ("stage.cu", "          else\n            conv_tile::tap_tf32<",
         "          else if (false)\n            conv_tile::tap_tf32<"),
    ]),
    "no_upsampler_fma": Variant([
        ("stage.cu", "          const float* xr = xin + ci * lin + r;",
         "          if (ci >= 0) continue;\n"
         "          const float* xr = xin + ci * lin + r;"),
    ]),
    # where the MMA sums go: one accumulator over the whole conv, or a
    # fresh one per tap, instead of one per K chunk
    "one_accumulator": Variant([
        ("conv_tile.cuh", _CHUNK_PART,
         "    float(&part)[MW][NW][4] = acc;  // one accumulator\n"),
        ("conv_tile.cuh", "    add_into(acc, part);\n", ""),
    ]),
    "flush_per_tap": Variant([
        ("conv_tile.cuh", _CHUNK_PART, ""),
        ("conv_tile.cuh", _CHUNK_LOOP,
         "  float part[MW][NW][4];  // this tap's three passes\n"
         "  zero(part);\n" + _CHUNK_LOOP),
        ("conv_tile.cuh", _CHUNK_ADD, "  }\n  add_into(acc, part);\n}\n"),
    ]),
    # the TF32 fragments through a two-slot cp.async ring in shared memory
    # instead of the read-only cache
    "ring": Variant([
        ("stage.cu", "// The stage of stage_mma_kernel in f32:",
         _RING_HELPERS + "// The stage of stage_mma_kernel in f32:"),
        ("stage.cu",
         "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
         + _PLAN_F32,
         "  extern __shared__ __align__(16) unsigned char smem_raw[];\n"
         "  const StagePlan p(C, tile, halo, post_pad, 4, 2 * kTap);\n"
         "  uint4* ring = reinterpret_cast<uint4*>(smem_raw + p.w_offset);\n"),
        ("stage.cu", _STAGE_INPUT_F32, _RING_PREFETCH + _STAGE_INPUT_F32),
        ("stage.cu",
         "          const uint4* wt = frags + (size_t)g * kTap;\n",
         _RING_TAP),
        ("conv_tile.cuh", "const uint4 b = __ldg(wl + (kc * nts + ni) * 32);",
         "const uint4 b = wl[(kc * nts + ni) * 32];"),
        # the barrier at the next conv's first tap orders its reads
        ("stage.cu",
         "        __syncthreads();  // the next conv reads what this one "
         "wrote\n      }\n    }\n  }\n",
         "      }\n    }\n  }\n  __syncthreads();\n"),
        ("stage.cu", "  auto kernel = stage_tf32_kernel<C>;\n" + _PLAN_F32,
         "  auto kernel = stage_tf32_kernel<C>;\n"
         "  const StagePlan p(C, tile, halo, post_pad, 4,\n"
         "                    2 * (C / 8) * (C / 8) * 32);\n"),
    ], ring=True),
    # warps of a block x 16-row M tiles a warp holds: more slots feed more
    # MMAs from each B fragment read, at the cost of registers
    "warps_8_slots_2": Variant(_tf32_shape(8, 2), 8, slots=2),
    "warps_8_slots_4": Variant(_tf32_shape(8, 4), 8, slots=4),
    "warps_12_slots_3": Variant(_tf32_shape(12, 3), 12, slots=3),
}


def patched_sources(name: str, variant: Variant) -> typing.Dict[str, str]:
    """The variant's copy of ``csrc/stage.cu`` and its headers, by file
    name; raises if a patch does not apply to exactly one place."""
    texts = {p.name: p.read_text()
             for p in build.source_files(stage.SOURCE)}
    for file, old, new in variant.patches:
        if texts[file].count(old) != 1:
            raise RuntimeError(f"{name}: a patch of {file} no longer applies")
        texts[file] = texts[file].replace(old, new)
    return texts


def build_variants(
    variants: typing.Dict[str, Variant], tag: str
) -> typing.Dict[str, ctypes.CDLL]:
    """Each variant's copy of ``csrc/``, patched and built (one nvcc each,
    together) under the build directory."""
    jobs = {}
    for name, variant in variants.items():
        root = stage.BUILD_DIR / "ablate" / f"{tag}_{name}"
        root.mkdir(parents=True, exist_ok=True)
        for file, text in patched_sources(name, variant).items():
            (root / file).write_text(text)
        jobs[name] = root / stage.SOURCE.name

    def compile_one(path):
        out = build.library_path(path, path.parent)
        build.compile_library(path, out)
        return out

    with ThreadPoolExecutor(len(jobs)) as pool:
        outs = dict(zip(jobs, pool.map(compile_one, jobs.values())))
    return {n: stage.bind(ctypes.CDLL(str(p))) for n, p in outs.items()}


@contextlib.contextmanager
def using(lib: ctypes.CDLL, variant: Variant):
    """Route ``hifigan_stage_fused`` to ``lib`` (and its block plan)."""
    saved = (stage._LIB, stage.mma_warps, stage.TF32_SLOTS,
             stage._smem_regions, stage.WARPGROUPS, stage.WG_SLOTS)
    stage._LIB = lib
    if variant.wgs is not None:
        stage.WARPGROUPS, stage.WG_SLOTS = variant.wgs
    if variant.warps is not None:
        stage.mma_warps = lambda channels, dtype=None: variant.warps
    if variant.slots is not None:
        stage.TF32_SLOTS = variant.slots
    if variant.ring:
        regions = stage._smem_regions

        def with_ring(weights, rows, dtype):
            smem, room = regions(weights, rows, dtype)
            # two taps' TF32 hi/lo fragments: 2 x (C/8)^2 x 32 uint4
            return smem + 2 * weights.channels ** 2 * 8, room

        stage._smem_regions = with_ring
    stage._pick_mma_rows_cached.cache_clear()
    stage._pick_wgmma_rows_cached.cache_clear()
    try:
        yield
    finally:
        (stage._LIB, stage.mma_warps, stage.TF32_SLOTS, stage._smem_regions,
         stage.WARPGROUPS, stage.WG_SLOTS) = saved
        stage._pick_mma_rows_cached.cache_clear()
        stage._pick_wgmma_rows_cached.cache_clear()


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


def _double(tree):
    """A copy of a parameter tree with every tensor in float64."""
    if isinstance(tree, torch.Tensor):
        return tree.double()
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_double(v) for v in tree]
    return tree


def _bar_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest error of ``got`` as a share of the f32 bar at ``ref``."""
    ref = ref.double()
    return float(((got.double() - ref).abs()
                  / (2e-4 + 1e-3 * ref.abs())).max())


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--loops", type=int, default=20)
    parser.add_argument("--dtype", choices=("bfloat16", "float32"),
                        help="only this dtype's variants (default: both)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible: this profile needs one")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    libs = {dt: (variants, build_variants(variants, str(dt)[6:]))
            for dt, variants in ((torch.bfloat16, BF16_VARIANTS),
                                 (torch.float32, F32_VARIANTS))
            if args.dtype in (None, str(dt)[6:])}
    rng = np.random.RandomState(0)
    result = {}
    for dtype, name, c, c_in, post, batch, t_in in (
        (torch.bfloat16, "C=64 stage + ups, 1024 frames, B=16", 64, 128,
         False, 16, 1024 * 64),
        (torch.bfloat16, "last stage, 1024 frames, B=16", 32, 64, True, 16,
         1024 * 128),
        (torch.bfloat16, "last stage, 128 frames, B=1", 32, 64, True, 1,
         128 * 128),
        (torch.float32, "last stage, 128 frames, B=1", 32, 64, True, 1,
         128 * 128),
        (torch.float32, "last stage, 256 frames, B=4", 32, 64, True, 4,
         256 * 128),
        (torch.float32, "C=64 stage alone, 256 frames, B=1", 64, None, False,
         1, 256 * 128),
    ):
        if dtype not in libs:
            continue
        rb, kw = _stage(rng, c, c_in, post, dev)
        weights = stage.pack_stage_weights(rb, KERNELS, DILATIONS,
                                           device=dev, dtype=dtype, **kw)
        x = torch.from_numpy(
            rng.randn(batch, c_in or c, t_in).astype(np.float32)
        ).to(dev, dtype)
        if dtype == torch.float32:
            plain = stage.hifigan_stage_plain(rb, x, KERNELS, DILATIONS, **kw)
            exact = stage.hifigan_stage_plain(
                _double(rb), x.double(), KERNELS, DILATIONS, **_double(kw))
        variants, built = libs[dtype]
        times, shares, shares_f64 = {}, {}, {}
        for variant, lib in built.items():
            with using(lib, variants[variant]):
                def call():
                    return stage.hifigan_stage_fused(
                        rb, x, KERNELS, DILATIONS, weights=weights, **kw
                    )

                times[variant] = _cuda_ms(call, args.loops)
                if dtype == torch.float32:
                    got = call()
                    shares[variant] = _bar_share(got, plain)
                    shares_f64[variant] = _bar_share(got, exact)
        key = f"{name} ({str(dtype)[6:]})"
        result[key] = {"ms": times}
        if shares:
            result[key].update(bar_share=shares, bar_share_f64=shares_f64)
        print(json.dumps({key: result[key]}), flush=True)
    return result


if __name__ == "__main__":
    main()
