"""Fused HiFi-GAN MRF stage: hand-written CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``mimic3_tpu/ops/stage.py::
hifigan_stage_fused``.  One launch computes a whole multi-receptive-field
stage — the mean over the ResBlock1s (kernels 3/7/11, dilations 1/3/5,
two convs per step, residual adds) — optionally with the preceding
``lrelu + ConvTranspose1d`` upsampler fused before it and, on the last
stage, ``tanh(conv_post(lrelu(y)))`` fused after it so that only the
float32 waveform is written.

Activations use the port's ``[B, C, T]`` layout.  The kernel source is
``mimic3_tpu_torch/csrc/stage.cu``; it is compiled with ``nvcc`` at first
use into ``build/mimic3_tpu_torch/`` (keyed by a hash of the source and
its headers) and bound through ``ctypes``.  Nothing is built when this module is imported.

Which kernel a stage reaches, by x's dtype and C:

- bf16, ``C`` in 16/32/64: ``stage_mma_kernel``, every conv of the stage,
  the upsampler included, on Hopper's warpgroup MMA (``wgmma``, 64-row
  tiles; weights packed once per voice as C x C bf16 blocks in the wgmma
  B layout by :mod:`.mma`, streamed through a shared-memory ring);
- float32, ``C`` in 16/32/64: ``stage_tf32_kernel``, the same on tensor
  cores in three TF32 passes (``mma.sync.m16n8k8`` on the hi/lo split of
  both operands, f32-accurate; weights packed as TF32 hi/lo fragments);
  its TF32 is explicit in the kernel's instructions, and torch's TF32
  switches do not reach it;
- ``C = 8`` (under the MMA depth of both), either dtype: ``stage_kernel``
  on FFMA.

For a CPU tensor :func:`hifigan_stage_fused` runs
:func:`hifigan_stage_plain`; for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import typing
from dataclasses import dataclass
from pathlib import Path

import torch

from ..models.vits.layers import (
    LRELU_SLOPE,
    Params,
    conv1d,
    conv_transpose1d,
    leaky_relu,
)
from . import build, mma

SOURCE = build.PACKAGE_DIR / "csrc" / "stage.cu"
BUILD_DIR = build.BUILD_DIR

# channel counts the kernel is instantiated for (csrc/stage.cu)
SUPPORTED_CHANNELS = (8, 16, 32, 64)
# those that run on tensor cores, in bf16 and in f32 (the bf16 MMA depth
# is 16; f32 pads channels to 16 as well, so both share their plans)
MMA_CHANNELS = (16, 32, 64)
# f32: 16-row M tiles a warp holds per conv (kTf32Slots in csrc/stage.cu)
TF32_SLOTS = 2
# bf16 (warpgroup MMA): the consumer warpgroups of a block, the 64-row M
# tiles a warpgroup holds per pass and the weight ring's slots of one
# C x C block each (kWarpgroups, kSlots and kRing in csrc/stage.cu)
WARPGROUPS = 3
WG_SLOTS = {16: 6, 32: 4, 64: 2}
RING_SLOTS = {16: 16, 32: 8, 64: 4}
# dynamic shared memory one block may use on Hopper
_MAX_SMEM_BYTES = 232448
_TILES = (256, 128, 64, 32)  # time tiles tried, largest first
_SMS = 132  # streaming multiprocessors of an H100 SXM
# tensor-core paths: output rows per block (tile + 2 * conv_post padding),
# multiples of 16, tried largest first
_MMA_ROWS = tuple(range(512, 47, -16))

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0
_LAUNCHES_LOCK = threading.Lock()

_LIB: typing.Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def library_path() -> Path:
    return build.library_path(SOURCE, BUILD_DIR)


def build_library() -> ctypes.CDLL:
    """Compile ``csrc/stage.cu`` for sm_90a (once per source hash) and
    load it.  Raises if nvcc is missing or the build fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        out = library_path()
        build.compile_library(SOURCE, out)
        _LIB = bind(ctypes.CDLL(str(out)))
        return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points' C signatures on a loaded library."""
    fn = lib.hifigan_stage_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5  # x, out, w, b, plan
        + [ctypes.c_int] * 14
        + [ctypes.c_void_p]  # stream
    )
    fn = lib.hifigan_stage_mma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # x, out, w, b, plan, weight blocks
        + [ctypes.c_int] * 14
        + [ctypes.c_void_p]  # stream
    )
    fn = lib.hifigan_stage_tf32_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # x, out, w, b, plan, fragments
        + [ctypes.c_int] * 14
        + [ctypes.c_void_p]  # stream
    )
    return lib


# ---------------------------------------------------------------------------
# Weights, prepared once per voice
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StageWeights:
    """One stage's conv weights laid out for the kernel.

    ``w``: float32, every conv as ``[Cin, K, Cout]`` back to back in
    launch order (ups, then per resblock per step conv1/conv2, then
    post); ``b``: float32 biases; ``plan``: int32 ``[n_convs, 4]`` rows
    of (weight offset, bias offset, K, dilation).  ``fragments``: the
    weights again for the tensor-core path of ``dtype`` (``None`` below
    16 channels, where the FFMA kernel reads ``w``): for bfloat16 the
    stream of C x C bf16 wgmma blocks (:func:`.mma.pack_wgmma_block`,
    int32 pairs) in the order the kernel's passes take them, the
    upsampler's taps by phase (each split into ``ceil(Cin / C)`` K
    blocks) then every resblock conv's taps; for float32 the resblock
    convs' TF32 hi/lo fragments, back to back in launch order.
    ``convs``: the resblock convs' (K, dilation) in launch order.
    """

    w: torch.Tensor
    b: torch.Tensor
    plan: torch.Tensor
    fragments: typing.Optional[torch.Tensor]
    dtype: torch.dtype  # the activations' dtype the pack is for
    convs: typing.Tuple[typing.Tuple[int, int], ...]
    post_kernel: int
    channels: int
    in_channels: int
    n_res: int
    n_steps: int
    halo: int
    ups_kernel: int  # 0 = no fused upsampler
    ups_stride: int
    ups_padding: int
    has_post: bool


def stage_halo(
    kernel_sizes: typing.Sequence[int],
    dilations: typing.Sequence[typing.Sequence[int]],
    post_kernel: int = 0,
) -> int:
    """Receptive half-width of the stage (+ the post conv), in samples."""
    rf = max(
        sum((k - 1) // 2 * d + (k - 1) // 2 for d in ds)
        for k, ds in zip(kernel_sizes, dilations)
    )
    return rf + (post_kernel - 1) // 2 if post_kernel else rf


def pack_stage_weights(
    resblock_params: typing.Sequence[Params],
    kernel_sizes: typing.Sequence[int],
    dilations: typing.Sequence[typing.Sequence[int]],
    *,
    ups_params: typing.Optional[Params] = None,
    ups_stride: int = 2,
    ups_padding: typing.Optional[int] = None,
    post_params: typing.Optional[Params] = None,
    device: typing.Optional[torch.device] = None,
    dtype: torch.dtype = torch.bfloat16,
) -> StageWeights:
    """Lay out (and cast to float32) one stage's weights for the kernel
    that activations of ``dtype`` reach."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {dtype}")
    ws: typing.List[torch.Tensor] = []
    bs: typing.List[torch.Tensor] = []
    plan: typing.List[typing.Tuple[int, int, int, int]] = []
    frags: typing.List[torch.Tensor] = []
    convs: typing.List[typing.Tuple[int, int]] = []
    w_off = b_off = 0

    def add(weight_cik: torch.Tensor, bias, c_out: int, dil: int) -> None:
        nonlocal w_off, b_off
        w = weight_cik.float().contiguous().reshape(-1)
        b = (
            torch.zeros(c_out) if bias is None else bias.float().reshape(-1)
        )
        plan.append((w_off, b_off, weight_cik.shape[1], dil))
        ws.append(w.cpu())
        bs.append(b.cpu())
        w_off += w.numel()
        b_off += c_out

    n_steps = len(dilations[0])
    if any(len(d) != n_steps for d in dilations):
        raise ValueError("resblocks must share the number of dilations")
    channels = resblock_params[0]["convs1"]["0"]["weight"].shape[0]
    in_channels = channels
    ups_kernel = 0
    if ups_params is not None:
        uw = ups_params["weight"]  # [Cin, Cout, K]
        in_channels, c_out, ups_kernel = uw.shape
        if c_out != channels:
            raise ValueError(
                f"upsampler emits {c_out} channels, stage has {channels}"
            )
        if ups_padding is None:
            ups_padding = (ups_kernel - ups_stride) // 2
        add(uw.permute(0, 2, 1), ups_params.get("bias"), channels, 1)
        if dtype == torch.bfloat16 and channels in MMA_CHANNELS:
            frags.append(_ups_blocks(uw, ups_stride))
    for rp, k, ds in zip(resblock_params, kernel_sizes, dilations):
        for j, d in enumerate(ds):
            for key, dil in (("convs1", d), ("convs2", 1)):
                p = rp[key][str(j)]
                if p["weight"].shape != (channels, channels, k):
                    raise ValueError(
                        f"{key}.{j} weight {tuple(p['weight'].shape)} "
                        f"!= {(channels, channels, k)}"
                    )
                add(p["weight"].permute(1, 2, 0), p.get("bias"), channels, dil)
                convs.append((k, dil))
                if channels not in MMA_CHANNELS:
                    continue
                if dtype == torch.float32:
                    frags.append(
                        mma.pack_conv_fragments_tf32(p["weight"]).cpu())
                else:  # one block per tap: B[ci, co] = W[co, ci, tap]
                    frags.append(mma.pack_wgmma_block(
                        p["weight"].permute(2, 1, 0)).cpu())
    post_kernel = 0
    if post_params is not None:
        pw = post_params["weight"]  # [1, C, K]
        if pw.shape[:2] != (1, channels):
            raise ValueError(f"post conv {tuple(pw.shape)} does not fit")
        post_kernel = pw.shape[2]
        add(pw.permute(1, 2, 0), post_params.get("bias"), 1, 1)

    return StageWeights(
        w=torch.cat(ws).to(device),
        b=torch.cat(bs).to(device),
        plan=torch.tensor(plan, dtype=torch.int32).to(device),
        fragments=(
            _as_int32(torch.cat([f.reshape(-1) for f in frags])).to(device)
            if frags else None
        ),
        dtype=dtype,
        convs=tuple(convs),
        post_kernel=post_kernel,
        channels=channels,
        in_channels=in_channels,
        n_res=len(kernel_sizes),
        n_steps=n_steps,
        halo=stage_halo(kernel_sizes, dilations, post_kernel),
        ups_kernel=ups_kernel,
        ups_stride=ups_stride if ups_kernel else 1,
        ups_padding=ups_padding if ups_kernel else 0,
        has_post=post_params is not None,
    )


def _ups_blocks(uw: torch.Tensor, stride: int) -> torch.Tensor:
    """The upsampler's wgmma blocks (``uw``: ``[Cin, C, K]``, the
    ConvTranspose1d weight) on the CPU, in the order of the kernel's
    passes: phase r (the outputs t with (t + pad) % stride == r) takes the
    taps j = r, r + stride, ... < K; each tap's ``B[ci, co] = uw[ci, co,
    j]`` in K blocks of C input channels, zero-padded past Cin."""
    c_in, c, k = uw.shape
    kbs = -(-c_in // c)
    padded = torch.zeros(kbs * c, c, k, dtype=uw.dtype, device=uw.device)
    padded[:c_in] = uw.detach()
    taps = [j for r in range(stride) for j in range(r, k, stride)]
    blocks = padded[:, :, taps].permute(2, 0, 1).reshape(len(taps), kbs, c, c)
    return mma.pack_wgmma_block(blocks).cpu()


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """bf16 weight blocks as int32 pairs (TF32 fragments are int32
    already)."""
    return t.view(torch.int32) if t.dtype == torch.bfloat16 else t


def uses_mma(channels: int, dtype: torch.dtype) -> bool:
    """Stages of at least the MMA depth run on tensor cores, bf16 and
    float32 alike; C = 8 runs the FFMA kernel."""
    return channels in MMA_CHANNELS and dtype in (torch.float32,
                                                  torch.bfloat16)


def _pick_tile(weights: StageWeights) -> int:
    """FFMA kernel (C = 8): largest time tile whose four f32
    [C, tile + 2*halo] buffers (and the upsampler's staged input) fit in
    one block's shared memory."""
    c = weights.channels
    for tile in _TILES:
        length = tile + 2 * weights.halo
        if 4 * c * length * 4 > _MAX_SMEM_BYTES:
            continue
        if weights.ups_kernel:
            lin = (length + weights.ups_kernel - 2) // weights.ups_stride + 2
            if weights.in_channels * lin > 2 * c * length:
                continue
        return tile
    raise ValueError(
        f"no time tile fits C={c}, halo={weights.halo} in shared memory"
    )


def mma_warps(channels: int, dtype: torch.dtype = torch.float32) -> int:
    """Warps of a TF32 block: ``kTf32Warps`` in ``csrc/stage.cu`` (the
    bf16 path runs :data:`WARPGROUPS` warpgroups)."""
    if dtype != torch.float32:
        raise ValueError("the bf16 stage runs warpgroups, not a warp count")
    return 16 if channels <= 32 else 8


def _post_pad(weights: StageWeights) -> int:
    return (weights.post_kernel - 1) // 2 if weights.has_post else 0


def _smem_regions(
    weights: StageWeights, rows: int, dtype: torch.dtype = torch.float32
) -> typing.Tuple[int, int]:
    """(bytes of one TF32 block's shared memory, bytes of its state,
    conv1 and sum buffers, over which the upsampler stages its input) for
    ``rows`` output rows (``StagePlan`` in ``csrc/stage.cu``): three f32
    buffers of the haloed tile plus 16 rows of slack (rows padded by 16
    bytes), the f32 sum over resblocks and the launch plan."""
    if dtype != torch.float32:
        raise ValueError("the bf16 block plan is _wgmma_layout's")
    c = weights.channels
    buffer_rows = rows - 2 * _post_pad(weights) + 2 * weights.halo + 16
    buf = buffer_rows * (c + 4) * 4
    acts = 3 * buf + rows * (c + 1) * 4
    return -(-acts // 16) * 16 + 64 * 16, acts - buf


def _wgmma_layout(
    weights: StageWeights, rows: int
) -> typing.Tuple[int, int, int]:
    """(bytes of one wgmma block's shared memory, bytes of its room over
    the state, conv1 and sum buffers, bytes of the upsampler's staged
    input there) for ``rows`` output rows (``WgmmaPlan`` in
    ``csrc/stage.cu``): three bf16 buffers of the haloed tile (rows padded
    by 16 bytes, no slack), the f32 sum, the weight ring, its mbarriers
    and the launch plan."""
    c = weights.channels
    length = rows - 2 * _post_pad(weights) + 2 * weights.halo
    buf = length * (c + 8) * 2
    y = rows * (c + 1) * 4
    ring = RING_SLOTS[c]
    smem = -(-(3 * buf + y) // 128) * 128 + ring * (c * c * 2 + 16) + 64 * 16
    xin = 0
    if weights.ups_kernel:
        lin = (length + weights.ups_kernel - 2) // weights.ups_stride + 2
        xin = lin * (-(-weights.in_channels // c) * c + 8) * 2
    return smem, 2 * buf + y, xin


def mma_smem_bytes(
    weights: StageWeights, rows: int, dtype: torch.dtype = torch.bfloat16
) -> int:
    """Shared memory of one tensor-core block for ``rows`` output rows
    (``WgmmaPlan`` for bf16, ``StagePlan`` for f32, in
    ``csrc/stage.cu``)."""
    if dtype == torch.float32:
        return _smem_regions(weights, rows, dtype)[0]
    return _wgmma_layout(weights, rows)[0]


def wgmma_passes(
    weights: StageWeights, rows: int
) -> typing.List[typing.Tuple[int, int]]:
    """(rows the pass computes, weight blocks it takes) for every pass of
    one bf16 block with ``rows`` output rows: each upsampler phase (at
    most ``ceil(L / stride)`` rows of the haloed tile's L), then each
    resblock conv (the output rows plus the receptive half-width of the
    resblock's convs after it).  The kernel runs each pass in 64-row M
    tiles."""
    passes = []
    length = rows - 2 * _post_pad(weights) + 2 * weights.halo
    if weights.ups_kernel:
        s, k = weights.ups_stride, weights.ups_kernel
        kbs = -(-weights.in_channels // weights.channels)
        for r in range(s):
            passes.append((-(-length // s), len(range(r, k, s)) * kbs))
    per_res = len(weights.convs) // weights.n_res
    for r in range(weights.n_res):
        convs = weights.convs[r * per_res:(r + 1) * per_res]
        ext = sum(d * (k - 1) // 2 for k, d in convs)
        for k, d in convs:
            ext -= d * (k - 1) // 2
            passes.append((rows + 2 * ext, k))
    return passes


# The bf16 block's time on one SM, in ns, as the wave model counts it
# (:func:`_wgmma_block_ns`): a weight block takes the tensor cores 128 C^2
# FLOPs per 64-row M tile at 989 TFLOP/s over 132 SMs, and a warpgroup a
# fixed cost besides (its ring wait, fragment loads, MMA latency and
# release) that the other warpgroups' MMAs hide; each pass's epilogue
# costs per M tile and 8 channels a warpgroup writes back, plus its
# barriers; staging the input and writing the output per element.  Fit
# (6.6% rms) to the card's times of both cell stages at 16 x 1024 frames
# and the last stage at 128 frames, over tiles of 64-512 rows (PERF.md).
_SM_FLOPS_PER_NS = 989e12 / _SMS / 1e9
_WG_BLOCK_NS = 300.0
_EPILOGUE_NS = 160.0
_PASS_NS = 500.0
_IO_NS = 0.5


def _wgmma_block_ns(weights: StageWeights, rows: int) -> float:
    c, wgs = weights.channels, WARPGROUPS
    t_mma = 128 * c * c / _SM_FLOPS_PER_NS
    total = 0.0
    for n, blocks in wgmma_passes(weights, rows):
        mt = -(-n // 64)
        mine = -(-mt // wgs)  # M tiles of the busiest warpgroup
        total += blocks * max(mt * t_mma, _WG_BLOCK_NS + mine * t_mma)
        total += mine * _EPILOGUE_NS * c / 8 + _PASS_NS
    length = rows - 2 * _post_pad(weights) + 2 * weights.halo
    return total + _IO_NS * (weights.in_channels * length + c * rows)


def _pick_wgmma_rows(weights: StageWeights, t_out: int, batch: int) -> int:
    """Output rows per block (tile + 2 * conv_post padding) for the bf16
    stage: the least modelled time, waves of blocks over the SMs (one
    block an SM) times a block's modelled time (:func:`_wgmma_block_ns`),
    over the tiles that fit shared memory and the warpgroups' M-tile
    slots.  Cached on the pack's shape (this runs on every launch)."""
    return _pick_wgmma_rows_cached(
        dataclasses.replace(weights, w=None, b=None, plan=None,
                            fragments=None),
        t_out, batch,
    )


@functools.lru_cache(maxsize=256)
def _pick_wgmma_rows_cached(
    weights: StageWeights, t_out: int, batch: int
) -> int:
    c = weights.channels
    best = None
    for rows in _MMA_ROWS:
        tile = rows - 2 * _post_pad(weights)
        smem, room, xin = _wgmma_layout(weights, rows)
        if tile < 1 or smem > _MAX_SMEM_BYTES or xin > room:
            continue
        if -(-(tile + 2 * weights.halo) // 64) > WG_SLOTS[c] * WARPGROUPS:
            continue  # a pass's rows exceed the warpgroups' slots
        blocks = -(-t_out // tile) * batch
        cost = -(-blocks // _SMS) * _wgmma_block_ns(weights, rows)
        if best is None or cost < best[0]:
            best = (cost, rows)
        if tile >= t_out:
            break  # longer tiles only add masked rows
    if best is None:
        raise ValueError(
            f"no wgmma tile fits C={c}, halo={weights.halo} in shared memory"
        )
    return best[1]


def _mma_rounds(weights: StageWeights, rows: int, warps: int) -> int:
    """Warp rounds of one TF32 block's convs, weighted by K: each conv
    computes its needed rows (the output rows plus the receptive
    half-width of the resblock's convs after it) in 16-row items over the
    block's warps."""
    total = 0
    per_res = len(weights.convs) // weights.n_res
    for r in range(weights.n_res):
        convs = weights.convs[r * per_res:(r + 1) * per_res]
        ext = sum(d * (k - 1) // 2 for k, d in convs)
        for k, d in convs:
            ext -= d * (k - 1) // 2
            items = -(-(rows + 2 * ext) // 16)
            total += k * -(-items // warps)
    return total


def _pick_mma_rows(
    weights: StageWeights, t_out: int, batch: int,
    dtype: torch.dtype = torch.float32,
) -> int:
    """Output rows per block (tile + 2 * conv_post padding) for the TF32
    path: the least modelled time, waves of blocks over the SMs times a
    block's warp rounds; ties go to the longer tile.  Cached on the
    pack's shape (this runs on every launch)."""
    if dtype != torch.float32:
        raise ValueError("the bf16 stage's plan is _pick_wgmma_rows's")
    return _pick_mma_rows_cached(
        dataclasses.replace(weights, w=None, b=None, plan=None,
                            fragments=None),
        t_out, batch, dtype,
    )


@functools.lru_cache(maxsize=256)
def _pick_mma_rows_cached(
    weights: StageWeights, t_out: int, batch: int, dtype: torch.dtype
) -> int:
    warps = mma_warps(weights.channels, dtype)
    best = None
    for rows in _MMA_ROWS:
        tile = rows - 2 * _post_pad(weights)
        smem, room = _smem_regions(weights, rows, dtype)
        if tile < 1 or smem > _MAX_SMEM_BYTES:
            continue
        if -(-(tile + 2 * weights.halo) // 16) > TF32_SLOTS * warps:
            continue  # a conv's rows exceed the warps' M-tile slots
        if weights.ups_kernel:
            # the upsampler stages lrelu(x_in) as f32 over the state,
            # conv1 and sum buffers
            length = tile + 2 * weights.halo
            lin = (length + weights.ups_kernel - 2) // weights.ups_stride + 2
            if weights.in_channels * lin * 4 > room:
                continue
        blocks = -(-t_out // tile) * batch
        cost = -(-blocks // _SMS) * _mma_rounds(weights, rows, warps)
        if best is None or cost < best[0]:
            best = (cost, rows)
        if tile >= t_out:
            break  # longer tiles only add masked rows
    if best is None:
        raise ValueError(
            f"no tensor-core tile fits C={weights.channels}, "
            f"halo={weights.halo} in shared memory"
        )
    return best[1]


# ---------------------------------------------------------------------------
# Plain version and wrapper
# ---------------------------------------------------------------------------


def hifigan_stage_plain(
    resblock_params: typing.Sequence[Params],
    x: torch.Tensor,
    kernel_sizes: typing.Sequence[int],
    dilations: typing.Sequence[typing.Sequence[int]],
    *,
    ups_params: typing.Optional[Params] = None,
    ups_stride: int = 2,
    ups_padding: typing.Optional[int] = None,
    post_params: typing.Optional[Params] = None,
) -> torch.Tensor:
    """The stage as plain PyTorch ops (same function as the kernel)."""
    from ..models.vits.hifigan import resblock1

    if ups_params is not None:
        if ups_padding is None:
            ups_padding = (ups_params["weight"].shape[2] - ups_stride) // 2
        x = conv_transpose1d(
            leaky_relu(x, LRELU_SLOPE),
            ups_params,
            stride=ups_stride,
            padding=ups_padding,
        )
    y = None
    for rp, k, ds in zip(resblock_params, kernel_sizes, dilations):
        out = resblock1(rp, x, k, ds)
        y = out if y is None else y + out
    y = y / len(kernel_sizes)
    if post_params is None:
        return y
    y = leaky_relu(y.float(), LRELU_SLOPE)
    pad = (post_params["weight"].shape[2] - 1) // 2
    return torch.tanh(
        conv1d(y, post_params, padding=pad, dtype=torch.float32)
    )[:, 0]


def hifigan_stage_fused(
    resblock_params: typing.Sequence[Params],
    x: torch.Tensor,
    kernel_sizes: typing.Sequence[int],
    dilations: typing.Sequence[typing.Sequence[int]],
    *,
    ups_params: typing.Optional[Params] = None,
    ups_stride: int = 2,
    ups_padding: typing.Optional[int] = None,
    post_params: typing.Optional[Params] = None,
    weights: typing.Optional[StageWeights] = None,
) -> torch.Tensor:
    """Whole MRF stage in one kernel launch.

    ``x``: ``[B, C, T]`` (``[B, Cin, T_in]`` before the upsampler when
    ``ups_params`` is given), float32 or bfloat16, contiguous.  Returns
    the stage output ``[B, C, T]`` in x's dtype, or with ``post_params``
    the float32 waveform ``[B, T]``.  ``weights`` is the stage packed by
    :func:`pack_stage_weights` for x's device and dtype (built here when
    omitted).
    """
    global launches
    kwargs = dict(
        ups_params=ups_params,
        ups_stride=ups_stride,
        ups_padding=ups_padding,
        post_params=post_params,
    )
    if x.device.type == "cpu":
        return hifigan_stage_plain(
            resblock_params, x, kernel_sizes, dilations, **kwargs
        )
    build.refuse_autograd(
        "hifigan_stage_fused", x, resblock_params, ups_params, post_params
    )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if weights is None:
        weights = pack_stage_weights(
            resblock_params, kernel_sizes, dilations,
            device=x.device, dtype=x.dtype, **kwargs,
        )
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dim() != 3 or x.shape[1] != weights.in_channels:
        raise ValueError(
            f"x {tuple(x.shape)} does not match {weights.in_channels} "
            "input channels"
        )
    if weights.channels not in SUPPORTED_CHANNELS:
        raise ValueError(f"C={weights.channels} not in {SUPPORTED_CHANNELS}")
    for t in (weights.w, weights.b, weights.plan):
        if t.device != x.device:
            raise ValueError("stage weights are on another device")
    if weights.has_post != (post_params is not None) or bool(
        weights.ups_kernel
    ) != (ups_params is not None):
        raise ValueError("stage weights were packed for other fusions")

    batch, _, t_in = x.shape
    if weights.ups_kernel:
        t_out = (
            (t_in - 1) * weights.ups_stride
            - 2 * weights.ups_padding
            + weights.ups_kernel
        )
    else:
        t_out = t_in
    if t_out <= 0:
        raise ValueError(f"empty stage output for T_in={t_in}")
    c = weights.channels
    if weights.has_post:
        out = torch.empty(batch, t_out, device=x.device, dtype=torch.float32)
    else:
        out = torch.empty(batch, c, t_out, device=x.device, dtype=x.dtype)

    lib = build_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # ctypes launches on the current device, and the kernels'
    # cudaFuncSetAttribute applies to it alone: make it x's
    with torch.cuda.device(x.device):
        if uses_mma(c, x.dtype):
            frags = weights.fragments
            if (frags is None or weights.dtype != x.dtype
                    or frags.device != x.device):
                raise ValueError(
                    f"stage weights carry no {x.dtype} MMA fragments on "
                    f"{x.device}"
                )
            post_pad = _post_pad(weights)
            if x.dtype == torch.float32:
                rows = _pick_mma_rows(weights, t_out, batch, x.dtype)
            else:
                rows = _pick_wgmma_rows(weights, t_out, batch)
            args = (
                x.data_ptr(), out.data_ptr(),
                weights.w.data_ptr(), weights.b.data_ptr(),
                weights.plan.data_ptr(), frags.data_ptr(),
                batch, c, weights.in_channels, t_in, t_out,
                weights.n_res, weights.n_steps,
                weights.ups_kernel, weights.ups_stride, weights.ups_padding,
                int(weights.has_post), post_pad, rows - 2 * post_pad,
                weights.halo,
            )
            launch = (lib.hifigan_stage_tf32_launch
                      if x.dtype == torch.float32
                      else lib.hifigan_stage_mma_launch)
            err = launch(*args, stream)
        else:
            tile = _pick_tile(weights)
            err = lib.hifigan_stage_launch(
                x.data_ptr(), out.data_ptr(),
                weights.w.data_ptr(), weights.b.data_ptr(),
                weights.plan.data_ptr(),
                batch, c, weights.in_channels, t_in, t_out,
                weights.n_res, weights.n_steps,
                weights.ups_kernel, weights.ups_stride, weights.ups_padding,
                int(weights.has_post), tile, weights.halo,
                int(x.dtype == torch.bfloat16), stream,
            )
    if err != 0:
        raise RuntimeError(f"hifigan_stage kernel launch failed: cuda error {err}")
    with _LAUNCHES_LOCK:  # several request and driver threads launch
        launches += 1
    return out
