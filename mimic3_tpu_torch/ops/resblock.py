"""Fused HiFi-GAN ResBlock1 dilation step: hand-written CUDA kernel + plain
version.

Replaces the Pallas TPU kernel ``mimic3_tpu/ops/resblock.py::
fused_resblock_subblock``.  One launch computes one step of ResBlock1,

    out = x + conv_k(lrelu(conv_{k,d}(lrelu(x))))

with torch zero padding (the intermediate is zero outside ``[0, T)``
before the second conv), for activations in the port's ``[B, C, T]``
layout and conv weights ``[Cout, Cin, K]``.  As on the TPU, the weights
are rounded to x's dtype, the sums are float32 and the output has x's
dtype.  The TPU kernel's tiling limits (8-row halo rounding, T a multiple
of the tile) do not apply: any ``T >= 1`` and any C that is a multiple of
8 up to 256 are taken.  Which kernel a step reaches, by x's dtype and C:

- bf16, ``C >= 16``: ``subblock_mma_kernel<NW, bf16>`` on tensor cores
  (``mma.sync.m16n8k16``, weights packed as bf16 MMA fragments by
  :mod:`.mma`; the intermediate rounded to bf16 as on the TPU);
- float32, ``C >= 16``: ``subblock_mma_kernel<NW, float>``, the same in
  three TF32 passes (``mma.sync.m16n8k8`` on the hi/lo split of both
  operands, f32-accurate; the intermediate kept in f32);
- ``C = 8`` (under the MMA depth of both), either dtype:
  ``subblock_kernel`` on FFMA.

No synthesis path calls this kernel, as in the JAX package: its entry
point is ``mimic3_tpu_torch/scripts/profile_resblock.py``.  The source is
``mimic3_tpu_torch/csrc/resblock.cu``, compiled with ``nvcc`` at first use
into ``build/mimic3_tpu_torch/`` and bound through ``ctypes``.  For a CPU
tensor :func:`fused_resblock_subblock` runs
:func:`resblock_subblock_plain`; for a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import typing
from dataclasses import dataclass

import torch

from . import build, mma

SOURCE = build.PACKAGE_DIR / "csrc" / "resblock.cu"
BUILD_DIR = build.BUILD_DIR

MAX_CHANNELS = 256  # the widest resblock of the full-width decoder
# dynamic shared memory one block may use on Hopper
_MAX_SMEM_BYTES = 232448
# a block's share when two blocks run on one SM (minus the 1 KB each
# block reserves)
_HALF_SMEM_BYTES = 228 * 1024 // 2 - 1024
_TILES = (256, 128, 64, 32, 16, 8)  # time tiles tried, largest first
_SMS = 132  # streaming multiprocessors of an H100 SXM
# tensor-core path: rows of the first conv per block, tried in order, and
# output-channel groups per time tile
_MMA_ROWS = (256, 224, 192, 160, 128, 96, 64, 32)
_MMA_GROUPS = (1, 2, 4, 8)
_MMA_WARPS = 8

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0
_LAUNCHES_LOCK = threading.Lock()

_LIB: typing.Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def library_path():
    return build.library_path(SOURCE, BUILD_DIR)


def build_library() -> ctypes.CDLL:
    """Compile ``csrc/resblock.cu`` for sm_90a (once per source hash) and
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
    fn = lib.resblock_subblock_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # x, out, w1, b1, w2, b2
        + [ctypes.c_int] * 7  # batch, C, T, K, dilation, tile, is_bf16
        + [ctypes.c_void_p]  # stream
    )
    fn = lib.resblock_subblock_mma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6  # x, out, w1, b1, w2, b2
        # batch, C, T, K, dilation, rows, groups, is_bf16
        + [ctypes.c_int] * 8
        + [ctypes.c_void_p]  # stream
    )
    return lib


@dataclass(frozen=True)
class SubblockWeights:
    """One step's two convs laid out for the kernel.  FFMA path (C = 8):
    weights ``[Cin, K, Cout]`` and biases ``[C]``, rounded to ``dtype``
    and held as float32.  Tensor-core path (``mma``): weights as int32 MMA
    fragments, bf16 (:func:`.mma.pack_conv_fragments`) or TF32 hi/lo
    (:func:`.mma.pack_conv_fragments_tf32`) by ``dtype``, and biases
    rounded to ``dtype``, held as float32 and padded to a multiple of
    16."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    channels: int
    kernel_size: int
    dtype: torch.dtype
    mma: bool = False


def pack_subblock_weights(
    w1: torch.Tensor,
    b1: typing.Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: typing.Optional[torch.Tensor],
    dtype: torch.dtype,
    device: typing.Optional[torch.device] = None,
) -> SubblockWeights:
    """Pack ``[Cout, Cin, K]`` conv weights (``None`` bias = zeros) for
    the path that x's ``dtype`` takes: MMA fragments (bf16, or TF32 hi/lo
    for float32) with ``C >= 16``, else the FFMA layout."""
    c, c_in, k = w1.shape
    if c_in != c or tuple(w2.shape) != (c, c, k):
        raise ValueError(
            f"weights {tuple(w1.shape)} / {tuple(w2.shape)} are not two "
            "square convs of one kernel size"
        )
    if uses_mma(c, dtype):
        pack = (mma.pack_conv_fragments_tf32 if dtype == torch.float32
                else mma.pack_conv_fragments)
        return SubblockWeights(
            w1=pack(w1.to(device)),
            b1=mma.pad_bias(b1, c, device, dtype),
            w2=pack(w2.to(device)),
            b2=mma.pad_bias(b2, c, device, dtype),
            channels=c, kernel_size=k, dtype=dtype, mma=True,
        )

    def weight(w):
        return w.to(dtype).float().permute(1, 2, 0).contiguous().to(device)

    def bias(b):
        if b is None:
            return torch.zeros(c, device=device)
        return b.to(dtype).float().reshape(c).contiguous().to(device)

    return SubblockWeights(
        w1=weight(w1), b1=bias(b1), w2=weight(w2), b2=bias(b2),
        channels=c, kernel_size=k, dtype=dtype,
    )


def uses_mma(channels: int, dtype: torch.dtype) -> bool:
    """At least the MMA depth of channels runs on tensor cores, bf16 and
    float32 alike; C = 8 runs the FFMA kernel."""
    return channels >= 16 and dtype in (torch.float32, torch.bfloat16)


def mma_smem_bytes(
    channels: int, kernel_size: int, dilation: int, rows: int, groups: int,
    dtype: torch.dtype = torch.bfloat16,
) -> int:
    """Shared memory of one tensor-core block (``MmaPlan`` in
    ``csrc/resblock.cu``): the intermediate h, then lrelu(x) or the
    second conv's f32 output tile, whichever is larger; h and lrelu(x) in
    x's dtype, rows padded by 16 bytes."""
    cp = mma.padded(channels)
    elt = 4 if dtype == torch.float32 else 2
    ld = cp + 16 // elt
    h1 = dilation * (kernel_size - 1) // 2
    h2 = (kernel_size - 1) // 2
    m2 = -(-(rows - 2 * h2) // 32) * 32
    a_bytes = (rows + 2 * h1) * ld * elt
    o_bytes = cp // groups * (m2 + 4) * 4
    return (m2 + 2 * h2) * ld * elt + max(a_bytes, o_bytes)


@functools.lru_cache(maxsize=256)
def pick_mma_config(
    channels: int, kernel_size: int, dilation: int, t: int, batch: int,
    dtype: torch.dtype = torch.bfloat16,
) -> typing.Tuple[int, int]:
    """(rows of the first conv per block, output-channel groups) for the
    tensor-core path of ``dtype``.  Each candidate is costed as waves of
    blocks over the SMs times a block's rounds of warp items (32 rows x
    8*NW output channels x C_in x K MACs each), the first conv over all
    channels and the second over the block's group.  Blocks that let two share an SM
    (16 warps to hide MMA latency) come first; ties go to less shared
    memory."""
    cp = mma.padded(channels)
    h2 = (kernel_size - 1) // 2
    best = None
    for rows in _MMA_ROWS:
        tile = rows - 2 * h2
        if tile < 1 or (tile > 2 * t and rows != _MMA_ROWS[-1]):
            continue
        m2 = -(-tile // 32) * 32
        for groups in _MMA_GROUPS:
            cg = cp // groups
            if cp % groups or cg % 16:
                continue
            smem = mma_smem_bytes(
                channels, kernel_size, dilation, rows, groups, dtype
            )
            if smem > _MAX_SMEM_BYTES:
                continue
            nw = 4 if cg % 32 == 0 else 2
            items1 = rows // 32 * (cp // (8 * nw))
            items2 = m2 // 32 * (cg // (8 * nw))
            per_block = (
                -(-items1 // _MMA_WARPS) + -(-items2 // _MMA_WARPS)
            ) * nw
            blocks = -(-t // tile) * batch * groups
            cost = (
                smem > _HALF_SMEM_BYTES,
                -(-blocks // _SMS) * per_block,
                smem,
            )
            if best is None or cost < best[0]:
                best = (cost, rows, groups)
    if best is None:
        raise ValueError(
            f"no tensor-core block fits C={channels}, K={kernel_size}, "
            f"d={dilation} in shared memory"
        )
    return best[1], best[2]


def pick_tile(channels: int, kernel_size: int, dilation: int, t: int) -> int:
    """FFMA kernel (C = 8): time tile, the largest whose two f32 buffers
    (lrelu(x) with both halos, and the intermediate with the second halo)
    let two blocks share an SM with a tile of at least 64, else the
    largest that fits one block; never much longer than the sequence."""
    h1 = dilation * (kernel_size - 1) // 2
    h2 = (kernel_size - 1) // 2

    def smem(tile: int) -> int:
        return 4 * channels * ((tile + 2 * h2 + 2 * h1) + (tile + 2 * h2))

    tiles = [tl for tl in _TILES if tl < 2 * t] or [_TILES[-1]]
    for tile in tiles:
        if tile >= 64 and smem(tile) <= _HALF_SMEM_BYTES:
            return tile
    for tile in tiles:
        if smem(tile) <= _MAX_SMEM_BYTES:
            return tile
    raise ValueError(
        f"no time tile fits C={channels}, K={kernel_size}, d={dilation} "
        "in shared memory"
    )


def resblock_subblock_plain(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: typing.Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: typing.Optional[torch.Tensor],
    *,
    kernel_size: int,
    dilation: int,
) -> torch.Tensor:
    """The step as plain PyTorch ops: one step of ``hifigan.resblock1``
    with ``dilations=[dilation]``."""
    from ..models.vits.hifigan import resblock1

    def conv(w, b):
        return {"weight": w} if b is None else {"weight": w, "bias": b}

    params = {"convs1": {"0": conv(w1, b1)}, "convs2": {"0": conv(w2, b2)}}
    return resblock1(params, x, kernel_size, [dilation])


def fused_resblock_subblock(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: typing.Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: typing.Optional[torch.Tensor],
    *,
    kernel_size: int,
    dilation: int,
    weights: typing.Optional[SubblockWeights] = None,
) -> torch.Tensor:
    """``x + conv(lrelu(conv(lrelu(x), dilation)))`` in one kernel launch.

    ``x``: ``[B, C, T]`` float32 or bfloat16, contiguous; ``w1``, ``w2``:
    ``[C, C, K]``; ``b1``, ``b2``: ``[C]`` or None.  Returns ``[B, C, T]``
    in x's dtype.  ``weights`` is the pair packed by
    :func:`pack_subblock_weights` for x's dtype and device (packed here
    when omitted).
    """
    global launches
    if x.device.type == "cpu":
        return resblock_subblock_plain(
            x, w1, b1, w2, b2, kernel_size=kernel_size, dilation=dilation
        )
    build.refuse_autograd("fused_resblock_subblock", x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [B, C, T] tensor")
    if kernel_size % 2 == 0 or kernel_size < 1 or dilation < 1:
        raise ValueError(f"unsupported K={kernel_size}, d={dilation}")
    batch, c, t = x.shape
    if c % 8 or not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"C={c} is not a multiple of 8 up to {MAX_CHANNELS}")
    if t < 1:
        raise ValueError("empty sequence")
    if weights is None:
        weights = pack_subblock_weights(w1, b1, w2, b2, x.dtype, x.device)
    if (weights.channels, weights.kernel_size, weights.dtype) != (
        c, kernel_size, x.dtype,
    ) or weights.mma != uses_mma(c, x.dtype):
        raise ValueError("packed weights do not match x or kernel_size")
    for p in (weights.w1, weights.b1, weights.w2, weights.b2):
        if p.device != x.device:
            raise ValueError("packed weights are on another device")

    out = torch.empty_like(x)
    lib = build_library()
    pointers = (
        x.data_ptr(), out.data_ptr(),
        weights.w1.data_ptr(), weights.b1.data_ptr(),
        weights.w2.data_ptr(), weights.b2.data_ptr(),
    )
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # ctypes launches on the current device, and the kernels'
    # cudaFuncSetAttribute applies to it alone: make it x's
    with torch.cuda.device(x.device):
        if weights.mma:
            rows, groups = pick_mma_config(
                c, kernel_size, dilation, t, batch, x.dtype
            )
            err = lib.resblock_subblock_mma_launch(
                *pointers, batch, c, t, kernel_size, dilation, rows, groups,
                int(x.dtype == torch.bfloat16), stream,
            )
        else:
            tile = pick_tile(c, kernel_size, dilation, t)
            err = lib.resblock_subblock_launch(
                *pointers, batch, c, t, kernel_size, dilation, tile,
                int(x.dtype == torch.bfloat16), stream,
            )
    if err != 0:
        raise RuntimeError(
            f"resblock_subblock kernel launch failed: cuda error {err}"
        )
    with _LAUNCHES_LOCK:  # several request and driver threads launch
        launches += 1
    return out
