"""Conv weights packed for the tensor-core tile of ``csrc/conv_tile.cuh``.

bf16: a conv ``[Cout, Cin, K]`` becomes bf16 MMA B-operand fragments, in
the order in which the lanes of a warp load them: for tap ``j``, 16-deep K
chunk ``kc`` (input channels) and pair ``np`` of 8-wide N tiles (output
channels), lane ``l`` holds four 32-bit registers, each two bf16 values
with the lower K index in the low half:

- register ``2h``: ``W[n, k], W[n, k + 1]``,
- register ``2h + 1``: ``W[n, k + 8], W[n, k + 9]``,

with ``n = 16 np + 8 h + l // 4`` and ``k = 16 kc + 2 (l % 4)``: the
``b0, b1`` / ``b2, b3`` registers of ``mma.sync.m16n8k16`` for N tile
``2 np + h``.  Both channel counts are zero-padded to multiples of 16.
The result is an int32 tensor ``[K, Cin/16, Cout/16, 32, 4]``.

float32 (three TF32 passes): the weights are split once, ``w = w_hi +
w_lo`` with both parts rounded to TF32 (:func:`split_tf32`), and packed
for ``mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32``: for tap ``j``, 8-deep
K chunk ``kc`` and 8-wide N tile ``nt``, lane ``l`` holds four 32-bit
registers

- ``w_hi[n, k], w_hi[n, k + 4], w_lo[n, k], w_lo[n, k + 4]``

with ``n = 8 nt + l // 4`` and ``k = 8 kc + l % 4``: the ``b0, b1`` of
the hi pass, then those of the lo pass.  Channels are zero-padded to
multiples of 16, as for bf16, so both paths share their launch plans.
The result is an int32 tensor ``[K, Cin/8, Cout/8, 32, 4]`` holding the
float32 bit patterns.

bf16 for the warpgroup MMA (``wgmma``, the fused stage of
``csrc/stage.cu``): a ``C x C`` block ``B[k, n]`` (input channel ``k``,
output channel ``n``; ``C`` a multiple of 16) becomes the K-major B
operand in shared memory without swizzle, as ``wgmma`` reads it through a
matrix descriptor: 16-deep K chunk ``kc``, 8-wide N group ``ng``, K half
``kh`` (a core matrix: 8 output channels x 16 bytes of 8 input channels,
row ``n % 8``), so element ``(k, n)`` sits at bf16 index
``((kc (C/8) + ng) 2 + kh) 64 + (n % 8) 8 + k % 8`` with ``k = 16 kc +
8 kh + k % 8``.  A K chunk's operand starts at byte ``kc (C/8) 256``; the
next K core matrix lies 128 bytes on (the descriptor's leading byte
offset), the next N group 256 bytes on (its stride byte offset).
"""

from __future__ import annotations

import torch


def padded(channels: int) -> int:
    """Channels rounded up to the MMA depth of 16."""
    return -(-channels // 16) * 16


def fragment_index(cin_p: int, cout_p: int):
    """(n, k) index tensors ``[Cin/16, Cout/16, 32, 4, 2]`` of the weight
    element at each (K chunk, N-tile pair, lane, register, half)."""
    kc = torch.arange(cin_p // 16).view(-1, 1, 1, 1, 1)
    npair = torch.arange(cout_p // 16).view(1, -1, 1, 1, 1)
    lane = torch.arange(32).view(1, 1, -1, 1, 1)
    reg = torch.arange(4).view(1, 1, 1, -1, 1)
    half = torch.arange(2).view(1, 1, 1, 1, -1)
    n = 16 * npair + 8 * (reg // 2) + lane // 4
    k = 16 * kc + 2 * (lane % 4) + 8 * (reg % 2) + half
    shape = (cin_p // 16, cout_p // 16, 32, 4, 2)
    return n.expand(shape), k.expand(shape)


def pack_conv_fragments(w: torch.Tensor) -> torch.Tensor:
    """``[Cout, Cin, K]`` weights -> int32 fragments
    ``[K, Cin/16, Cout/16, 32, 4]`` (bf16 pairs), on w's device."""
    cout, cin, k = w.shape
    cin_p, cout_p = padded(cin), padded(cout)
    wp = torch.zeros(k, cout_p, cin_p, dtype=torch.bfloat16, device=w.device)
    wp[:, :cout, :cin] = w.detach().to(torch.bfloat16).permute(2, 0, 1)
    n, kk = fragment_index(cin_p, cout_p)
    vals = wp[:, n.to(w.device), kk.to(w.device)]  # [K, kc, np, 32, 4, 2]
    return vals.contiguous().view(torch.int32).squeeze(-1).contiguous()


def split_tf32(t: torch.Tensor):
    """``(hi, lo)`` float32 with ``t = hi + lo`` up to the rounding of
    ``lo``: ``hi`` is ``t`` rounded to TF32 (10 mantissa bits, the low 13
    bits zero) to nearest with ties away from zero, as ``cvt.rna.tf32.f32``
    rounds, and ``lo`` is ``t - hi`` rounded the same way."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t)
    return hi, rna(t.float() - hi)


def tf32_fragment_index(cin_p: int, cout_p: int):
    """(n, k, part) index tensors ``[Cin/8, Cout/8, 32, 4]`` of the weight
    element at each (K chunk, N tile, lane, register); ``part`` is 0 for
    ``w_hi``, 1 for ``w_lo``."""
    kc = torch.arange(cin_p // 8).view(-1, 1, 1, 1)
    nt = torch.arange(cout_p // 8).view(1, -1, 1, 1)
    lane = torch.arange(32).view(1, 1, -1, 1)
    reg = torch.arange(4).view(1, 1, 1, -1)
    n = 8 * nt + lane // 4
    k = 8 * kc + lane % 4 + 4 * (reg % 2)
    part = reg // 2
    shape = (cin_p // 8, cout_p // 8, 32, 4)
    return n.expand(shape), k.expand(shape), part.expand(shape)


def pack_conv_fragments_tf32(w: torch.Tensor) -> torch.Tensor:
    """``[Cout, Cin, K]`` float32 weights -> int32 fragments
    ``[K, Cin/8, Cout/8, 32, 4]`` (TF32 hi/lo bit patterns), on w's
    device."""
    cout, cin, k = w.shape
    cin_p, cout_p = padded(cin), padded(cout)
    wp = torch.zeros(k, cout_p, cin_p, device=w.device)
    wp[:, :cout, :cin] = w.detach().float().permute(2, 0, 1)
    parts = torch.stack(split_tf32(wp))  # [2, K, Cout_p, Cin_p]
    n, kk, part = (i.to(w.device) for i in tf32_fragment_index(cin_p, cout_p))
    vals = parts[part, :, n, kk]  # [kc, nt, 32, 4, K]
    return vals.permute(4, 0, 1, 2, 3).contiguous().view(torch.int32)


def pack_wgmma_block(b: torch.Tensor) -> torch.Tensor:
    """``[..., C, C]`` blocks ``B[k, n]`` -> bf16 ``[..., C * C]``, each in
    the wgmma B layout (module docstring), on b's device."""
    c = b.shape[-1]
    if b.shape[-2] != c or c % 16:
        raise ValueError(f"a wgmma block is C x C with C % 16 == 0, "
                         f"not {tuple(b.shape[-2:])}")
    lead = b.shape[:-2]
    v = b.detach().to(torch.bfloat16).reshape(*lead, c // 16, 2, 8, c // 8, 8)
    n = len(lead)  # kc, ng, kh, n % 8, k % 8
    v = v.permute(*range(n), n, n + 3, n + 1, n + 4, n + 2)
    return v.reshape(*lead, c * c)


def pad_bias(b, channels: int, device=None,
             dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Bias rounded to ``dtype``, held as float32 and padded with zeros to
    :func:`padded` channels (``None`` = zeros)."""
    out = torch.zeros(padded(channels), device=device)
    if b is not None:
        out[:channels] = b.detach().to(dtype).float().reshape(-1)
    return out
