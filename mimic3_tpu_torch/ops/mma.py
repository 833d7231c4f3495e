"""Conv weights packed for the tensor-core tile of ``csrc/conv_tile.cuh``.

A conv ``[Cout, Cin, K]`` becomes bf16 MMA B-operand fragments, in the
order in which the lanes of a warp load them: for tap ``j``, 16-deep K
chunk ``kc`` (input channels) and pair ``np`` of 8-wide N tiles (output
channels), lane ``l`` holds four 32-bit registers, each two bf16 values
with the lower K index in the low half:

- register ``2h``: ``W[n, k], W[n, k + 1]``,
- register ``2h + 1``: ``W[n, k + 8], W[n, k + 9]``,

with ``n = 16 np + 8 h + l // 4`` and ``k = 16 kc + 2 (l % 4)``: the
``b0, b1`` / ``b2, b3`` registers of ``mma.sync.m16n8k16`` for N tile
``2 np + h``.  Both channel counts are zero-padded to multiples of 16.
The result is an int32 tensor ``[K, Cin/16, Cout/16, 32, 4]``.
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


def pad_bias(b, channels: int, device=None) -> torch.Tensor:
    """Bias rounded to bf16, held as float32 and padded with zeros to
    :func:`padded` channels (``None`` = zeros)."""
    out = torch.zeros(padded(channels), device=device)
    if b is not None:
        out[:channels] = b.detach().to(torch.bfloat16).float().reshape(-1)
    return out
