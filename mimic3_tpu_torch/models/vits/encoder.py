"""VITS text encoder with windowed relative-position attention.

Counterpart of ``mimic3_tpu/models/vits/encoder.py`` in ``[B, C, T]``
layout.  The relative<->absolute index shifts are the same pad-and-reshape
tricks as the reference.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

from ...parallel import tensor as tp
from .layers import Params, conv1d, conv_weight, embedding, layer_norm

WINDOW_SIZE = 4


def _get_relative_embeddings(
    rel_emb: torch.Tensor, length: int, window: int
) -> torch.Tensor:
    """Pad/slice the learned [1, 2*window+1, D] table to [1, 2*length-1, D]."""
    pad_length = max(length - (window + 1), 0)
    slice_start = max((window + 1) - length, 0)
    if pad_length > 0:
        rel_emb = F.pad(rel_emb, (0, 0, pad_length, pad_length))
    return rel_emb[:, slice_start : slice_start + 2 * length - 1]


def _relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, 2L-1] relative logits -> [B, H, L, L] absolute logits."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1 :]


def _absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """[B, H, L, L] attention weights -> [B, H, L, 2L-1] relative weights."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * (2 * l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def relative_attention(
    x: torch.Tensor,
    p: Params,
    attn_mask: torch.Tensor,
    n_heads: int,
    window: typing.Optional[int] = WINDOW_SIZE,
) -> torch.Tensor:
    """Self-attention block. x: [B, C, T]; attn_mask: [B, 1, T, T]."""
    b, c, t = x.shape
    head_dim = c // n_heads

    def split_heads(y: torch.Tensor) -> torch.Tensor:  # -> [B, H, T, D]
        return y.reshape(b, n_heads, head_dim, t).transpose(2, 3)

    q = split_heads(conv1d(x, p["conv_q"])) / math.sqrt(head_dim)
    k = split_heads(conv1d(x, p["conv_k"]))
    v = split_heads(conv1d(x, p["conv_v"]))

    scores = torch.matmul(q, k.transpose(2, 3))
    if window is not None:
        rel_k = _get_relative_embeddings(p["emb_rel_k"], t, window)
        rel_logits = torch.matmul(q, rel_k[0].t())  # [B, H, T, 2T-1]
        scores = scores + _relative_to_absolute(rel_logits)

    scores = scores.masked_fill(attn_mask <= 0, -1e4)
    weights = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.matmul(weights, v)
    if window is not None:
        rel_v = _get_relative_embeddings(p["emb_rel_v"], t, window)
        out = out + torch.matmul(
            _absolute_to_relative(weights), rel_v[0].to(weights.dtype)
        )
    out = out.transpose(2, 3).reshape(b, c, t)
    return conv1d(out, p["conv_o"])


def ffn(
    x: torch.Tensor, p: Params, x_mask: torch.Tensor, kernel_size: int
) -> torch.Tensor:
    """Conv feed-forward: conv(k) -> relu -> conv(k), masked.

    With the convs split over a tp row (Megatron style: ``conv_1`` on its
    output channels, ``conv_2`` on its input channels) the hidden
    channels stay split between them, relu and mask per part, and the
    one cross-device step is ``conv_2``'s sum of partial outputs.
    """
    pad = (kernel_size - 1) // 2
    if tp.is_split(p["conv_1"]):
        h = tp.conv(x * x_mask, conv_weight(p["conv_1"]),
                    p["conv_1"].get("bias"), padding=pad, keep_split=True)
        h = tp.Split(tuple(torch.relu(t) * x_mask.to(t.device)
                           for t in h.parts), h.axis, h.row)
        return tp.conv(h, conv_weight(p["conv_2"]), p["conv_2"].get("bias"),
                       padding=pad) * x_mask
    y = torch.relu(conv1d(x * x_mask, p["conv_1"], padding=pad))
    y = conv1d(y * x_mask, p["conv_2"], padding=pad)
    return y * x_mask


def text_encoder(
    params: Params,
    ids: torch.Tensor,
    x_mask: torch.Tensor,
    *,
    n_layers: int,
    n_heads: int,
    kernel_size: int,
    window: int = WINDOW_SIZE,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(x, m_p, logs_p)``, all ``[B, C, T]`` and masked.

    ids: [B, T]; x_mask: [B, 1, T].
    """
    hidden = params["emb"]["weight"].shape[1]
    x = embedding(ids, params["emb"]) * math.sqrt(hidden)
    x = x.transpose(1, 2) * x_mask
    attn_mask = x_mask.unsqueeze(-1) * x_mask.unsqueeze(2)  # [B,1,T,T]

    for i in range(n_layers):
        si = str(i)
        y = relative_attention(
            x, params["attn_layers"][si], attn_mask, n_heads, window
        )
        x = layer_norm(x + y, params["norm_layers_1"][si])
        y = ffn(x, params["ffn_layers"][si], x_mask, kernel_size)
        x = layer_norm(x + y, params["norm_layers_2"][si])

    x = x * x_mask
    stats = conv1d(x, params["proj"]) * x_mask
    inter = stats.shape[1] // 2
    return x, stats[:, :inter], stats[:, inter:]
