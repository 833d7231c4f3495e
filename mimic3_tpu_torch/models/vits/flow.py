"""Residual-coupling flow and its WaveNet inner net.

Counterpart of ``mimic3_tpu/models/vits/flow.py`` in ``[B, C, T]`` layout:
reverse at synthesis (prior sample -> decoder latent), forward at training
(posterior latent -> prior space).
"""

from __future__ import annotations

import typing

import torch

from .layers import Params, conv1d, fused_add_tanh_sigmoid_multiply

WN_KERNEL = 5
WN_LAYERS = 4
N_COUPLING = 4


def wavenet(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    kernel_size: int = WN_KERNEL,
    n_layers: int = WN_LAYERS,
    dilation_rate: int = 1,
) -> torch.Tensor:
    """Gated WaveNet stack (VITS ``WN``).  x: [B, hidden, T];
    g: [B, gin, 1] global conditioning."""
    hidden = x.shape[1]
    output = torch.zeros_like(x)
    g_all = None
    if g is not None and "cond_layer" in params:
        g_all = conv1d(g, params["cond_layer"])  # [B, 2*hidden*n_layers, 1]

    for i in range(n_layers):
        si = str(i)
        dilation = dilation_rate**i
        x_in = conv1d(
            x,
            params["in_layers"][si],
            padding=(kernel_size * dilation - dilation) // 2,
            dilation=dilation,
        )
        g_l = (
            g_all[:, i * 2 * hidden : (i + 1) * 2 * hidden]
            if g_all is not None
            else torch.zeros_like(x_in)
        )
        acts = fused_add_tanh_sigmoid_multiply(x_in, g_l, hidden)
        res_skip = conv1d(acts, params["res_skip_layers"][si])
        if i < n_layers - 1:
            x = (x + res_skip[:, :hidden]) * x_mask
            output = output + res_skip[:, hidden:]
        else:
            output = output + res_skip
    return output * x_mask


def _coupling_mean(
    params: Params,
    x0: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor],
) -> torch.Tensor:
    """A mean-only coupling's shift m(x0)."""
    h = conv1d(x0, params["pre"]) * x_mask
    h = wavenet(params["enc"], h, x_mask, g=g)
    return conv1d(h, params["post"]) * x_mask


def residual_coupling_layer(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean-only affine coupling, forward: x1 <- x1 + m(x0)."""
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]
    m = _coupling_mean(params, x0, x_mask, g)
    return torch.cat([x0, (m + x1) * x_mask], dim=1)


def residual_coupling_layer_reverse(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean-only affine coupling, inverse: x1 <- x1 - m(x0)."""
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]
    m = _coupling_mean(params, x0, x_mask, g)
    return torch.cat([x0, (x1 - m) * x_mask], dim=1)


def residual_coupling_block(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    n_flows: int = N_COUPLING,
) -> torch.Tensor:
    """The full flow forward: [coupling, flip] for couplings at
    ``flows.{0,2,4,6}``."""
    for i in range(n_flows):
        x = residual_coupling_layer(params["flows"][str(2 * i)], x, x_mask, g=g)
        x = torch.flip(x, dims=[1])
    return x


def residual_coupling_block_reverse(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    n_flows: int = N_COUPLING,
) -> torch.Tensor:
    """The full flow in reverse: [flip, coupling^-1] for couplings at
    ``flows.{6,4,2,0}``."""
    for i in reversed(range(n_flows)):
        x = torch.flip(x, dims=[1])
        x = residual_coupling_layer_reverse(
            params["flows"][str(2 * i)], x, x_mask, g=g
        )
    return x
