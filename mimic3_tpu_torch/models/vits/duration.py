"""Duration predictors (inference direction).

Counterpart of ``mimic3_tpu/models/vits/duration.py`` in ``[B, C, T]``
layout: the stochastic duration predictor run in reverse and the
deterministic conv predictor for ``use_sdp=False`` voices.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

from .layers import Params, conv1d, layer_norm
from .transforms import unconstrained_rational_quadratic_spline_inverse

SDP_NUM_BINS = 10
SDP_TAIL_BOUND = 5.0
SDP_N_FLOWS = 4
SDP_KERNEL = 3
SDP_DDS_LAYERS = 3


def dds_conv(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    kernel_size: int = SDP_KERNEL,
    n_layers: int = SDP_DDS_LAYERS,
) -> torch.Tensor:
    """Dilated depth-separable convs with residuals (VITS ``DDSConv``)."""
    channels = x.shape[1]
    if g is not None:
        x = x + g
    for i in range(n_layers):
        si = str(i)
        dilation = kernel_size**i
        y = conv1d(
            x * x_mask,
            params["convs_sep"][si],
            padding=(kernel_size * dilation - dilation) // 2,
            dilation=dilation,
            groups=channels,
        )
        y = F.gelu(layer_norm(y, params["norms_1"][si]))
        y = conv1d(y, params["convs_1x1"][si])
        y = F.gelu(layer_norm(y, params["norms_2"][si]))
        x = x + y
    return x * x_mask


def elementwise_affine_reverse(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor
) -> torch.Tensor:
    """Inverse of ``y = m + exp(logs) * x`` (params m/logs: [C])."""
    m = p["m"][None, :, None]
    logs = p["logs"][None, :, None]
    return (x - m) * torch.exp(-logs) * x_mask


def flip_flow(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=[1])


def conv_flow_reverse(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    num_bins: int = SDP_NUM_BINS,
    tail_bound: float = SDP_TAIL_BOUND,
) -> torch.Tensor:
    """Inverse spline coupling: x [B, 2, T]; the first half conditions the
    spline applied to the second."""
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]

    h = conv1d(x0, p["pre"])
    h = dds_conv(p["convs"], h, x_mask, g=g)
    h = conv1d(h, p["proj"]) * x_mask

    b, _, t = x0.shape
    # proj channels split channel-major: [B, half, bins*3-1, T] -> bins last
    h = h.reshape(b, half, num_bins * 3 - 1, t).permute(0, 1, 3, 2)
    denom = math.sqrt(p["pre"]["weight"].shape[0])  # sqrt(filter_channels)
    x1_new = unconstrained_rational_quadratic_spline_inverse(
        x1,
        h[..., :num_bins] / denom,
        h[..., num_bins : 2 * num_bins] / denom,
        h[..., 2 * num_bins :],
        tail_bound=tail_bound,
    )
    return torch.cat([x0, x1_new], dim=1) * x_mask


def _sdp_condition(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor],
) -> torch.Tensor:
    """Shared preprocessing: encoder text -> flow conditioning."""
    x = conv1d(x, params["pre"])
    if g is not None and "cond" in params:
        x = x + conv1d(g, params["cond"])
    x = dds_conv(params["convs"], x, x_mask)
    return conv1d(x, params["proj"]) * x_mask


def stochastic_duration_predictor_infer(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    noise: torch.Tensor,
    noise_scale: float,
    g: typing.Optional[torch.Tensor] = None,
    *,
    n_flows: int = SDP_N_FLOWS,
) -> torch.Tensor:
    """Sample log-durations (reverse pass).  Returns [B, 1, T].

    ``noise`` [B, 2, T] is drawn by the caller (position-indexed in
    ``model.py``).  With ``noise_scale == 0`` the path is deterministic.
    """
    cond = _sdp_condition(params, x, x_mask, g)
    z = noise * noise_scale * x_mask
    # flows.0 = ElementwiseAffine, flows.{1,3,5,7} = ConvFlows.  VITS drops
    # the first ConvFlow (flows.1) at inference: flip, cf_3, flip, cf_2,
    # flip, cf_1, flip, affine.
    for i in reversed(range(1, n_flows)):
        z = flip_flow(z)
        z = conv_flow_reverse(
            params["flows"][str(2 * i + 1)], z, x_mask, g=cond
        )
    z = flip_flow(z)
    z = elementwise_affine_reverse(params["flows"]["0"], z, x_mask)
    return z[:, 0:1]


def duration_predictor(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    kernel_size: int = SDP_KERNEL,
) -> torch.Tensor:
    """Two-conv duration predictor; returns log-durations [B, 1, T]."""
    if g is not None and "cond" in params:
        x = x + conv1d(g, params["cond"])
    pad = kernel_size // 2
    x = torch.relu(conv1d(x * x_mask, params["conv_1"], padding=pad))
    x = layer_norm(x, params["norm_1"])
    x = torch.relu(conv1d(x * x_mask, params["conv_2"], padding=pad))
    x = layer_norm(x, params["norm_2"])
    x = conv1d(x * x_mask, params["proj"])
    return x * x_mask
