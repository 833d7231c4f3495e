"""Duration predictors.

Counterpart of ``mimic3_tpu/models/vits/duration.py`` in ``[B, C, T]``
layout: the stochastic duration predictor run in reverse (synthesis) and
forward to score durations (training,
:func:`stochastic_duration_predictor_nll`), and the deterministic conv
predictor for ``use_sdp=False`` voices.
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

from .layers import Params, conv1d, layer_norm
from .transforms import (
    piecewise_rational_quadratic_transform,
    unconstrained_rational_quadratic_spline_inverse,
)

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


def log_flow(
    x: torch.Tensor, x_mask: torch.Tensor
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Forward ``y = log(max(x, 1e-5))``; returns (y, logdet [B])."""
    y = torch.log(torch.clamp(x, min=1e-5)) * x_mask
    return y, torch.sum(-y, dim=(1, 2))


def elementwise_affine(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Forward ``y = m + exp(logs) * x``; returns (y, logdet [B])."""
    m = p["m"][None, :, None]
    logs = p["logs"][None, :, None]
    y = (m + torch.exp(logs) * x) * x_mask
    return y, torch.sum(logs * x_mask, dim=(1, 2))


def elementwise_affine_reverse(
    p: Params, x: torch.Tensor, x_mask: torch.Tensor
) -> torch.Tensor:
    """Inverse of ``y = m + exp(logs) * x`` (params m/logs: [C])."""
    m = p["m"][None, :, None]
    logs = p["logs"][None, :, None]
    return (x - m) * torch.exp(-logs) * x_mask


def flip_flow(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=[1])


def _spline_params(
    p: Params,
    x0: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor],
    num_bins: int,
) -> typing.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A coupling's spline parameters from its conditioning half x0:
    (widths, heights, derivatives), unnormalized, bins last."""
    h = conv1d(x0, p["pre"])
    h = dds_conv(p["convs"], h, x_mask, g=g)
    h = conv1d(h, p["proj"]) * x_mask

    b, half, t = x0.shape
    # proj channels split channel-major: [B, half, bins*3-1, T] -> bins last
    h = h.reshape(b, half, num_bins * 3 - 1, t).permute(0, 1, 3, 2)
    denom = math.sqrt(p["pre"]["weight"].shape[0])  # sqrt(filter_channels)
    return (
        h[..., :num_bins] / denom,
        h[..., num_bins : 2 * num_bins] / denom,
        h[..., 2 * num_bins :],
    )


def conv_flow(
    p: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    num_bins: int = SDP_NUM_BINS,
    tail_bound: float = SDP_TAIL_BOUND,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Forward spline coupling: x [B, 2, T]; the first half conditions the
    spline applied to the second.  Returns (x, logdet [B])."""
    half = x.shape[1] // 2
    x0, x1 = x[:, :half], x[:, half:]
    x1_new, logabsdet = piecewise_rational_quadratic_transform(
        x1,
        *_spline_params(p, x0, x_mask, g, num_bins),
        tails="linear",
        tail_bound=tail_bound,
    )
    x_out = torch.cat([x0, x1_new], dim=1) * x_mask
    return x_out, torch.sum(logabsdet * x_mask, dim=(1, 2))


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
    x1_new = unconstrained_rational_quadratic_spline_inverse(
        x1,
        *_spline_params(p, x0, x_mask, g, num_bins),
        tail_bound=tail_bound,
    )
    return torch.cat([x0, x1_new], dim=1) * x_mask


def _sdp_condition(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor],
) -> torch.Tensor:
    """Shared preprocessing: encoder text -> flow conditioning (no
    gradient reaches the encoder or the speaker embedding from here)."""
    x = conv1d(x.detach(), params["pre"])
    if g is not None and "cond" in params:
        x = x + conv1d(g.detach(), params["cond"])
    x = dds_conv(params["convs"], x, x_mask)
    return conv1d(x, params["proj"]) * x_mask


def stochastic_duration_predictor_infer(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    noise: torch.Tensor,
    noise_scale: typing.Union[float, torch.Tensor],
    g: typing.Optional[torch.Tensor] = None,
    *,
    n_flows: int = SDP_N_FLOWS,
) -> torch.Tensor:
    """Sample log-durations (reverse pass).  Returns [B, 1, T].

    ``noise`` [B, 2, T] is drawn by the caller (position-indexed in
    ``model.py``).  With ``noise_scale == 0`` the path is deterministic.
    ``noise_scale`` may be a 0-d float32 tensor on ``noise``'s device.
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


def stochastic_duration_predictor_nll(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    w: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    noise: typing.Optional[torch.Tensor] = None,
    generator: typing.Optional[torch.Generator] = None,
    n_flows: int = SDP_N_FLOWS,
) -> torch.Tensor:
    """Training negative log-likelihood of durations ``w`` [B, 1, T].

    The variational bound of the VITS paper: a posterior flow proposes
    (u, v) that dequantize the integer durations, then the main flow
    scores (w - u, v).  ``noise`` [B, 2, T] is the posterior's standard
    normal draw (the reference's ``e_q``, duration.py:255-256); without
    it the draw comes from ``generator``.  Returns per-example NLL summed
    over time: [B].
    """
    cond = _sdp_condition(params, x, x_mask, g)

    # posterior over (u, noise)
    h_w = conv1d(w, params["post_pre"])
    h_w = dds_conv(params["post_convs"], h_w, x_mask)
    h_w = conv1d(h_w, params["post_proj"]) * x_mask

    b, _, t = x.shape
    if noise is None:
        noise = torch.randn(
            b, 2, t, generator=generator, device=x.device, dtype=x.dtype
        )
    e_q = noise * x_mask
    z_q, logdet_tot_q = elementwise_affine(
        params["post_flows"]["0"], e_q, x_mask
    )
    for i in range(n_flows):
        z_q, ld = conv_flow(
            params["post_flows"][str(2 * i + 1)], z_q, x_mask, g=cond + h_w
        )
        logdet_tot_q = logdet_tot_q + ld
        z_q = flip_flow(z_q)

    z_u, z1 = z_q[:, 0:1], z_q[:, 1:2]
    u = torch.sigmoid(z_u) * x_mask
    z0 = (w - u) * x_mask
    logdet_tot_q = logdet_tot_q + torch.sum(
        (F.logsigmoid(z_u) + F.logsigmoid(-z_u)) * x_mask, dim=(1, 2)
    )
    logq = (
        torch.sum(
            -0.5 * (math.log(2 * math.pi) + e_q.square()) * x_mask,
            dim=(1, 2),
        )
        - logdet_tot_q
    )

    # main flow forward
    z0, logdet_tot = log_flow(z0, x_mask)
    z = torch.cat([z0, z1], dim=1)
    z, ld = elementwise_affine(params["flows"]["0"], z, x_mask)
    logdet_tot = logdet_tot + ld
    for i in range(n_flows):
        z, ld = conv_flow(params["flows"][str(2 * i + 1)], z, x_mask, g=cond)
        logdet_tot = logdet_tot + ld
        z = flip_flow(z)

    nll = (
        torch.sum(
            0.5 * (math.log(2 * math.pi) + z.square()) * x_mask, dim=(1, 2)
        )
        - logdet_tot
    )
    return nll + logq


def duration_predictor(
    params: Params,
    x: torch.Tensor,
    x_mask: torch.Tensor,
    g: typing.Optional[torch.Tensor] = None,
    *,
    kernel_size: int = SDP_KERNEL,
) -> torch.Tensor:
    """Two-conv duration predictor; returns log-durations [B, 1, T]."""
    x = x.detach()
    if g is not None and "cond" in params:
        x = x + conv1d(g.detach(), params["cond"])
    pad = kernel_size // 2
    x = torch.relu(conv1d(x * x_mask, params["conv_1"], padding=pad))
    x = layer_norm(x, params["norm_1"])
    x = torch.relu(conv1d(x * x_mask, params["conv_2"], padding=pad))
    x = layer_norm(x, params["norm_2"])
    x = conv1d(x * x_mask, params["proj"])
    return x * x_mask
