"""Piecewise rational-quadratic spline (neural spline flows).

Counterpart of ``mimic3_tpu/models/vits/transforms.py``: the same math
(Durkan et al., arXiv 1906.04032) with linear tails outside
``[-tail_bound, tail_bound]``, bins on the last axis.  Synthesis runs the
duration flows in reverse and discards the log-determinant
(``*_inverse``); training runs them forward and needs it
(:func:`rational_quadratic_spline`,
:func:`unconstrained_rational_quadratic_spline`,
:func:`piecewise_rational_quadratic_transform`).
"""

from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted_onehot(
    bin_locations: torch.Tensor, inputs: torch.Tensor
) -> torch.Tensor:
    """Index of the bin containing each input, in [0, n_bins-1]."""
    inside = (inputs[..., None] >= bin_locations[..., :-1]).long()
    idx = inside.sum(dim=-1) - 1
    return idx.clamp(0, bin_locations.shape[-1] - 2)


def _edges(
    unnormalized: torch.Tensor, low: float, high: float, min_bin: float
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Softmax bin sizes -> (cumulative edges pinned to [low, high], sizes)."""
    num_bins = unnormalized.shape[-1]
    sizes = torch.softmax(unnormalized, dim=-1)
    sizes = min_bin + (1 - min_bin * num_bins) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0))
    cum = (high - low) * cum + low
    cum = torch.cat(
        [
            torch.full_like(cum[..., :1], low),
            cum[..., 1:-1],
            torch.full_like(cum[..., :1], high),
        ],
        dim=-1,
    )
    return cum, cum[..., 1:] - cum[..., :-1]


def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(arr, -1, idx[..., None])[..., 0]


def rational_quadratic_spline_inverse(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    bound: float,
) -> torch.Tensor:
    """Inverse of the monotonic rational-quadratic spline mapping
    ``[-bound, bound]`` onto itself (the reference's ``inverse=True``)."""
    cumwidths, widths = _edges(
        unnormalized_widths, -bound, bound, DEFAULT_MIN_BIN_WIDTH
    )
    cumheights, heights = _edges(
        unnormalized_heights, -bound, bound, DEFAULT_MIN_BIN_HEIGHT
    )
    derivatives = DEFAULT_MIN_DERIVATIVE + F.softplus(
        unnormalized_derivatives
    )

    bin_idx = _searchsorted_onehot(cumheights, inputs)
    in_cumwidths = _gather(cumwidths, bin_idx)
    in_widths = _gather(widths, bin_idx)
    in_cumheights = _gather(cumheights, bin_idx)
    in_heights = _gather(heights, bin_idx)
    in_delta = _gather(heights / widths, bin_idx)
    in_d = _gather(derivatives, bin_idx)
    in_d1 = _gather(derivatives[..., 1:], bin_idx)
    slope_sum = in_d + in_d1 - 2 * in_delta

    dy = inputs - in_cumheights
    a = dy * slope_sum + in_heights * (in_delta - in_d)
    b = in_heights * in_d - dy * slope_sum
    c = -in_delta * dy
    discriminant = torch.clamp(b * b - 4 * a * c, min=0.0)
    root = (2 * c) / (-b - torch.sqrt(discriminant))
    return root * in_widths + in_cumwidths


def unconstrained_rational_quadratic_spline_inverse(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    tail_bound: float = 5.0,
) -> torch.Tensor:
    """Inverse spline inside ``[-tail_bound, tail_bound]``, identity
    (linear tails) outside; the boundary slopes are pinned to 1."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - DEFAULT_MIN_DERIVATIVE))
    spline_out = rational_quadratic_spline_inverse(
        inputs.clamp(-tail_bound, tail_bound),
        unnormalized_widths,
        unnormalized_heights,
        F.pad(unnormalized_derivatives, (1, 1), value=constant),
        tail_bound,
    )
    return torch.where(inside, spline_out, inputs)


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    left: float = 0.0,
    right: float = 1.0,
    bottom: float = 0.0,
    top: float = 1.0,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Forward monotonic rational-quadratic spline ``[left, right] ->
    [bottom, top]`` (the reference's ``inverse=False``).

    inputs: [...]; unnormalized_*: [..., n_bins] (derivatives: n_bins+1).
    Returns (outputs, logabsdet), both shaped like ``inputs``.
    """
    cumwidths, widths = _edges(
        unnormalized_widths, left, right, DEFAULT_MIN_BIN_WIDTH
    )
    cumheights, heights = _edges(
        unnormalized_heights, bottom, top, DEFAULT_MIN_BIN_HEIGHT
    )
    derivatives = DEFAULT_MIN_DERIVATIVE + F.softplus(
        unnormalized_derivatives
    )

    bin_idx = _searchsorted_onehot(cumwidths, inputs)
    in_cumwidths = _gather(cumwidths, bin_idx)
    in_widths = _gather(widths, bin_idx)
    in_cumheights = _gather(cumheights, bin_idx)
    in_heights = _gather(heights, bin_idx)
    in_delta = _gather(heights / widths, bin_idx)
    in_d = _gather(derivatives, bin_idx)
    in_d1 = _gather(derivatives[..., 1:], bin_idx)

    theta = (inputs - in_cumwidths) / in_widths
    theta_one_minus_theta = theta * (1 - theta)
    numerator = in_heights * (
        in_delta * theta.square() + in_d * theta_one_minus_theta
    )
    denominator = in_delta + (
        (in_d + in_d1 - 2 * in_delta) * theta_one_minus_theta
    )
    outputs = in_cumheights + numerator / denominator
    derivative_numerator = in_delta.square() * (
        in_d1 * theta.square()
        + 2 * in_delta * theta_one_minus_theta
        + in_d * (1 - theta).square()
    )
    logabsdet = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, logabsdet


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    tail_bound: float = 5.0,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Forward spline inside ``[-tail_bound, tail_bound]``, identity
    (linear tails, log-determinant 0) outside; boundary slopes pinned to
    1."""
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.expm1(1 - DEFAULT_MIN_DERIVATIVE))
    spline_out, spline_logdet = rational_quadratic_spline(
        inputs.clamp(-tail_bound, tail_bound),
        unnormalized_widths,
        unnormalized_heights,
        F.pad(unnormalized_derivatives, (1, 1), value=constant),
        left=-tail_bound,
        right=tail_bound,
        bottom=-tail_bound,
        top=tail_bound,
    )
    return (
        torch.where(inside, spline_out, inputs),
        torch.where(inside, spline_logdet, torch.zeros_like(spline_logdet)),
    )


def piecewise_rational_quadratic_transform(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    tails: typing.Optional[str] = None,
    tail_bound: float = 1.0,
) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """Forward dispatcher with the VITS call signature: ``tails=None`` is
    the spline on the unit square, ``"linear"`` adds identity tails."""
    if tails is None:
        return rational_quadratic_spline(
            inputs,
            unnormalized_widths,
            unnormalized_heights,
            unnormalized_derivatives,
        )
    if tails != "linear":
        raise ValueError(f"Unsupported tails: {tails}")
    return unconstrained_rational_quadratic_spline(
        inputs,
        unnormalized_widths,
        unnormalized_heights,
        unnormalized_derivatives,
        tail_bound=tail_bound,
    )
