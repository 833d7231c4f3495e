"""Piecewise rational-quadratic spline, inverse direction only.

Counterpart of ``mimic3_tpu/models/vits/transforms.py`` for synthesis: the
same math (Durkan et al., arXiv 1906.04032) with linear tails outside
``[-tail_bound, tail_bound]``, bins on the last axis.  Synthesis runs the
duration flows in reverse and discards the log-determinant, so neither the
forward direction nor the log-determinant is ported.
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
