"""Tensor parallelism over one dp row's ``tp`` devices, in one process.

The reference has no such module: it places the tp-ruled weights
(``parallel/mesh.py::_TP_RULES``) with ``NamedSharding`` and XLA's SPMD
partitioner inserts the collectives.  Here they are explicit, and all of
them are in this file:

- :class:`Split`: a tensor cut into T contiguous parts along one axis,
  part ``j`` on the row's device ``j`` (``shard_params`` makes the
  weights' splits; a column-parallel conv makes the activations').
- Column parallel (the weight split on its output channels, the bias
  with it): the input is sent to each device, each convolves it into its
  share of the output channels, and the parts stay split (an FFN's
  hidden) or are gathered with ``cat``, part 0 first, on the row's first
  device (an upsampler's output, before its MRF stage).
- Row parallel (the weight split on its input channels): each device
  convolves its share of the input channels, the partial sums are added
  on the row's first device in tp order, then the bias, once.

``gathers`` and ``reductions`` count the cross-device gathers and sums
since the last reset, as ``ops/stage.launches`` counts launches.  In one
process a transfer is ``.to(device)``: on a row that repeats a device
(``[cuda:0, cuda:0]``, the CPU meshes) it moves nothing, so such a row
checks the arithmetic of the split and not the transfers.
"""

from __future__ import annotations

import threading
import typing
from dataclasses import dataclass

import torch
import torch.nn.functional as F

# cross-device gathers and reductions since the last reset (read by
# chip_smoke.py)
gathers = 0
reductions = 0
_COUNT_LOCK = threading.Lock()


@dataclass(frozen=True, eq=False)
class Split:
    """A tensor in ``len(parts)`` contiguous parts along ``axis``; part
    ``j`` lies on the row's device ``j``.  It is not a tensor: code that
    takes a whole tensor raises on it rather than see part 0 alone."""

    parts: typing.Tuple[torch.Tensor, ...]
    axis: int

    @property
    def shape(self) -> torch.Size:
        """The whole tensor's shape."""
        shape = list(self.parts[0].shape)
        shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        return torch.Size(shape)

    def __getattr__(self, name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        raise TypeError(
            f"a tensor split over a tp row ({tuple(self.shape)} along axis "
            f"{self.axis}) reached code that takes a whole tensor (.{name})"
        )


def is_split(p: typing.Mapping[str, typing.Any]) -> bool:
    """Whether a layer's param dict holds a split leaf."""
    return any(isinstance(v, Split) for v in p.values())


def _count(n_gathers: int = 0, n_reductions: int = 0) -> None:
    global gathers, reductions
    with _COUNT_LOCK:
        gathers += n_gathers
        reductions += n_reductions


def gather(x: Split) -> torch.Tensor:
    """The whole tensor on part 0's device (``cat`` in part order)."""
    device = x.parts[0].device
    _count(n_gathers=1)
    return torch.cat([p.to(device) for p in x.parts], dim=x.axis)


def conv(
    x: typing.Union[torch.Tensor, Split],
    p: typing.Mapping[str, typing.Any],
    *,
    transpose: bool = False,
    keep_split: bool = False,
    **kwargs: typing.Any,
) -> typing.Union[torch.Tensor, Split]:
    """``F.conv1d`` (or ``F.conv_transpose1d`` with ``transpose``) of
    ``x`` by a layer whose weight is a :class:`Split`, computed in x's
    dtype.

    Column parallel when the weight is split on its output channels (dim
    0 of a conv's ``[Cout, Cin, K]``, dim 1 of a transposed conv's
    ``[Cin, Cout, K]``; the bias split with it): the output is gathered,
    or with ``keep_split`` returned as a :class:`Split` over channels.
    Row parallel when it is split on its input channels: ``x`` is a
    :class:`Split` over channels (a kept column output) or a whole tensor
    cut here to the weight's parts, and the bias stays whole.
    """
    weight, bias = p["weight"], p.get("bias")
    if not isinstance(weight, Split):
        # a weight-normed tree (weight_v/weight_g, which no rule matches)
        # with its bias split: the reference's layout, not the port's
        raise ValueError("a tp-split bias needs a split weight")
    fn = F.conv_transpose1d if transpose else F.conv1d
    if weight.axis == (1 if transpose else 0):
        biases = (None,) * len(weight.parts) if bias is None else bias.parts
        parts = tuple(
            fn(x.to(w.device), w.to(x.dtype),
               None if b is None else b.to(x.dtype), **kwargs)
            for w, b in zip(weight.parts, biases)
        )
        out = Split(parts, axis=1)
        return out if keep_split else gather(out)
    if not isinstance(x, Split):
        sizes = [w.shape[weight.axis] for w in weight.parts]
        x = Split(tuple(
            xj.to(w.device)
            for xj, w in zip(torch.split(x, sizes, dim=1), weight.parts)
        ), axis=1)
    partials = [
        fn(xj, w.to(xj.dtype), None, **kwargs)
        for xj, w in zip(x.parts, weight.parts)
    ]
    out = partials[0]
    for partial in partials[1:]:
        out = out + partial.to(out.device)
    _count(n_reductions=1)
    if bias is not None:
        out = out + bias.to(out.device, out.dtype)[None, :, None]
    return out
