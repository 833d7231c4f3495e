"""Tensor parallelism over one dp row's ``tp`` devices: in one process, or
across the row's processes (one device each).

The reference has no such module: it places the tp-ruled weights
(``parallel/mesh.py::_TP_RULES``) with ``NamedSharding`` and XLA's SPMD
partitioner inserts the collectives.  Here they are explicit, and all of
them are in this file:

- :class:`Split`: a tensor cut into T contiguous parts along one axis,
  part ``j`` on the row's device ``j`` (``shard_params`` makes the
  weights' splits; a column-parallel conv makes the activations').  Over
  a row that spans processes (:class:`Row`) a rank holds its own part
  alone.
- Column parallel (the weight split on its output channels, the bias
  with it): the input is sent to each device, each convolves it into its
  share of the output channels, and the parts stay split (an FFN's
  hidden) or are gathered with ``cat``, part 0 first, on the row's first
  device (an upsampler's output, before its MRF stage).
- Row parallel (the weight split on its input channels): each device
  convolves its share of the input channels, the partial sums are added
  on the row's first device in tp order, then the bias, once.

In one process every step is a ``.to(device)``, a ``cat`` or an add, so
autograd differentiates the split convs as it does the whole ones.
Across processes each rank runs the row's program on its own device, and
the three collectives are ``torch.autograd.Function``s over the row's
process group (Megatron's f, g and gather): ``_CopyToRow`` (identity
forward; backward the sum over the row of the ranks' input gradients,
each covering its own part's use of the input), ``_ReduceFromRow``
(forward the sum of the partial outputs; identity backward, since every
rank's downstream is the same) and ``_GatherFromRow`` (forward every
part ``cat`` in tp order; backward the rank's own slice of the whole
gradient).

``gathers`` and ``reductions`` count the forward gathers and sums since
the last reset, a cross-process collective as one, as ``ops/stage.
launches`` counts launches (backward passes are not counted).  In one
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

# forward gathers and reductions since the last reset (read by
# chip_smoke.py)
gathers = 0
reductions = 0
_COUNT_LOCK = threading.Lock()


@dataclass(frozen=True)
class Row:
    """A tp row that spans processes, seen from one of its ranks: the
    row's process group (its ranks in tp order), this rank's tp index and
    the row's size."""

    group: typing.Any
    index: int
    size: int


@dataclass(frozen=True, eq=False)
class Split:
    """A tensor in ``len(parts)`` contiguous parts along ``axis``; part
    ``j`` lies on the row's device ``j``.  With ``row`` (a row that spans
    processes) ``parts`` holds this rank's part alone, part ``row.index``
    of ``row.size``.  It is not a tensor: code that takes a whole tensor
    raises on it rather than see one part alone."""

    parts: typing.Tuple[torch.Tensor, ...]
    axis: int
    row: typing.Optional[Row] = None

    @property
    def shape(self) -> torch.Size:
        """The whole tensor's shape."""
        shape = list(self.parts[0].shape)
        if self.row is None:
            shape[self.axis] = sum(p.shape[self.axis] for p in self.parts)
        else:
            shape[self.axis] *= self.row.size
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


# ---------------------------------------------------------------------------
# the collectives of a row that spans processes
# ---------------------------------------------------------------------------


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    from .distributed import all_reduce_sum

    return all_reduce_sum([t], group)[0]


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` ``cat`` along ``dim`` in the group's rank
    order."""
    from .distributed import all_gather_rows

    moved = t.movedim(dim, 0)
    parts = all_gather_rows(moved, group).chunk(
        torch.distributed.get_world_size(group))
    return torch.cat([p.movedim(0, dim) for p in parts], dim=dim)


class _CopyToRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromRow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row, dim):
        ctx.index, ctx.dim, ctx.size = row.index, dim, x.shape[dim]
        return _all_gather(x.contiguous(), row.group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


# ---------------------------------------------------------------------------
# split ops
# ---------------------------------------------------------------------------


def gather(x: Split) -> torch.Tensor:
    """The whole tensor on part 0's device (``cat`` in part order), or
    over a row that spans processes on this rank's device."""
    _count(n_gathers=1)
    return cat_parts(x)


def cat_parts(x: Split) -> torch.Tensor:
    """:func:`gather` without the count: the parts ``cat`` in part order
    (every rank of a row that spans processes must call it)."""
    if x.row is not None:
        return _GatherFromRow.apply(x.parts[0], x.row, x.axis)
    device = x.parts[0].device
    return torch.cat([p.to(device) for p in x.parts], dim=x.axis)


def conv(
    x: typing.Union[torch.Tensor, Split],
    weight: Split,
    bias: typing.Union[torch.Tensor, Split, None] = None,
    *,
    transpose: bool = False,
    keep_split: bool = False,
    **kwargs: typing.Any,
) -> typing.Union[torch.Tensor, Split]:
    """``F.conv1d`` (or ``F.conv_transpose1d`` with ``transpose``) of
    ``x`` by a split ``weight`` (weight norm already folded per part) and
    ``bias``, computed in x's dtype.

    Column parallel when the weight is split on its output channels (dim
    0 of a conv's ``[Cout, Cin, K]``, dim 1 of a transposed conv's
    ``[Cin, Cout, K]``; the bias split with it): the output is gathered,
    or with ``keep_split`` returned as a :class:`Split` over channels.
    Row parallel when it is split on its input channels: ``x`` is a
    :class:`Split` over channels (a kept column output) or a whole tensor
    cut here to the weight's parts, and the bias stays whole.
    """
    if not isinstance(weight, Split):
        # a split bias beside a whole weight: a tree the rules did not
        # place
        raise ValueError("a tp-split bias needs a split weight")
    fn = F.conv_transpose1d if transpose else F.conv1d
    row = weight.row
    if weight.axis == (1 if transpose else 0):
        biases = (None,) * len(weight.parts) if bias is None else bias.parts
        if row is not None:
            x = _CopyToRow.apply(x, row.group)
        parts = tuple(
            fn(x.to(w.device), w.to(x.dtype),
               None if b is None else b.to(x.dtype), **kwargs)
            for w, b in zip(weight.parts, biases)
        )
        out = Split(parts, axis=1, row=row)
        return out if keep_split else gather(out)
    if row is not None:
        if not isinstance(x, Split):
            size = weight.parts[0].shape[weight.axis]
            x = _CopyToRow.apply(x, row.group).narrow(
                1, row.index * size, size)
        else:
            x = x.parts[0]
        out = _ReduceFromRow.apply(
            fn(x, weight.parts[0].to(x.dtype), None, **kwargs), row.group)
    else:
        if not isinstance(x, Split):
            sizes = [w.shape[weight.axis] for w in weight.parts]
            x = Split(tuple(
                xj.to(w.device)
                for xj, w in zip(torch.split(x, sizes, dim=1),
                                 weight.parts)
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
