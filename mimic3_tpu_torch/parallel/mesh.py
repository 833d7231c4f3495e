"""Device meshes and the data-parallel layout of params and batches.

Port of ``mimic3_tpu/parallel/mesh.py``.  A :class:`Mesh` is a ``dp x tp``
grid of ``torch.device``s, each held by one process (one process holds
them all unless :func:`~.distributed.make_global_mesh` spans several):

- **dp** (data parallel): the batch dimension of requests and training
  examples.  Params are replicated, one copy per dp device, and each
  device runs its own rows (``TorchVitsSession``'s decode, the train
  step's shard).  VITS-low needs nothing else.
- **tp** (tensor parallel): :data:`_TP_RULES` name the wide weights that
  each dp row splits over its ``tp`` devices (with ``use_tp``): the
  encoder FFNs Megatron style, the decoder's upsamplers by output
  channel.  :func:`shard_params` places the parts
  (``parallel/tensor.py::Split``) and ``parallel/tensor.py`` runs the
  convs over them with explicit gathers and reductions, where XLA
  inserts them for the reference.  Every other leaf lives on the row's
  first device.  A row's devices belong to one process, or (a mesh from
  :func:`~.distributed.make_global_mesh` over several ranks) each to a
  rank of its own: then every rank of the row runs the row's program on
  its device, holds its own part of each split leaf, and the collectives
  run over the row's process group.

The device list, when none is given, is the visible cards ``cuda:0..n-1``
(raising when fewer are visible) or, on the CPU, ``n`` replicas on the one
CPU device, the counterpart of the reference's virtual CPU devices.  A
list passed in may repeat a device: ``[cuda:0, cuda:0]`` runs two
replicas on one card.
"""

from __future__ import annotations

import typing
from dataclasses import dataclass

import numpy as np
import torch

from .tensor import Row, Split

Params = typing.Dict[str, typing.Any]

# param-path suffix -> the tensor axis ``tp`` shards.  The rules are the
# reference's; the port keeps torch's layouts ([Cout, Cin, K] for convs,
# [Cin, Cout, K] for the transposed ``ups``), so the sharded axis is not
# the reference's (its convs are [K, Cin, Cout]): the wide output
# channels of ffn conv_1 and of the upsamplers, the input channels of
# ffn conv_2.  Training trees keep the upsamplers' weight norm unfolded;
# its norm runs over every axis but the output channel, so ``weight_v``
# and ``weight_g`` split with the bias and each part folds its own norm
# exactly.  The reference's rules name only ``weight``, so there it
# splits only those biases: another placement, the same results.
_TP_RULES: typing.Tuple[typing.Tuple[str, int], ...] = (
    ("ffn_layers/*/conv_1/weight", 0),
    ("ffn_layers/*/conv_1/bias", 0),
    ("ffn_layers/*/conv_2/weight", 1),
    ("dec/ups/*/weight", 1),
    ("dec/ups/*/weight_v", 1),
    ("dec/ups/*/weight_g", 1),
    ("dec/ups/*/bias", 0),
)


class LocalRow(typing.NamedTuple):
    """A dp row this process works on: its dp index, the devices this
    process runs it on (the whole tp row, or this rank's one device when
    the row spans processes) and, in that case, this rank's tp index
    (``column``; None when the process holds the whole row)."""

    index: int
    devices: typing.Tuple[torch.device, ...]
    column: typing.Optional[int] = None


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``dp x tp`` grid of devices.

    ``devices[i, j]`` is a ``torch.device``; ``processes[i, j]`` is the
    rank of the process that holds it and ``process_index`` this
    process's rank (all 0 in one process).  Over several processes with
    ``tp > 1``, ``tp_group`` is the process group of this rank's tp row
    and ``dp_group`` that of its tp column (the ranks it sums gradients
    with); None otherwise.
    """

    devices: np.ndarray
    processes: np.ndarray
    process_index: int = 0
    tp_group: typing.Any = None
    dp_group: typing.Any = None

    @property
    def shape(self) -> typing.Dict[str, int]:
        dp, tp = self.devices.shape
        return {"dp": int(dp), "tp": int(tp)}

    @property
    def multiprocess(self) -> bool:
        return bool((self.processes != self.process_index).any())

    def local_rows(self) -> typing.List[LocalRow]:
        """The dp rows this process works on, in dp order: each row it
        holds whole, and the row it holds one device of (a row spanning
        processes, one device per rank).  Raises ``ValueError`` when this
        process holds no device of the mesh, or several but not all of a
        row's."""
        rows = []
        for i, owners in enumerate(self.processes):
            mine = np.flatnonzero(owners == self.process_index)
            if len(mine) == len(owners):
                rows.append(LocalRow(i, tuple(self.devices[i])))
            elif len(mine) == 1:
                j = int(mine[0])
                rows.append(LocalRow(i, (self.devices[i, j],), j))
            elif len(mine):
                raise ValueError(
                    f"process {self.process_index} holds {len(mine)} of dp "
                    f"row {i}'s {len(owners)} devices: a row that spans "
                    "processes takes one device from each"
                )
        if not rows:
            raise ValueError(
                f"process {self.process_index} holds no device of this "
                f"mesh (processes {self.processes.tolist()})"
            )
        return rows

    def local_shards(self) -> typing.List[typing.Tuple[int, torch.device]]:
        """(dp index, device) of the dp rows this process works on: the
        row's first device, or this rank's device of a row that spans
        processes."""
        return [(row.index, row.devices[0]) for row in self.local_rows()]


def _default_devices(
    n: typing.Optional[int], platform: str = "cuda"
) -> typing.List[torch.device]:
    """``n`` devices of ``platform``: the visible cards ``cuda:0..n-1``
    (every card when ``n`` is None), or ``n`` replicas of the CPU."""
    if platform == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if platform != "cuda":
        raise ValueError(f"unsupported platform {platform!r}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = visible if n is None else n
    if n < 1 or n > visible:
        raise RuntimeError(
            f"a mesh of {n} CUDA device(s) needs that many cards; "
            f"{visible} visible (name the CPU to run replicas there)"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(
    n_devices: typing.Optional[int] = None,
    dp: typing.Optional[int] = None,
    tp: int = 1,
    devices: typing.Optional[typing.Sequence[torch.device]] = None,
    platform: str = "cuda",
) -> Mesh:
    """Create a ``(dp, tp)`` mesh over ``devices`` (default: see the
    module docstring; on the CPU ``n_devices``, else ``dp * tp``)."""
    if devices is None:
        if n_devices is None and platform == "cpu" and dp is not None:
            n_devices = dp * tp
        devices = _default_devices(n_devices, platform)
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n or n == 0:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    grid = np.empty((dp, tp), dtype=object)
    for i, d in enumerate(devices):
        grid[i // tp, i % tp] = d
    return Mesh(grid, np.zeros((dp, tp), dtype=np.int64))


def _match(path: str, pattern: str) -> bool:
    """Suffix match: the pattern matches the trailing path segments."""
    p_parts = pattern.split("/")
    parts = path.split("/")
    if len(parts) < len(p_parts):
        return False
    tail = parts[-len(p_parts):]
    return all(pp == "*" or pp == part for pp, part in zip(p_parts, tail))


def _map_tree(fn, tree: Params, prefix: str = "") -> Params:
    """``fn(path, leaf)`` over a nested dict, paths joined with ``/``."""
    return {
        k: _map_tree(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
        else fn(f"{prefix}{k}", v)
        for k, v in tree.items()
    }


def param_sharding(
    mesh: Mesh, params: Params, use_tp: bool = False
) -> Params:
    """The tree of ``params`` with each leaf's plan: the axis ``tp``
    shards where a rule matches (only with ``use_tp`` and a mesh whose tp
    axis is larger than 1), else None (replicated)."""
    on = use_tp and mesh.shape["tp"] > 1
    return _map_tree(lambda path, _: _tp_axis(path) if on else None, params)


def _tp_axis(path: str) -> typing.Optional[int]:
    """The axis the first matching rule splits, else None."""
    for pattern, axis in _TP_RULES:
        if _match(path, pattern):
            return axis
    return None


def shard_rows(index: int, count: int, batch: int) -> slice:
    """Rows ``[index * b, (index + 1) * b)`` of a batch of ``count * b``
    rows: the one rule by which a batch splits over dp shards and over
    ranks (:class:`BatchSharding`, ``process_local_batch_slice``, the
    train step's ``Shard``)."""
    if batch % count:
        raise ValueError(f"batch {batch} does not divide into {count}")
    per = batch // count
    return slice(index * per, (index + 1) * per)


class BatchSharding(typing.NamedTuple):
    """The leading (batch) dimension split evenly over the mesh's dp
    axis, in dp order."""

    mesh: Mesh

    def slices(self, batch: int) -> typing.List[slice]:
        dp = self.mesh.shape["dp"]
        return [shard_rows(i, dp, batch) for i in range(dp)]


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Batch-dimension sharding over dp for inputs and activations."""
    return BatchSharding(mesh)


def shard_params(
    mesh: Mesh, params: Params, use_tp: bool = False,
    requires_grad: bool = False,
) -> typing.List[Params]:
    """One tree of ``params`` (a tree of tensors) per dp row this process
    works on (:meth:`Mesh.local_rows`); rows on the same devices share one
    tree.

    Each leaf :func:`param_sharding` marks becomes a
    :class:`~.tensor.Split` in T contiguous parts along its axis, part
    ``j`` on the row's device ``j`` (a row that spans processes: this
    rank's part alone, on its device, with the row's process group); a
    marked axis that does not divide by T raises ``ValueError``.  Every
    other leaf, and every leaf without ``use_tp`` or on a ``tp == 1``
    mesh, lives on the row's first device (this rank's).  Parts are new
    contiguous leaf tensors; with ``requires_grad`` every placed tensor
    requires grad (a leaf already on its device is the caller's storage,
    detached).
    """
    on = use_tp and mesh.shape["tp"] > 1
    tp = mesh.shape["tp"]

    def fresh(t: torch.Tensor, device: torch.device) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)

    def place(devices, column, path: str, t: torch.Tensor):
        t = t.detach()
        axis = _tp_axis(path) if on else None
        if axis is None:
            return t.to(devices[0]).requires_grad_(requires_grad)
        if t.shape[axis] % tp:
            raise ValueError(
                f"{path}: axis {axis} of {tuple(t.shape)} does not divide "
                f"over tp={tp}"
            )
        chunks = t.chunk(tp, axis)
        if column is None:
            parts = zip(chunks, devices)
            row = None
        else:
            if mesh.tp_group is None:
                raise ValueError(
                    "a tp row that spans processes needs its process group "
                    "(parallel.make_global_mesh builds it)"
                )
            parts = [(chunks[column], devices[0])]
            row = Row(mesh.tp_group, column, tp)
        return Split(tuple(fresh(c, d).requires_grad_(requires_grad)
                           for c, d in parts), axis, row)

    trees: typing.Dict[typing.Tuple[torch.device, ...], Params] = {}
    out = []
    for row in mesh.local_rows():
        key = row.devices if on else row.devices[:1]
        if key not in trees:
            trees[key] = _map_tree(
                lambda path, t, key=key, column=row.column: place(
                    key, column, path, t),
                params,
            )
        out.append(trees[key])
    return out


def gather_params(params: Params) -> Params:
    """``params`` with every :class:`~.tensor.Split` made whole again (on
    part 0's device, detached; over a row that spans processes every rank
    of the row must call this, and each gets the whole tensor)."""
    from .tensor import cat_parts

    with torch.no_grad():
        return _map_tree(
            lambda _, t: cat_parts(t) if isinstance(t, Split) else t, params
        )


def shard_batch(
    mesh: Mesh, batch: typing.Mapping[str, typing.Any]
) -> typing.List[typing.Dict[str, typing.Any]]:
    """Each local dp row's part of ``batch`` (name -> tensor, numpy array
    or None) on its device: leaves with a leading dim are sliced by rows,
    0-dim leaves replicated."""
    leaves = {k: None if v is None else torch.as_tensor(v)
              for k, v in batch.items()}
    size = next(t.shape[0] for t in leaves.values()
                if t is not None and t.dim())
    slices = batch_sharding(mesh).slices(size)
    return [
        {k: None if t is None else (t[slices[i]] if t.dim() else t).to(d)
         for k, t in leaves.items()}
        for i, d in mesh.local_shards()
    ]
