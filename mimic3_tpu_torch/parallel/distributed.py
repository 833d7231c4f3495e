"""Multi-process initialization, the global mesh and the collectives the
port uses.

Port of ``mimic3_tpu/parallel/distributed.py`` on ``torch.distributed``,
one process per card, launched by PyTorch's own launcher (``python -m
torch.distributed.run --nproc_per_node N ...``, which sets
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE``) or by hand with explicit coordinates.

Each rank works on ``cuda:LOCAL_RANK`` (or the CPU when named).  The
backend follows from that topology, decided before init and logged:
``nccl`` when every local rank has a card of its own, ``gloo`` on the CPU
or when ranks share a card (NCCL refuses two ranks on one device).  An
init that fails raises; it never retries on another backend.

Where the reference's ``jit`` inserts the gradient ``psum`` over replicated
params, the port's train step calls :func:`all_reduce_sum` once per
parameter tree, on one flattened bucket, over the mesh's dp group (the
world when ``tp`` is 1).  With ``tp > 1`` :func:`make_global_mesh` also
builds each tp row's group, over which ``parallel/tensor.py`` runs the
split convs' collectives.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import typing

import numpy as np
import torch

_LOGGER = logging.getLogger(__name__)


def _env_int(name: str) -> typing.Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def local_device(
    device: typing.Union[str, torch.device, None] = None,
) -> torch.device:
    """This rank's device: the CPU when named, else
    ``cuda:(LOCAL_RANK mod cards)``.  Raises when no card is visible."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; name the CPU explicitly "
            "(device='cpu', --device cpu) to run there"
        )
    return torch.device(
        "cuda", (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count()
    )


def backend_for(
    device: torch.device, local_world: typing.Optional[int] = None
) -> str:
    """``nccl`` when each of ``local_world`` local ranks (default: the
    launcher's ``LOCAL_WORLD_SIZE``, else 1) has a card of its own, else
    ``gloo`` (the CPU, or more local ranks than cards)."""
    if device.type != "cuda":
        return "gloo"
    if local_world is None:
        local_world = _env_int("LOCAL_WORLD_SIZE") or 1
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(
    coordinator_address: typing.Optional[str] = None,
    num_processes: typing.Optional[int] = None,
    process_id: typing.Optional[int] = None,
    *,
    device: typing.Union[str, torch.device, None] = None,
) -> bool:
    """Initialize ``torch.distributed`` when running multi-process.

    Two activation paths, as the reference's:

    - coordinates, via arguments (``coordinator_address`` ``host:port``,
      then ``init_method="tcp://host:port"``) or torch's launcher
      variables ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
      (then ``init_method="env://"``, which also joins the launcher's
      store);
    - ``MIMIC3_MULTIHOST=1`` with no coordinates: ``env://`` as well, for
      cluster launchers that set those variables themselves.

    ``device`` is what the caller runs on (default: the card); the backend
    follows from it (:func:`backend_for`).  Returns True when a
    multi-process group is active, False for one process (a no-op).
    Idempotent.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    auto_detect = os.environ.get("MIMIC3_MULTIHOST", "").strip() in (
        "1", "true", "yes",
    )
    from_env = "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ
    if num_processes in (None, 1) and not (auto_detect and not explicit):
        return False  # single process: nothing to do
    if not (explicit or from_env or auto_detect):
        raise ValueError(
            f"{num_processes} processes but no coordinator: pass "
            "coordinator_address or set MASTER_ADDR/MASTER_PORT"
        )
    if num_processes not in (None, 1) and process_id is None:
        raise ValueError("a multi-process run needs this process's rank")

    dev = local_device(device)
    backend = backend_for(dev)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    kwargs: typing.Dict[str, typing.Any] = {}
    if num_processes is not None:
        kwargs.update(world_size=num_processes, rank=process_id)
    init_method = (
        f"tcp://{coordinator_address}" if explicit else "env://"
    )
    _LOGGER.info(
        "torch.distributed: backend %s for %s (%s local rank(s), %d "
        "card(s) visible), init %s",
        backend, dev, os.environ.get("LOCAL_WORLD_SIZE", "1"),
        torch.cuda.device_count() if torch.cuda.is_available() else 0,
        init_method,
    )
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    _LOGGER.info(
        "torch.distributed initialized: process %d/%d",
        dist.get_rank(), dist.get_world_size(),
    )
    return dist.get_world_size() > 1


def _world() -> typing.Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_global_mesh(
    tp: int = 1,
    dp_outer: typing.Optional[int] = None,
    device: typing.Union[str, torch.device, None] = None,
):
    """Mesh over EVERY process's devices, the reference's ``(dp, tp)``
    layout.

    One process (no group): every visible card, or one CPU replica when
    ``device`` names the CPU.  Several processes: each rank's
    :func:`local_device`, ordered by rank, so tp rows are contiguous in
    rank order (row ``i`` holds ranks ``i * tp .. i * tp + tp - 1``) and
    a batch splits over the rows in dp order.  ``dp_outer`` overrides the
    data-parallel size (default ``total_devices // tp``); the mesh takes
    the first ``dp * tp`` devices.

    Each rank holds one device, so with several processes and ``tp > 1``
    every tp row spans ranks.  The mesh then carries this rank's two
    process groups (:class:`~.mesh.Mesh` ``tp_group``, ``dp_group``): its
    row's, over which ``parallel/tensor.py`` gathers and reduces, and its
    column's, over which the train step sums gradients.  Every rank
    creates every group, in one order.  A ``tp`` that does not divide the
    ranks, or a ``dp_outer`` that leaves a rank without a row or asks for
    devices no rank holds, raises ``ValueError``.
    """
    import torch.distributed as dist

    from .mesh import make_mesh

    rank, world = _world()
    if world > 1 and world % tp:
        raise ValueError(
            f"tp={tp} does not divide the {world} processes of one device "
            "each: every rank must sit in one tp row"
        )
    if world > 1 and dp_outer is not None and dp_outer * tp != world:
        raise ValueError(
            f"dp_outer={dp_outer} x tp={tp} over {world} processes of one "
            "device each: every rank must own one dp row"
        )
    tp_group = dp_group = None
    if world == 1:
        platform = local_device(device).type
        devices = make_mesh(platform=platform).devices.ravel().tolist()
        owners = [0] * len(devices)
    else:
        names: typing.List[typing.Any] = [None] * world
        dist.all_gather_object(names, str(local_device(device)))
        devices = [torch.device(n) for n in names]
        owners = list(range(world))
        if tp > 1:
            tp_group, dp_group = _row_and_column_groups(rank, world, tp)
    dp = dp_outer if dp_outer is not None else len(devices) // tp
    mesh = make_mesh(n_devices=dp * tp, dp=dp, tp=tp, devices=devices)
    processes = np.asarray(owners[: dp * tp], np.int64).reshape(dp, tp)
    return dataclasses.replace(mesh, processes=processes, process_index=rank,
                               tp_group=tp_group, dp_group=dp_group)


def _row_and_column_groups(rank: int, world: int, tp: int):
    """(this rank's tp row group, its dp column group) of the ``(world //
    tp, tp)`` grid of ranks.  ``dist.new_group`` is collective over the
    world: every rank creates every row's group, then every column's, in
    one order, and keeps its own."""
    import torch.distributed as dist

    dp = world // tp
    rows = [dist.new_group([i * tp + j for j in range(tp)])
            for i in range(dp)]
    columns = [dist.new_group([i * tp + j for i in range(dp)])
               for j in range(tp)]
    return rows[rank // tp], columns[rank % tp]


def process_local_batch_slice(
    global_batch: int, mesh=None,
) -> typing.Tuple[int, int]:
    """(start, size) of this process's shard of a global batch: the rows
    of its dp rows.  Without a mesh each rank is a dp row of its own (the
    global batch must divide by the number of processes); on a mesh whose
    tp rows span processes the ranks of one row hold the same rows."""
    from .mesh import shard_rows

    if mesh is None:
        rank, world = _world()
        rows = shard_rows(rank, world, global_batch)
        return rows.start, rows.stop - rows.start
    mine = [row.index for row in mesh.local_rows()]
    first = shard_rows(mine[0], mesh.shape["dp"], global_batch)
    return first.start, (first.stop - first.start) * len(mine)


def _staged(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` where the group's backend takes it: gloo's collectives run on
    host tensors, NCCL's on this rank's card."""
    import torch.distributed as dist

    if dist.get_backend(group) == "gloo":
        return t.cpu()
    if t.device.type != "cuda":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def all_reduce_sum(
    tensors: typing.Sequence[torch.Tensor], group=None,
) -> typing.List[torch.Tensor]:
    """The sum over every rank of ``group`` (default: the world) of each
    tensor, as one collective on one flattened bucket (a tree's ~950
    gradients in one call).  Returns contiguous tensors of the inputs'
    shapes on their device; the inputs are not changed."""
    import torch.distributed as dist

    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    staged = _staged(flat, group)
    dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=group)
    flat = staged.to(flat.device)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset : offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` (default: the world) concatenated
    along dim 0 in rank order (the shapes must agree across ranks), on
    ``t``'s device."""
    import torch.distributed as dist

    if _world()[1] == 1 or dist.get_world_size(group) == 1:
        return t
    staged = _staged(t.contiguous(), group)
    parts = [torch.empty_like(staged)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, staged, group=group)
    return torch.cat(parts).to(t.device)
