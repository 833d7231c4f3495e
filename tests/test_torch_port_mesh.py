"""``mimic3_tpu_torch.parallel`` against ``mimic3_tpu.parallel`` on the CPU:
mesh shapes and errors, the tensor-parallel rules on the port's layouts,
the batch and param layouts, and the single-process no-ops of the
distributed helpers.  The JAX side runs on conftest.py's 8 virtual CPU
devices; the port's CPU meshes hold replicas of the one CPU device.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mimic3_tpu.parallel import make_mesh as j_make_mesh
from mimic3_tpu.parallel import param_sharding as j_param_sharding
from mimic3_tpu_torch.parallel import (
    Split,
    batch_sharding,
    initialize_distributed,
    make_global_mesh,
    make_mesh,
    param_sharding,
    process_local_batch_slice,
    shard_batch,
    shard_params,
)
from mimic3_tpu_torch.parallel.distributed import backend_for
from mimic3_tpu_torch.runtime.convert import _layout_axes, to_torch_params

CPU = torch.device("cpu")
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MIMIC3_MULTIHOST")


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("kwargs,shape", [
    (dict(n_devices=8, tp=2), {"dp": 4, "tp": 2}),
    (dict(dp=4), {"dp": 4, "tp": 1}),
    (dict(n_devices=2), {"dp": 2, "tp": 1}),
    (dict(), {"dp": 1, "tp": 1}),
])
def test_make_mesh_shapes(kwargs, shape):
    mesh = make_mesh(platform="cpu", **kwargs)
    assert mesh.shape == shape
    assert mesh.devices.size == shape["dp"] * shape["tp"]
    assert all(d == CPU for d in mesh.devices.ravel())
    assert [i for i, _ in mesh.local_shards()] == list(range(shape["dp"]))
    assert not mesh.multiprocess


def test_make_mesh_shapes_match_the_reference():
    assert (make_mesh(n_devices=8, tp=2, platform="cpu").shape
            == dict(j_make_mesh(n_devices=8, tp=2).shape))


def test_make_mesh_takes_a_repeated_device_list():
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.shape == {"dp": 2, "tp": 1}
    assert list(mesh.devices[:, 0]) == [CPU, CPU]


def test_make_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match=r"dp\(3\) \* tp\(2\) != devices\(8\)"):
        make_mesh(n_devices=8, dp=3, tp=2, platform="cpu")
    with pytest.raises(ValueError):
        j_make_mesh(n_devices=8, dp=3, tp=2)
    with pytest.raises(ValueError, match="unsupported platform"):
        make_mesh(n_devices=2, platform="tpu")
    # on the card: never fewer replicas, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs that many cards"):
        make_mesh(n_devices=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 visible"):
        make_mesh(n_devices=2)
    mesh = make_mesh(n_devices=1)
    assert list(mesh.devices.ravel()) == [torch.device("cuda", 0)]


def _tp_tree():
    """tests/test_training.py::test_mesh_and_shardings's tree in the JAX
    layout, with a leaf for each other rule and one no rule matches."""
    return {
        "enc_p": {"ffn_layers": {"0": {
            "conv_1": {"weight": np.zeros((3, 8, 16), np.float32),
                       "bias": np.zeros((16,), np.float32)},
            "conv_2": {"weight": np.zeros((3, 16, 8), np.float32),
                       "bias": np.zeros((8,), np.float32)},
        }}},
        "dec": {
            "conv_pre": {"weight": np.zeros((7, 8, 16), np.float32)},
            "ups": {"0": {"weight": np.zeros((4, 16, 8), np.float32),
                          "bias": np.zeros((8,), np.float32)}},
        },
    }


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def test_param_sharding_marks_the_reference_axes():
    """The port marks the parameters the reference's PartitionSpecs
    shard, on the axis that holds the same channels in torch's layout."""
    tree = _tp_tree()
    want = dict(_leaves(j_param_sharding(
        j_make_mesh(n_devices=8, tp=2),
        jax.tree_util.tree_map(jnp.asarray, tree), use_tp=True,
    )))
    got = dict(_leaves(param_sharding(
        make_mesh(n_devices=8, tp=2, platform="cpu"),
        to_torch_params(tree), use_tp=True,
    )))
    assert set(got) == set(want)
    for name, sharding in want.items():
        spec = tuple(sharding.spec)
        if "tp" not in spec:
            assert got[name] is None, name
            continue
        jax_axis = spec.index("tp")
        ndim = len(dict(_leaves(tree))[name].shape)
        perm = _layout_axes(name, ndim) or tuple(range(ndim))
        # torch axis i holds the reference's axis perm[i]
        assert got[name] == perm.index(jax_axis), name
    marked = {n for n, axis in got.items() if axis is not None}
    assert marked == {
        "enc_p.ffn_layers.0.conv_1.weight", "enc_p.ffn_layers.0.conv_1.bias",
        "enc_p.ffn_layers.0.conv_2.weight", "dec.ups.0.weight",
        "dec.ups.0.bias",
    }


@pytest.mark.parametrize("tp,use_tp", [(2, False), (1, True)])
def test_param_sharding_replicates_without_tp(tp, use_tp):
    plan = param_sharding(make_mesh(n_devices=4, tp=tp, platform="cpu"),
                          to_torch_params(_tp_tree()), use_tp=use_tp)
    assert all(axis is None for _, axis in _leaves(plan))


def test_batch_and_param_layouts():
    mesh = make_mesh(dp=4, platform="cpu")
    assert batch_sharding(mesh).slices(8) == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)
    ]
    with pytest.raises(ValueError, match="does not divide"):
        batch_sharding(mesh).slices(6)
    ids = torch.arange(16).reshape(8, 2)
    parts = shard_batch(mesh, {"scale": torch.tensor(0.5), "ids": ids,
                               "lengths": np.arange(8), "sid": None})
    assert len(parts) == 4
    torch.testing.assert_close(torch.cat([p["ids"] for p in parts]), ids)
    assert [p["lengths"].tolist() for p in parts] == [
        [0, 1], [2, 3], [4, 5], [6, 7]
    ]
    assert all(p["scale"].item() == 0.5 and p["sid"] is None for p in parts)
    params = to_torch_params(_tp_tree())
    replicas = shard_params(mesh, params)
    assert len(replicas) == 4
    # rows on one device share one copy
    assert all(r is replicas[0] for r in replicas)
    torch.testing.assert_close(replicas[0]["dec"]["conv_pre"]["weight"],
                               params["dec"]["conv_pre"]["weight"])
    # a tp mesh is accepted: each dp row splits the ruled leaves over its
    # tp devices (rows on the same devices share one tree)
    tp_rows = shard_params(make_mesh(n_devices=4, tp=2, platform="cpu"),
                           params, use_tp=True)
    assert len(tp_rows) == 2 and tp_rows[0] is tp_rows[1]
    ups = tp_rows[0]["dec"]["ups"]["0"]["weight"]
    assert isinstance(ups, Split) and ups.axis == 1
    assert [p.shape for p in ups.parts] == [(16, 4, 4), (16, 4, 4)]
    torch.testing.assert_close(torch.cat(ups.parts, dim=1),
                               params["dec"]["ups"]["0"]["weight"])
    torch.testing.assert_close(tp_rows[0]["dec"]["conv_pre"]["weight"],
                               params["dec"]["conv_pre"]["weight"])


def test_single_process_is_noop(no_launcher):
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert process_local_batch_slice(16) == (0, 16)
    mesh = make_global_mesh(device="cpu")
    assert mesh.shape == {"dp": 1, "tp": 1}
    assert mesh.process_index == 0 and not mesh.multiprocess


@pytest.mark.parametrize("world", [1, 2, 4])
def test_one_row_rule_for_shards_and_ranks(monkeypatch, world):
    """The mesh's dp shards, a process's slice and the train step's
    ``Shard`` take the same rows of a global batch."""
    from mimic3_tpu_torch.models.vits.train import Shard
    from mimic3_tpu_torch.parallel import distributed

    batch = 8
    shards = batch_sharding(make_mesh(dp=world, platform="cpu")).slices(batch)
    for rank in range(world):
        monkeypatch.setattr(distributed, "_world", lambda: (rank, world))
        start, size = process_local_batch_slice(batch)
        assert Shard(rank, world).rows(batch) == shards[rank] == slice(
            start, start + size)
    with pytest.raises(ValueError, match="does not divide"):
        Shard(0, 3).rows(batch)
    monkeypatch.setattr(distributed, "_world", lambda: (0, 3))
    with pytest.raises(ValueError, match="does not divide"):
        process_local_batch_slice(batch)


def test_backend_follows_the_topology(monkeypatch, no_launcher):
    """nccl only when every local rank has a card of its own; ranks that
    share a card, and the CPU, take gloo."""
    assert backend_for(CPU) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    card = torch.device("cuda", 0)
    assert backend_for(card) == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert backend_for(card) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert backend_for(card) == "nccl"
    # a launch planned from outside the ranks names its own local world
    assert backend_for(card, local_world=4) == "gloo"
    assert backend_for(card, local_world=2) == "nccl"


def test_multi_process_needs_a_coordinator(monkeypatch, no_launcher):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="no coordinator"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
