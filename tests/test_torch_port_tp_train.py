"""The port's GAN train step on dp x tp CPU meshes in one process, against
the one-device port step and the JAX package's step under a tp mesh.

The reference trains under a ``(dp, tp)`` mesh with the generator's
params placed by ``param_sharding(use_tp=True)``
(``__graft_entry__._dryrun_train``).  The port's state on a mesh
(``init_train_state(..., mesh=, use_tp=True)``) splits the ``_TP_RULES``
leaves over each dp row's tp devices, the upsamplers' ``weight_v`` and
``weight_g`` with their bias, and runs each dp row's rows.  The CPU
meshes repeat the one CPU device, so these tests check the arithmetic of
the split (the parts' gradients, the bias added once, the sums over the
right rows) and not cross-device transfers.

Bars: the dp 1 x tp 2 and dp 2 x tp 2 steps against the one-device step
at ``tests/test_torch_port_distributed.py``'s dp2 bars (losses
``rtol=1e-5``; every gradient, parts gathered, within relative L2 1e-5,
with the same set of zero gradients); with the reference's draws
injected, against the reference's step under a dp 2 x tp 2 mesh at
``rtol=1e-3`` / relative L2 1e-3; the split convs' gradients and the
per-part weight-norm fold against the whole ones 1e-6 (the fold
bitwise).
"""

import types

import numpy as np
import pytest
import torch
import torch._dynamo  # noqa: F401  (see tests/torch_train_reference.py)
import torch.nn.functional as F

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_train_reference as ref_lib
from test_torch_port_train_cli import make_dataset
from mimic3_tpu.parallel import make_mesh as j_make_mesh
from mimic3_tpu.parallel import param_sharding as j_param_sharding
from mimic3_tpu_torch import train_cli
from mimic3_tpu_torch.models.vits import layers as tl
from mimic3_tpu_torch.models.vits import train as ttrain
from mimic3_tpu_torch.parallel import (
    Split,
    gather_params,
    make_mesh,
    shard_params,
)
from mimic3_tpu_torch.parallel import tensor as tpt
from mimic3_tpu_torch.runtime.convert import to_jax_layout

METRICS = ("loss_g", "loss_mel", "loss_kl", "loss_dur", "loss_adv",
           "loss_fm", "loss_d")
# the split convs against the whole ones: float32 rounding of sums in
# another order
CLOSE = dict(atol=1e-6, rtol=1e-6)
MESHES = {"dp1xtp2": dict(dp=1, tp=2), "dp2xtp2": dict(dp=2, tp=2)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(dp, tp):
    return make_mesh(dp=dp, tp=tp, platform="cpu")


def gathered(tree, attr=None):
    """{dotted name: numpy} of a (possibly split) tree: each leaf, or its
    ``attr`` (``"grad"``), with a split leaf's parts put back together."""
    out = {}
    for name, leaf in _walk(tree):
        get = (lambda t: t) if attr is None else (
            lambda t: getattr(t, attr))
        if isinstance(leaf, Split):
            value = torch.cat([get(p) for p in leaf.parts], leaf.axis)
        else:
            value = get(leaf)
        out[name] = value.detach().numpy()
    return out


def _walk(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _walk(v, path)
        else:
            yield path, v


@pytest.fixture(scope="module")
def setup():
    cfg = ref_lib.config(port=True, learning_rate=0.0)
    return dict(cfg=cfg, state0=ref_lib.port_initial_state(cfg),
                batch=ref_lib.batch_arrays(rows=4))


def _step(setup, mesh=None, noise=None, cfg=None):
    cfg = cfg or setup["cfg"]
    state = ttrain.init_train_state(
        ref_lib.carry(setup["state0"].params),
        ref_lib.carry(setup["state0"].disc_params), cfg, mesh=mesh,
        use_tp=mesh is not None,
    )
    generator = None if noise else torch.Generator().manual_seed(123)
    state, metrics = ttrain.make_train_step(cfg)(
        state, ref_lib.t_batch(setup["batch"]), noise=noise,
        generator=generator,
    )
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def one_device(setup):
    return _step(setup)


def _assert_grads(state, want_state, bar):
    for tree in ("params", "disc_params"):
        bad = ref_lib.gradient_errors(
            gathered(getattr(want_state, tree), "grad"),
            gathered(getattr(state, tree), "grad"), bar,
        )
        assert not bad, (tree, bad)


# ---------------------------------------------------------------------------
# the split convs under autograd
# ---------------------------------------------------------------------------


def _conv_case(seed, transpose, axis):
    rng = np.random.RandomState(seed)
    cin, cout, k = 8, 6, 4
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
    x, w, b = t(2, cin, 9), t(*shape), t(cout)
    weight = Split(tuple(p.clone() for p in w.chunk(2, axis)), axis)
    column = axis == (1 if transpose else 0)
    bias = Split(tuple(p.clone() for p in b.chunk(2)), 0) if column \
        else b.clone()
    return x, dict(weight=w, bias=b), weight, bias


@pytest.mark.parametrize("transpose,axis", [
    (False, 0), (False, 1), (True, 1), (True, 0),
], ids=["conv-column", "conv-row", "transposed-column", "transposed-row"])
def test_split_conv_gradients_equal_the_whole_conv(transpose, axis):
    """A column-parallel conv's input gradient is the sum of the parts'
    (each sends the input to its device); a row-parallel conv's bias is
    added once, so its gradient is the whole conv's, not T times it."""
    x, whole, weight, bias = _conv_case(3, transpose, axis)
    kwargs = dict(stride=2, padding=1) if transpose else dict(padding=1)
    fn = F.conv_transpose1d if transpose else F.conv1d
    leaves = [x, whole["weight"], whole["bias"]]
    parts = [x] + list(weight.parts) + (
        list(bias.parts) if isinstance(bias, Split) else [bias])
    for t in leaves + parts:
        t.requires_grad_(True)
    want = fn(x, whole["weight"], whole["bias"], **kwargs)
    got = tpt.conv(x, weight, bias, transpose=transpose, **kwargs)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **CLOSE)
    cot = torch.from_numpy(
        np.random.RandomState(5).randn(*want.shape).astype(np.float32))
    g_want = torch.autograd.grad(want, leaves, cot)
    g_got = torch.autograd.grad(got, parts, cot)
    np.testing.assert_allclose(g_got[0].numpy(), g_want[0].numpy(),
                               **CLOSE)
    w_grad = torch.cat(g_got[1:3], axis)
    np.testing.assert_allclose(w_grad.numpy(), g_want[1].numpy(), **CLOSE)
    b_grad = (torch.cat(g_got[3:5]) if isinstance(bias, Split)
              else g_got[3])
    np.testing.assert_allclose(b_grad.numpy(), g_want[2].numpy(), **CLOSE)


def test_weight_norm_fold_per_part_equals_the_whole():
    rng = np.random.RandomState(1)
    v = torch.from_numpy(rng.randn(8, 6, 4).astype(np.float32))  # [Cin, Cout, K]
    g = torch.from_numpy(rng.rand(1, 6, 1).astype(np.float32) + 0.5)
    p = {"weight_v": v, "weight_g": g, "bias": torch.zeros(6)}
    tree = shard_params(_cpu_mesh(1, 2), {"dec": {"ups": {"0": p}}},
                        use_tp=True)[0]["dec"]["ups"]["0"]
    assert isinstance(tree["weight_v"], Split)
    assert isinstance(tree["weight_g"], Split)
    folded = tl.conv_weight(tree, out_dim=1)
    assert isinstance(folded, Split) and folded.axis == 1
    assert torch.equal(torch.cat(folded.parts, 1),
                       tl.conv_weight(p, out_dim=1))
    with pytest.raises(ValueError, match="output channel"):
        tl.conv_weight({"weight_v": Split(v.chunk(2, 0), 0),
                        "weight_g": g}, out_dim=1)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_training_layout_splits_weight_norm_with_the_bias(setup):
    params = ref_lib.carry(setup["state0"].params)
    state = ttrain.init_train_state(
        params, ref_lib.carry(setup["state0"].disc_params), setup["cfg"],
        mesh=_cpu_mesh(2, 2), use_tp=True,
    )
    # the two rows share the one CPU device: one tree, one optimizer
    assert [r.index for r in state.rows] == [0, 1]
    assert state.rows[1].state is state
    ups = state.params["dec"]["ups"]["0"]
    for key, axis in (("weight_v", 1), ("weight_g", 1), ("bias", 0)):
        leaf = ups[key]
        assert isinstance(leaf, Split) and leaf.axis == axis, key
        whole = params["dec"]["ups"]["0"][key]
        assert leaf.shape == whole.shape
        assert torch.equal(torch.cat(leaf.parts, axis), whole.detach())
        for part in leaf.parts:
            assert part.is_leaf and part.requires_grad
            assert part.is_contiguous()
            assert part.untyped_storage().data_ptr() != \
                whole.untyped_storage().data_ptr()
    names = [n for n, _ in state.g_leaves]
    assert "dec.ups.0.weight_v[0]" in names and "dec.ups.0.weight_v[1]" in names
    assert "enc_p.ffn_layers.0.conv_2.weight[1]" in names
    # every part and whole leaf is one Adam parameter, contiguous (the
    # state the trainer's ranks build on their mesh)
    adam = {id(p) for group in state.opt_g.param_groups
            for p in group["params"]}
    assert adam == {id(t) for _, t in state.g_leaves}
    assert all(p.is_contiguous() for opt in (state.opt_g, state.opt_d)
               for group in opt.param_groups for p in group["params"])
    assert not any(isinstance(v, Split)
                   for _, v in _walk(state.disc_params))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
def test_tp_step_equals_the_one_device_step(setup, one_device, name):
    want_state, want = one_device
    tpt.gathers = tpt.reductions = 0
    state, got = _step(setup, _cpu_mesh(**MESHES[name]))
    for metric in METRICS:
        np.testing.assert_allclose(got[metric], want[metric], rtol=1e-5,
                                   err_msg=metric)
    _assert_grads(state, want_state, 1e-5)
    # per dp row: each FFN reduces once and each upsampler gathers once
    hp = ttrain.VitsModel(setup["cfg"].model).hp
    dp = MESHES[name]["dp"]
    assert (tpt.reductions, tpt.gathers) == (
        dp * hp.n_layers, dp * len(hp.upsample_rates))


def test_tp_step_matches_the_reference_under_a_tp_mesh(setup):
    """The reference's step on its 8 virtual CPU devices' dp 2 x tp 2 mesh
    with the generator placed by ``param_sharding(use_tp=True)``, as
    ``_dryrun_train`` places it, and its draws injected into the port's
    dp 2 x tp 2 step."""
    mesh = j_make_mesh(n_devices=4, tp=2)
    state0 = setup["state0"]
    placed = types.SimpleNamespace(
        params=jax.tree_util.tree_map(
            jax.device_put, state0.params,
            j_param_sharding(mesh, state0.params, use_tp=True)),
        disc_params=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P())),
            state0.disc_params),
    )
    assert placed.params["dec"]["ups"]["0"]["bias"].sharding.spec == P("tp")
    rng = jax.random.PRNGKey(1)
    metrics, grads_g, grads_d = ref_lib.reference_step(
        ref_lib.config(), placed, setup["batch"], rng)
    noise = ref_lib.reference_noise(rng, setup["batch"], setup["cfg"])
    state, got = _step(setup, _cpu_mesh(2, 2), noise=noise)
    for metric in METRICS:
        np.testing.assert_allclose(got[metric], float(metrics[metric]),
                                   rtol=1e-3, err_msg=metric)
    for tree, want in (("params", grads_g), ("disc_params", grads_d)):
        got_grads = ref_lib.flat(to_jax_layout(ref_lib.unflat({
            k: torch.from_numpy(v)
            for k, v in gathered(getattr(state, tree), "grad").items()
        })))
        bad = ref_lib.gradient_errors(ref_lib.flat(want), got_grads, 1e-3)
        assert not bad, (tree, bad)


def test_global_norm_and_clip_equal_the_one_device_ones(setup, one_device):
    state, _ = _step(setup, _cpu_mesh(1, 2))
    want_state, _ = one_device
    grads = [t.grad.clone() for _, t in state.g_leaves]
    want = [t.grad.clone() for _, t in want_state.g_leaves]
    norm = float(ttrain.global_norm(grads))
    want_norm = float(ttrain.global_norm(want))
    np.testing.assert_allclose(norm, want_norm, rtol=1e-6)
    # a bar below the norm scales every gradient, the parts alike
    ttrain.clip_by_global_norm(grads, want_norm / 4)
    np.testing.assert_allclose(float(ttrain.global_norm(grads)),
                               want_norm / 4, rtol=1e-5)


def test_tp_trained_state_exports_the_gathered_state(setup, one_device):
    """After a step with a learning rate, the export of the split state
    equals the export of its gathered trees, and stays within the Adam
    bound (2 * lr per step) of the one-device state's."""
    cfg = ref_lib.config(port=True)
    state, _ = _step(setup, _cpu_mesh(1, 2), cfg=cfg)
    one, _ = _step(setup, cfg=cfg)
    got = ref_lib.flat(train_cli.export_params(state.params))
    gathered_params = gather_params(state.params)
    assert not any(isinstance(v, Split) for _, v in _walk(gathered_params))
    want = ref_lib.flat(train_cli.export_params(gathered_params))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the exported weights are folded and in the reference's layout
    assert "weight" in ref_lib.unflat(got)["dec"]["ups"]["0"]
    reference = ref_lib.flat(train_cli.export_params(one.params))
    bound = 2 * cfg.learning_rate + 1e-6
    for name in reference:
        assert np.abs(got[name] - reference[name]).max() <= bound * max(
            1.0, np.abs(reference[name]).max()), name


# ---------------------------------------------------------------------------
# the trainer's leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["fresh", "fine_tune", "resume"])
def test_train_cli_hands_adam_contiguous_leaves(tmp_path, monkeypatch,
                                                path):
    """Every leaf ``mimic3-torch-train`` gives Adam is contiguous, on each
    way into training: a fresh init, a fine-tune from generator.npz, and a
    resume from a checkpoint (``--steps 0``: the state is built, no step
    runs).  A strided leaf costs every step a copy per use."""
    voice_dir, audio_dir, metadata = make_dataset(tmp_path)
    if path != "fine_tune":
        (voice_dir / "generator.npz").unlink()
    ckpt = tmp_path / "ckpt"
    if path == "resume":
        from mimic3_tpu_torch.config import TrainingConfig

        config = TrainingConfig.load_path(voice_dir / "config.json")
        params, disc = ttrain.init_training_params(0, config)
        from mimic3_tpu_torch.runtime.convert import to_torch_train_params

        state = ttrain.init_train_state(to_torch_train_params(params),
                                        to_torch_train_params(disc), config)
        train_cli.save_checkpoint(ckpt / "3", state)
    seen = []
    real = torch.optim.Adam

    class Recording(real):
        def __init__(self, params, *args, **kwargs):
            params = list(params)
            seen.append([p.is_contiguous() for p in params])
            super().__init__(params, *args, **kwargs)

    monkeypatch.setattr(torch.optim, "Adam", Recording)
    argv = [str(voice_dir), "--metadata", str(metadata), "--audio-dir",
            str(audio_dir), "--steps", "0", "--device", "cpu",
            "--checkpoint-dir", str(ckpt)]
    assert train_cli.main(argv + (["--resume"] if path == "resume" else [])
                          ) == 0
    # fresh optimizers for G and D, then (resume) the checkpoint's
    assert len(seen) == (4 if path == "resume" else 2)
    assert all(all(flags) and flags for flags in seen)
