"""Tensor-parallel serving on the port over dp x tp CPU meshes, against
the JAX package and the port's own single-device session.

The port's counterpart of the reference's ``use_tp`` sessions: the
``_TP_RULES`` leaves split over each dp row's tp devices
(``parallel/mesh.py::shard_params``), the encoder FFNs Megatron style and
the decoder's upsamplers by output channel, with the gathers and
reductions XLA inserts for the reference made explicit in
``parallel/tensor.py``.  The CPU meshes repeat the one CPU device, so
these tests check the arithmetic of the split (the parts, the bias added
once, the part order of a gather), not cross-device transfers.

Bars: modules against JAX f32 ``atol=2e-4, rtol=1e-3``; the split FFN
against the port's whole FFN 1e-6; sessions against the one-device
session ``atol=2e-5`` with equal durations; against the JAX ``use_tp``
session equal lengths and corr >= 0.999 (the north-star bar).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mimic3_tpu.config import ModelConfig
from mimic3_tpu.config import TrainingConfig as JTrainingConfig
from mimic3_tpu.models.vits import encoder as jenc
from mimic3_tpu.models.vits import hifigan as jhfg
from mimic3_tpu.models.vits import init_vits_params
from mimic3_tpu.models.vits.mbistft import (
    mb_istft_generator as j_mb_istft_generator,
)
from mimic3_tpu.parallel import make_global_mesh as j_make_global_mesh
from mimic3_tpu.parallel import make_mesh as j_make_mesh
from mimic3_tpu.runtime.convert import load_pytree_npz as j_load_npz
from mimic3_tpu.runtime.session import VitsSession
from mimic3_tpu.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.config import TrainingConfig
from mimic3_tpu_torch.models.vits import encoder as tenc
from mimic3_tpu_torch.models.vits import hifigan as thfg
from mimic3_tpu_torch.models.vits import layers as tl
from mimic3_tpu_torch.models.vits.mbistft import mb_istft_generator
from mimic3_tpu_torch.models.vits.model import VitsModel
from mimic3_tpu_torch.ops import stage as stage_mod
from mimic3_tpu_torch.parallel import (
    Mesh,
    Split,
    make_global_mesh,
    make_mesh,
    param_sharding,
    shard_params,
)
from mimic3_tpu_torch.parallel import distributed
from mimic3_tpu_torch.parallel import tensor as tpt
from mimic3_tpu_torch.runtime.convert import load_pytree_npz, to_torch_params
from mimic3_tpu_torch.runtime.session import TorchVitsSession

TOL = dict(atol=2e-4, rtol=1e-3)
SEQS = [
    [1, 5, 9, 2, 7, 3],
    [4, 4, 8, 1],
    [2, 9, 9, 9, 5, 5, 6, 1, 3],
    [7, 1],
    [3, 3, 3, 8, 2, 6],
    [5, 2, 7],
    [6, 6, 1, 4, 9, 2, 8, 3],
    [9, 8, 7, 6, 5],
]
DET = dict(noise_scale=0.0, noise_w=0.0, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def voice_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_voices") / "en_US" / "test_low"
    create_test_voice(d, full_size=False, n_speakers=4)
    return d


def _session(voice_dir, mesh=None, use_tp=True, **tpu):
    config = TrainingConfig.load_path(voice_dir / "config.json")
    if tpu:
        config = copy.deepcopy(config)
        for key, value in tpu.items():
            setattr(config.tpu, key, value)
    return TorchVitsSession(
        config, load_pytree_npz(voice_dir / "generator.npz"),
        deterministic=True, device=None if mesh else "cpu", mesh=mesh,
        use_tp=use_tp,
    )


@pytest.fixture(scope="module")
def single(voice_dir):
    return _session(voice_dir)


@pytest.fixture(scope="module")
def dp2tp2(voice_dir):
    return _session(voice_dir, make_mesh(dp=2, tp=2, platform="cpu"))


def _assert_same(got, want, atol=2e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _get(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------


def test_shard_params_splits_the_marked_leaves(voice_dir):
    params = to_torch_params(load_pytree_npz(voice_dir / "generator.npz"))
    mesh = make_mesh(dp=2, tp=2, platform="cpu")
    trees = shard_params(mesh, params, use_tp=True)
    # the two rows hold the same devices, so they share one tree
    assert len(trees) == 2 and trees[0] is trees[1]
    plan = dict(_leaves(param_sharding(mesh, params, use_tp=True)))
    split = {p for p, axis in plan.items() if axis is not None}
    # every rule matched: 2 FFN layers x 3 leaves, 4 upsamplers x 2
    assert len(split) == 2 * 3 + 4 * 2
    assert "dec/ups/0/weight" in split  # weight norm folded at load
    for path, leaf in _leaves(trees[0]):
        whole = _get(params, path)
        if path in split:
            assert isinstance(leaf, Split) and leaf.axis == plan[path]
            assert len(leaf.parts) == 2
            assert all(p.is_contiguous() for p in leaf.parts)
            assert leaf.shape == whole.shape
            assert torch.equal(torch.cat(leaf.parts, dim=leaf.axis), whole)
        else:
            assert isinstance(leaf, torch.Tensor)
            assert torch.equal(leaf, whole)


def test_shard_params_refuses_a_non_dividing_axis(voice_dir):
    params = to_torch_params(load_pytree_npz(voice_dir / "generator.npz"))
    with pytest.raises(ValueError, match="ffn_layers/0/conv_1/weight"):
        shard_params(make_mesh(n_devices=3, tp=3, platform="cpu"), params,
                     use_tp=True)


def test_use_tp_off_replicates_on_the_first_column(voice_dir):
    params = to_torch_params(load_pytree_npz(voice_dir / "generator.npz"))
    trees = shard_params(make_mesh(dp=2, tp=2, platform="cpu"), params)
    assert not any(isinstance(v, Split) for _, v in _leaves(trees[0]))


def test_split_leaf_reaching_a_whole_tensor_layer_raises():
    split = Split((torch.ones(2), torch.ones(2)), 0)
    p = {"gamma": split, "beta": torch.zeros(4)}
    with pytest.raises(TypeError, match="split over a tp row"):
        tl.layer_norm(torch.ones(1, 4, 3), p)
    with pytest.raises(TypeError):
        tl.embedding(torch.zeros(1, 2, dtype=torch.long),
                     {"weight": split})


# ---------------------------------------------------------------------------
# modules against JAX
# ---------------------------------------------------------------------------


def _t(a: np.ndarray) -> torch.Tensor:
    """[B, T, C] numpy -> [B, C, T] torch."""
    return torch.from_numpy(np.ascontiguousarray(a)).transpose(1, 2)


def _split_tree(tree, tp=2):
    """``tree`` (torch layout) with the rules' leaves split over tp."""
    return shard_params(make_mesh(n_devices=tp, tp=tp, platform="cpu"),
                        tree, use_tp=True)[0]


@pytest.mark.parametrize("tp", [2, 4])
def test_split_ffn_matches_jax(tp):
    rng = np.random.RandomState(tp)
    c, hidden, k, t = 16, 32, 3, 11

    def conv(cin, cout):
        # the init's scale, 1/sqrt(fan-in): outputs of order 1
        w = rng.randn(k, cin, cout) / np.sqrt(cin * k)
        return {"weight": w.astype(np.float32),
                "bias": rng.randn(cout).astype(np.float32)}

    jp = {"conv_1": conv(c, hidden), "conv_2": conv(hidden, c)}
    x = rng.randn(2, t, c).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.array([[11], [7]])).astype(
        np.float32)[..., None]
    want = np.asarray(jenc.ffn(
        jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, jp),
        jnp.asarray(mask), k,
    ))
    whole = to_torch_params({"ffn_layers": {"0": jp}})
    split = _split_tree(whole, tp)["ffn_layers"]["0"]
    assert isinstance(split["conv_1"]["bias"], Split)
    assert isinstance(split["conv_2"]["weight"], Split)
    assert not isinstance(split["conv_2"]["bias"], Split)
    tpt.reductions = tpt.gathers = 0
    got = tenc.ffn(_t(x), split, _t(mask), k)
    # one reduction, no gather of the hidden channels
    assert (tpt.reductions, tpt.gathers) == (1, 0)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **TOL)
    # the bias is added once: a (tp - 1) * bias error is far above 1e-6
    plain = tenc.ffn(_t(x), whole["ffn_layers"]["0"], _t(mask), k)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)


def _hifigan_config() -> ModelConfig:
    return ModelConfig(num_symbols=40, hidden_channels=32,
                       inter_channels=32, filter_channels=64, n_layers=2,
                       upsample_initial_channel=64, n_speakers=2,
                       gin_channels=16)


def test_split_hifigan_matches_jax():
    ref = init_vits_params(jax.random.PRNGKey(0), _hifigan_config())
    dec = to_torch_params(jax.tree_util.tree_map(np.asarray, ref))["dec"]
    split = _split_tree({"dec": dec})["dec"]
    assert isinstance(split["ups"]["0"]["weight"], Split)
    rng = np.random.RandomState(9)
    z = rng.randn(2, 12, 32).astype(np.float32) * 0.5
    g = rng.randn(2, 1, 16).astype(np.float32)
    want = jhfg.hifigan_generator(
        ref["dec"], jnp.asarray(z), g=jnp.asarray(g),
        compute_dtype=jnp.float32,
    )
    tpt.gathers = 0
    got = thfg.hifigan_generator(split, _t(z), g=_t(g),
                                 compute_dtype=torch.float32)
    assert tpt.gathers == 4  # one per upsampler, before its MRF stage
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = thfg.hifigan_generator(dec, _t(z), g=_t(g),
                                   compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=0)


def test_split_upsampler_gather_keeps_bf16_and_part_order():
    rng = np.random.RandomState(4)
    ups = {"weight": torch.from_numpy(rng.randn(8, 6, 4).astype(np.float32)),
           "bias": torch.from_numpy(rng.randn(6).astype(np.float32))}
    x = torch.from_numpy(rng.randn(2, 8, 5).astype(np.float32))
    split = _split_tree({"dec": {"ups": {"0": ups}}}, 2)["dec"]["ups"]["0"]
    got = tl.conv_transpose1d(x, split, stride=2, padding=1,
                              dtype=torch.bfloat16)
    want = tl.conv_transpose1d(x, ups, stride=2, padding=1,
                               dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_split_mb_istft_matches_jax():
    from mimic3_tpu_torch.config import ModelConfig as TModelConfig
    from mimic3_tpu_torch.models.vits.model import init_params
    from mimic3_tpu_torch.runtime.convert import (
        flatten_pytree,
        unflatten_pytree,
    )

    cfg = TModelConfig(
        num_symbols=10, hidden_channels=16, inter_channels=16,
        filter_channels=32, n_layers=1, upsample_initial_channel=32,
        decoder_type="mb-istft",
    )
    flat = {k[4:]: np.asarray(v)
            for k, v in flatten_pytree(init_params(5, cfg)).items()
            if k.startswith("dec.")}
    rng = np.random.RandomState(2)
    w = flat["conv_post.weight"]
    flat["conv_post.weight"] = (rng.randn(*w.shape) * 0.3).astype(np.float32)
    # spread the log-magnitudes over the clip range (the head starts near
    # silent)
    flat["conv_post.bias"] = rng.randn(
        *flat["conv_post.bias"].shape).astype(np.float32)
    dec = unflatten_pytree(flat)
    z = rng.randn(2, 16, 9).astype(np.float32)
    want = np.asarray(j_mb_istft_generator(
        jax.tree_util.tree_map(jnp.asarray, dec),
        jnp.asarray(z.transpose(0, 2, 1)),
    ))
    split = _split_tree({"dec": to_torch_params(dec)})["dec"]
    assert isinstance(split["ups"]["1"]["weight"], Split)
    tpt.gathers = 0
    got = mb_istft_generator(split, torch.from_numpy(z)).numpy()
    assert tpt.gathers == 2
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------


def _durations(session, seqs):
    """Replica 0's integer durations for ``seqs`` padded as the session
    pads them."""
    ids, lengths, sid = session._pad(seqs, None, "duration")
    rep = session._replicas[0]
    durations, _ = session.model.infer_durations(
        rep.params, session._put(ids, rep.device),
        session._put(lengths, rep.device), 0, 1.0, 0.0,
        sid=session._sid(sid, rep.device),
    )
    return durations.numpy()


def test_dp2tp2_session_places_the_parts(dp2tp2):
    assert dp2tp2.mesh.shape == {"dp": 2, "tp": 2}
    assert dp2tp2.dp == 2
    assert all(b % 2 == 0 for b in dp2tp2.batch_buckets)
    rep = dp2tp2._replicas[0]
    assert len(rep.devices) == 2
    assert isinstance(
        rep.params["enc_p"]["ffn_layers"]["1"]["conv_2"]["weight"], Split)
    assert isinstance(rep.params["dec"]["ups"]["3"]["bias"], Split)


def test_dp2tp2_matches_single_deterministic(single, dp2tp2):
    tpt.gathers = tpt.reductions = 0
    got = dp2tp2.synthesize_ids_batch(SEQS, **DET)
    # per dp row: the encoder's 2 FFNs in the duration pass and again in
    # the decode pass, and the 4 upsamplers
    assert (tpt.reductions, tpt.gathers) == (2 * 2 * 2, 2 * 4)
    _assert_same(got, single.synthesize_ids_batch(SEQS, **DET))
    np.testing.assert_array_equal(_durations(dp2tp2, SEQS),
                                  _durations(single, SEQS))


def test_dp2tp2_matches_single_with_noise_and_speakers(single, dp2tp2):
    kw = dict(speaker_ids=[0, 1, 2, 3, 0, 1, 2, 3], noise_scale=0.667,
              noise_w=0.8, seed=11)
    _assert_same(dp2tp2.synthesize_ids_batch(SEQS, **kw),
                 single.synthesize_ids_batch(SEQS, **kw))


def test_dp2tp2_partial_batch(single, dp2tp2):
    got = dp2tp2.synthesize_ids_batch(SEQS[:5], **DET)
    assert len(got) == 5
    _assert_same(got, single.synthesize_ids_batch(SEQS[:5], **DET))
    np.testing.assert_array_equal(_durations(dp2tp2, SEQS[:5]),
                                  _durations(single, SEQS[:5]))


def test_dp2tp2_speculative_decode(single, dp2tp2):
    """A repeated batch speculates (its decode signature has run), and the
    speculative decode over the split params gives the same audio."""
    seqs = SEQS[:4]
    dp2tp2.synthesize_ids_batch(seqs, **DET)
    before = dict(dp2tp2.speculation)
    got = dp2tp2.synthesize_ids_batch(seqs, **DET)
    assert dp2tp2.speculation["used"] == before["used"] + 1
    _assert_same(got, single.synthesize_ids_batch(seqs, **DET))


def test_dp2tp2_streaming(single, dp2tp2):
    stream = dict(chunk_frames=8, overlap=16, noise_scale=0.0, noise_w=0.0)
    long = SEQS[2] + SEQS[6] + SEQS[0]
    chunks = list(dp2tp2.synthesize_ids_chunked(long, **stream))
    want = list(single.synthesize_ids_chunked(long, **stream))
    assert len(chunks) > 1
    np.testing.assert_allclose(chunks[0], want[0], atol=2e-5, rtol=0)
    _assert_same(chunks, want)
    batched = dp2tp2.stream_start_batch(SEQS[:3], **stream)
    ref = single.stream_start_batch(SEQS[:3], **stream)
    for got_row, want_row in zip(batched, ref):
        _assert_same(list(got_row), list(want_row))


def test_use_tp_false_on_a_tp_mesh(voice_dir, single):
    session = _session(voice_dir, make_mesh(dp=2, tp=2, platform="cpu"),
                       use_tp=False)
    assert all(len(r.devices) == 1 for r in session._replicas)
    assert not any(isinstance(v, Split)
                   for _, v in _leaves(session.params))
    tpt.gathers = tpt.reductions = 0
    _assert_same(session.synthesize_ids_batch(SEQS, **DET),
                 single.synthesize_ids_batch(SEQS, **DET))
    assert (tpt.gathers, tpt.reductions) == (0, 0)


def test_dp2tp2_matches_the_jax_tp_session(voice_dir, dp2tp2):
    """The JAX package's ``use_tp`` session on a dp 2 x tp 2 mesh of its
    8 virtual CPU devices (conftest) and the port's on one batch."""
    ref = VitsSession(
        JTrainingConfig.load_path(voice_dir / "config.json"),
        j_load_npz(voice_dir / "generator.npz"),
        deterministic=True, mesh=j_make_mesh(n_devices=4, tp=2),
        use_tp=True,
    )
    want = ref.synthesize_ids_batch(SEQS[:4], **DET)
    got = dp2tp2.synthesize_ids_batch(SEQS[:4], **DET)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        corr = np.corrcoef(g.astype(np.float64), w.astype(np.float64))[0, 1]
        assert corr >= 0.999, corr


# ---------------------------------------------------------------------------
# the kernel gate
# ---------------------------------------------------------------------------


def test_tp_mesh_keeps_kernel_off(voice_dir, monkeypatch):
    """The counterpart of tests/test_mesh_stage_kernel.py's: with the
    stage asked for, a tp mesh's model has the gate at 0, packs nothing,
    and its batch calls never reach the fused stage, which a dp-only mesh
    of the same config does."""
    calls = []
    real = stage_mod.hifigan_stage_plain

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(stage_mod, "hifigan_stage_plain", counting)
    for use_tp in (True, False):
        session = _session(voice_dir, make_mesh(dp=2, tp=2, platform="cpu"),
                           use_tp=use_tp, pallas_stage_max_channels=32)
        assert session.model.stage_max_channels == 0
        assert all(r.stage_weights == {} for r in session._replicas)
        session.synthesize_ids_batch(SEQS[:4], **DET)
        assert calls == []
    dp_only = _session(voice_dir, make_mesh(dp=2, platform="cpu"),
                       pallas_stage_max_channels=32)
    dp_only.synthesize_ids_batch(SEQS[:4], **DET)
    assert calls


def test_pack_decoder_refuses_split_leaves(voice_dir):
    config = TrainingConfig.load_path(voice_dir / "config.json")
    params = to_torch_params(load_pytree_npz(voice_dir / "generator.npz"))
    split = _split_tree(params)
    model = VitsModel(config.model, decoder_dtype=torch.float32,
                      stage_max_channels=32)
    assert model.pack_decoder(params["dec"], torch.device("cpu"))
    with pytest.raises(ValueError, match="whole weights"):
        model.pack_decoder(split["dec"], torch.device("cpu"))


# ---------------------------------------------------------------------------
# the global mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp,dp_outer", [
    (1, None), (2, None), (4, None), (2, 2), (1, 4), (2, 1),
])
def test_global_mesh_shapes_match_the_reference(monkeypatch, tp, dp_outer):
    """One process over 8 devices: the reference's 8 virtual CPU devices,
    the port's 8 cards (counted, not touched)."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    mesh = make_global_mesh(tp=tp, dp_outer=dp_outer)
    want = j_make_global_mesh(tp=tp, dp_outer=dp_outer)
    assert mesh.shape == dict(want.shape)
    assert [str(d) for d in mesh.devices.ravel()] == [
        f"cuda:{d.id}" for d in want.devices.ravel()
    ]
    assert len(mesh.local_rows()) == mesh.shape["dp"]
    assert all(row.column is None for row in mesh.local_rows())


@pytest.mark.parametrize("dp_outer", [1, 3])
def test_dp_outer_other_than_the_ranks_raises(monkeypatch, dp_outer):
    """Two processes of one device each: a dp_outer below the ranks
    would leave rank 1 with no row, one above them asks for devices no
    rank holds."""
    monkeypatch.setattr(distributed, "_world", lambda: (1, 2))
    with pytest.raises(ValueError, match="every rank must own one dp row"):
        make_global_mesh(dp_outer=dp_outer, device="cpu")


@pytest.mark.parametrize("rank,world,tp", [(0, 2, 3), (1, 3, 2)])
def test_tp_that_does_not_divide_the_ranks_raises(monkeypatch, rank, world,
                                                  tp):
    """Over several processes of one device each every rank sits in one
    tp row: a tp that does not divide the ranks raises before any group
    is made."""
    monkeypatch.setattr(distributed, "_world", lambda: (rank, world))
    with pytest.raises(ValueError, match="does not divide"):
        make_global_mesh(tp=tp, device="cpu")


def test_local_rows_of_a_row_across_processes():
    """A row that spans processes is each rank's row at its own column; a
    rank the mesh does not hold, or one holding part of a row, raises."""
    cpu = torch.device("cpu")
    grid = np.array([[cpu, cpu], [cpu, cpu]], dtype=object)
    owners = np.array([[0, 1], [2, 3]], np.int64)
    for rank in range(4):
        mesh = Mesh(grid, owners, process_index=rank)
        assert mesh.local_rows() == [(rank // 2, (cpu,), rank % 2)]
        assert mesh.local_shards() == [(rank // 2, cpu)]
    with pytest.raises(ValueError, match="holds no device"):
        Mesh(grid, owners, process_index=4).local_rows()
    three = np.array([[cpu, cpu, cpu]], dtype=object)
    with pytest.raises(ValueError, match="holds 2 of dp row 0"):
        Mesh(three, np.array([[0, 0, 1]], np.int64)).local_rows()
