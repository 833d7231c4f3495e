"""Per-module parity: the port's VITS modules against the JAX reference.

The same numpy inputs (from a seed) go through both packages; the port
runs in its [B, C, T] layout and is transposed back for comparison.
Tolerance: f32 ``atol=2e-4, rtol=1e-3`` (the tests/test_stage_kernel.py
bar).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mimic3_tpu.config import ModelConfig
from mimic3_tpu.models.vits import duration as jdur
from mimic3_tpu.models.vits import encoder as jenc
from mimic3_tpu.models.vits import flow as jflw
from mimic3_tpu.models.vits import hifigan as jhfg
from mimic3_tpu.models.vits import init_vits_params
from mimic3_tpu.models.vits import layers as jl
from mimic3_tpu.models.vits import transforms as jtr
from mimic3_tpu.models.vits.model import expand_by_durations as j_expand
from mimic3_tpu_torch.models.vits import duration as tdur
from mimic3_tpu_torch.models.vits import encoder as tenc
from mimic3_tpu_torch.models.vits import flow as tflw
from mimic3_tpu_torch.models.vits import hifigan as thfg
from mimic3_tpu_torch.models.vits import layers as tl
from mimic3_tpu_torch.models.vits import transforms as ttr
from mimic3_tpu_torch.models.vits.model import (
    expand_by_durations as t_expand,
    indexed_noise,
)
from mimic3_tpu_torch.runtime.convert import to_torch_params

TOL = dict(atol=2e-4, rtol=1e-3)


def _t(a: np.ndarray) -> torch.Tensor:
    """[B, T, C] numpy -> [B, C, T] torch."""
    return torch.from_numpy(np.ascontiguousarray(a)).transpose(1, 2)


def _n(x: torch.Tensor) -> np.ndarray:
    """[B, C, T] torch -> [B, T, C] numpy."""
    return x.transpose(1, 2).detach().numpy()


def _config(**kw) -> ModelConfig:
    base = dict(
        num_symbols=40,
        hidden_channels=32,
        inter_channels=32,
        filter_channels=64,
        n_layers=2,
        upsample_initial_channel=64,
    )
    base.update(kw)
    return ModelConfig(**base)


def _params(config: ModelConfig, seed: int = 0):
    """(JAX params, port params) from one JAX initialization."""
    ref = init_vits_params(jax.random.PRNGKey(seed), config)
    host = jax.tree_util.tree_map(np.asarray, ref)
    return ref, to_torch_params(host)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32
    )[..., None]


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------


def _conv_case(rng, name, k, cin, cout, groups=1):
    p = {
        "weight": rng.randn(k, cin // groups, cout).astype(np.float32) * 0.3,
        "bias": rng.randn(cout).astype(np.float32) * 0.1,
    }
    port = to_torch_params({name: p})[name]
    return {k_: jnp.asarray(v) for k_, v in p.items()}, port


@pytest.mark.parametrize(
    "op",
    [
        "conv1d",
        "conv1d_dilated",
        "conv1d_grouped",
        "conv_transpose1d",
        "layer_norm",
        "embedding",
        "leaky_relu",
        "gate",
        "sequence_mask",
    ],
)
def test_layers_op(op):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 19, 8).astype(np.float32)
    if op.startswith("conv1d"):
        kw, groups = {"conv1d": ({"padding": 1}, 1),
                      "conv1d_dilated": ({"padding": 6, "dilation": 3}, 1),
                      "conv1d_grouped": ({"padding": 2, "dilation": 2}, 8)}[op]
        jp, tp = _conv_case(rng, "c", 5 if op != "conv1d" else 3, 8, 8
                            if groups > 1 else 12, groups)
        ref = jl.conv1d(jnp.asarray(x), jp, groups=groups, **kw)
        got = tl.conv1d(_t(x), tp, groups=groups, **kw)
    elif op == "conv_transpose1d":
        jp, tp = _conv_case(rng, "ups.0", 4, 8, 6)
        ref = jl.conv_transpose1d(jnp.asarray(x), jp, stride=2, padding=1)
        got = tl.conv_transpose1d(_t(x), tp, stride=2, padding=1)
        assert got.shape[-1] == (19 - 1) * 2 - 2 + 4
    elif op == "layer_norm":
        p = {"gamma": rng.randn(8).astype(np.float32),
             "beta": rng.randn(8).astype(np.float32)}
        ref = jl.layer_norm(jnp.asarray(x), p)
        got = tl.layer_norm(_t(x), {k: torch.from_numpy(v) for k, v in p.items()})
    elif op == "embedding":
        w = rng.randn(11, 8).astype(np.float32)
        ids = rng.randint(0, 11, size=(2, 7))
        ref = jl.embedding(jnp.asarray(ids), {"weight": jnp.asarray(w)})
        got = tl.embedding(torch.from_numpy(ids), {"weight": torch.from_numpy(w)})
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        return
    elif op == "leaky_relu":
        ref = jl.leaky_relu(jnp.asarray(x))
        got = tl.leaky_relu(_t(x))
    elif op == "gate":
        g = rng.randn(2, 19, 8).astype(np.float32)
        ref = jl.fused_add_tanh_sigmoid_multiply(jnp.asarray(x), jnp.asarray(g), 4)
        got = tl.fused_add_tanh_sigmoid_multiply(_t(x), _t(g), 4)
    else:
        lengths = np.array([5, 19])
        ref = jl.sequence_mask(jnp.asarray(lengths), 19)
        got = tl.sequence_mask(torch.from_numpy(lengths), 19)
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# encoder.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t_bucket,lengths", [(32, (7, 32)), (64, (50, 13))])
def test_text_encoder_with_padding(t_bucket, lengths):
    config = _config()
    jp, tp = _params(config)
    rng = np.random.RandomState(t_bucket)
    ids = rng.randint(1, 40, size=(2, t_bucket))
    mask = _mask(lengths, t_bucket)
    kw = dict(n_layers=2, n_heads=2, kernel_size=3)
    ref = jenc.text_encoder(
        jp["enc_p"], jnp.asarray(ids), jnp.asarray(mask), **kw
    )
    got = tenc.text_encoder(tp["enc_p"], torch.from_numpy(ids), _t(mask), **kw)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(_n(g), np.asarray(r), **TOL)


# ---------------------------------------------------------------------------
# transforms.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tail_bound", [5.0, 2.0])
def test_spline_inverse_with_tails(tail_bound):
    rng = np.random.RandomState(11)
    shape = (3, 4, 17)
    inputs = (rng.randn(*shape) * 3.5).astype(np.float32)
    inputs[0, 0, :4] = [-7.0, 6.0, tail_bound, -tail_bound]  # tails, bounds
    w = rng.randn(*shape, 10).astype(np.float32)
    h = rng.randn(*shape, 10).astype(np.float32)
    d = rng.randn(*shape, 9).astype(np.float32)
    ref, _ = jtr.piecewise_rational_quadratic_transform(
        *(jnp.asarray(a) for a in (inputs, w, h, d)),
        inverse=True, tails="linear", tail_bound=tail_bound,
    )
    got = ttr.unconstrained_rational_quadratic_spline_inverse(
        *(torch.from_numpy(a) for a in (inputs, w, h, d)),
        tail_bound=tail_bound,
    )
    assert (np.abs(inputs) > tail_bound).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_searchsorted_onehot():
    rng = np.random.RandomState(2)
    edges = np.sort(rng.randn(5, 11).astype(np.float32), axis=-1)
    x = rng.randn(5).astype(np.float32) * 2
    ref = jtr._searchsorted_onehot(jnp.asarray(edges), jnp.asarray(x))
    got = ttr._searchsorted_onehot(torch.from_numpy(edges), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# duration.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise_w,speakers", [(0.8, 1), (0.0, 1), (0.8, 2)])
def test_stochastic_duration_predictor(noise_w, speakers):
    config = _config(n_speakers=speakers, gin_channels=16 if speakers > 1 else 0)
    jp, tp = _params(config)
    rng = np.random.RandomState(5)
    t = 24
    x = rng.randn(2, t, 32).astype(np.float32)
    mask = _mask((17, 24), t)
    noise = rng.randn(2, t, 2).astype(np.float32)
    g_np = rng.randn(2, 1, 16).astype(np.float32) if speakers > 1 else None
    ref = jdur.stochastic_duration_predictor_infer(
        jp["dp"], jnp.asarray(x), jnp.asarray(mask), jax.random.PRNGKey(0),
        jnp.float32(noise_w),
        g=None if g_np is None else jnp.asarray(g_np),
        noise=jnp.asarray(noise),
    )
    got = tdur.stochastic_duration_predictor_infer(
        tp["dp"], _t(x), _t(mask), _t(noise), noise_w,
        g=None if g_np is None else _t(g_np),
    )
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)


def test_duration_predictor():
    config = _config(use_sdp=False, n_speakers=2, gin_channels=16)
    jp, tp = _params(config)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 20, 32).astype(np.float32)
    mask = _mask((20, 9), 20)
    g = rng.randn(2, 1, 16).astype(np.float32)
    ref = jdur.duration_predictor(
        jp["dp"], jnp.asarray(x), jnp.asarray(mask), g=jnp.asarray(g)
    )
    got = tdur.duration_predictor(tp["dp"], _t(x), _t(mask), g=_t(g))
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# flow.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("speakers", [1, 2])
def test_residual_coupling_block_reverse(speakers):
    config = _config(n_speakers=speakers, gin_channels=16 if speakers > 1 else 0)
    jp, tp = _params(config)
    # zero-initialized post convs would make the flow the identity
    rng = np.random.RandomState(8)
    for i in ("0", "2", "4", "6"):
        w = rng.randn(1, 32, 16).astype(np.float32) * 0.1
        jp["flow"]["flows"][i]["post"]["weight"] = jnp.asarray(w)
        tp["flow"]["flows"][i]["post"]["weight"] = torch.from_numpy(
            np.ascontiguousarray(w.transpose(2, 1, 0))
        )
    x = rng.randn(2, 40, 32).astype(np.float32)
    mask = _mask((40, 23), 40)
    g = rng.randn(2, 1, 16).astype(np.float32) if speakers > 1 else None
    ref = jflw.residual_coupling_block(
        jp["flow"], jnp.asarray(x), jnp.asarray(mask),
        g=None if g is None else jnp.asarray(g), reverse=True,
    )
    got = tflw.residual_coupling_block_reverse(
        tp["flow"], _t(x), _t(mask), g=None if g is None else _t(g)
    )
    assert np.abs(np.asarray(ref) - x * mask).max() > 1e-3
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)


# ---------------------------------------------------------------------------
# hifigan.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stage_max_channels", [0, 32])
def test_hifigan_generator_f32(stage_max_channels):
    """Plain path, and the fused-stage dispatch (which on CPU tensors runs
    the stage's plain version) for the C <= 32 stages."""
    config = _config(n_speakers=2, gin_channels=16)
    jp, tp = _params(config)
    rng = np.random.RandomState(9)
    z = rng.randn(2, 12, 32).astype(np.float32) * 0.5
    g = rng.randn(2, 1, 16).astype(np.float32)
    ref = jhfg.hifigan_generator(
        jp["dec"], jnp.asarray(z), g=jnp.asarray(g),
        compute_dtype=jnp.float32,
    )
    got = thfg.hifigan_generator(
        tp["dec"], _t(z), g=_t(g), compute_dtype=torch.float32,
        stage_max_channels=stage_max_channels,
    )
    assert got.shape == (2, 12 * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fused_stage_predicate():
    _, tp = _params(_config())  # stages at C = 32, 16, 8, 4
    kw = dict(
        resblock_type="1",
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3,
        upsample_rates=(8, 8, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4),
    )
    assert thfg.fused_stages(tp["dec"], stage_max_channels=0, **kw) == []
    assert thfg.fused_stages(tp["dec"], stage_max_channels=16, **kw) == [1, 2]
    assert thfg.fused_stages(tp["dec"], stage_max_channels=32, **kw) == [0, 1, 2]
    kw["resblock_type"] = "2"
    assert thfg.fused_stages(tp["dec"], stage_max_channels=32, **kw) == []


# ---------------------------------------------------------------------------
# model.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_frames,offset", [(40, 0), (25, 9), (70, 0)])
def test_expand_by_durations(num_frames, offset):
    rng = np.random.RandomState(num_frames)
    values = rng.randn(2, 9, 5).astype(np.float32)
    durations = rng.randint(0, 6, size=(2, 9)).astype(np.int32)
    durations[1, 3:] = 0  # zero-length phonemes and a short row
    ref = j_expand(
        jnp.asarray(values), jnp.asarray(durations), num_frames, offset
    )
    got = t_expand(_t(values), torch.from_numpy(durations), num_frames, offset)
    np.testing.assert_array_equal(_n(got), np.asarray(ref))


def test_indexed_noise_is_position_indexed():
    full = indexed_noise(42, 1, 0, 1000, 6)
    assert full.shape == (1000, 6)
    for start, count in [(0, 1), (255, 2), (300, 500), (511, 257)]:
        np.testing.assert_array_equal(
            indexed_noise(42, 1, start, count, 6).numpy(),
            full[start : start + count].numpy(),
        )
    assert not torch.equal(indexed_noise(43, 1, 0, 10, 6), full[:10])
    assert not torch.equal(indexed_noise(42, 2, 0, 10, 6), full[:10])
    assert abs(float(full.mean())) < 0.1 and abs(float(full.std()) - 1) < 0.1
