"""Per-module parity of the port's training modules against the JAX
reference: the same numpy inputs (from a seed) through both packages; the
port runs in its [B, C, T] layout and is transposed back to compare.

Tolerances: f32 ``atol=2e-4, rtol=1e-3`` (the tests/test_stage_kernel.py
bar) unless a test says otherwise; gradients by relative L2 norm 1e-4;
MAS paths bit-equal.
"""

import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first optimizer, and that
# import looks up every module it knows with importlib; other test files
# put an ``onnx`` stub without a spec into sys.modules, which makes the
# lookup raise.  Importing it here, at collection, comes first.
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

from mimic3_tpu.config import ModelConfig
from mimic3_tpu.models.vits import discriminator as jdisc
from mimic3_tpu.models.vits import duration as jdur
from mimic3_tpu.models.vits import flow as jflw
from mimic3_tpu.models.vits import init_vits_params
from mimic3_tpu.models.vits import layers as jl
from mimic3_tpu.models.vits import posterior as jpost
from mimic3_tpu.models.vits import train as jtrain
from mimic3_tpu.models.vits import transforms as jtr
from mimic3_tpu.models.vits.mas import monotonic_alignment_search as j_mas
from mimic3_tpu.ops import stft as jstft
from mimic3_tpu_torch.models.vits import discriminator as tdisc
from mimic3_tpu_torch.models.vits import duration as tdur
from mimic3_tpu_torch.models.vits import flow as tflw
from mimic3_tpu_torch.models.vits import layers as tl
from mimic3_tpu_torch.models.vits import posterior as tpost
from mimic3_tpu_torch.models.vits import train as ttrain
from mimic3_tpu_torch.models.vits import transforms as ttr
from mimic3_tpu_torch.models.vits.mas import monotonic_alignment_search as t_mas
from mimic3_tpu_torch.ops import stft as tstft
from mimic3_tpu_torch.runtime.convert import (
    to_jax_layout,
    to_torch_train_params,
)

TOL = dict(atol=2e-4, rtol=1e-3)
GRAD_REL_L2 = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: in a parallel test run (a process per core)
    more oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a) -> torch.Tensor:
    """[B, T, C] numpy -> [B, C, T] torch."""
    return torch.from_numpy(np.array(a, np.float32)).transpose(1, 2)


def _n(x: torch.Tensor) -> np.ndarray:
    """[B, C, T] torch -> [B, T, C] numpy."""
    return x.transpose(1, 2).detach().numpy()


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32
    )[..., None]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _config() -> ModelConfig:
    return ModelConfig(
        num_symbols=40, n_layers=1, hidden_channels=32, inter_channels=32,
        filter_channels=64, upsample_initial_channel=64,
    )


# ---------------------------------------------------------------------------
# weight norm (layers.py) and the training layout (runtime/convert.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["conv1d", "conv_transpose1d", "conv2d"])
def test_weight_norm_conv_and_its_gradient(op):
    """A weight-normed conv and the gradient of a loss through it with
    respect to ``weight_v`` and ``weight_g``, in the carried layout."""
    rng = np.random.RandomState(5)
    if op == "conv2d":
        shape, x = (5, 1, 6, 8), rng.randn(2, 9, 3, 6).astype(np.float32)
        norm_axes, name = (0, 1, 2), "convs.0"
    else:
        shape, x = (4, 6, 8), rng.randn(2, 11, 6).astype(np.float32)
        norm_axes, name = (0, 1), "ups.0" if op == "conv_transpose1d" else "c"
    v = rng.randn(*shape).astype(np.float32)
    g = np.sqrt(np.sum(v**2, axis=norm_axes, keepdims=True)) * (
        1 + 0.3 * rng.rand(*([1] * (len(shape) - 1)), shape[-1])
    ).astype(np.float32)
    p = {"weight_v": v, "weight_g": g, "bias": rng.randn(8).astype(np.float32)}

    def j_apply(pp, xx):
        if op == "conv1d":
            return jl.conv1d(xx, pp, padding=1)
        if op == "conv_transpose1d":
            return jl.conv_transpose1d(xx, pp, stride=2, padding=1)
        return jdisc._conv2d(xx, pp, stride=(3, 1), padding=(2, 0))

    weights = rng.randn(*np.asarray(j_apply(p, x)).shape).astype(np.float32)

    def j_loss(pp):
        return jnp.sum(j_apply(pp, jnp.asarray(x)) * weights)

    ref = np.asarray(j_apply(p, x))
    ref_grads = _host(jax.grad(j_loss)(p))

    tp = to_torch_train_params({name: p})[name]
    for t in tp.values():
        t.requires_grad_(True)
    if op == "conv1d":
        got = tl.conv1d(_t(x), tp, padding=1)
        got_n = _n(got)
        w_t = _t(weights)
    elif op == "conv_transpose1d":
        got = tl.conv_transpose1d(_t(x), tp, stride=2, padding=1)
        got_n = _n(got)
        w_t = _t(weights)
    else:
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tdisc._conv2d(xt, tp, stride=(3, 1), padding=(2, 0))
        got_n = got.permute(0, 2, 3, 1).detach().numpy()
        w_t = torch.from_numpy(weights).permute(0, 3, 1, 2)
    np.testing.assert_allclose(got_n, ref, **TOL)
    (got * w_t).sum().backward()
    got_grads = to_jax_layout(
        {name: {k: t.grad for k, t in tp.items()}}
    )[name]
    for key in ("weight_v", "weight_g", "bias"):
        assert got_grads[key].shape == ref_grads[key].shape
        assert _rel_l2(got_grads[key], ref_grads[key]) < GRAD_REL_L2, key


def test_train_layout_round_trip():
    """The training trees (generator + enc_q + discriminators) go to the
    port's layout and back unchanged, weight norm unfolded."""
    cfg = jtrain.TrainingConfig()
    cfg.model = _config()
    params, disc = jtrain.init_training_params(jax.random.PRNGKey(0), cfg)
    for tree in (_host(params), _host(disc)):
        port = to_torch_train_params(tree)
        back = to_jax_layout(port)
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        flat_b = dict(
            (jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_leaves_with_path(back)
        )
        assert len(flat_a) == len(flat_b)
        for k, v in flat_a:
            np.testing.assert_array_equal(flat_b[jax.tree_util.keystr(k)], v)
    port = to_torch_train_params(_host(params))
    assert all(
        t.is_contiguous() for tree in (port, to_torch_train_params(_host(disc)))
        for t in jax.tree_util.tree_leaves(tree)
    )
    assert port["dec"]["ups"]["0"]["weight_g"].shape == (1, 32, 1)
    assert port["dec"]["resblocks"]["0"]["convs1"]["0"]["weight_g"].shape == (
        32, 1, 1,
    )
    mpd = to_torch_train_params(_host(disc))["mpd"]["2"]["convs"]["1"]
    assert mpd["weight_v"].shape == (128, 32, 5, 1)
    assert mpd["weight_g"].shape == (128, 1, 1, 1)


# ---------------------------------------------------------------------------
# ops/stft.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,win", [(1024, 256, 1024), (512, 128, 400)])
def test_spectrogram_and_mel(n_fft, hop, win):
    rng = np.random.RandomState(0)
    audio = (rng.randn(2, 4096) * 0.2).astype(np.float32)
    spec_ref = np.asarray(jstft.spectrogram(jnp.asarray(audio), n_fft, hop, win))
    spec = tstft.spectrogram(torch.from_numpy(audio), n_fft, hop, win)
    np.testing.assert_allclose(_n(spec), spec_ref, **TOL)
    kw = dict(sample_rate=22050, n_fft=n_fft, hop_length=hop,
              win_length=win, n_mels=80, fmin=0.0, fmax=8000.0)
    mel_ref = np.asarray(jstft.mel_spectrogram(jnp.asarray(audio), **kw))
    mel = tstft.mel_spectrogram(torch.from_numpy(audio), **kw)
    np.testing.assert_allclose(_n(mel), mel_ref, **TOL)
    np.testing.assert_array_equal(
        tstft.mel_filterbank(22050, n_fft, 80, 0.0, 8000.0),
        jstft.mel_filterbank(22050, n_fft, 80, 0.0, 8000.0),
    )


# ---------------------------------------------------------------------------
# transforms.py, forward
# ---------------------------------------------------------------------------


def _spline_inputs(rng, shape=(3, 7, 1), bins=10, scale=3.0):
    x = (rng.randn(*shape) * scale).astype(np.float32)
    w = rng.randn(*shape, bins).astype(np.float32)
    h = rng.randn(*shape, bins).astype(np.float32)
    d = rng.randn(*shape, bins - 1).astype(np.float32)
    return x, w, h, d


@pytest.mark.parametrize("tails", ["linear", None])
def test_spline_forward_with_logabsdet(tails):
    rng = np.random.RandomState(1)
    x, w, h, d = _spline_inputs(rng)
    if tails is None:
        x = rng.rand(*x.shape).astype(np.float32)
        d = rng.randn(*x.shape, 11).astype(np.float32)
    ref_y, ref_ld = jtr.piecewise_rational_quadratic_transform(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(h), jnp.asarray(d),
        inverse=False, tails=tails, tail_bound=5.0,
    )
    y, ld = ttr.piecewise_rational_quadratic_transform(
        *(torch.from_numpy(a) for a in (x, w, h, d)), tails=tails,
        tail_bound=5.0,
    )
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), **TOL)


def test_spline_forward_then_inverse_is_identity():
    rng = np.random.RandomState(2)
    x, w, h, d = (torch.from_numpy(a) for a in _spline_inputs(rng))
    y, _ = ttr.unconstrained_rational_quadratic_spline(x, w, h, d, 5.0)
    back = ttr.unconstrained_rational_quadratic_spline_inverse(y, w, h, d, 5.0)
    torch.testing.assert_close(back, x, atol=1e-4, rtol=1e-4)
    assert ((x.abs() > 5.0) & (y == x)).sum() == (x.abs() > 5.0).sum()


# ---------------------------------------------------------------------------
# duration.py, forward
# ---------------------------------------------------------------------------


def _sdp_case(seed=3):
    cfg = _config()
    params = init_vits_params(jax.random.PRNGKey(seed), cfg)
    # zero-initialized projections make every spline the identity: give
    # them weights so the forward flows act
    rng = np.random.RandomState(seed)
    host = _host(params)
    for tree in (host["dp"]["flows"], host["dp"]["post_flows"]):
        for key, flow in tree.items():
            if key == "0":
                flow["m"] = rng.randn(2).astype(np.float32) * 0.3
                flow["logs"] = rng.randn(2).astype(np.float32) * 0.3
            else:
                flow["proj"]["weight"] = (
                    rng.randn(*flow["proj"]["weight"].shape) * 0.3
                ).astype(np.float32)
    return host, to_torch_train_params(host), rng


def test_log_flow_and_elementwise_affine():
    rng = np.random.RandomState(4)
    x = np.abs(rng.randn(2, 9, 2)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # below the clamp
    mask = _mask([9, 5], 9)
    ref_y, ref_ld = jdur.log_flow(jnp.asarray(x), jnp.asarray(mask))
    y, ld = tdur.log_flow(_t(x), _t(mask))
    np.testing.assert_allclose(_n(y), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), **TOL)
    p = {"m": rng.randn(2).astype(np.float32),
         "logs": rng.randn(2).astype(np.float32)}
    ref_y, ref_ld = jdur.elementwise_affine(p, jnp.asarray(x), jnp.asarray(mask))
    y, ld = tdur.elementwise_affine(
        {k: torch.from_numpy(v) for k, v in p.items()}, _t(x), _t(mask)
    )
    np.testing.assert_allclose(_n(y), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), **TOL)


def test_conv_flow_forward():
    host, port, rng = _sdp_case()
    x = (rng.randn(2, 9, 2) * 2).astype(np.float32)
    cond = rng.randn(2, 9, 192).astype(np.float32)
    mask = _mask([9, 6], 9)
    p = host["dp"]["flows"]["3"]
    ref_y, ref_ld = jax.jit(jdur.conv_flow)(
        p, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(cond)
    )
    y, ld = tdur.conv_flow(port["dp"]["flows"]["3"], _t(x), _t(mask), _t(cond))
    np.testing.assert_allclose(_n(y), np.asarray(ref_y), **TOL)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), **TOL)


def test_stochastic_duration_predictor_nll():
    """The NLL with the reference's own e_q draw (duration.py:255-256)
    injected."""
    host, port, rng = _sdp_case()
    b, t = 2, 9
    x = rng.randn(b, t, 32).astype(np.float32)
    mask = _mask([9, 6], t)
    w = (rng.randint(1, 6, (b, t, 1)) * mask).astype(np.float32)
    key = jax.random.PRNGKey(7)
    ref = jax.jit(jdur.stochastic_duration_predictor_nll)(
        host["dp"], jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w), key
    )
    e_q = np.asarray(
        jax.random.normal(jax.random.split(key)[0], (b, t, 2), jnp.float32)
    )
    got = tdur.stochastic_duration_predictor_nll(
        port["dp"], _t(x), _t(mask), _t(w), noise=_t(e_q)
    )
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    # the noise a generator draws has the right shape and is used
    gen = torch.Generator().manual_seed(0)
    other = tdur.stochastic_duration_predictor_nll(
        port["dp"], _t(x), _t(mask), _t(w), generator=gen
    )
    assert other.shape == (b,) and torch.isfinite(other).all()


# ---------------------------------------------------------------------------
# flow.py forward, posterior.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("speakers", [1, 3])
def test_residual_coupling_block_forward(speakers):
    cfg = _config()
    if speakers > 1:
        cfg.n_speakers, cfg.gin_channels = speakers, 16
    host = _host(init_vits_params(jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(1)
    for flow in host["flow"]["flows"].values():  # zero-init posts
        flow["post"]["weight"] = (
            rng.randn(*flow["post"]["weight"].shape) * 0.2
        ).astype(np.float32)
    port = to_torch_train_params(host)
    z = rng.randn(2, 13, 32).astype(np.float32)
    mask = _mask([13, 8], 13)
    g = rng.randn(2, 1, 16).astype(np.float32) if speakers > 1 else None
    ref = jax.jit(jflw.residual_coupling_block)(
        host["flow"], jnp.asarray(z), jnp.asarray(mask),
        None if g is None else jnp.asarray(g),
    )
    got = tflw.residual_coupling_block(
        port["flow"], _t(z), _t(mask), None if g is None else _t(g)
    )
    np.testing.assert_allclose(_n(got), np.asarray(ref), **TOL)
    back = tflw.residual_coupling_block_reverse(
        port["flow"], got, _t(mask), None if g is None else _t(g)
    )
    np.testing.assert_allclose(_n(back), z * mask, atol=1e-5)


def test_posterior_encoder():
    """With the reference's own noise draw (posterior.py:66) injected."""
    rng = np.random.RandomState(6)
    key = jax.random.PRNGKey(2)
    p = _host(jpost.init_posterior_encoder(key, 65, 16, 32, 0, n_layers=4))
    spec = np.abs(rng.randn(2, 11, 65)).astype(np.float32)
    mask = _mask([11, 7], 11)
    nkey = jax.random.PRNGKey(9)
    fn = jax.jit(lambda *a: jpost.posterior_encoder(*a, n_layers=4))
    ref = fn(p, jnp.asarray(spec), jnp.asarray(mask), nkey)
    noise = np.asarray(jax.random.normal(nkey, (2, 11, 16), jnp.float32))
    got = tpost.posterior_encoder(
        to_torch_train_params(p), _t(spec), _t(mask), noise=_t(noise),
        n_layers=4,
    )
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_n(a), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# discriminator.py
# ---------------------------------------------------------------------------


def test_discriminators_logits_and_feature_maps():
    host = _host(jdisc.init_discriminators(jax.random.PRNGKey(4)))
    port = to_torch_train_params(host)
    rng = np.random.RandomState(8)
    audio = (rng.randn(2, 2048) * 0.3).astype(np.float32)
    ref_logits, ref_fmaps = jax.jit(jdisc.discriminate)(host, jnp.asarray(audio))
    logits, fmaps = tdisc.discriminate(port, torch.from_numpy(audio))
    assert len(logits) == len(ref_logits) == 1 + len(tdisc.PERIODS)
    for a, b in zip(logits, ref_logits):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    for head, (fa, fb) in enumerate(zip(fmaps, ref_fmaps)):
        assert len(fa) == len(fb)
        for a, b in zip(fa, fb):
            a = a.detach()
            # port NCHW / NCT -> the reference's channels-last
            a = a.permute(0, 2, 3, 1) if a.dim() == 4 else a.transpose(1, 2)
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---------------------------------------------------------------------------
# mas.py
# ---------------------------------------------------------------------------


def _brute_mas(ll, tt, ts):
    """The reference tests' brute-force DP (tests/test_training.py)."""
    neg = -1e9
    val = np.full((tt, ts), neg)
    back = np.zeros((tt, ts), bool)
    val[0, 0] = ll[0, 0]
    for t in range(1, ts):
        for j in range(tt):
            stay = val[j, t - 1]
            diag = val[j - 1, t - 1] if j > 0 else neg
            if diag >= stay:
                val[j, t] = diag + ll[j, t]
                back[j, t] = True
            else:
                val[j, t] = stay + ll[j, t]
    path = np.zeros((tt, ts))
    j = tt - 1
    for t in range(ts - 1, -1, -1):
        path[j, t] = 1
        if t > 0 and back[j, t]:
            j -= 1
    return path


@pytest.mark.parametrize("ties", [False, True])
def test_mas_matches_bruteforce_and_reference(ties):
    rng = np.random.RandomState(3)
    ll = rng.randn(4, 9, 21).astype(np.float32)
    if ties:  # integer scores: many equal path sums
        ll = np.round(ll).astype(np.float32)
    tts = np.array([9, 5, 2, 7])
    tss = np.array([21, 13, 9, 7])
    path = t_mas(torch.from_numpy(ll), torch.from_numpy(tts),
                 torch.from_numpy(tss)).numpy()
    ref = np.asarray(j_mas(jnp.asarray(ll), jnp.asarray(tts), jnp.asarray(tss)))
    np.testing.assert_array_equal(path, ref)
    for b in range(4):
        want = _brute_mas(ll[b, : tts[b], : tss[b]], tts[b], tss[b])
        np.testing.assert_array_equal(path[b, : tts[b], : tss[b]], want)
        assert path[b, tts[b]:, :].sum() == 0
        assert path[b, :, tss[b]:].sum() == 0
        np.testing.assert_array_equal(path[b, :, : tss[b]].sum(axis=0), 1.0)


def test_mas_text_longer_than_frames_matches_reference():
    """A degenerate example (more text than frames) takes the reference's
    path too, indices wrapped as its indexing wraps them."""
    rng = np.random.RandomState(11)
    ll = rng.randn(2, 8, 6).astype(np.float32)
    tts, tss = np.array([8, 3]), np.array([5, 6])
    path = t_mas(torch.from_numpy(ll), torch.from_numpy(tts),
                 torch.from_numpy(tss)).numpy()
    ref = np.asarray(j_mas(jnp.asarray(ll), jnp.asarray(tts), jnp.asarray(tss)))
    np.testing.assert_array_equal(path, ref)


# ---------------------------------------------------------------------------
# train.py: losses and segments
# ---------------------------------------------------------------------------


def test_losses():
    rng = np.random.RandomState(12)
    z_p, logs_q, m_p, logs_p = (
        rng.randn(2, 10, 8).astype(np.float32) * 0.5 for _ in range(4)
    )
    mask = _mask([10, 6], 10)
    ref = jtrain.kl_loss(*(jnp.asarray(a) for a in (z_p, logs_q, m_p, logs_p,
                                                    mask)))
    got = ttrain.kl_loss(*(_t(a) for a in (z_p, logs_q, m_p, logs_p, mask)))
    np.testing.assert_allclose(float(got), float(ref), **TOL)

    real = [[rng.randn(2, 5, 3).astype(np.float32) for _ in range(3)]
            for _ in range(2)]
    fake = [[rng.randn(2, 5, 3).astype(np.float32) for _ in range(3)]
            for _ in range(2)]
    as_j = lambda ls: [[jnp.asarray(a) for a in fm] for fm in ls]  # noqa: E731
    as_t = lambda ls: [[torch.from_numpy(a) for a in fm] for fm in ls]  # noqa
    np.testing.assert_allclose(
        float(ttrain.feature_matching_loss(as_t(real), as_t(fake))),
        float(jtrain.feature_matching_loss(as_j(real), as_j(fake))), **TOL,
    )
    logits_r = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    logits_f = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        float(ttrain.generator_adv_loss([torch.from_numpy(a) for a in logits_f])),
        float(jtrain.generator_adv_loss([jnp.asarray(a) for a in logits_f])),
        **TOL,
    )
    np.testing.assert_allclose(
        float(ttrain.discriminator_adv_loss(
            [torch.from_numpy(a) for a in logits_r],
            [torch.from_numpy(a) for a in logits_f])),
        float(jtrain.discriminator_adv_loss(
            [jnp.asarray(a) for a in logits_r],
            [jnp.asarray(a) for a in logits_f])),
        **TOL,
    )


def test_segments_with_the_reference_starts():
    rng = np.random.RandomState(13)
    values = rng.randn(3, 20, 4).astype(np.float32)
    lengths = np.array([20, 12, 5])
    ref, starts = jtrain.random_segments(
        jnp.asarray(values), jnp.asarray(lengths), jax.random.PRNGKey(3), 8
    )
    got, got_starts = ttrain.random_segments(
        _t(values), torch.from_numpy(lengths), 8,
        starts=torch.from_numpy(np.array(starts)),
    )
    np.testing.assert_array_equal(_n(got), np.asarray(ref))
    audio = rng.randn(3, 20 * 4).astype(np.float32)
    np.testing.assert_array_equal(
        ttrain.slice_audio_segments(torch.from_numpy(audio), got_starts, 8, 4)
        .numpy(),
        np.asarray(jtrain.slice_audio_segments(jnp.asarray(audio), starts, 8, 4)),
    )
    # drawn starts keep every window inside the valid region
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        _, s = ttrain.random_segments(
            _t(values), torch.from_numpy(lengths), 8, generator=gen
        )
        assert (s >= 0).all() and (s <= torch.tensor([12, 4, 0])).all()


def test_optimizer_schedule_and_clip_follow_optax():
    """The learning rate per update count and the global-norm clip equal
    optax's; one Adam update equals optax.adam's."""
    import optax

    cfg = jtrain.TrainingConfig()
    cfg.lr_decay = 0.9
    for count in (0, 1, 7, 2500):
        want = cfg.learning_rate * np.power(np.float32(cfg.lr_decay),
                                            count / 1000)
        got = ttrain.learning_rate(cfg, count, 1000)
        np.testing.assert_allclose(got, want, rtol=1e-6)

    rng = np.random.RandomState(14)
    grads = [rng.randn(5, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    for max_norm in (1.0, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None
        )
        got = [torch.from_numpy(g.copy()) for g in grads]
        ttrain.clip_by_global_norm(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    params = [rng.randn(5, 3).astype(np.float32)]
    tx = optax.adam(cfg.learning_rate, b1=cfg.betas[0], b2=cfg.betas[1],
                    eps=cfg.eps)
    p_j = [jnp.asarray(params[0])]
    opt_state = tx.init(p_j)
    tree = {"w": torch.from_numpy(params[0].copy())}
    state = ttrain.init_train_state(tree, {"d": torch.zeros(2)}, cfg)
    for step in range(3):
        g = rng.randn(5, 3).astype(np.float32)
        upd, opt_state = tx.update([jnp.asarray(g)], opt_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        ttrain._update(state.opt_g, state.g_leaves, [torch.from_numpy(g)],
                       cfg.learning_rate, None)
    np.testing.assert_allclose(tree["w"].detach().numpy(), np.asarray(p_j[0]),
                               rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# the kernels refuse autograd
# ---------------------------------------------------------------------------


def test_kernels_refuse_to_launch_under_autograd():
    """A launch through ctypes would cut the gradient: with grad mode on
    and an input or weight requiring grad, both kernels' wrappers raise
    before they look at the device (a meta tensor stands in for the
    card's); without grad they go on to their device check."""
    from mimic3_tpu_torch.ops import resblock, stage

    def meta(*shape, grad=False):
        return torch.zeros(*shape, device="meta", requires_grad=grad)

    calls = {
        "stage": lambda x, w: stage.hifigan_stage_fused(
            [{"convs1": {"0": {"weight": w}}}], x, (3,), ((1,),)
        ),
        "resblock": lambda x, w: resblock.fused_resblock_subblock(
            x, w, None, w, None, kernel_size=3, dilation=1
        ),
    }
    for call in calls.values():
        for x_grad, w_grad in ((True, False), (False, True)):
            x, w = meta(1, 32, 8, grad=x_grad), meta(32, 32, 3, grad=w_grad)
            with pytest.raises(RuntimeError, match="requires grad"):
                call(x, w)
            with torch.no_grad(), pytest.raises(
                ValueError, match="unsupported device"
            ):
                call(x, w)
