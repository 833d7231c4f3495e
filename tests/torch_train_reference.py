"""Shared fixtures of the train-step parity tests
(``test_torch_port_train_step.py``, ``test_torch_port_train_adam.py``):
the tiny config, its batch, the reference's initial state carried to the
port, and the draws of the reference's key injected into the port.

The config is tests/test_training.py's (1 layer, widths 32/32/64/64,
segment 2048; the discriminators are full size).  The initial state is
the JAX package's ``init_train_state`` with one change, made alike on
both sides: the decoder's weight-norm gains ``weight_g`` are scaled by
10.  At the plain init the residual branches are near zero and the
decoder's output is a bias-driven line spectrum (median bin 8e-6); there
the mel loss's gradient moves by 3.3e-3 (relative L2) when the audio moves
by 2.5e-8, in float64 as in float32, so no float32 implementation can be
held to 1e-3 of another.  With the gains scaled the output's spectrum is
broad and the same change moves the gradient by 2.8e-6.
"""

import fnmatch
import types

import numpy as np
import torch
# torch.optim imports torch._dynamo at its first optimizer, and that
# import looks up every module it knows with importlib; other test files
# put an ``onnx`` stub without a spec into sys.modules, which makes the
# lookup raise.  Importing it here, at collection, comes first.
import torch._dynamo  # noqa: F401

import jax
import jax.numpy as jnp

from mimic3_tpu.config import ModelConfig, TrainingConfig
from mimic3_tpu.models.vits import train as jtrain
from mimic3_tpu_torch.config import ModelConfig as TModelConfig
from mimic3_tpu_torch.config import TrainingConfig as TTrainingConfig
from mimic3_tpu_torch.models.vits import train as ttrain
from mimic3_tpu_torch.runtime.convert import to_torch_train_params

DECODER_GAIN = 10.0
# parameters whose gradient is zero in exact arithmetic: softmax ignores a
# shift shared by a row, so the attention key bias moves no output; in
# float32 both packages compute rounding noise for it
_ZERO_GRADIENT = ("enc_p.attn_layers.*.conv_k.bias",)


def zero_gradient_in_exact_arithmetic(name: str) -> bool:
    return any(fnmatch.fnmatch(name, p) for p in _ZERO_GRADIENT)


def config(port: bool = False, model=None, **overrides):
    """The tiny config; ``model`` updates its model fields (a variant),
    ``overrides`` its training fields."""
    cls, model_cls = (
        (TTrainingConfig, TModelConfig) if port
        else (TrainingConfig, ModelConfig)
    )
    cfg = cls()
    cfg.model = model_cls(**{
        **dict(num_symbols=40, n_layers=1, hidden_channels=32,
               inter_channels=32, filter_channels=64,
               upsample_initial_channel=64),
        **(model or {}),
    })
    cfg.segment_size = 2048
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def batch_arrays(rows: int = 2, n_speakers: int = 1):
    """tests/test_training.py's batch, as numpy (``rows`` up to 4; with
    several speakers, ``speaker_ids`` cycle through them)."""
    rng = np.random.RandomState(0)
    b = dict(
        phoneme_ids=rng.randint(1, 40, (rows, 6)).astype(np.int32),
        text_lengths=np.array([6, 4, 5, 3][:rows], np.int32),
        audio=(rng.randn(rows, 4096) * 0.1).astype(np.float32),
        spec_lengths=np.array([16, 12, 14, 10][:rows], np.int32),
    )
    if n_speakers > 1:
        b["speaker_ids"] = (np.arange(rows) % n_speakers).astype(np.int32)
    return b


def j_batch(b):
    return jtrain.TrainBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def t_batch(b):
    return ttrain.TrainBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def initial_state(cfg):
    """The reference's ``init_train_state`` (jitted) with the decoder's
    gains scaled (module docstring)."""
    state = jax.jit(lambda k: jtrain.init_train_state(k, cfg))(
        jax.random.PRNGKey(0)
    )

    def scale(tree):
        return {
            k: scale(v) if isinstance(v, dict)
            else v * DECODER_GAIN if k == "weight_g" else v
            for k, v in tree.items()
        }

    params = dict(state.params)
    params["dec"] = scale(params["dec"])
    return jtrain.TrainState(
        params=params, disc_params=state.disc_params, opt_g=state.opt_g,
        opt_d=state.opt_d, step=state.step,
    )


def port_initial_state(tcfg):
    """The port's own training init (``init_training_params(0, ...)``,
    no JAX compile) with the decoder's gains scaled as
    :func:`initial_state` scales them: host trees in the JAX layout, as
    ``.params`` and ``.disc_params``."""
    params, disc = ttrain.init_training_params(0, tcfg)
    for name, t in ttrain.tree_leaves(params["dec"]):
        if name.endswith("weight_g"):
            t.mul_(DECODER_GAIN)
    return types.SimpleNamespace(params=host(params), disc_params=host(disc))


def reference_step(cfg, state0, b, rng):
    """The reference's first step (train.py:372-421) on batch ``b``
    against the initial discriminators, jitted: (metrics incl. ``attn``,
    G gradients, D gradients), each a host tree."""
    from mimic3_tpu.models.vits.model import VitsModel as JVitsModel

    model = JVitsModel(cfg.model, compute_dtype=jnp.float32,
                       decoder_dtype=jnp.float32)

    @jax.jit
    def grads(params, disc_params, batch, rng):
        rng_g = jax.random.fold_in(rng, 0)
        fwd = jtrain.generator_forward(model, cfg, params, batch, rng_g)

        def disc_loss_fn(dp):
            real, _ = jtrain.discriminate(dp, fwd["y_real"])
            fake, _ = jtrain.discriminate(
                dp, jax.lax.stop_gradient(fwd["y_hat"])
            )
            return jtrain.discriminator_adv_loss(real, fake)

        loss_d, grads_d = jax.value_and_grad(disc_loss_fn)(disc_params)

        def gen_loss_fn(p):
            out = jtrain.generator_forward(model, cfg, p, batch, rng_g)
            _, fmaps_r = jtrain.discriminate(disc_params, out["y_real"])
            fake, fmaps_f = jtrain.discriminate(disc_params, out["y_hat"])
            loss_adv = jtrain.generator_adv_loss(fake)
            loss_fm = jtrain.feature_matching_loss(fmaps_r, fmaps_f)
            loss = (out["loss_mel"] * cfg.c_mel + out["loss_kl"] * cfg.c_kl
                    + out["loss_dur"] + loss_adv + loss_fm)
            return loss, dict(loss_g=loss, loss_mel=out["loss_mel"],
                              loss_kl=out["loss_kl"],
                              loss_dur=out["loss_dur"], loss_adv=loss_adv,
                              loss_fm=loss_fm, attn=out["attn"])

        (_, metrics), grads_g = jax.value_and_grad(
            gen_loss_fn, has_aux=True
        )(params)
        metrics["loss_d"] = loss_d
        return metrics, grads_g, grads_d

    metrics, grads_g, grads_d = grads(state0.params, state0.disc_params,
                                      j_batch(b), rng)
    return host(metrics), host(grads_g), host(grads_d)


def gradient_errors(want, got, bar):
    """{name: relative L2 error} of every gradient past ``bar``, after
    the checks of the train-step test: the same names and shapes, the
    gradients zero in exact arithmetic within a millionth of the largest,
    and the same set of tensors without a gradient."""
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    bad = {}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if zero_gradient_in_exact_arithmetic(name):
            assert max(np.abs(g).max(), np.abs(w).max()) < 1e-6 * scale
            continue
        norm = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / norm if norm else np.abs(g).max()
        if not err <= bar:
            bad[name] = float(err)
    assert {n for n, w in want.items() if not w.any()} == {
        n for n, g in got.items() if not g.any()
    }
    return bad


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    """A host JAX-layout tree -> the port's training tensors."""
    return to_torch_train_params(host(tree))


def _t(a) -> torch.Tensor:
    """[B, T, C] -> [B, C, T]."""
    return torch.from_numpy(np.array(a)).transpose(1, 2)


def reference_noise(rng, b, cfg) -> ttrain.TrainNoise:
    """The draws the reference's generator_forward makes from one train
    step's key ``rng`` (train.py:204, :366; posterior.py:66;
    duration.py:255-256), in the port's layout."""
    hop = cfg.audio.hop_length
    k_post, k_seg, k_dur = jax.random.split(jax.random.fold_in(rng, 0), 3)
    n_batch, t_spec = b["audio"].shape[0], b["audio"].shape[1] // hop
    posterior = jax.random.normal(
        k_post, (n_batch, t_spec, cfg.model.inter_channels), jnp.float32
    )
    _, starts = jtrain.random_segments(
        jnp.zeros((n_batch, t_spec, 1)), jnp.asarray(b["spec_lengths"]),
        k_seg, cfg.segment_size // hop,
    )
    e_q = jax.random.normal(
        jax.random.split(k_dur)[0], (n_batch, b["phoneme_ids"].shape[1], 2),
        jnp.float32,
    )
    return ttrain.TrainNoise(
        posterior=_t(posterior), duration=_t(e_q),
        starts=torch.from_numpy(np.array(starts)),
    )


def flat(tree, prefix=""):
    """{dotted name: numpy array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflat(named):
    tree = {}
    for name, value in named.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def carry_state(state, cfg) -> ttrain.TrainState:
    """A reference TrainState after some steps -> the port's, Adam's
    moments and step count included (``optax.adam``'s ``mu``/``nu`` are
    ``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq``)."""
    port = ttrain.init_train_state(
        carry(state.params), carry(state.disc_params), cfg
    )
    port.step = int(state.step)
    for opt, leaves, opt_state in (
        (port.opt_g, port.g_leaves, state.opt_g),
        (port.opt_d, port.d_leaves, state.opt_d),
    ):
        adam = opt_state[0]  # optax.adam: (ScaleByAdamState, schedule)
        mu = dict(ttrain.tree_leaves(carry(adam.mu)))
        nu = dict(ttrain.tree_leaves(carry(adam.nu)))
        for name, p in leaves:
            opt.state[p] = {
                "step": torch.tensor(float(adam.count)),
                "exp_avg": mu[name],
                "exp_avg_sq": nu[name],
            }
    return port
