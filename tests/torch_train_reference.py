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


def config(port: bool = False, **overrides):
    cls, model_cls = (
        (TTrainingConfig, TModelConfig) if port
        else (TrainingConfig, ModelConfig)
    )
    cfg = cls()
    cfg.model = model_cls(
        num_symbols=40, n_layers=1, hidden_channels=32, inter_channels=32,
        filter_channels=64, upsample_initial_channel=64,
    )
    cfg.segment_size = 2048
    for key, value in overrides.items():
        setattr(cfg, key, value)
    return cfg


def batch_arrays():
    """tests/test_training.py's batch, as numpy."""
    rng = np.random.RandomState(0)
    return dict(
        phoneme_ids=rng.randint(1, 40, (2, 6)).astype(np.int32),
        text_lengths=np.array([6, 4], np.int32),
        audio=(rng.randn(2, 4096) * 0.1).astype(np.float32),
        spec_lengths=np.array([16, 12], np.int32),
    )


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
