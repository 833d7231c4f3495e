"""One VITS train step of the port against the JAX reference's, on the CPU.

The port starts from the JAX package's own ``init_train_state``, carried
across with weight norm unfolded, and every draw the reference makes from
its key is taken from the reference's own key splits and injected
(``tests/torch_train_reference.py``, which also says why the decoder's
gains are scaled).  Bars:

- the losses within ``rtol=1e-3``;
- every G and D gradient tensor within relative L2 1e-3, and the same set
  of tensors without a gradient; the attention key biases, whose gradient
  is zero in exact arithmetic (``torch_train_reference.py``), within a
  millionth of the largest gradient;
- MAS paths bit-equal.

The JAX init and its jitted gradients run once, in a module-scoped
fixture.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_reference as ref_lib
from mimic3_tpu.models.vits import train as jtrain
from mimic3_tpu.models.vits.layers import sequence_mask as j_sequence_mask
from mimic3_tpu.models.vits.mas import monotonic_alignment_search as j_mas
from mimic3_tpu.models.vits.model import VitsModel as JVitsModel
from mimic3_tpu.ops.stft import spectrogram as j_spectrogram
from mimic3_tpu_torch.models.vits import train as ttrain
from mimic3_tpu_torch.models.vits.mas import monotonic_alignment_search as t_mas
from mimic3_tpu_torch.runtime.convert import to_jax_layout

LOSS_RTOL = 1e-3
GRAD_REL_L2 = 1e-3
METRICS = ("loss_g", "loss_mel", "loss_kl", "loss_dur", "loss_adv",
           "loss_fm", "loss_d")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """JAX: the initial state, the first step's losses and gradients, both
    against the initial discriminators (train.py:372-421), and the scores
    MAS runs on (:193-234)."""
    cfg = ref_lib.config()
    state0 = ref_lib.initial_state(cfg)
    b = ref_lib.batch_arrays()
    batch = ref_lib.j_batch(b)
    model = JVitsModel(cfg.model, compute_dtype=jnp.float32,
                       decoder_dtype=jnp.float32)

    @jax.jit
    def mas_input(params, batch, rng):
        k_post = jax.random.split(jax.random.fold_in(rng, 0), 3)[0]
        x_mask = j_sequence_mask(batch.text_lengths,
                                 batch.phoneme_ids.shape[1])
        _, m_p, logs_p = model.encode(params, batch.phoneme_ids, x_mask)
        spec = j_spectrogram(batch.audio, cfg.audio.filter_length,
                             cfg.audio.hop_length, cfg.audio.win_length)
        y_mask = j_sequence_mask(batch.spec_lengths, spec.shape[1])
        z, _, _ = jtrain.posterior_encoder(params["enc_q"], spec, y_mask,
                                           k_post)
        z_p = jtrain.flw.residual_coupling_block(params["flow"], z, y_mask)
        s = jnp.exp(-2.0 * logs_p)
        hi = jax.lax.Precision.HIGHEST
        return (
            jnp.sum(-0.5 * math.log(2 * math.pi) - logs_p, -1)[:, :, None]
            + jnp.einsum("btc,bjc->bjt", -0.5 * z_p**2, s, precision=hi)
            + jnp.einsum("btc,bjc->bjt", z_p, m_p * s, precision=hi)
            + jnp.sum(-0.5 * m_p**2 * s, -1)[:, :, None]
        )

    rng = jax.random.PRNGKey(1)
    metrics, grads_g, grads_d = ref_lib.reference_step(cfg, state0, b, rng)
    return dict(
        batch=b,
        params0=ref_lib.host(state0.params),
        disc0=ref_lib.host(state0.disc_params),
        metrics=metrics,
        grads_g=ref_lib.flat(grads_g),
        grads_d=ref_lib.flat(grads_d),
        neg_x_ent=np.asarray(mas_input(state0.params, batch, rng)),
    )


@pytest.fixture(scope="module")
def port_step(reference):
    """The port's first step with a zero learning rate: the gradients stay
    on ``.grad`` and the discriminators do not move, so the generator's
    gradients are taken against the initial discriminators as above."""
    cfg = ref_lib.config(port=True, learning_rate=0.0)
    state = ttrain.init_train_state(
        ref_lib.carry(reference["params0"]), ref_lib.carry(reference["disc0"]),
        cfg,
    )
    noise = ref_lib.reference_noise(jax.random.PRNGKey(1),
                                    reference["batch"], cfg)
    state, metrics = ttrain.make_train_step(cfg)(
        state, ref_lib.t_batch(reference["batch"]), noise=noise
    )
    model = ttrain.VitsModel(cfg.model, decoder_dtype=torch.float32)
    with ttrain.full_f32(), torch.no_grad():
        attn = ttrain.generator_forward(
            model, cfg, state.params, ref_lib.t_batch(reference["batch"]),
            noise=noise,
        )["attn"].numpy()

    def grads(leaves):
        return ref_lib.flat(to_jax_layout(
            ref_lib.unflat({name: t.grad for name, t in leaves})
        ))

    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        attn=attn,
        grads_g=grads(state.g_leaves),
        grads_d=grads(state.d_leaves),
    )


def test_generator_forward_losses_match(reference, port_step):
    for name in METRICS:
        np.testing.assert_allclose(
            port_step["metrics"][name], float(reference["metrics"][name]),
            rtol=LOSS_RTOL, err_msg=name,
        )


@pytest.mark.parametrize("which", ["grads_g", "grads_d"])
def test_every_gradient_matches(reference, port_step, which):
    bad = ref_lib.gradient_errors(reference[which], port_step[which],
                                  GRAD_REL_L2)
    assert not bad, bad


def test_mas_on_the_step_scores_is_bit_equal(reference, port_step):
    """The port's MAS on the reference step's own scores gives the
    reference step's alignment bit for bit, and so does the port's
    generator forward."""
    b = reference["batch"]
    want = reference["metrics"]["attn"]
    got = t_mas(torch.from_numpy(reference["neg_x_ent"].copy()),
                torch.from_numpy(b["text_lengths"]),
                torch.from_numpy(b["spec_lengths"])).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        j_mas(jnp.asarray(reference["neg_x_ent"]),
              jnp.asarray(b["text_lengths"]), jnp.asarray(b["spec_lengths"])),
        want,
    )
    np.testing.assert_array_equal(port_step["attn"], want)


def test_port_init_has_the_reference_structure(reference):
    """The port's own training init (the card's machine has no JAX) has
    the reference's key names and shapes: generator, enc_q and
    discriminators."""
    params, disc = ttrain.init_training_params(0, ref_lib.config(port=True))
    for got, want in ((params, reference["params0"]),
                      (disc, reference["disc0"])):
        got, want = ref_lib.flat(got), ref_lib.flat(want)
        assert {k: v.shape for k, v in got.items()} == {
            k: v.shape for k, v in want.items()
        }
