"""The port's train step against the reference's on the model variants the
tiny config does not cover, on the CPU: several speakers (``emb_g``,
``speaker_ids``), the deterministic duration predictor (``use_sdp:
false``) and the MB-iSTFT decoder (``decoder_type: "mb-istft"``).

Each variant runs ``test_torch_port_train_step.py``'s one-step parity
from one initial state on both sides, the port's own init carried to the
reference (``tests/torch_train_reference.py::port_initial_state``: the
reference's jitted init costs about 100 s a variant here, and the port's
init has the reference's structure, ``test_torch_port_train_step.py``),
with the reference's key splits injected into the port, a zero learning
rate, and the same bars: losses within ``rtol=1e-3``; every G and D
gradient within relative L2 1e-3, with the same tensors without a
gradient.  The JAX step is jitted once per variant, in a module-scoped
fixture.
"""

import numpy as np
import pytest
import torch

import jax

import torch_train_reference as ref_lib
from mimic3_tpu_torch.models.vits import train as ttrain
from mimic3_tpu_torch.runtime.convert import to_jax_layout

LOSS_RTOL = 1e-3
GRAD_REL_L2 = 1e-3
METRICS = ("loss_g", "loss_mel", "loss_kl", "loss_dur", "loss_adv",
           "loss_fm", "loss_d")
# (model fields, speakers in the batch)
VARIANTS = {
    "multispeaker": (dict(n_speakers=4, gin_channels=16), 4),
    "no_sdp": (dict(use_sdp=False), 1),
    "mb_istft": (dict(decoder_type="mb-istft"), 1),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_gradients(leaves):
    """{dotted name: gradient} of a port tree, in the JAX layout."""
    return ref_lib.flat(to_jax_layout(
        ref_lib.unflat({name: t.grad for name, t in leaves})
    ))


@pytest.fixture(scope="module", params=list(VARIANTS))
def step(request):
    """The reference's and the port's first step on one variant."""
    model, n_speakers = VARIANTS[request.param]
    tcfg = ref_lib.config(port=True, model=model, learning_rate=0.0)
    state0 = ref_lib.port_initial_state(tcfg)
    b = ref_lib.batch_arrays(n_speakers=n_speakers)
    rng = jax.random.PRNGKey(1)
    metrics, grads_g, grads_d = ref_lib.reference_step(
        ref_lib.config(model=model), state0, b, rng
    )
    state = ttrain.init_train_state(
        ref_lib.carry(state0.params), ref_lib.carry(state0.disc_params), tcfg
    )
    noise = ref_lib.reference_noise(rng, b, tcfg)
    state, port_metrics = ttrain.make_train_step(tcfg)(
        state, ref_lib.t_batch(b), noise=noise
    )
    return dict(
        metrics=metrics,
        port_metrics={k: float(v) for k, v in port_metrics.items()},
        grads_g=(ref_lib.flat(grads_g), port_gradients(state.g_leaves)),
        grads_d=(ref_lib.flat(grads_d), port_gradients(state.d_leaves)),
        has_emb_g="emb_g" in state.params,
    )


def test_variant_losses_match(step):
    for name in METRICS:
        np.testing.assert_allclose(
            step["port_metrics"][name], float(step["metrics"][name]),
            rtol=LOSS_RTOL, err_msg=name,
        )


@pytest.mark.parametrize("which", ["grads_g", "grads_d"])
def test_variant_gradients_match(step, which):
    want, got = step[which]
    bad = ref_lib.gradient_errors(want, got, GRAD_REL_L2)
    assert not bad, bad


def test_multispeaker_trains_the_speaker_table(step, request):
    """Only the multi-speaker variant has ``emb_g``, and its gradient is
    held above with the rest."""
    variant = request.node.callspec.params["step"]
    assert step["has_emb_g"] == (variant == "multispeaker")
    if step["has_emb_g"]:
        assert step["grads_g"][1]["emb_g.weight"].any()
