"""Port weight loading: JAX parameter pytree -> torch tensors.

Every tensor of a ``create_test_voice`` npz loads into the port in torch
layout, and the weight-norm fold matches ``layers.conv_weight``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mimic3_tpu.config import ModelConfig
from mimic3_tpu.models.vits import init_vits_params
from mimic3_tpu.models.vits.layers import conv_weight
from mimic3_tpu.runtime.convert import flatten_pytree, load_pytree_npz
from mimic3_tpu.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.models.vits.model import init_params
from mimic3_tpu_torch.runtime.convert import to_torch_params


def _expected(name: str, flat: dict) -> np.ndarray:
    """The torch-layout array the port should hold for ``name``."""
    if name.endswith(".weight_v"):
        base = name[: -len(".weight_v")]
        w = np.asarray(
            conv_weight(
                {
                    "weight_v": jnp.asarray(flat[base + ".weight_v"]),
                    "weight_g": jnp.asarray(flat[base + ".weight_g"]),
                }
            )
        )
        name = base + ".weight"
    else:
        w = flat[name]
    if name.endswith(".weight") and w.ndim == 3:
        if ".ups." in f".{name}":
            return name, w.transpose(1, 2, 0)  # [Cin, Cout, K]
        return name, w.transpose(2, 1, 0)  # [Cout, Cin, K]
    return name, w


def _lookup(tree: dict, name: str):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


@pytest.mark.parametrize("n_speakers", [1, 3])
def test_every_tensor_loads(tmp_path, n_speakers):
    voice = create_test_voice(
        tmp_path / "v", n_speakers=n_speakers, full_size=False
    )
    tree = load_pytree_npz(voice / "generator.npz")
    flat = flatten_pytree(tree)
    port = to_torch_params(tree)

    n_checked = 0
    for name in flat:
        if name.endswith(".weight_g"):
            continue  # folded with its weight_v
        port_name, want = _expected(name, flat)
        # C order: a strided weight costs every convolution a copy
        assert _lookup(port, port_name).is_contiguous(), port_name
        got = _lookup(port, port_name).numpy()
        assert got.shape == want.shape, port_name
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        n_checked += 1
    assert n_checked == len(flat) - sum(
        n.endswith(".weight_g") for n in flat
    )
    # weight norm really was present and folded
    assert any(n.endswith(".weight_v") for n in flat)
    assert "weight_v" not in port["dec"]["ups"]["0"]
    if n_speakers > 1:
        assert port["emb_g"]["weight"].shape == (n_speakers, 32)


@pytest.mark.parametrize(
    "use_sdp,n_speakers,decoder_type",
    [
        (True, 1, "hifigan"),
        (False, 2, "hifigan"),
        (True, 1, "mb-istft"),
        (False, 2, "mb-istft"),
    ],
    ids=["True-1", "False-2", "True-1-mb-istft", "False-2-mb-istft"],
)
def test_init_params_matches_reference_keys_and_shapes(
    use_sdp, n_speakers, decoder_type
):
    config = ModelConfig(
        decoder_type=decoder_type,
        num_symbols=40,
        n_speakers=n_speakers,
        hidden_channels=32,
        inter_channels=32,
        filter_channels=64,
        n_layers=2,
        upsample_initial_channel=64,
        use_sdp=use_sdp,
        gin_channels=16 if n_speakers > 1 else 0,
    )
    ref = flatten_pytree(
        jax.tree_util.tree_map(
            np.asarray, init_vits_params(jax.random.PRNGKey(0), config)
        )
    )
    got = flatten_pytree(init_params(0, config))
    assert sorted(got) == sorted(ref)
    for name, arr in ref.items():
        assert got[name].shape == arr.shape, name
