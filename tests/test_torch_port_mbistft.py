"""The port's MB-iSTFT decoder family against the JAX package's.

The same seeded numpy inputs through ``mimic3_tpu.ops.istft`` /
``mimic3_tpu.models.vits.mbistft`` and their port copies, within
``atol=2e-4, rtol=1e-3``; then a tiny MB-iSTFT voice end to end
(deterministic: equal durations, correlation >= 0.999), through the
engine and the CLI, and streamed against the JAX session's stream.
"""

import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.models.vits import VitsModel as RefModel
from mimic3_tpu.models.vits.mbistft import (
    mb_istft_generator as ref_generator,
)
from mimic3_tpu.ops import istft as ref_ops
from mimic3_tpu.runtime.convert import load_pytree_npz, unflatten_pytree
from mimic3_tpu.runtime.session import VitsSession
from mimic3_tpu_torch.models.vits.mbistft import (
    mb_istft_generator as port_generator,
)
from mimic3_tpu_torch.models.vits.model import VitsModel as PortModel
from mimic3_tpu_torch.ops import istft as port_ops
from mimic3_tpu_torch.runtime.convert import flatten_pytree, to_torch_params
from mimic3_tpu_torch.runtime.session import TorchVitsSession
from mimic3_tpu_torch.runtime.testvoice import create_test_voice

TOL = dict(atol=2e-4, rtol=1e-3)
IDS = [1, 4, 7, 12, 5, 30, 9, 2, 17, 22, 3, 14, 8, 11, 6, 25, 19, 2]
DET = dict(noise_scale=0.0, noise_w=0.0)
GRID = dict(chunk_frames=16, overlap=48, first_chunk_frames=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_fft,hop,frames", [(16, 4, 37), (32, 8, 5)])
def test_istft_matches_reference(n_fft, hop, frames):
    rng = np.random.RandomState(n_fft)
    nb = n_fft // 2 + 1
    real, imag = (rng.randn(3, frames, nb).astype(np.float32) for _ in "ri")
    want = np.asarray(
        ref_ops.istft(jnp.asarray(real), jnp.asarray(imag), n_fft, hop)
    )
    got = port_ops.istft(
        torch.from_numpy(real), torch.from_numpy(imag), n_fft, hop
    ).numpy()
    assert got.shape == want.shape == (3, frames * hop)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [1, 50, 257])
def test_pqmf_synthesis_matches_reference(t):
    bands = np.random.RandomState(t).randn(2, t, 4).astype(np.float32)
    want = np.asarray(ref_ops.pqmf_synthesis(jnp.asarray(bands), 4))
    got = port_ops.pqmf_synthesis(torch.from_numpy(bands), 4).numpy()
    assert got.shape == want.shape == (2, t * 4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [64, 203, 4096])
def test_pqmf_analysis_matches_reference(t):
    audio = np.random.RandomState(t).randn(2, t).astype(np.float32)
    want = np.asarray(ref_ops.pqmf_analysis(jnp.asarray(audio), 4))
    got = port_ops.pqmf_analysis(torch.from_numpy(audio), 4).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_pqmf_round_trip_reconstructs():
    """The reference's near-perfect-reconstruction check on the port."""
    sig = np.random.RandomState(1).randn(1, 4096).astype(np.float32)
    rec = port_ops.pqmf_synthesis(
        port_ops.pqmf_analysis(torch.from_numpy(sig), 4), 4
    ).numpy()
    a, b = sig[0, :3800], rec[0, :3800]
    assert 10 * np.log10(np.mean(a**2) / np.mean((a - b) ** 2)) > 35.0


def _decoder_params(gin: int, rng) -> dict:
    """A tiny MB-iSTFT decoder in the JAX layout, with a conv_post that
    spreads the log-magnitudes over the clip range."""
    from mimic3_tpu_torch.config import ModelConfig
    from mimic3_tpu_torch.models.vits.model import init_params

    cfg = ModelConfig(
        num_symbols=10, hidden_channels=16, inter_channels=16,
        filter_channels=32, n_layers=1, upsample_initial_channel=32,
        decoder_type="mb-istft", n_speakers=2 if gin else 1,
        gin_channels=gin,
    )
    flat = {
        k[4:]: np.asarray(v)
        for k, v in flatten_pytree(init_params(5, cfg)).items()
        if k.startswith("dec.")
    }
    w = flat["conv_post.weight"]
    flat["conv_post.weight"] = (rng.randn(*w.shape) * 0.3).astype(np.float32)
    flat["conv_post.bias"] = (
        rng.randn(*flat["conv_post.bias"].shape).astype(np.float32)
    )
    return unflatten_pytree(flat)


@pytest.mark.parametrize("gin", [0, 8], ids=["no_g", "g"])
def test_mb_istft_generator_matches_reference(gin):
    rng = np.random.RandomState(gin + 1)
    dec = _decoder_params(gin, rng)
    z = rng.randn(2, 16, 9).astype(np.float32)  # [B, inter, frames]
    g = rng.randn(2, gin, 1).astype(np.float32) if gin else None
    want = np.asarray(
        ref_generator(
            jax.tree_util.tree_map(jnp.asarray, dec),
            jnp.asarray(z.transpose(0, 2, 1)),
            g=None if g is None else jnp.asarray(g.transpose(0, 2, 1)),
        )
    )
    got = port_generator(
        to_torch_params(dec), torch.from_numpy(z),
        g=None if g is None else torch.from_numpy(g),
    ).numpy()
    assert got.shape == want.shape == (2, 9 * 256)
    assert np.abs(want).max() > 0.05  # the head is not near silent
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# a tiny MB-iSTFT voice end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[1, 3], ids=["single", "multi"])
def voice(request, tmp_path_factory):
    """(voice dir, config, params): a tiny MB-iSTFT test voice whose
    durations vary and whose flow acts (the weights of the slice test)."""
    d = create_test_voice(
        tmp_path_factory.mktemp("mb") / "en_US" / "mb_low",
        n_speakers=request.param, full_size=False, decoder_type="mb-istft",
    )
    config = TrainingConfig.load_path(d / "config.json")
    params = load_pytree_npz(d / "generator.npz")
    rng = np.random.RandomState(request.param)
    flows = params["dp"]["flows"]
    flows["0"]["m"] = np.array([-1.4, 0.0], np.float32)
    for i in ("1", "3", "5", "7"):
        w = flows[i]["proj"]["weight"]
        flows[i]["proj"]["weight"] = (rng.randn(*w.shape) * 0.3).astype(
            np.float32
        )
    for i in ("0", "2", "4", "6"):
        post = params["flow"]["flows"][i]["post"]
        post["weight"] = (rng.randn(*post["weight"].shape) * 0.1).astype(
            np.float32
        )
    post = params["dec"]["conv_post"]
    post["weight"] = (rng.randn(*post["weight"].shape) * 0.3).astype(
        np.float32
    )
    return d, config, params, request.param


def test_to_torch_params_round_trips(voice):
    """Every MB-iSTFT tensor reaches the port in torch layout: convs
    [Cout, Cin, K], the transposed ``ups`` [Cin, Cout, K], weight norm
    folded; and back again to the JAX layout."""
    _, _, params, _ = voice
    port = flatten_pytree(to_torch_params(params))
    flat = flatten_pytree(params)
    assert not any(k.endswith(("weight_g", "weight_v")) for k in port)
    for name, got in port.items():
        if name in flat:
            want = flat[name]
        else:  # folded weight norm
            base = name[: -len(".weight")]
            v, g = flat[base + ".weight_v"], flat[base + ".weight_g"]
            want = g * v / np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
        if got.ndim == 3 and name.endswith(".weight"):
            back = got.transpose(2, 0, 1) if ".ups." in name else (
                got.transpose(2, 1, 0)
            )
        else:
            back = got
        np.testing.assert_allclose(back, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    assert port["dec.conv_post.weight"].shape == (18 * 4, 32, 7)


def test_model_matches_reference_infer(voice):
    """``VitsModel.infer`` with a frame capacity, deterministic: equal
    durations (sample lengths) and correlation >= 0.999."""
    _, config, params, n_speakers = voice
    ref = RefModel(config.model, decoder_dtype=jnp.float32)
    port = PortModel(config.model, decoder_dtype=torch.float32)
    assert port.hp.hop_length == ref.hp.hop_length == 256
    assert port.pack_decoder(to_torch_params(params["dec"]), "cpu") == {}
    sid = [2] if n_speakers > 1 else None
    infer = jax.jit(ref.infer, static_argnums=(7,))
    want, want_n = infer(
        jax.tree_util.tree_map(jnp.asarray, params),
        jnp.asarray([IDS], jnp.int32), jnp.asarray([len(IDS)], jnp.int32),
        jax.random.PRNGKey(0), jnp.float32(0.0), jnp.float32(1.0),
        jnp.float32(0.0), 256,
        None if sid is None else jnp.asarray(sid, jnp.int32),
    )
    got, got_n = port.infer(
        to_torch_params(params), torch.tensor([IDS]),
        torch.tensor([len(IDS)]), 0, 0.0, 1.0, 0.0, 256,
        sid=None if sid is None else torch.tensor(sid),
    )
    n = int(want_n[0])
    assert int(got_n[0]) == n and 256 * len(IDS) < n < 256 * 256
    a, b = got[0, :n].numpy(), np.asarray(want)[0, :n]
    assert np.isfinite(a).all()
    assert np.corrcoef(a, b)[0, 1] >= 0.999


def test_chunked_stream_matches_jax_session(voice):
    """``synthesize_ids_chunked`` on an MB-iSTFT voice: the JAX session's
    chunk sizes and correlation >= 0.999, and the stream agrees with the
    port's unchunked output."""
    _, config, params, n_speakers = voice
    sid = 1 if n_speakers > 1 else None
    ref = VitsSession(config, params, deterministic=True)
    port = TorchVitsSession(config, params, deterministic=True, device="cpu")
    want = list(ref.synthesize_ids_chunked(IDS, speaker_id=sid, **DET, **GRID))
    got = list(port.synthesize_ids_chunked(IDS, speaker_id=sid, **DET, **GRID))
    assert [c.size for c in got] == [c.size for c in want]
    assert len(got) >= 3
    got, want = np.concatenate(got), np.concatenate(want)
    assert np.corrcoef(got, want)[0, 1] >= 0.999
    full = port.synthesize_ids(IDS, speaker_id=sid, **DET)
    assert full.size == got.size
    assert np.corrcoef(full, got)[0, 1] >= 0.999


def test_engine_and_cli_synthesize(voice, tmp_path):
    from mimic3_tpu_torch import cli
    from mimic3_tpu_torch.engine import (
        Mimic3Settings,
        Mimic3TextToSpeechSystem,
    )

    voice_dir, _, _, n_speakers = voice
    root = str(voice_dir.parents[1])
    tts = Mimic3TextToSpeechSystem(
        Mimic3Settings(voices_directories=[root]), device="cpu"
    )
    tts.voice = "en_US/mb_low"
    wav = tts.text_to_wav("A rainbow is a meteorological phenomenon.")
    assert len(wav) > 1000
    out = tmp_path / "out"
    rc = cli.main([
        "--voices-dir", root, "--voice", "en_US/mb_low", "--device", "cpu",
        "--deterministic", "--output-dir", str(out), "Hello world.",
    ])
    assert rc == 0
    with wave.open(str(out / "Hello_world.wav")) as f:
        assert f.getframerate() == 22050 and f.getnframes() > 0
        audio = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    assert np.any(audio)
