"""The port's main path in its default dtype against the JAX model.

A batch of two rows goes through ``TorchVitsSession.synthesize_ids_batch``
as the session serves by default (bf16 decoder; on the CPU the stage
kernel is off) and through ``mimic3_tpu``'s ``VitsModel``
(``infer_durations`` + ``decode_frames`` at the session's frame bucket,
bf16 decoder, Pallas stage off), both with ``noise_scale=0``, ``noise_w=0``: equal sample lengths
and correlation >= 0.999, for a HiFi-GAN voice, a multi-speaker HiFi-GAN
voice and an MB-iSTFT voice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.models.vits import VitsModel as RefModel
from mimic3_tpu.runtime.convert import load_pytree_npz
from mimic3_tpu_torch.runtime.session import TorchVitsSession, pick_bucket
from mimic3_tpu_torch.runtime.testvoice import create_test_voice

ROWS = [
    [1, 4, 7, 12, 5, 30, 9, 2, 17, 22, 3, 14, 8, 11, 6, 25, 19, 2],
    [3, 9, 27, 6, 14, 2, 21, 8, 5],
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[
    ("hifigan", 1), ("hifigan", 3), ("mb-istft", 1),
], ids=["hifigan", "hifigan-multispeaker", "mb-istft"])
def voice(request, tmp_path_factory):
    """(config, params, speaker ids) of a tiny test voice whose durations
    vary and whose flow and decoder act (the weights of
    tests/test_torch_port_mbistft.py)."""
    decoder, n_speakers = request.param
    d = create_test_voice(
        tmp_path_factory.mktemp("parity") / "v", n_speakers=n_speakers,
        full_size=False, decoder_type=decoder,
    )
    config = TrainingConfig.load_path(d / "config.json")
    params = load_pytree_npz(d / "generator.npz")
    rng = np.random.RandomState(n_speakers)
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
    # a waveform that varies: at the fresh voice's conv_post the audio
    # sits within 0.0005 of a constant, under a few bf16 steps
    post = params["dec"]["conv_post"]
    post["weight"] = (rng.randn(*post["weight"].shape) * 0.3).astype(
        np.float32
    )
    speakers = [2, 1] if n_speakers > 1 else None
    return config, params, speakers


def test_default_session_matches_jax_model(voice):
    config, params, speakers = voice
    session = TorchVitsSession(config, params, device="cpu")
    assert session.model.decoder_dtype == torch.bfloat16
    got = session.synthesize_ids_batch(
        ROWS, speaker_ids=speakers, noise_scale=0.0, noise_w=0.0
    )

    ref = RefModel(config.model, decoder_dtype=jnp.bfloat16,
                   pallas_stage_max_channels=0)
    ref_params = jax.tree_util.tree_map(jnp.asarray, params)
    ids = np.zeros((len(ROWS), max(map(len, ROWS))), np.int32)
    for i, row in enumerate(ROWS):
        ids[i, : len(row)] = row
    ids, lengths = jnp.asarray(ids), jnp.asarray([len(r) for r in ROWS])
    sid = None if speakers is None else jnp.asarray(speakers, jnp.int32)
    key = jax.random.PRNGKey(0)
    durations, totals = ref.infer_durations(
        ref_params, ids, lengths, key, 1.0, 0.0, sid=sid
    )
    # at the session's frame bucket: a row's last samples see the frames
    # past its end (on a multi-speaker voice, the speaker's bias)
    frames = pick_bucket(int(totals.max()), session.frame_buckets)
    want, want_len = ref.decode_frames(
        ref_params, ids, lengths, durations, frames, key, 0.0, sid=sid
    )
    want, want_len = np.asarray(want), np.asarray(want_len)

    assert [len(a) for a in got] == want_len.tolist()
    a = np.concatenate(got)
    b = np.concatenate([want[i, :n] for i, n in enumerate(want_len)])
    assert np.isfinite(a).all()
    assert np.corrcoef(a, b)[0, 1] >= 0.999
