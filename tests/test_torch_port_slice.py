"""The ported slice end to end against the JAX reference.

Deterministic mode (``noise_scale=0, noise_w=0``): the port's session and
``VitsSession`` get the same voice and phoneme ids; integer durations must
be equal and the waveforms must correlate >= 0.999.  The voice is written
by the port's testvoice, so the reference loading it also checks that
layout.  Also: batching is transparent, the noise contract holds, and the
port runs with JAX blocked.
"""

import copy
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime.convert import load_pytree_npz
from mimic3_tpu.runtime.session import VitsSession
from mimic3_tpu_torch.runtime.testvoice import create_test_voice
from mimic3_tpu_torch.runtime.session import TorchVitsSession

REPO = Path(__file__).resolve().parents[1]
IDS = [1, 4, 7, 12, 5, 30, 9, 2, 17, 22, 3, 14, 8, 11, 6, 25, 19, 2]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and in
    a parallel test run (a process per core) more oversubscribe the CPU
    and slow every op by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[1, 3], ids=["single", "multi"])
def sessions(request, tmp_path_factory):
    voice = create_test_voice(
        tmp_path_factory.mktemp("voice") / "v",
        n_speakers=request.param,
        full_size=False,
    )
    config = TrainingConfig.load_path(voice / "config.json")
    params = load_pytree_npz(voice / "generator.npz")
    # A fresh voice's zero-initialized flow projections make every
    # duration exactly 1 and the latent flow the identity; give them
    # weights so durations vary (about 2-9 frames) and the flow acts.
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
    ref = VitsSession(config, params, deterministic=True)
    port = TorchVitsSession(config, params, deterministic=True, device="cpu")
    return ref, port, request.param, config, params


def _jax_w(ref: VitsSession, ids, sid):
    """The reference's durations before the ceil, and after it."""
    model = ref.model
    ids_j = jnp.asarray([ids], jnp.int32)
    lengths = jnp.asarray([len(ids)], jnp.int32)
    sid_j = jnp.asarray([sid], jnp.int32) if sid is not None else None
    from mimic3_tpu.models.vits.layers import sequence_mask

    x_mask = sequence_mask(lengths, len(ids))
    g = model.speaker_embedding(ref.params, sid_j) if sid is not None else None
    x, _, _ = model.encode(ref.params, ids_j, x_mask)
    logw = model.log_durations(
        ref.params, x, x_mask, jax.random.PRNGKey(0), jnp.float32(0.0), g
    )
    w = np.asarray(jnp.exp(logw) * x_mask)[0, :, 0]
    return w, np.ceil(w).astype(np.int32)


def test_deterministic_session_matches_reference(sessions):
    ref, port, n_speakers, _, _ = sessions
    sid = 2 if n_speakers > 1 else None
    kw = dict(speaker_id=sid, noise_scale=0.0, noise_w=0.0)

    w, dur_ref = _jax_w(ref, IDS, sid)
    assert len(set(dur_ref.tolist())) > 2, dur_ref
    ids_t = torch.tensor([IDS])
    lengths_t = torch.tensor([len(IDS)])
    sid_t = torch.tensor([sid]) if sid is not None else None
    dur_port, _ = port.model.infer_durations(
        port.params, ids_t, lengths_t, 0, 1.0, 0.0, sid=sid_t
    )
    near = np.abs(w - np.round(w)) < 1e-4
    if near.any():
        # a last-ulp difference could move a frame count: decode the
        # reference's durations on both sides instead
        warnings.warn(
            f"ceil within 1e-4 of an integer at {np.flatnonzero(near)}; "
            "injecting the reference durations into the port"
        )
        dur_port = torch.from_numpy(dur_ref[None])
        audio, n = port.model.decode_frames(
            port.params, ids_t, lengths_t, dur_port, 128, 0, 0.0, sid=sid_t
        )
        got = audio[0, : int(n[0])].numpy()
    else:
        np.testing.assert_array_equal(dur_port[0].numpy(), dur_ref)
        got = port.synthesize_ids(IDS, **kw)

    want = ref.synthesize_ids(IDS, **kw)
    assert got.shape == want.shape == (int(dur_ref.sum()) * 256,)
    assert np.isfinite(got).all()
    corr = np.corrcoef(got, want)[0, 1]
    assert corr >= 0.999, corr


def test_infer_with_frame_capacity_matches_reference(sessions):
    """``VitsModel.infer``: one call with a fixed frame capacity that cuts
    the utterance (the cumulative-duration clamp)."""
    ref, port, n_speakers, _, _ = sessions
    sid = [1] if n_speakers > 1 else None
    want, want_n = ref.model.infer(
        ref.params, jnp.asarray([IDS], jnp.int32),
        jnp.asarray([len(IDS)], jnp.int32), jax.random.PRNGKey(0),
        jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0), 20,
        sid=None if sid is None else jnp.asarray(sid, jnp.int32),
    )
    got, got_n = port.model.infer(
        port.params, torch.tensor([IDS]), torch.tensor([len(IDS)]), 0,
        0.0, 1.0, 0.0, 20, sid=None if sid is None else torch.tensor(sid),
    )
    assert int(got_n[0]) == int(want_n[0]) == 20 * 256
    assert np.corrcoef(got[0].numpy(), np.asarray(want)[0])[0, 1] >= 0.999


def test_frame_cap_truncation_matches_reference(sessions):
    """Outputs past the largest frame bucket are cut there, durations
    clamped, on both sides."""
    _, _, n_speakers, config, params = sessions
    config = copy.deepcopy(config)
    config.tpu.frame_buckets = (8, 16)
    ref = VitsSession(config, params, deterministic=True)
    port = TorchVitsSession(config, params, deterministic=True, device="cpu")
    kw = dict(
        speaker_id=1 if n_speakers > 1 else None, noise_scale=0.0, noise_w=0.0
    )
    want = ref.synthesize_ids(IDS, **kw)
    got = port.synthesize_ids(IDS, **kw)
    assert got.shape == want.shape == (16 * 256,)
    assert np.corrcoef(got, want)[0, 1] >= 0.999


def test_batch_equals_rows_alone(sessions):
    _, port, n_speakers, _, _ = sessions
    seqs = [IDS, IDS[:7], IDS[3:] + IDS[:5]]
    sids = [0, 2, 1] if n_speakers > 1 else None
    for kw in (
        dict(noise_scale=0.0, noise_w=0.0),
        dict(noise_scale=0.667, noise_w=0.8, seed=7),
    ):
        batch = port.synthesize_ids_batch(seqs, speaker_ids=sids, **kw)
        assert len(batch) == 3
        for i, seq in enumerate(seqs):
            alone = port.synthesize_ids(
                seq, speaker_id=None if sids is None else sids[i], **kw
            )
            assert batch[i].shape == alone.shape
            np.testing.assert_allclose(batch[i], alone, atol=1e-5)


def test_noise_is_invariant_to_slot_bucket_and_offset(sessions):
    """For a fixed seed, the port's SDP and prior noise do not depend on
    the batch slot, the text or frame bucket, or the frame offset."""
    _, port, _, _, _ = sessions
    model, params = port.model, port.params
    n = len(IDS)
    durs = []
    for t_bucket in (32, 64):
        ids = torch.zeros(2, t_bucket, dtype=torch.long)
        ids[:, :n] = torch.tensor(IDS)
        lengths = torch.tensor([n, n])
        d, _ = model.infer_durations(params, ids, lengths, 5, 1.0, 0.8)
        assert torch.equal(d[0, :n], d[1, :n])  # batch slot
        durs.append(d[:1, :n])
    assert torch.equal(durs[0], durs[1])  # text bucket

    ids = torch.tensor([IDS, IDS])
    lengths = torch.tensor([n, n])
    dur = durs[0].repeat(2, 1)
    total = int(dur[0].sum())
    small, _ = model.decode_frames(params, ids, lengths, dur, total, 5, 0.667)
    big, _ = model.decode_frames(params, ids, lengths, dur, total + 50, 5, 0.667)
    # the decoder's zero padding past the bucket's end reaches back about
    # three frames (conv_pre sees bias-only frames in the bigger bucket)
    valid = (total - 4) * 256
    np.testing.assert_allclose(small[0], small[1], atol=1e-6)  # batch slot
    np.testing.assert_allclose(
        small[0, :valid], big[0, :valid], atol=1e-5
    )  # frame bucket

    # frame offset: the window [16, 16+64) sees the same latent noise
    from mimic3_tpu_torch.models.vits.model import indexed_noise

    full = indexed_noise(5, 1, 0, 128, 64)
    np.testing.assert_array_equal(
        indexed_noise(5, 1, 16, 64, 64).numpy(), full[16:80].numpy()
    )


def test_port_runs_with_jax_blocked(tmp_path):
    """Engine, CLI and test voice of the port import and synthesize with
    ``sys.modules['jax'] = None`` and ``sys.modules['mimic3_tpu'] =
    None``: the port needs neither JAX nor the JAX package."""
    code = textwrap.dedent(
        f"""
        import sys, wave
        sys.modules["jax"] = None
        sys.modules["mimic3_tpu"] = None
        import mimic3_tpu_torch, mimic3_tpu_torch.cli
        from mimic3_tpu_torch.engine import (
            Mimic3Settings, Mimic3TextToSpeechSystem,
        )
        from mimic3_tpu_torch.runtime.testvoice import create_test_voice

        root = {str(tmp_path)!r}
        create_test_voice(root + "/en_US/tiny_low", full_size=False)
        tts = Mimic3TextToSpeechSystem(
            Mimic3Settings(voices_directories=[root]), device="cpu"
        )
        tts.voice = "en_US/tiny_low"
        wav = tts.text_to_wav("A rainbow is a meteorological phenomenon.")
        assert len(wav) > 1000
        rc = mimic3_tpu_torch.cli.main([
            "--voices-dir", root, "--voice", "en_US/tiny_low", "--device",
            "cpu", "--deterministic", "--output-dir", root + "/out",
            "Hello world.",
        ])
        assert rc == 0
        with wave.open(root + "/out/Hello_world.wav") as f:
            assert f.getframerate() == 22050 and f.getnframes() > 0
        assert not any(
            m.split(".")[0] in ("jax", "mimic3_tpu") for m in sys.modules
            if sys.modules[m] is not None
        )
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_port_source_never_imports_jax():
    import re

    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    files = sorted((REPO / "mimic3_tpu_torch").rglob("*.py"))
    assert files
    for path in files:
        assert not pattern.search(path.read_text()), path
    assert not pattern.search((REPO / "chip_smoke.py").read_text())
