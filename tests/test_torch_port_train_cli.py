"""The port's dataset pipeline, ``mimic3-torch-train`` and its export, on
the CPU, against the JAX package (tiny synthetic voice and data, as
tests/test_dataset_train_cli.py).

- The port's ``batches`` yields the reference's arrays for one seed,
  the partial batch topped up to full.
- ``mimic3-torch-train --device cpu`` runs 2 steps, then ``--resume``
  for 1 more; ``--export`` writes a ``generator.npz`` that loads in the
  JAX package and in the port, and deterministic synthesis from it
  correlates >= 0.999 between them.
- ``merge_pretrained`` keeps ``weight_v``/``weight_g`` and
  ``g * v / ||v||`` equals the folded weight (the counterpart of
  tests/test_training.py::test_finetune_overlay_from_folded_weights).
- A run with ``jax``, ``optax``, ``orbax``, ``flax`` and ``mimic3_tpu``
  blocked trains and exports.
"""

import json
import os
import subprocess
import sys
import textwrap
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
# torch.optim imports torch._dynamo at its first optimizer, and that
# import looks up every module it knows with importlib; other test files
# put an ``onnx`` stub without a spec into sys.modules, which makes the
# lookup raise.  Importing it here, at collection, comes first.
import torch._dynamo  # noqa: F401

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.runtime import dataset as jdataset
from mimic3_tpu_torch import train_cli
from mimic3_tpu_torch.runtime import dataset as tdataset
from mimic3_tpu_torch.runtime.testvoice import create_test_voice

REPO = Path(__file__).resolve().parents[1]
TEXTS = ["hello world", "good morning", "testing one two"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_wav(path: Path, samples: np.ndarray, rate: int = 22050):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((samples * 20000).astype(np.int16).tobytes())


def make_dataset(root: Path):
    """A tiny port test voice (segment 2048, batch 2) and three WAVs."""
    voice_dir = create_test_voice(root / "voice", full_size=False)
    cfg = TrainingConfig.load_path(voice_dir / "config.json")
    cfg.segment_size = 2048
    cfg.batch_size = 2
    with open(voice_dir / "config.json", "w") as f:
        cfg.save(f)
    audio_dir = root / "wavs"
    audio_dir.mkdir()
    rng = np.random.RandomState(0)
    rows = []
    for i, text in enumerate(TEXTS):
        _write_wav(audio_dir / f"utt{i}.wav",
                   rng.randn(22050 // 4 + i * 1000) * 0.05)
        rows.append(f"utt{i}|{text}")
    (root / "metadata.csv").write_text("\n".join(rows) + "\n")
    return voice_dir, audio_dir, root / "metadata.csv"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("train_data"))


@pytest.mark.parametrize("batch_size,text_buckets,frame_buckets", [
    (2, (32, 64), (16, 32, 64)),
    (8, (32,), (64,)),  # 3 utterances: the batch is topped up to full
])
def test_batches_equal_the_reference(dataset, batch_size, text_buckets,
                                     frame_buckets):
    voice_dir, audio_dir, metadata = dataset
    streams = []
    for mod in (jdataset, tdataset):
        utts = mod.load_metadata(metadata, audio_dir,
                                 mod.make_frontend(voice_dir))
        config = mod.TrainingConfig.load_path(voice_dir / "config.json")
        streams.append((utts, mod.batches(
            utts, config, batch_size, seed=3, text_buckets=text_buckets,
            frame_buckets=frame_buckets,
        )))
    (ref_utts, ref_it), (utts, it) = streams
    assert [(u.utt_id, u.phoneme_ids) for u in utts] == [
        (u.utt_id, u.phoneme_ids) for u in ref_utts
    ]
    for _ in range(4):
        want, got = next(ref_it), next(it)
        for field in ("phoneme_ids", "text_lengths", "audio",
                      "spec_lengths"):
            np.testing.assert_array_equal(
                getattr(got, field).numpy(), np.asarray(getattr(want, field))
            )
        assert got.phoneme_ids.shape[0] == batch_size
        assert got.speaker_ids is None and want.speaker_ids is None


def _run(argv, capsys):
    assert train_cli.main([str(a) for a in argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_resume_and_export(dataset, tmp_path, capsys):
    """2 steps, then --resume for 1 more and --export; the exported
    voice synthesizes the same audio in the JAX package and the port."""
    voice_dir, audio_dir, metadata = dataset
    ckpt = tmp_path / "ckpt"
    common = [voice_dir, "--metadata", metadata, "--audio-dir", audio_dir,
              "--batch-size", "2", "--checkpoint-dir", ckpt,
              "--checkpoint-every", "1000", "--log-every", "1",
              "--device", "cpu"]
    out = _run(common + ["--steps", "2"], capsys)
    assert out == {"steps": 2, "final_step": 2}
    assert (ckpt / "2" / train_cli.CHECKPOINT_FILE).is_file()

    state = train_cli.load_checkpoint(
        ckpt / "2", train_cli_config(voice_dir), torch.device("cpu")
    )
    assert state.step == 2
    assert all(s["step"] == 2 for s in state.opt_g.state.values())

    out = _run(common + ["--steps", "1", "--resume", "--export"], capsys)
    assert out == {"steps": 1, "final_step": 3}
    assert (ckpt / "3" / train_cli.CHECKPOINT_FILE).is_file()
    resumed = train_cli.load_checkpoint(
        ckpt / "3", train_cli_config(voice_dir), torch.device("cpu")
    )
    assert all(s["step"] == 3 for s in resumed.opt_d.state.values())

    # the export: inference weights in the reference's layout
    from mimic3_tpu_torch.runtime.convert import (
        flatten_pytree,
        load_pytree_npz,
    )

    flat = flatten_pytree(load_pytree_npz(voice_dir / "generator.npz"))
    assert not any(k.startswith("enc_q") or k.endswith(("weight_v",
                                                        "weight_g"))
                   for k in flat)
    assert flat["dec.ups.0.weight"].shape == (16, 128, 64)  # [K, Cin, Cout]

    from mimic3_tpu.runtime.voice import TpuVoice
    from mimic3_tpu_torch.runtime.voice import load_from_directory

    ref_voice = TpuVoice.load_from_directory(voice_dir, deterministic=True)
    port_voice = load_from_directory(voice_dir, deterministic=True,
                                     device="cpu")
    ids = ref_voice.phonemes_to_ids([list("a rainbow")])
    assert port_voice.phonemes_to_ids([list("a rainbow")]) == ids
    want = ref_voice.ids_to_audio(ids, noise_scale=0, noise_w=0)
    got = port_voice.ids_to_audio(ids, noise_scale=0, noise_w=0)
    assert got.shape == want.shape and got.size > 0
    corr = np.corrcoef(got.astype(np.float64), want.astype(np.float64))[0, 1]
    assert corr >= 0.999, corr


def train_cli_config(voice_dir):
    from mimic3_tpu_torch.config import TrainingConfig as TTrainingConfig

    return TTrainingConfig.load_path(voice_dir / "config.json")


def test_merge_pretrained_keeps_weight_norm():
    """Fine-tuning from folded weights: the merged tree has the training
    tree's structure, and g * v / ||v|| reproduces each folded weight."""
    from mimic3_tpu_torch.config import ModelConfig
    from mimic3_tpu_torch.config import TrainingConfig as TTrainingConfig
    from mimic3_tpu_torch.models.vits import train as ttrain
    from mimic3_tpu_torch.models.vits.layers import conv_weight
    from mimic3_tpu_torch.runtime.convert import (
        flatten_pytree,
        to_torch_params,
        to_torch_train_params,
    )

    cfg = TTrainingConfig()
    cfg.model = ModelConfig(num_symbols=40, n_layers=1, hidden_channels=32,
                            inter_channels=32, filter_channels=64,
                            upsample_initial_channel=64)
    cfg.segment_size = 2048
    params, disc = ttrain.init_training_params(0, cfg)
    # an inference npz: the synthesis modules, weight norm folded
    folded = to_torch_params({k: params[k] for k in ("enc_p", "dp", "flow",
                                                     "dec")})
    from mimic3_tpu_torch.runtime.convert import to_jax_layout

    pretrained = to_jax_layout(folded)
    merged = train_cli.merge_pretrained(params, pretrained)
    shapes = {k: v.shape for k, v in flatten_pytree(merged).items()}
    assert shapes == {k: v.shape for k, v in flatten_pytree(params).items()}

    port = to_torch_train_params(merged)
    for path in (("dec", "ups", "0"), ("dec", "resblocks", "4", "convs1", "2"),
                 ("flow", "flows", "2", "enc", "in_layers", "1")):
        got, want = port, folded
        for key in path:
            got, want = got[key], want[key]
        out_dim = 1 if "ups" in path else 0
        torch.testing.assert_close(conv_weight(got, out_dim), want["weight"],
                                   atol=1e-6, rtol=1e-5)
    # and it trains
    state = ttrain.init_train_state(port, to_torch_train_params(disc), cfg)
    rng = np.random.RandomState(0)
    batch = ttrain.TrainBatch(
        torch.from_numpy(rng.randint(1, 40, (2, 6))),
        torch.tensor([6, 4]),
        torch.from_numpy((rng.randn(2, 4096) * 0.1).astype(np.float32)),
        torch.tensor([16, 12]),
    )
    _, metrics = ttrain.make_train_step(cfg)(
        state, batch, generator=torch.Generator().manual_seed(0)
    )
    assert all(torch.isfinite(v) for v in metrics.values())


def test_train_and_export_with_jax_blocked(tmp_path):
    """The trainer imports neither JAX nor optax, orbax, flax or the JAX
    package."""
    voice, wavs, metadata = make_dataset(tmp_path)
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("jax", "jaxlib", "optax", "orbax", "flax",
                     "mimic3_tpu"):
            sys.modules[name] = None
        from mimic3_tpu_torch import train_cli

        assert train_cli.main([
            {str(voice)!r}, "--metadata", {str(metadata)!r},
            "--audio-dir", {str(wavs)!r}, "--batch-size", "2",
            "--steps", "1", "--device", "cpu", "--export",
        ]) == 0
        assert not any(
            m.split(".")[0] in ("jax", "optax", "orbax", "flax",
                                "mimic3_tpu")
            for m in sys.modules if sys.modules[m] is not None
        )
        print("ok")
        """
    )
    before = (voice / "generator.npz").stat().st_mtime_ns
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=tmp_path,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert (voice / "generator.npz").stat().st_mtime_ns != before
