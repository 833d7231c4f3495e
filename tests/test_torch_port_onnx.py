"""The port's ONNX import against the JAX package's converter.

Real ``torch.onnx.export`` runs of the tiny torch oracle (single speaker,
multispeaker with ``sid``, ``resblock: "2"``, ``use_sdp: False``; opset 17,
constant folding on, so weight-norm initializers are anonymized), the
fully anonymized legacy idiom, and files from the independent test
writer go through both packages' reader, name recovery and
``convert_voice_directory``.  Recovered names and live arrays must be
equal; parameters a traced inference graph omits are filled from each
package's own initializer, so those are compared by shape.  A voice
directory holding only ``generator.onnx``, ``config.json`` and
``phonemes.txt`` then loads through the port with JAX blocked and
synthesizes what the JAX package's voice synthesizes from the same files.
"""

import json
import logging
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import onnx_writer
import torch_oracle as oracle
from test_onnx_opset_matrix import _anonymize, _build, _export

from mimic3_tpu import config as ref_config
from mimic3_tpu.runtime import convert as ref_convert
from mimic3_tpu.runtime.onnx_reader import read_onnx_graph as ref_read
from mimic3_tpu.runtime.voice import TpuVoice
from mimic3_tpu_torch import config as port_config
from mimic3_tpu_torch.runtime import convert as port_convert
from mimic3_tpu_torch.runtime.onnx_reader import read_onnx_graph as port_read

REPO = Path(__file__).resolve().parents[1]
VARIANTS = ("base", "ms", "resblock2", "sdpfalse")
IDS = [1, 4, 7, 12, 5, 30, 9, 2, 17, 22, 3, 14, 8, 11, 6, 25, 19, 2]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_model_config(ref_model):
    """The same ModelConfig as the port's own dataclass."""
    return port_config.ModelConfig(**ref_model.__dict__)


def _voice_dir(path: Path, onnx_path: Path, model) -> Path:
    """A voice directory with generator.onnx, config.json, phonemes.txt."""
    path.mkdir(parents=True)
    shutil.copy(onnx_path, path / "generator.onnx")
    cfg = ref_config.TrainingConfig(model=model)
    cfg.phonemizer = ref_config.Phonemizer.SYMBOLS
    with open(path / "config.json", "w", encoding="utf-8") as f:
        cfg.save(f)
    with open(path / "phonemes.txt", "w", encoding="utf-8") as f:
        for i in range(model.num_symbols):
            f.write(f"{i} s{i}\n")
    return path


_BUILT: dict = {}


def _variant(name: str, tmp_path_factory) -> dict:
    """One export per variant and both converters' results on it, built
    once per module run."""
    if name not in _BUILT:
        _BUILT[name] = _build_variant(name, tmp_path_factory)
    return _BUILT[name]


@pytest.fixture(scope="module", params=VARIANTS)
def variant(request, tmp_path_factory):
    return _variant(request.param, tmp_path_factory)


def _build_variant(name: str, tmp_path_factory) -> dict:
    root = tmp_path_factory.mktemp(f"onnx_{name}")
    net, cfg = _build(name)
    path = root / "generator.onnx"
    _export(net, name, path, 17, True)
    ref_inits, ref_nodes = ref_read(path)
    ref_named = ref_convert.recover_initializer_names(
        ref_inits, ref_nodes, cfg, strict=True
    )
    ref_npz = ref_convert.convert_voice_directory(
        _voice_dir(root / "ref", path, cfg)
    )
    port_cfg = _port_model_config(cfg)
    port_inits, port_nodes = port_read(path)
    port_named = port_convert.recover_initializer_names(
        port_inits, port_nodes, port_cfg, strict=True
    )
    port_npz = port_convert.convert_voice_directory(
        _voice_dir(root / "port", path, cfg)
    )
    return dict(
        name=name, net=net, cfg=cfg, path=path, root=root,
        ref=(ref_inits, ref_nodes, ref_named, ref_npz),
        port=(port_inits, port_nodes, port_named, port_npz),
    )


def _assert_graphs_equal(ref, port):
    ref_inits, ref_nodes = ref
    port_inits, port_nodes = port
    assert list(port_inits) == list(ref_inits)
    for k, v in ref_inits.items():
        assert port_inits[k].dtype == v.dtype, k
        np.testing.assert_array_equal(port_inits[k], v, err_msg=k)
    assert len(port_nodes) == len(ref_nodes)
    for a, b in zip(port_nodes, ref_nodes):
        assert (a.op_type, a.name, a.inputs, a.outputs) == (
            b.op_type, b.name, b.inputs, b.outputs
        )


def _assert_named_equal(port_named, ref_named):
    assert sorted(port_named) == sorted(ref_named)
    for k, v in ref_named.items():
        np.testing.assert_array_equal(
            np.asarray(port_named[k]), np.asarray(v), err_msg=k
        )


def test_reader_matches_reference(variant):
    _assert_graphs_equal(variant["ref"][:2], variant["port"][:2])
    # the gap being closed is real: the export anonymized initializers
    assert sum(k.startswith("onnx::") for k in variant["port"][0]) > 10


def test_recovered_names_match_reference(variant):
    _assert_named_equal(variant["port"][2], variant["ref"][2])


def test_converted_npz_matches_reference(variant):
    """Live arrays equal, inference-dead arrays of the same shape."""
    ref = ref_convert.flatten_pytree(
        ref_convert.load_pytree_npz(variant["ref"][3])
    )
    port = port_convert.flatten_pytree(
        port_convert.load_pytree_npz(variant["port"][3])
    )
    assert sorted(port) == sorted(ref)
    dead = [k for k in ref if port_convert._is_dead_at_inference(k)]
    # the SDP's posterior branch and dropped flow; the deterministic
    # duration predictor has none
    assert bool(dead) == variant["cfg"].use_sdp
    for k, v in ref.items():
        assert port[k].shape == v.shape, k
        if k not in dead:
            np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_reader_matches_reference_on_writer_files(tmp_path):
    """Raw, packed and Constant-node tensors of the independent writer."""
    rng = np.random.RandomState(0)
    tensors = {
        "a.weight": rng.randn(3, 4, 5).astype(np.float32),
        "c.ids": np.arange(-3, 3, dtype=np.int64),
        "d.scalar": np.array(2.5, dtype=np.float32),
        "e.half": rng.randn(2, 2).astype(np.float16),
    }
    path = tmp_path / "raw.onnx"
    onnx_writer.write_onnx(str(path), tensors)
    _assert_graphs_equal(ref_read(path), port_read(path))
    path = tmp_path / "packed.onnx"
    onnx_writer.write_onnx(
        str(path),
        {"w": tensors["a.weight"], "n": tensors["c.ids"]},
        constants={"folded.weight": rng.randn(4).astype(np.float32)},
        use_raw=False,
    )
    _assert_graphs_equal(ref_read(path), port_read(path))
    bad = tmp_path / "bad.onnx"
    bad.write_bytes(b"not a protobuf at all")
    with pytest.raises(ValueError):
        port_read(bad)


def test_writer_state_dict_converts_like_reference(tmp_path):
    """Named (unanonymized) weight-norm pairs in torch layout, without a
    config: both converters give the same pytree."""
    torch.manual_seed(3)
    net = oracle.SynthesizerTrn(
        30, inter_channels=16, hidden=16, filter_channels=32, n_heads=2,
        n_layers=1, initial_channel=32, rates=(4, 4), up_kernels=(8, 8),
    )
    path = tmp_path / "generator.onnx"
    onnx_writer.write_onnx(str(path), oracle.state_dict_numpy(net))
    ref = ref_convert.flatten_pytree(ref_convert.onnx_to_pytree(path))
    port = port_convert.flatten_pytree(port_convert.onnx_to_pytree(path))
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)


@pytest.mark.parametrize("name,opset", [("base", 11), ("ms", 13)])
def test_fully_anonymized_recovery_matches_reference(name, opset, tmp_path):
    """Opaque tensor ids, bare node names, distinct values: shape, order
    and pattern matching assign the same tensors to the same names."""
    net, cfg = _build(name, distinct=True)
    path = tmp_path / "g.onnx"
    _export(net, name, path, opset, True)
    named = []
    for read, conv, mcfg in (
        (ref_read, ref_convert, cfg),
        (port_read, port_convert, _port_model_config(cfg)),
    ):
        inits, nodes = _anonymize(*read(path))
        named.append(
            conv.recover_initializer_names(inits, nodes, mcfg, strict=True)
        )
    _assert_named_equal(named[1], named[0])


def test_strict_mode_raises_like_reference(tmp_path_factory, caplog):
    """A config whose widths do not fit the export raises in strict mode
    and warns otherwise, in both packages."""
    variant = _variant("base", tmp_path_factory)
    wrong = ref_config.ModelConfig(
        **{**variant["cfg"].__dict__,
           "filter_channels": variant["cfg"].filter_channels * 2}
    )
    with pytest.raises(ref_convert.ConversionError):
        ref_convert.onnx_to_pytree(variant["path"], model_config=wrong)
    with pytest.raises(port_convert.ConversionError):
        port_convert.onnx_to_pytree(
            variant["path"], model_config=_port_model_config(wrong)
        )
    inits, nodes = port_read(variant["path"])
    with caplog.at_level(logging.WARNING):
        port_convert.recover_initializer_names(
            inits, nodes, _port_model_config(wrong), strict=False
        )
    assert any("could not be recovered" in r.message for r in caplog.records)


def _subprocess_env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")


def test_cli_prints_reference_counts(tmp_path_factory, capsys):
    """``python -m mimic3_tpu_torch.runtime.convert`` reports the tensors
    and parameters the reference CLI reports."""
    variant = _variant("ms", tmp_path_factory)
    ref_dir = variant["root"] / "ref"
    ref_convert.main([str(ref_dir), "--force"])
    want = json.loads(capsys.readouterr().out)
    port_dir = _voice_dir(
        variant["root"] / "port_cli", variant["path"], variant["cfg"]
    )
    proc = subprocess.run(
        [sys.executable, "-m", "mimic3_tpu_torch.runtime.convert",
         str(port_dir)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=_subprocess_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout)
    assert (port_dir / "generator.npz").is_file()
    assert got["npz"] == str(port_dir / "generator.npz")
    assert (got["tensors"], got["parameters"]) == (
        want["tensors"], want["parameters"]
    )


@pytest.mark.parametrize("name", ["base", "ms"])
def test_onnx_only_voice_loads_without_jax(name, tmp_path_factory):
    """generator.onnx + config.json + phonemes.txt, loaded by the port
    with JAX and the JAX package blocked: the npz is written beside the
    file, and the deterministic audio matches the JAX package's voice
    converted from the same files."""
    variant = _variant(name, tmp_path_factory)
    sid = 3 if variant["name"] == "ms" else None
    port_dir = _voice_dir(
        variant["root"] / "port_load", variant["path"], variant["cfg"]
    )
    out = variant["root"] / f"port_{variant['name']}.npy"
    code = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["mimic3_tpu"] = None
        import numpy as np
        from mimic3_tpu_torch.runtime.voice import load_from_directory

        voice = load_from_directory(
            {str(port_dir)!r}, deterministic=True, device="cpu"
        )
        audio = voice.session.synthesize_ids(
            {IDS!r}, speaker_id={sid!r}, noise_scale=0.0, noise_w=0.0
        )
        np.save({str(out)!r}, audio)
        assert not any(
            m.split(".")[0] in ("jax", "mimic3_tpu") for m in sys.modules
            if sys.modules[m] is not None
        )
        print("ok")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=variant["root"], env=_subprocess_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (port_dir / "generator.npz").is_file()
    got = np.load(out)

    ref_dir = _voice_dir(
        variant["root"] / "ref_load", variant["path"], variant["cfg"]
    )
    ref_voice = TpuVoice.load_from_directory(
        ref_dir, share_sessions=False, deterministic=True
    )
    want = ref_voice.session.synthesize_ids(
        IDS, speaker_id=sid, noise_scale=0.0, noise_w=0.0
    )
    assert got.shape == want.shape  # equal durations
    assert np.isfinite(got).all()
    assert np.corrcoef(got, want)[0, 1] >= 0.999


def test_read_only_directory_converts_in_memory(
    tmp_path_factory, monkeypatch
):
    """When the npz cannot be written, the voice converts in memory with
    its config (name recovery needs it) and writes nothing."""
    variant = _variant("sdpfalse", tmp_path_factory)
    from mimic3_tpu_torch.runtime.voice import _load_voice_params

    voice_dir = _voice_dir(
        variant["root"] / "read_only", variant["path"], variant["cfg"]
    )

    def refuse(path, tree):
        raise PermissionError(f"read-only: {path}")

    monkeypatch.setattr(port_convert, "save_pytree_npz", refuse)
    params = _load_voice_params(voice_dir)
    assert not (voice_dir / "generator.npz").exists()
    got = port_convert.flatten_pytree(params)
    want = port_convert.flatten_pytree(
        port_convert.load_pytree_npz(variant["port"][3])
    )
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
