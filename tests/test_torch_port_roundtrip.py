"""The port's teacher -> student round trip against the reference's.

``mimic3_tpu_torch/scripts/train_roundtrip.py`` is held to
``scripts/train_roundtrip.py``, imported by path as
``tests/test_train_roundtrip.py`` does: the texts and the tone teacher
bitwise, the mel correlation (the reference's mel computed with JAX on
the CPU) within 1e-5 and the default held-out baseline within 1e-4.  Then
the port's ``main`` runs end to end on the CPU at a tiny size: training
through ``mimic3-torch-train``, export, held-out synthesis and the
deterministic double-run through the CLI in separate processes, and a
resumed run that trains only the milestone beyond the last checkpoint.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
sys.path.insert(0, str(SCRIPTS))

import train_roundtrip as ref  # noqa: E402

from mimic3_tpu_torch.scripts import train_roundtrip as port  # noqa: E402

# the keys of the reference's result line (scripts/train_roundtrip.py)
RESULT_KEYS = {
    "steps", "decoder", "mean_corr", "min_corr", "curve",
    "baseline_cross_corr", "threshold", "passed", "deterministic_hash",
    "sha256_heldout0",
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: in a parallel test run more oversubscribe the
    CPU and slow the tiny ops by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_texts_equal_reference():
    assert port._texts(80) == ref._texts(80)


@pytest.mark.parametrize("text", ref._texts(5))
def test_tone_teacher_bitwise_equal(text):
    a, b = port.tone_teacher(text), ref.tone_teacher(text)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    assert port.tone_teacher_wav_bytes(text) == ref.tone_teacher_wav_bytes(
        text
    )


@pytest.mark.parametrize("seed", range(4))
def test_mel_correlation_matches_reference(seed):
    """Two teacher utterances of different lengths, the second with
    seeded noise: the trim must cut frames (the port's mel is
    ``[n_mels, frames]``, the reference's ``[frames, n_mels]``)."""
    rng = np.random.RandomState(seed)
    texts = ref._texts(8, seed=seed)
    a = ref.tone_teacher(texts[0])
    b = ref.tone_teacher(texts[1])
    b = (b + 0.05 * rng.randn(b.size)).astype(np.float32)
    assert abs(a.size - b.size) > 256  # lengths differ by frames
    got = port.mel_correlation(a, b)
    want = ref.mel_correlation(a, b)
    assert abs(got - want) <= 1e-5, (got, want)
    assert port.mel_of(a).shape == ref.mel_of(a).shape


def test_default_baseline_matches_reference():
    heldout = port._texts(80)[72:]

    def baseline(module):
        return float(np.mean([
            module.mel_correlation(
                module.tone_teacher(heldout[i]),
                module.tone_teacher(heldout[(i + 1) % len(heldout)]),
            )
            for i in range(len(heldout))
        ]))

    got, want = baseline(port), baseline(ref)
    assert abs(got - want) <= 1e-4, (got, want)


def test_no_device_named_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # raised before any work


def _result(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_roundtrip_end_to_end_on_cpu_with_resume(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the CLI subprocesses
    args = [
        "--device", "cpu", "--n-train", "4", "--n-heldout", "2",
        "--batch", "2", "--threshold", "-1", "--workdir", str(tmp_path),
        "--keep",
    ]
    assert port.main(args + ["--eval-at", "1,2"]) == 0
    result = _result(capsys.readouterr().out)
    assert set(result) == RESULT_KEYS
    assert result["deterministic_hash"] is True and result["passed"]
    assert [p["steps"] for p in result["curve"]] == [1, 2]
    assert result["steps"] == 2 and result["decoder"] == "hifigan"
    student = tmp_path / "voices" / "en_US" / "student_low"
    assert (student / "generator.npz").is_file()

    assert port.main(args + ["--eval-at", "1,2,3", "--resume-run"]) == 0
    out = capsys.readouterr().out
    assert "resuming crashed run at step 2" in out
    # the trainer ran one step, from step 2 to 3
    assert '{"steps": 1, "final_step": 3}' in out
    result = _result(out)
    assert set(result) == RESULT_KEYS
    assert result["deterministic_hash"] is True
    assert [p["steps"] for p in result["curve"]] == [3]
    assert sorted(p.name for p in (student / "checkpoints").iterdir()) == [
        "1", "2", "3",
    ]
