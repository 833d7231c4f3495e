"""The comparison that decides ``correct``.

Each answer the program gave (a row of a batch call, a served WAV, a
stream) is held against the plain reference (``reference/``) run on the
same voice files and the same inputs:

- ``length_bad``: answers whose sample count no duration vector of the
  reference gives.  A phoneme's frame count is the ceiling of a float
  that the program and the reference compute with different rounding;
  where the reference's value lies within :data:`DURATION_TOL` of an
  integer either count is the reference's answer, and the one the
  answer's length picks (the closest audio among those that fit) is
  compared.  Limit 0.
- ``wave_err``: the widest relative error over the answers,
  ``||got - ref|| / ||ref||`` over every sample, after the conversion the
  answer went through (none, the whole-WAV peak normalization to int16,
  or the stream's fixed gain).
- ``failed``: answers that never came.  Limit 0.
"""

from __future__ import annotations

import itertools
import json
import sys
import typing
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .reference import params as ref_params
from .reference import text as ref_text
from .reference.vits import Vits

DURATION_TOL = 5e-4
MAX_AMBIGUOUS = 6
# the decoder sees this many zero frames past the utterance, more than
# its receptive field, as in a bucket with room to spare
PAD_FRAMES = 64
STREAM_GAIN = 32767.0 * 0.7
MAX_WAV = 32767.0
NOT_FINITE = 1e300


@dataclass
class Answer:
    """One answer and the inputs that asked for it."""

    got: np.ndarray  # float32 samples, or int16 PCM
    ids: typing.Optional[typing.Sequence[int]] = None
    text: typing.Optional[str] = None
    seed: int = 0
    length_scale: float = 1.0
    noise_scale: float = 0.667
    noise_w: float = 0.8
    conversion: str = "float"  # "float", "wav" or "stream"


def to_int16(audio: np.ndarray, conversion: str) -> np.ndarray:
    if conversion == "wav":
        peak = max(0.01, float(np.max(np.abs(audio)))) if audio.size \
            else 0.01
        scaled = audio * (MAX_WAV / peak)
    else:
        scaled = audio * STREAM_GAIN
    return np.clip(scaled, -MAX_WAV, MAX_WAV).astype(np.int16)


def _candidates(w: np.ndarray, frames: int):
    """Duration vectors of the reference whose sum is ``frames``."""
    base = np.ceil(w).astype(np.int64)
    near = np.flatnonzero(np.abs(w - np.round(w)) < DURATION_TOL)
    near = near[np.argsort(np.abs(w[near] - np.round(w[near])))][
        :MAX_AMBIGUOUS]
    for pick in itertools.product((0, 1), repeat=len(near)):
        d = base.copy()
        d[near] = np.round(w[near]).astype(np.int64) + np.array(pick,
                                                                np.int64)
        if max(1, int(d.sum())) == frames:
            yield d


class Judge:
    """The reference on a voice directory, on ``device``."""

    def __init__(self, voice_dir: Path, device: torch.device,
                 precision: str = "float32"):
        config = json.loads((voice_dir / "config.json").read_text())
        self.phonemes = config["phonemes"]
        self.table = ref_text.load_table(voice_dir / "phonemes.txt")
        self.model = Vits(config["model"],
                          ref_params.load(voice_dir / "generator.npz", device),
                          device, precision)

    def error(self, answer: Answer) -> typing.Optional[float]:
        """The answer's relative error, or None when its length fits no
        duration vector of the reference."""
        ids = answer.ids if answer.ids is not None else ref_text.text_to_ids(
            answer.text, self.table, self.phonemes)
        w, m_p, logs_p = self.model.durations(
            ids, answer.seed, answer.length_scale, answer.noise_w)
        hop = self.model.hop
        if len(answer.got) % hop:
            return None
        best = None
        for d in _candidates(w, len(answer.got) // hop):
            ref = self.model.decode(m_p, logs_p, d, answer.seed,
                                    answer.noise_scale, PAD_FRAMES)
            if answer.conversion != "float":
                ref = to_int16(ref, answer.conversion)
            ref = ref.astype(np.float64)
            got = answer.got.astype(np.float64)
            err = float(np.linalg.norm(got - ref)
                        / max(np.linalg.norm(ref), 1e-30))
            if not np.isfinite(err):
                err = float("inf")
            best = err if best is None else min(best, err)
        return best


def judge(voice_dir: Path, answers: typing.Sequence[Answer],
          device: torch.device, precision: str = "float32"
          ) -> typing.Dict[str, float]:
    """``length_bad`` and ``wave_err`` over ``answers``."""
    j = Judge(voice_dir, device, precision)
    errors = [j.error(a) for a in answers]
    fitted = [e for e in errors if e is not None]
    if fitted:
        print(f"judged {len(answers)} answers: error min {min(fitted):.6g}"
              f" median {float(np.median(fitted)):.6g} max "
              f"{max(fitted):.6g} (answer {errors.index(max(fitted))})",
              file=sys.stderr)
    return {
        "length_bad": float(sum(e is None for e in errors)),
        "wave_err": max(fitted) if fitted else float("inf"),
        "answers": float(len(answers)),
    }


def held(numbers: typing.Mapping[str, float],
         limits: typing.Mapping[str, float]) -> typing.Dict[str, typing.Any]:
    """Each compared number beside its limit; a number passes when it is
    at most its limit.  One that is not finite reads as ``NOT_FINITE``."""
    def finite(v: float) -> float:
        return float(v) if np.isfinite(v) else NOT_FINITE

    return {name: {"value": finite(numbers[name]), "limit": float(limit)}
            for name, limit in limits.items()}


def passes(checks: typing.Mapping[str, typing.Mapping[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
