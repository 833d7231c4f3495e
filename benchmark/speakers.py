"""Multi-speaker voices: the voice directory, and the comparison that
decides ``correct`` for answers that carry a speaker id.

:func:`write_voice` writes what :func:`.voice.write_voice` writes for a
single-speaker configuration, with the leaves of
``reference.vits_speakers.layout_speakers``: the single-speaker leaves
drawn exactly as :func:`.voice.make_params` draws them from the seed, and
the speaker leaves from a generator of their own seeded by (seed,
:data:`LEAVES_STREAM`), plus ``speakers.txt`` (one name a speaker, in id
order, as Mimic 3's multi-speaker voices have it).

:class:`Judge` is :class:`.check.Judge` over
``reference.vits_speakers.VitsSpeakers``: each answer is judged against
the reference run for the answer's own speaker.
"""

from __future__ import annotations

import json
import sys
import typing
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import check
from .reference import params as ref_params
from .reference.params import layout
from .reference.text import load_table
from .reference.vits_speakers import VitsSpeakers, layout_speakers
from .textgen import rng
from .voice import SEED_MASK, make_params, voice_config

LEAVES_STREAM = 17


def _single(model: typing.Mapping[str, typing.Any]) -> typing.Dict:
    return dict(model, n_speakers=1, gin_channels=0)


def make_speaker_params(model: typing.Mapping[str, typing.Any], seed: int,
                        device: torch.device
                        ) -> typing.Dict[str, np.ndarray]:
    """Every leaf of the multi-speaker voice file, drawn on ``device``."""
    out = make_params(_single(model), seed, device)
    extra = layout_speakers(model)[len(layout(_single(model))):]
    mixed = int(rng(seed, LEAVES_STREAM).integers(0, 1 << 62))
    gen = torch.Generator(device=device).manual_seed(mixed & SEED_MASK)
    drawn: typing.Dict[str, torch.Tensor] = {}
    for leaf in extra:
        if leaf.init == "uniform":
            t = (torch.rand(leaf.shape, generator=gen, device=device) * 2
                 - 1) * leaf.scale
        elif leaf.init == "normal":
            t = torch.randn(leaf.shape, generator=gen, device=device) \
                * leaf.scale
        else:  # weight norm's gain starts at the norm of its direction
            t = drawn[leaf.of].square().sum(dim=(0, 1), keepdim=True).sqrt()
        drawn[leaf.name] = t
    out.update({k: v.cpu().numpy() for k, v in drawn.items()})
    return out


def write_voice(voice_dir: Path, config: typing.Mapping[str, typing.Any],
                seed: int, device: torch.device) -> Path:
    """Write the multi-speaker voice directory."""
    voice_dir.mkdir(parents=True, exist_ok=True)
    vc = voice_config(config)
    (voice_dir / "config.json").write_text(json.dumps(vc, indent=1))
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {s}\n" for i, s in enumerate(config["symbols"])),
        encoding="utf-8")
    (voice_dir / "speakers.txt").write_text(
        "".join(f"speaker_{i}\n" for i in range(vc["model"]["n_speakers"])),
        encoding="utf-8")
    np.savez(voice_dir / "generator.npz",
             **make_speaker_params(vc["model"], seed, device))
    return voice_dir


@dataclass
class Answer(check.Answer):
    """An answer and the inputs that asked for it, its speaker among
    them."""

    speaker: int = 0


class Judge(check.Judge):
    """The multi-speaker reference on a voice directory: an answer is
    judged as :class:`.check.Judge` judges it, by the reference bound to
    the answer's speaker."""

    def __init__(self, voice_dir: Path, device: torch.device,
                 precision: str = "float32"):
        config = json.loads((voice_dir / "config.json").read_text())
        self.phonemes = config["phonemes"]
        self.table = load_table(voice_dir / "phonemes.txt")
        self.speakers = VitsSpeakers(
            config["model"], ref_params.load(voice_dir / "generator.npz",
                                             device), device, precision)

    def error(self, answer: Answer) -> typing.Optional[float]:
        self.model = self.speakers.with_speaker(answer.speaker)
        return super().error(answer)


def judge(voice_dir: Path, answers: typing.Sequence[Answer],
          device: torch.device, precision: str = "float32"
          ) -> typing.Dict[str, float]:
    """``length_bad`` and ``wave_err`` over ``answers``, each against its
    own speaker."""
    j = Judge(voice_dir, device, precision)
    errors = [j.error(a) for a in answers]
    fitted = [e for e in errors if e is not None]
    if fitted:
        worst = errors.index(max(fitted))
        print(f"judged {len(answers)} answers over "
              f"{len({a.speaker for a in answers})} speakers: error min "
              f"{min(fitted):.6g} median {float(np.median(fitted)):.6g} max "
              f"{max(fitted):.6g} (answer {worst}, speaker "
              f"{answers[worst].speaker})", file=sys.stderr)
    return {
        "length_bad": float(sum(e is None for e in errors)),
        "wave_err": max(fitted) if fitted else float("inf"),
        "answers": float(len(answers)),
    }
