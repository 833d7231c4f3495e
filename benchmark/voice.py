"""A voice directory made from a configuration file and a seed.

The benchmark's configurations have random weights: :func:`write_voice`
draws every leaf of the voice-file layout (``reference/params.py``) on
the device from ``--seed``, in two large calls (one uniform, one normal
draw, cut and scaled per leaf), and writes the directory a converted
Mimic 3 voice has: ``config.json`` (the ``symbols`` phonemizer),
``phonemes.txt`` and ``generator.npz``.  The program loads it through its
normal load path; the reference reads the same files.
"""

from __future__ import annotations

import json
import typing
from pathlib import Path

import numpy as np
import torch

from .reference.params import layout

SEED_MASK = (1 << 63) - 1


def make_params(model: typing.Mapping[str, typing.Any], seed: int,
                device: torch.device) -> typing.Dict[str, np.ndarray]:
    """Every leaf of the voice file, drawn on ``device`` from ``seed``."""
    leaves = layout(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    draws = {}
    for kind, draw in (("uniform", torch.rand), ("normal", torch.randn)):
        group = [leaf for leaf in leaves if leaf.init == kind]
        n = sum(int(np.prod(leaf.shape)) for leaf in group)
        flat = draw(n, generator=gen, device=device)
        if kind == "uniform":
            flat = flat * 2 - 1
        for leaf, part in zip(group, torch.split(
                flat, [int(np.prod(leaf.shape)) for leaf in group])):
            draws[leaf.name] = part.view(leaf.shape) * leaf.scale
    tensors = {}
    for leaf in leaves:
        if leaf.init in ("uniform", "normal"):
            tensors[leaf.name] = draws[leaf.name]
        elif leaf.init == "zeros":
            tensors[leaf.name] = torch.zeros(leaf.shape, device=device)
        elif leaf.init == "ones":
            tensors[leaf.name] = torch.ones(leaf.shape, device=device)
        else:  # weight norm's gain starts at the norm of its direction
            v = draws[leaf.of]
            tensors[leaf.name] = v.square().sum(dim=(0, 1),
                                                keepdim=True).sqrt()
    names = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1) for k in names]).cpu().numpy()
    out, at = {}, 0
    for k in names:
        n = tensors[k].numel()
        out[k] = flat[at: at + n].reshape(tensors[k].shape)
        at += n
    return out


def voice_config(config: typing.Mapping[str, typing.Any]
                 ) -> typing.Dict[str, typing.Any]:
    """The voice's ``config.json`` from a benchmark configuration."""
    model = dict(config["model"], num_symbols=len(config["symbols"]))
    return {
        "audio": config["audio"],
        "model": model,
        "phonemes": config["phonemes"],
        "phonemizer": "symbols",
        "text_language": config.get("language", "en_US"),
        "inference": config.get("inference", {}),
        "tpu": config.get("tpu", {}),
    }


def write_voice(voice_dir: Path, config: typing.Mapping[str, typing.Any],
                seed: int, device: torch.device) -> Path:
    """Write the voice directory."""
    voice_dir.mkdir(parents=True, exist_ok=True)
    vc = voice_config(config)
    (voice_dir / "config.json").write_text(json.dumps(vc, indent=1))
    (voice_dir / "phonemes.txt").write_text(
        "".join(f"{i} {s}\n" for i, s in enumerate(config["symbols"])),
        encoding="utf-8")
    np.savez(voice_dir / "generator.npz",
             **make_params(vc["model"], seed, device))
    return voice_dir
