"""Synthetic test voice made without JAX: a valid voice with random weights.

Counterpart of ``mimic3_tpu/runtime/testvoice.py``: the same
``config.json`` / ``phonemes.txt`` / ``generator.npz`` layout and
``symbols`` phonemizer, with the weights drawn by the port's seeded
:func:`~mimic3_tpu_torch.models.vits.model.init_params` (same key names
and shapes as the JAX initializer, different random values).

Usage: ``python -m mimic3_tpu_torch.runtime.testvoice <voice_dir> [--tiny]
[--decoder mb-istft]``
"""

from __future__ import annotations

import argparse
import json
import typing
from pathlib import Path

from ..config import (
    ModelConfig,
    PhonemesConfig,
    Phonemizer,
    TrainingConfig,
)
from ..models.vits.model import init_params
from .convert import save_pytree_npz

_META_SYMBOLS = ["_", "^", "$", "#"]
_CHARS = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?;:'- ")


def create_test_voice(
    voice_dir: typing.Union[str, Path],
    *,
    n_speakers: int = 1,
    seed: int = 1234,
    full_size: bool = True,
    sample_rate: int = 22050,
    decoder_type: str = "hifigan",
) -> Path:
    """Write a synthetic voice directory; returns its path.

    ``full_size=True`` uses the ``*_low`` hyperparameters of real Mimic 3
    voices (hidden 192, 6 layers, upsample 512, 8·8·2·2); ``False`` makes
    a tiny model (hidden 64, 2 layers, upsample 128) for tests.
    ``decoder_type`` picks the decoder family (``"hifigan"`` or
    ``"mb-istft"``).
    """
    voice_dir = Path(voice_dir)
    voice_dir.mkdir(parents=True, exist_ok=True)
    symbols = _META_SYMBOLS + _CHARS

    if full_size:
        model = ModelConfig(num_symbols=len(symbols), n_speakers=n_speakers)
    else:
        model = ModelConfig(
            num_symbols=len(symbols),
            n_speakers=n_speakers,
            hidden_channels=64,
            inter_channels=64,
            filter_channels=128,
            n_layers=2,
            upsample_initial_channel=128,
        )
    if n_speakers > 1:
        model.gin_channels = 256 if full_size else 32
    model.decoder_type = decoder_type

    config = TrainingConfig(seed=seed, model=model)
    config.audio.sample_rate = sample_rate
    config.phonemizer = Phonemizer.SYMBOLS
    config.text_language = "en_US"
    config.phonemes = PhonemesConfig(
        pad="_",
        bos="^",
        eos="$",
        blank="#",
        auto_bos_eos=True,
        blank_at_start=True,
        blank_at_end=True,
        word_separator=" ",
        simple_punctuation=True,
    )
    with open(voice_dir / "config.json", "w", encoding="utf-8") as f:
        config.save(f)
    with open(voice_dir / "phonemes.txt", "w", encoding="utf-8") as f:
        for i, symbol in enumerate(symbols):
            f.write(f"{i} {symbol}\n")

    save_pytree_npz(voice_dir / "generator.npz", init_params(seed, model))

    if n_speakers > 1:
        with open(voice_dir / "speakers.txt", "w", encoding="utf-8") as f:
            for i in range(n_speakers):
                f.write(f"speaker_{i}\n")
        with open(voice_dir / "speaker_map.csv", "w", encoding="utf-8") as f:
            for i in range(n_speakers):
                f.write(f"{i}|test|speaker_{i}\n")
    (voice_dir / "VERSION").write_text("1\n", encoding="utf-8")
    return voice_dir


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Create a synthetic (random-weight) test voice"
    )
    parser.add_argument("voice_dir")
    parser.add_argument("--speakers", type=int, default=1)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument(
        "--tiny",
        action="store_true",
        help="Small model (fast tests) instead of real *_low dimensions",
    )
    parser.add_argument(
        "--decoder",
        choices=("hifigan", "mb-istft"),
        default="hifigan",
        help="Decoder family",
    )
    args = parser.parse_args(argv)
    path = create_test_voice(
        args.voice_dir,
        n_speakers=args.speakers,
        seed=args.seed,
        full_size=not args.tiny,
        decoder_type=args.decoder,
    )
    print(json.dumps({"voice_dir": str(path)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
