"""Voice loading onto the torch session.

Counterpart of ``mimic3_tpu/runtime/voice.py::TpuVoice.load_from_directory``:
it builds the same phonemizer voice classes (``SymbolsTpuVoice``,
``EspeakTpuVoice``, ...) around a :class:`TorchVitsSession`.  Their
``ids_to_audio`` only calls ``session.synthesize_ids``, so the text front
end is reused unchanged.
"""

from __future__ import annotations

import csv
import logging
import typing
from pathlib import Path

import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.text import load_phoneme_ids, load_phoneme_map
from mimic3_tpu.runtime.voice import (
    _VOICE_CLASSES,
    EspeakTpuVoice,
    HazmEspeakTpuVoice,
    TpuVoice,
    _load_voice_params,
)

from .session import TorchVitsSession

_LOGGER = logging.getLogger(__name__)


def _load_speaker_map(path: Path) -> typing.Optional[typing.Dict[str, int]]:
    """``id|dataset|name|[alias...]`` rows -> alias -> speaker id."""
    if not path.is_file():
        return None
    speaker_map: typing.Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|"):
            if row:
                for alias in row[2:]:
                    speaker_map[alias] = int(row[0])
    return speaker_map


def load_from_directory(
    voice_dir: typing.Union[str, Path],
    *,
    share_sessions: bool = True,
    deterministic: bool = False,
    seed: int = 0,
    device: typing.Union[str, torch.device, None] = None,
) -> TpuVoice:
    """Load a Mimic 3 voice directory onto a torch session."""
    voice_dir = Path(voice_dir)
    _LOGGER.debug("Loading voice from %s", voice_dir)
    config = TrainingConfig.load_path(voice_dir / "config.json")
    with open(voice_dir / "phonemes.txt", "r", encoding="utf-8") as f:
        phoneme_to_id = load_phoneme_ids(f)

    def make_session() -> TorchVitsSession:
        return TorchVitsSession(
            config,
            _load_voice_params(voice_dir),
            deterministic=deterministic,
            seed=seed,
            device=device,
        )

    if share_sessions:
        key = (
            str((voice_dir / "generator").absolute())
            + (":det" if deterministic else "")
            + (f":{device}" if device else "")
        )
        session = TorchVitsSession.get_shared(key, make_session)
    else:
        session = make_session()

    phoneme_map = None
    pm_path = voice_dir / "phoneme_map.txt"
    if pm_path.is_file():
        with open(pm_path, "r", encoding="utf-8") as f:
            phoneme_map = load_phoneme_map(f)

    cls = _VOICE_CLASSES.get(config.phonemizer)
    if cls is None:
        raise ValueError(f"Unsupported phonemizer: {config.phonemizer}")
    if cls is EspeakTpuVoice and config.text_language == "fa":
        try:
            import hazm  # noqa: F401

            cls = HazmEspeakTpuVoice
        except ImportError:
            _LOGGER.warning(
                "hazm is recommended for language 'fa' "
                "(pip install 'hazm>=0.7.0')"
            )
    return cls(
        config=config,
        session=session,
        phoneme_to_id=phoneme_to_id,
        phoneme_map=phoneme_map,
        speaker_map=_load_speaker_map(voice_dir / "speaker_map.csv"),
        location=voice_dir,
    )
