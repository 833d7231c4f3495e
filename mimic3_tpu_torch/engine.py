"""Text-to-speech engine on the torch session.

A :class:`mimic3_tpu.engine.Mimic3TextToSpeechSystem` whose voices load
through the port's loader (``runtime/voice.py``); text handling, SSML,
voice lookup and settings are the reference engine's own.  Voices run on
``device``: the card by default (raising when none is visible), the CPU
only when named.
"""

from __future__ import annotations

import logging
import typing
from pathlib import Path

import torch

from mimic3_tpu.config import TrainingConfig
from mimic3_tpu.engine import (
    Mimic3Settings,
    Mimic3TextToSpeechSystem as _ReferenceSystem,
    VoiceNotFoundError,
)

from .runtime.voice import load_from_directory

__all__ = ["Mimic3Settings", "Mimic3TextToSpeechSystem"]

_LOGGER = logging.getLogger(__name__)


class Mimic3TextToSpeechSystem(_ReferenceSystem):
    """The reference engine with voices synthesized by PyTorch."""

    def __init__(
        self,
        settings: typing.Optional[Mimic3Settings] = None,
        *,
        device: typing.Union[str, torch.device, None] = None,
    ):
        super().__init__(settings)
        self.device = device

    def _get_or_load_voice(self, voice_key: str):
        existing = self._loaded_voices.get(voice_key)
        if existing is not None:
            return existing

        model_dir: typing.Optional[Path] = None
        # exact '<lang>/<name>' keys: probe the search dirs directly
        if voice_key.count("/") == 1 and "*" not in voice_key:
            for voices_dir in self._voice_search_dirs():
                candidate_dir = Path(voices_dir) / voice_key
                if (candidate_dir / "config.json").is_file():
                    try:
                        TrainingConfig.load_path(candidate_dir / "config.json")
                    except Exception:  # corrupt config: full scan skips it
                        _LOGGER.warning("Bad voice config: %s", candidate_dir)
                        break
                    model_dir = candidate_dir
                    break
        for candidate in self.get_voices() if model_dir is None else ():
            if voice_key == candidate.key or (
                candidate.aliases and voice_key in candidate.aliases
            ):
                maybe_dir = Path(candidate.location)
                if not maybe_dir.is_dir() and not self.settings.no_download:
                    maybe_dir = self._download_voice(candidate.key)
                if maybe_dir.is_dir():
                    model_dir = maybe_dir
                    break
        if model_dir is None:
            raise VoiceNotFoundError(voice_key)

        canonical_key = f"{model_dir.parent.name}/{model_dir.name}"
        existing = self._loaded_voices.get(canonical_key)
        if existing is not None:
            self._loaded_voices[voice_key] = existing
            return existing

        voice = load_from_directory(
            model_dir,
            share_sessions=self.settings.share_sessions,
            deterministic=self.settings.use_deterministic_compute,
            seed=self.settings.seed or 0,
            device=self.device,
        )
        _LOGGER.info("Loaded voice from %s", model_dir)
        self._loaded_voices[voice_key] = voice
        self._loaded_voices[canonical_key] = voice
        return voice
