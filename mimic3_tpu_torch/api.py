"""Abstract text-to-speech API: tokens, results, and the system contract.

This is the framework-neutral layer every consumer (CLI, HTTP server, SSML
engine, plugins) programs against.  It is contract-compatible with the
reference's `opentts_abc` package (reference: opentts_abc/__init__.py:56-318)
so code written for Mimic 3 can switch to mimic3-tpu unchanged.

Port copy of ``mimic3_tpu/api.py``.
"""

from __future__ import annotations

import io
import typing
import wave
from abc import ABC, abstractmethod
from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Tokens
# ---------------------------------------------------------------------------


@dataclass
class BaseToken:
    """A unit of text to be spoken."""

    text: str


@dataclass
class Word(BaseToken):
    """A single word, optionally with a role (usually a part of speech)."""

    role: typing.Optional[str] = None


@dataclass
class Phonemes(BaseToken):
    """A pre-phonemized word; ``text`` holds the phoneme string."""

    alphabet: typing.Optional[str] = None


@dataclass
class SayAs(BaseToken):
    """A word/phrase that must be spoken a particular way (SSML <say-as>)."""

    interpret_as: str = ""
    format: typing.Optional[str] = None


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclass
class BaseResult:
    """Base class of results yielded by ``end_utterance()``."""

    tag: typing.Optional[typing.Any] = None


@dataclass
class AudioResult(BaseResult):
    """A chunk of synthesized PCM audio (no header)."""

    sample_rate_hz: int = 22050
    sample_width_bytes: int = 2
    num_channels: int = 1
    audio_bytes: bytes = b""

    def to_wav_bytes(self) -> bytes:
        """Wrap the raw PCM in a RIFF/WAV container."""
        with io.BytesIO() as wav_io:
            with wave.open(wav_io, "wb") as wav_file:
                wav_file.setframerate(self.sample_rate_hz)
                wav_file.setsampwidth(self.sample_width_bytes)
                wav_file.setnchannels(self.num_channels)
                wav_file.writeframes(self.audio_bytes)
            return wav_io.getvalue()


@dataclass
class MarkResult(BaseResult):
    """Signals that a named SSML <mark> position has been reached."""

    name: str = ""


# ---------------------------------------------------------------------------
# Voice description
# ---------------------------------------------------------------------------


@dataclass
class Voice:
    """Description of an available voice."""

    key: str
    name: str
    language: str
    description: str
    location: str
    speakers: typing.Optional[typing.Sequence[str]] = None
    properties: typing.Optional[typing.Mapping[str, typing.Any]] = None
    aliases: typing.Optional[typing.Set[str]] = None
    version: typing.Optional[str] = None

    @property
    def is_multispeaker(self) -> bool:
        return (self.speakers is not None) and (len(self.speakers) > 1)


# ---------------------------------------------------------------------------
# The system contract
# ---------------------------------------------------------------------------


DEFAULT_WAV_PARAMS = (22050, 2, 1)  # rate, sample width, channels


def set_default_wav_params(wav_file: "wave.Wave_write") -> None:
    """Parameterize an empty/fallback WAV (a Wave_write with no params
    raises from close())."""
    rate, width, channels = DEFAULT_WAV_PARAMS
    wav_file.setframerate(rate)
    wav_file.setsampwidth(width)
    wav_file.setnchannels(channels)


class TextToSpeechSystem(ABC):
    """Abstract base class for text-to-speech systems.

    Expected usage::

        begin_utterance()
        speak_text(...)
        add_break(...)
        set_mark(...)
        speak_tokens(...)
        results = end_utterance()

    Voice/language/rate/volume may change between calls inside an utterance;
    implementations must apply the settings in effect at each ``speak_*``
    call (the reference snapshots settings per chunk,
    mimic3_tts/tts.py:399).
    """

    # -- settings -----------------------------------------------------------

    @property
    @abstractmethod
    def voice(self) -> str:
        """Current voice key."""

    @voice.setter
    def voice(self, new_voice: str) -> None: ...

    @property
    @abstractmethod
    def language(self) -> str:
        """Current language (e.g. ``en_US``)."""

    @language.setter
    def language(self, new_language: str) -> None: ...

    @property
    @abstractmethod
    def volume(self) -> float:
        """Current volume in [0, 100]."""

    @volume.setter
    def volume(self, new_volume: float) -> None: ...

    @property
    @abstractmethod
    def rate(self) -> float:
        """Current speaking rate (1.0 = normal)."""

    @rate.setter
    def rate(self, new_rate: float) -> None: ...

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the system and release resources."""

    def __enter__(self) -> "TextToSpeechSystem":
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        self.shutdown()

    # -- synthesis ----------------------------------------------------------

    @abstractmethod
    def get_voices(self) -> typing.Iterable[Voice]:
        """Iterate over all available voices."""

    @abstractmethod
    def begin_utterance(self) -> None:
        """Begin a new utterance."""

    @abstractmethod
    def speak_text(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> None:
        """Queue text for synthesis using the system's own tokenization."""

    @abstractmethod
    def speak_tokens(self, tokens: typing.Iterable[BaseToken]) -> None:
        """Queue pre-tokenized input (words, phonemes, say-as)."""

    @abstractmethod
    def add_break(self, time_ms: int) -> None:
        """Queue ``time_ms`` milliseconds of silence."""

    @abstractmethod
    def set_mark(self, name: str) -> None:
        """Queue a named mark; surfaces as a :class:`MarkResult`."""

    @abstractmethod
    def end_utterance(self) -> typing.Iterable[BaseResult]:
        """Flush the utterance, yielding audio and mark results."""

    # -- convenience ---------------------------------------------------------

    def text_to_wav(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> bytes:
        """One-shot synthesis of ``text`` to WAV bytes."""
        with io.BytesIO() as wav_io:
            wav_file: wave.Wave_write = wave.open(wav_io, "wb")
            wav_params_set = False

            with wav_file:
                try:
                    self.begin_utterance()
                    self.speak_text(text, text_language=text_language)
                    for result in self.end_utterance():
                        if isinstance(result, AudioResult):
                            if not wav_params_set:
                                wav_file.setframerate(result.sample_rate_hz)
                                wav_file.setsampwidth(result.sample_width_bytes)
                                wav_file.setnchannels(result.num_channels)
                                wav_params_set = True
                            wav_file.writeframes(result.audio_bytes)
                    if not wav_params_set:
                        # no audio produced (empty/punctuation-only
                        # input): emit a valid empty WAV instead of
                        # letting Wave_write.close() raise
                        set_default_wav_params(wav_file)
                        wav_params_set = True
                except Exception:
                    if not wav_params_set:
                        # Valid (empty) header so callers streaming the
                        # buffer still see a parseable WAV while the
                        # exception propagates
                        # (reference: opentts_abc/__init__.py:307-314).
                        set_default_wav_params(wav_file)
                    raise

            return wav_io.getvalue()
