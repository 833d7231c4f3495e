"""The TTS engine: voice discovery/loading, utterance assembly, synthesis.

Implements the :class:`~mimic3_tpu_torch.api.TextToSpeechSystem` contract with
the reference's observable behavior (reference: mimic3_tts/tts.py:65-631):

- settings are snapshotted per spoken chunk, so voice/rate/volume changes
  inside an utterance apply to exactly the text spoken after them,
- chunks accumulate until ``end_utterance()``, which coalesces phoneme
  chunks into sentences, flushing early when settings change or a
  break/mark interleaves,
- ``<lang>/<name>`` voice keys with optional ``#speaker`` suffix,
  wildcard preloading, alias resolution, and automatic download.

Port copy of ``mimic3_tpu/engine.py``: voices load through the port's
loader (``runtime/voice.py``) onto one torch ``device``, the card by
default (raising when none is visible), the CPU only when named.
"""

from __future__ import annotations

import itertools
import logging
import os
import typing
from copy import deepcopy
from dataclasses import dataclass, field
from pathlib import Path

from .api import (
    AudioResult,
    BaseResult,
    BaseToken,
    MarkResult,
    Phonemes,
    SayAs,
    TextToSpeechSystem,
    Voice,
    Word,
)
from .config import TrainingConfig
from .download import (
    VoiceFile,
    default_voices_download_dir,
    download_voice,
)
from .text.ipa import IPA
from .utils import WILDCARD, scale_int16_volume, wildcard_to_regex
from .voices_registry import (
    DEFAULT_LANGUAGE,
    DEFAULT_VOICE,
    registry_url_template,
    get_voices_registry,
)

if typing.TYPE_CHECKING:
    import torch

_LOGGER = logging.getLogger(__name__)

DEFAULT_VOLUME = 100.0
DEFAULT_RATE = 1.0

PHONEMES_LIST = typing.List[typing.List[str]]


@dataclass
class Mimic3Settings:
    """Engine settings (reference: mimic3_tts/tts.py:65-124)."""

    voice: typing.Optional[str] = None
    language: typing.Optional[str] = None
    voices_directories: typing.Optional[
        typing.Iterable[typing.Union[str, Path]]
    ] = None
    # None: use the registry's own url_template (falls back to the
    # default GitHub template)
    voices_url_format: typing.Optional[str] = None
    speaker: typing.Optional[typing.Union[str, int]] = None
    length_scale: typing.Optional[float] = None
    noise_scale: typing.Optional[float] = None
    noise_w: typing.Optional[float] = None
    text_language: typing.Optional[str] = None
    sample_rate: int = 22050
    voices_download_dir: typing.Union[str, Path] = field(
        default_factory=default_voices_download_dir
    )
    no_download: bool = False
    share_sessions: bool = True
    volume: float = DEFAULT_VOLUME
    rate: float = DEFAULT_RATE
    use_deterministic_compute: bool = False
    seed: typing.Optional[int] = None


@dataclass
class _PendingPhonemes:
    """A queued phoneme chunk with its settings snapshot
    (reference: mimic3_tts/tts.py:127-138)."""

    settings: Mimic3Settings
    phonemes: PHONEMES_LIST = field(default_factory=list)
    is_utterance: bool = True


class VoiceNotFoundError(Exception):
    def __init__(self, voice: str):
        super().__init__(f"Voice not found: {voice}")


def get_default_voices_directories() -> typing.List[Path]:
    """XDG data dirs + the reference's voice locations, so voices
    installed for Mimic 3 are found unchanged
    (reference: mimic3_tts/tts.py:160-172)."""
    data_home = os.environ.get(
        "XDG_DATA_HOME", str(Path.home() / ".local" / "share")
    )
    data_dirs = os.environ.get(
        "XDG_DATA_DIRS", "/usr/local/share:/usr/share"
    )
    dirs = [data_home] + [d for d in data_dirs.split(":") if d]
    return [Path(d) / "mycroft" / "mimic3" / "voices" for d in dirs]


class Mimic3TextToSpeechSystem(TextToSpeechSystem):
    """PyTorch implementation of the abstract TTS system."""

    def __init__(
        self,
        settings: typing.Optional[Mimic3Settings] = None,
        *,
        device: typing.Union[str, "torch.device", None] = None,
    ):
        self.settings = settings or Mimic3Settings()
        self.device = device
        self._pending: typing.List[
            typing.Union[BaseResult, _PendingPhonemes]
        ] = []
        self._loaded_voices: typing.Dict[str, typing.Any] = {}

    # -- settings properties ---------------------------------------------------

    @property
    def voice(self) -> str:
        return self.settings.voice or DEFAULT_VOICE

    @voice.setter
    def voice(self, new_voice: str) -> None:
        if new_voice != self.settings.voice:
            self.speaker = None  # speaker belongs to a voice
        self.settings.voice = new_voice or DEFAULT_VOICE
        if "#" in self.settings.voice:
            voice, speaker = self.settings.voice.split("#", maxsplit=1)
            self.settings.voice = voice
            self.speaker = speaker

    @property
    def speaker(self) -> typing.Optional[typing.Union[str, int]]:
        return self.settings.speaker

    @speaker.setter
    def speaker(self, new_speaker) -> None:
        self.settings.speaker = new_speaker

    @property
    def language(self) -> str:
        return self.settings.language or DEFAULT_LANGUAGE

    @language.setter
    def language(self, new_language: str) -> None:
        self.settings.language = new_language

    @property
    def volume(self) -> float:
        return self.settings.volume

    @volume.setter
    def volume(self, new_volume: float) -> None:
        self.settings.volume = max(0.0, min(100.0, new_volume))

    @property
    def rate(self) -> float:
        return self.settings.rate

    @rate.setter
    def rate(self, new_rate: float) -> None:
        self.settings.rate = new_rate

    # -- voice discovery ---------------------------------------------------------

    def _voice_search_dirs(
        self,
    ) -> typing.Iterable[typing.Union[str, Path]]:
        """Voice directories in search order: explicit settings dirs,
        XDG defaults, then the download dir."""
        voices_dirs: typing.Iterable[typing.Union[str, Path]] = (
            get_default_voices_directories()
        )
        if self.settings.voices_directories is not None:
            voices_dirs = itertools.chain(
                self.settings.voices_directories, voices_dirs
            )
        # the download dir is always searched
        return itertools.chain(
            voices_dirs, [self.settings.voices_download_dir]
        )

    def get_voices(self) -> typing.Iterable[Voice]:
        """All locally-installed voices, then not-yet-downloaded registry
        voices (reference: mimic3_tts/tts.py:174-284)."""
        voices_dirs = self._voice_search_dirs()

        registry = get_voices_registry()
        remaining = set(registry.keys())
        seen_dirs: typing.Set[str] = set()

        for voices_dir in voices_dirs:
            voices_dir = Path(voices_dir)
            if (
                str(voices_dir) in seen_dirs
                or not voices_dir.is_dir()
                or voices_dir.name.startswith(".")
            ):
                continue
            seen_dirs.add(str(voices_dir))

            for lang_dir in sorted(voices_dir.iterdir()):
                if not lang_dir.is_dir() or lang_dir.name.startswith("."):
                    continue
                for voice_dir in sorted(lang_dir.iterdir()):
                    if (
                        not voice_dir.is_dir()
                        or voice_dir.name.startswith(".")
                    ):
                        continue
                    config_path = voice_dir / "config.json"
                    if not config_path.is_file():
                        continue

                    try:
                        config = TrainingConfig.load_path(config_path)
                    except Exception:
                        _LOGGER.exception(
                            "Bad voice config: %s", config_path
                        )
                        continue

                    voice_lang = lang_dir.name
                    voice_name = voice_dir.name
                    voice_key = f"{voice_lang}/{voice_name}"

                    speakers = _read_lines(voice_dir / "speakers.txt")
                    aliases = _read_lines(voice_dir / "ALIASES")
                    version_text = None
                    version_path = voice_dir / "VERSION"
                    if version_path.is_file():
                        version_text = version_path.read_text(
                            encoding="utf-8"
                        ).strip()

                    yield Voice(
                        key=voice_key,
                        name=voice_name,
                        language=voice_lang,
                        description="",
                        speakers=speakers,
                        location=str(voice_dir.absolute()),
                        properties={
                            "length_scale": config.inference.length_scale,
                            "noise_scale": config.inference.noise_scale,
                            "noise_w": config.inference.noise_w,
                        },
                        aliases=set(aliases) if aliases else None,
                        version=version_text,
                    )
                    remaining.discard(voice_key)

        for voice_key in sorted(remaining):
            info = registry[voice_key]
            voice_lang, voice_name = voice_key.split("/", maxsplit=1)
            yield Voice(
                key=voice_key,
                name=voice_name,
                language=voice_lang,
                description="",
                speakers=info.get("speakers") or None,
                location=str.format(
                    self.settings.voices_url_format
                    or registry_url_template(),
                    lang=voice_lang,
                    name=voice_name,
                    key=voice_key,
                ),
                properties=info.get("properties") or {},
                aliases=set(info.get("aliases") or []) or None,
                version=info.get("version"),
            )

    def preload_voice(self, voice_key: str) -> None:
        """Load voice(s) ahead of synthesis; ``*`` wildcards allowed
        (reference: mimic3_tts/tts.py:286-310)."""
        keys: typing.List[str] = []
        if WILDCARD in voice_key:
            pattern = wildcard_to_regex(voice_key)
            for candidate in get_voices_registry().keys():
                if pattern.match(candidate):
                    keys.append(candidate)
            if not keys:
                # also try locally-installed voices
                for voice in self.get_voices():
                    if pattern.match(voice.key):
                        keys.append(voice.key)
        else:
            keys.append(voice_key)
        for key in keys:
            self._get_or_load_voice(key)

    # -- utterance assembly -------------------------------------------------------

    def begin_utterance(self) -> None:
        pass

    def speak_text(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> None:
        voice = self._get_or_load_voice(self.voice)
        inference = voice.config.inference

        if inference.auto_append_text and not text.endswith(
            inference.auto_append_text
        ):
            text += inference.auto_append_text

        from .runtime.voice import BreakType

        for sent_phonemes, break_type in voice.text_to_phonemes(
            text, text_language=text_language or self.settings.text_language
        ):
            add_major = (
                break_type == BreakType.MAJOR
                and inference.major_break_ms is not None
            )
            add_minor = (
                break_type == BreakType.MINOR
                and inference.minor_break_ms is not None
            )
            self._pending.append(
                _PendingPhonemes(
                    settings=deepcopy(self.settings),
                    phonemes=sent_phonemes,
                    is_utterance=(
                        break_type == BreakType.UTTERANCE
                        or add_major
                        or add_minor
                    ),
                )
            )
            if add_major:
                self.add_break(inference.major_break_ms)
            elif add_minor:
                self.add_break(inference.minor_break_ms)

    def speak_tokens(
        self,
        tokens: typing.Iterable[BaseToken],
        text_language: typing.Optional[str] = None,
    ) -> None:
        voice = self._get_or_load_voice(self.voice)
        token_phonemes: PHONEMES_LIST = []
        for token in tokens:
            if isinstance(token, Word):
                token_phonemes.append(
                    voice.word_to_phonemes(
                        token.text,
                        word_role=token.role,
                        text_language=text_language,
                    )
                )
            elif isinstance(token, Phonemes):
                phoneme_str = token.text.strip()
                if " " in phoneme_str:
                    token_phonemes.append(phoneme_str.split())
                else:
                    token_phonemes.append(
                        list(IPA.graphemes(phoneme_str))
                    )
            elif isinstance(token, SayAs):
                token_phonemes.extend(
                    voice.say_as_to_phonemes(
                        token.text,
                        interpret_as=token.interpret_as,
                        say_format=token.format,
                        text_language=text_language,
                    )
                )
        if token_phonemes:
            self._pending.append(
                _PendingPhonemes(
                    settings=deepcopy(self.settings),
                    phonemes=token_phonemes,
                    is_utterance=False,
                )
            )

    def add_break(self, time_ms: int) -> None:
        """Queue silence (16-bit mono)."""
        num_samples = int((time_ms / 1000.0) * self.settings.sample_rate)
        self._pending.append(
            AudioResult(
                sample_rate_hz=self.settings.sample_rate,
                sample_width_bytes=2,
                num_channels=1,
                audio_bytes=bytes(num_samples * 2),
            )
        )

    def set_mark(self, name: str) -> None:
        self._pending.append(MarkResult(name=name))

    def end_utterance(self) -> typing.Iterable[BaseResult]:
        """Coalesce queued chunks into synthesized sentences
        (reference algorithm: mimic3_tts/tts.py:470-515).

        Deliberate divergence from the reference: at an utterance
        boundary the reference synthesizes the sentence with the
        STALE ``last_settings`` — the settings captured with the
        *previous* chunk (``tts.py:489-495`` passes ``last_settings``,
        which is only updated after the item is processed; for the
        first sentence it is ``None`` and falls back to the engine's
        live settings at ``end_utterance`` time, ``tts.py:525``).  So
        in the reference, changing e.g. ``rate`` between two
        ``speak_text`` calls does not affect the next sentence — only
        the one after it.  Here each sentence is synthesized with the
        settings snapshot captured when its text was queued
        (``item.settings``), which is what the settings-change flush
        above exists to support.  Pinned by
        ``tests/test_engine.py::test_settings_snapshot_per_sentence``.
        """
        last_settings: typing.Optional[Mimic3Settings] = None
        sent_phonemes: PHONEMES_LIST = []

        try:
            for item in self._pending:
                if isinstance(item, _PendingPhonemes):
                    if item.is_utterance:
                        if (
                            sent_phonemes
                            and last_settings is not None
                            and item.settings != last_settings
                        ):
                            # settings changed: flush what we have first
                            yield self._synthesize(
                                sent_phonemes, last_settings
                            )
                            sent_phonemes = []
                        sent_phonemes.extend(item.phonemes)
                        if sent_phonemes:
                            yield self._synthesize(
                                sent_phonemes,
                                item.settings,
                            )
                            sent_phonemes = []
                    else:
                        sent_phonemes.extend(item.phonemes)
                    last_settings = item.settings
                else:
                    if sent_phonemes:
                        yield self._synthesize(sent_phonemes, last_settings)
                        sent_phonemes = []
                    yield item

            if sent_phonemes:
                yield self._synthesize(sent_phonemes, last_settings)
        finally:
            self._pending = []

    # -- synthesis ------------------------------------------------------------------

    def _synthesize(
        self,
        sent_phonemes: PHONEMES_LIST,
        settings: typing.Optional[Mimic3Settings],
    ) -> AudioResult:
        settings = settings or self.settings
        voice = self._get_or_load_voice(settings.voice or self.voice)
        ids = voice.phonemes_to_ids(sent_phonemes)
        _LOGGER.debug("phonemes=%s ids=%s", sent_phonemes, ids)

        audio = voice.ids_to_audio(
            ids,
            speaker=settings.speaker,
            length_scale=settings.length_scale,
            noise_scale=settings.noise_scale,
            noise_w=settings.noise_w,
            rate=settings.rate,
            seed=settings.seed,
        )
        audio_bytes = audio.tobytes()
        if settings.volume != DEFAULT_VOLUME:
            audio_bytes = scale_int16_volume(
                audio_bytes, settings.volume
            )
        return AudioResult(
            sample_rate_hz=voice.config.audio.sample_rate,
            sample_width_bytes=2,
            num_channels=1,
            audio_bytes=audio_bytes,
        )

    # -- lifecycle ---------------------------------------------------------------

    def shutdown(self) -> None:
        """Release loaded voices (shared sessions stay cached for other
        engines; see TorchVitsSession.get_shared)."""
        self._loaded_voices.clear()
        self._pending.clear()

    # -- loading ---------------------------------------------------------------------

    def preloaded_voice(self, voice_key: str):
        return self._loaded_voices.get(voice_key)

    def _get_or_load_voice(self, voice_key: str):
        existing = self._loaded_voices.get(voice_key)
        if existing is not None:
            return existing

        model_dir: typing.Optional[Path] = None
        # fast path for exact '<lang>/<name>' keys: probe the search
        # dirs directly instead of config-parsing every installed voice
        # (get_voices loads each config.json it walks past); aliases,
        # wildcards, and not-yet-downloaded voices fall through to the
        # full scan below
        if voice_key.count("/") == 1 and "*" not in voice_key:
            for voices_dir in self._voice_search_dirs():
                candidate_dir = Path(voices_dir) / voice_key
                if (candidate_dir / "config.json").is_file():
                    try:
                        TrainingConfig.load_path(
                            candidate_dir / "config.json"
                        )
                    except Exception:
                        # corrupt config: let the full scan skip this
                        # dir (and the registry path re-download it)
                        _LOGGER.warning(
                            "Bad voice config: %s", candidate_dir
                        )
                        break
                    model_dir = candidate_dir
                    break
        for candidate in self.get_voices() if model_dir is None else ():
            if voice_key == candidate.key or (
                candidate.aliases and voice_key in candidate.aliases
            ):
                maybe_dir = Path(candidate.location)
                if (
                    not maybe_dir.is_dir()
                ) and not self.settings.no_download:
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

        from .runtime.voice import load_from_directory

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

    def _download_voice(self, voice_key: str) -> Path:
        registry = get_voices_registry()
        info = registry.get(voice_key)
        if info is None:
            raise VoiceNotFoundError(voice_key)
        lang, name = voice_key.split("/", maxsplit=1)
        url_base = str.format(
            self.settings.voices_url_format or registry_url_template(),
            key=voice_key,
            lang=lang,
            name=name,
        )
        download_voice(
            voice_key=voice_key,
            url_base=url_base,
            voice_files=[
                VoiceFile(p, f.get("size_bytes"), f.get("sha256_sum"))
                for p, f in info["files"].items()
            ],
            voice_version=info.get("version"),
            voices_dir=self.settings.voices_download_dir,
        )
        return Path(self.settings.voices_download_dir) / voice_key


def _read_lines(path: Path) -> typing.Optional[typing.List[str]]:
    if not path.is_file():
        return None
    lines = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                lines.append(line)
    return lines
