"""Voice layer: phonemization dispatch + phoneme-id encoding + synthesis.

The voice classes of the reference (``text_to_phonemes`` /
``word_to_phonemes`` / ``say_as_to_phonemes`` / ``phonemes_to_ids`` /
``ids_to_audio``) around a :class:`TorchVitsSession`, and
:func:`load_from_directory`, which loads a Mimic 3 voice directory
(``config.json``, ``phonemes.txt``, ``generator.npz`` or
``generator.onnx``, optional ``phoneme_map.txt`` / ``speaker_map.csv``)
onto one torch device, or data parallel over several (``dp``).  A voice
that ships only ``generator.onnx`` (every voice of the registry) is
converted by the port's own converter on first use
(``runtime/convert.py``).

Port copy of ``mimic3_tpu/runtime/voice.py``: the classes lose the
``Tpu`` of their names.
"""

from __future__ import annotations

import csv
import logging
import typing
from abc import ABC, abstractmethod
from enum import Enum
from pathlib import Path

import numpy as np
import torch

from ..config import Phonemizer, TrainingConfig
from ..text import load_phoneme_ids, load_phoneme_map, phonemes2ids
from ..text.ipa import IPA
from ..utils import audio_float_to_int16, to_codepoints
from .session import TorchVitsSession

_LOGGER = logging.getLogger(__name__)

DEFAULT_LANGUAGE = "en_US"
DEFAULT_RATE = 1.0


class BreakType(str, Enum):
    NONE = "none"
    MINOR = "minor"
    MAJOR = "major"
    UTTERANCE = "utterance"


PHONEME = str
WORD_PHONEMES = typing.List[typing.List[PHONEME]]
TEXT_TO_PHONEMES_RESULT = typing.Iterable[
    typing.Tuple[WORD_PHONEMES, BreakType]
]
SPEAKER = typing.Union[str, int]


class VitsVoice(ABC):
    """A loaded voice: text front end + compiled synthesis session."""

    def __init__(
        self,
        config: TrainingConfig,
        session: TorchVitsSession,
        phoneme_to_id: typing.Dict[PHONEME, int],
        phoneme_map: typing.Optional[
            typing.Dict[PHONEME, typing.List[PHONEME]]
        ] = None,
        speaker_map: typing.Optional[typing.Dict[str, int]] = None,
        location: typing.Optional[Path] = None,
    ):
        self.config = config
        self.session = session
        self.phoneme_to_id = phoneme_to_id
        self.phoneme_map = phoneme_map
        self.speaker_map = speaker_map
        self.location = location

    # -- phonemization (per-phonemizer subclasses) -----------------------------

    @abstractmethod
    def text_to_phonemes(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> TEXT_TO_PHONEMES_RESULT:
        """Convert text into (word-phonemes, break-type) chunks."""

    def word_to_phonemes(
        self,
        word_text: str,
        word_role: typing.Optional[str] = None,
        text_language: typing.Optional[str] = None,
    ) -> typing.List[PHONEME]:
        del word_role  # only gruut understands roles
        phonemes: typing.List[PHONEME] = []
        for sent_phonemes, _bt in self.text_to_phonemes(
            word_text, text_language=text_language
        ):
            for wp in sent_phonemes:
                phonemes.extend(wp)
        return phonemes

    def say_as_to_phonemes(
        self,
        text: str,
        interpret_as: str,
        say_format: typing.Optional[str] = None,
        text_language: typing.Optional[str] = None,
    ) -> WORD_PHONEMES:
        del interpret_as, say_format  # gruut-only feature
        word_phonemes: WORD_PHONEMES = []
        for sent_phonemes, _bt in self.text_to_phonemes(
            text, text_language=text_language
        ):
            word_phonemes.extend(sent_phonemes)
        return word_phonemes

    # -- encoding -----------------------------------------------------------------

    def phonemes_to_ids(
        self, phonemes: WORD_PHONEMES
    ) -> typing.List[int]:
        """Phonemes -> model ids, honoring the voice's PhonemesConfig
        (reference: mimic3_tts/voice.py:126-152)."""
        pc = self.config.phonemes
        return phonemes2ids(
            word_phonemes=phonemes,
            phoneme_to_id=self.phoneme_to_id,
            pad=pc.pad,
            bos=pc.bos,
            eos=pc.eos,
            auto_bos_eos=pc.auto_bos_eos,
            blank=pc.blank,
            blank_word=pc.blank_word,
            blank_between=pc.blank_between,
            blank_at_start=pc.blank_at_start,
            blank_at_end=pc.blank_at_end,
            simple_punctuation=pc.simple_punctuation,
            punctuation_map=pc.punctuation_map,
            separate=pc.separate,
            separate_graphemes=pc.separate_graphemes,
            separate_tones=pc.separate_tones,
            tone_before=pc.tone_before,
            phoneme_map=self.phoneme_map or pc.phoneme_map,
            fail_on_missing=False,
        )

    # -- synthesis ------------------------------------------------------------------

    def resolve_speaker_id(
        self, speaker: typing.Optional[SPEAKER]
    ) -> int:
        """Speaker name/id -> model speaker index
        (reference semantics: mimic3_tts/voice.py:197-218)."""
        if not self.config.is_multispeaker or speaker is None:
            return 0
        if isinstance(speaker, int):
            return speaker
        if self.speaker_map and speaker in self.speaker_map:
            return self.speaker_map[speaker]
        try:
            return int(speaker)
        except ValueError:
            _LOGGER.warning(
                "Unknown speaker %r; falling back to first speaker",
                speaker,
            )
            return 0

    def ids_to_audio(
        self,
        phoneme_ids: typing.Sequence[int],
        speaker: typing.Optional[SPEAKER] = None,
        length_scale: typing.Optional[float] = None,
        noise_scale: typing.Optional[float] = None,
        noise_w: typing.Optional[float] = None,
        rate: float = DEFAULT_RATE,
        seed: typing.Optional[int] = None,
    ) -> np.ndarray:
        """Phoneme ids -> peak-normalized int16 waveform."""
        inference = self.config.inference
        if length_scale is None:
            length_scale = inference.length_scale
        if rate > 0:
            length_scale /= rate
        if noise_scale is None:
            noise_scale = inference.noise_scale
        if noise_w is None:
            noise_w = inference.noise_w

        speaker_id = self.resolve_speaker_id(speaker)
        _LOGGER.debug(
            "TTS settings: speaker-id=%s length-scale=%s "
            "noise-scale=%s noise-w=%s",
            speaker_id, length_scale, noise_scale, noise_w,
        )
        audio = self.session.synthesize_ids(
            phoneme_ids,
            speaker_id=speaker_id,
            length_scale=float(length_scale),
            noise_scale=float(noise_scale),
            noise_w=float(noise_w),
            seed=seed,
        )
        return audio_float_to_int16(audio)


def load_from_directory(
    voice_dir: typing.Union[str, Path],
    *,
    share_sessions: bool = True,
    deterministic: bool = False,
    seed: int = 0,
    device: typing.Union[str, torch.device, None] = None,
    dp: typing.Optional[int] = None,
) -> "VitsVoice":
    """Load a voice directory (Mimic 3 voice layout) onto a torch session
    on ``device`` (the card by default; runtime/session.py
    ``resolve_device``).

    ``dp`` > 1 serves the voice data parallel over that many devices of
    ``device``'s type: the visible cards ``cuda:0..dp-1`` (raising when
    fewer are visible), or ``dp`` replicas on the CPU.  ``dp=-1`` uses
    every visible card.  Default from ``$MIMIC3_DP`` (unset/0/1 = one
    device).
    """
    import os

    voice_dir = Path(voice_dir)
    _LOGGER.debug("Loading voice from %s", voice_dir)

    config = TrainingConfig.load_path(voice_dir / "config.json")

    with open(voice_dir / "phonemes.txt", "r", encoding="utf-8") as ids_file:
        phoneme_to_id = load_phoneme_ids(ids_file)

    if dp is None:
        dp = int(os.environ.get("MIMIC3_DP", "0") or 0)

    def make_session() -> TorchVitsSession:
        mesh = None
        if dp and dp != 1:
            from ..parallel import make_mesh

            platform = torch.device(device or "cuda").type
            mesh = make_mesh(
                n_devices=None if dp == -1 else dp, platform=platform
            )
            _LOGGER.info(
                "Serving %s data-parallel over %d %s device(s)",
                voice_dir.name, mesh.shape["dp"], platform,
            )
        return TorchVitsSession(
            config,
            _load_voice_params(voice_dir),
            deterministic=deterministic,
            seed=seed,
            device=device if mesh is None else None,
            mesh=mesh,
        )

    if share_sessions:
        key = (
            str((voice_dir / "generator").absolute())
            + (":det" if deterministic else "")
            + (f":{device}" if device else "")
            + (f":dp{dp}" if dp and dp != 1 else "")
        )
        session = TorchVitsSession.get_shared(key, make_session)
    else:
        session = make_session()

    phoneme_map = None
    pm_path = voice_dir / "phoneme_map.txt"
    if pm_path.is_file():
        with open(pm_path, "r", encoding="utf-8") as f:
            phoneme_map = load_phoneme_map(f)

    speaker_map = None
    sm_path = voice_dir / "speaker_map.csv"
    if sm_path.is_file():
        speaker_map = {}
        with open(sm_path, "r", encoding="utf-8") as f:
            # id | dataset | name | [alias...]
            for row in csv.reader(f, delimiter="|"):
                if not row:
                    continue
                sid = int(row[0])
                for alias in row[2:]:
                    speaker_map[alias] = sid

    cls = _VOICE_CLASSES.get(config.phonemizer)
    if cls is None:
        raise ValueError(f"Unsupported phonemizer: {config.phonemizer}")
    if cls is EspeakVoice and config.text_language == "fa":
        # hazm is strongly recommended for Persian (reference:
        # mimic3_tts/voice.py:337-346); fall back silently without it
        try:
            import hazm  # noqa: F401

            cls = HazmEspeakVoice
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
        speaker_map=speaker_map,
        location=voice_dir,
    )


def _load_voice_params(voice_dir: Path):
    """Load weights: prefer the converted npz; convert ONNX on first use
    (written beside it, or in memory when the directory is read-only)."""
    from .convert import (
        convert_voice_directory,
        load_pytree_npz,
        onnx_to_pytree,
    )

    npz_path = voice_dir / "generator.npz"
    if npz_path.is_file():
        return load_pytree_npz(npz_path)
    onnx_path = voice_dir / "generator.onnx"
    if onnx_path.is_file():
        try:
            convert_voice_directory(voice_dir)
            return load_pytree_npz(npz_path)
        except OSError:
            _LOGGER.warning(
                "Voice dir %s not writable; converting in memory", voice_dir
            )
            # real torch.onnx.export files have anonymized initializer
            # names that are only recoverable against the voice's
            # architecture, so pass its model config as the file would
            model_config = None
            config_path = voice_dir / "config.json"
            if config_path.is_file():
                model_config = TrainingConfig.load_path(config_path).model
            return onnx_to_pytree(onnx_path, model_config=model_config)
    raise FileNotFoundError(
        f"No generator.npz or generator.onnx in {voice_dir}"
    )


# ---------------------------------------------------------------------------
# Phonemizer-specific voices
# ---------------------------------------------------------------------------


def _split_on_breaks(
    all_word_phonemes: WORD_PHONEMES,
    minor_break: typing.Optional[str],
    major_break: typing.Optional[str],
    trailing_break: BreakType = BreakType.NONE,
) -> TEXT_TO_PHONEMES_RESULT:
    """Yield sentence chunks split at clause-break phonemes
    (reference behavior: mimic3_tts/voice.py:510-533)."""
    if not (minor_break or major_break):
        yield all_word_phonemes, BreakType.UTTERANCE
        return
    sent: WORD_PHONEMES = []
    for wp in all_word_phonemes:
        if not wp:
            continue
        sent.append(wp)
        if minor_break and wp[-1] == minor_break:
            yield sent, BreakType.MINOR
            sent = []
        elif major_break and wp[-1] == major_break:
            yield sent, BreakType.MAJOR
            sent = []
    if sent:
        yield sent, trailing_break


class EspeakVoice(VitsVoice):
    """espeak-ng phonemization (reference: mimic3_tts/voice.py:480-598)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from ..text.espeak import EspeakPhonemizer

        self._phonemizer = EspeakPhonemizer()

    def text_to_phonemes(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> TEXT_TO_PHONEMES_RESULT:
        from ..text.espeak import language_to_espeak_voice

        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        word_separator = self.config.phonemes.word_separator
        phoneme_str = self._phonemizer.phonemize(
            text,
            voice=language_to_espeak_voice(language),
            keep_clause_breakers=True,
            phoneme_separator="",
            word_separator=word_separator,
            punctuation_separator="",
        )
        all_word_phonemes = [
            list(IPA.graphemes(wp))
            for wp in phoneme_str.split(word_separator)
        ]
        yield from _split_on_breaks(
            all_word_phonemes,
            self.config.phonemes.minor_break,
            self.config.phonemes.major_break,
        )

    def word_to_phonemes(
        self,
        word_text: str,
        word_role: typing.Optional[str] = None,
        text_language: typing.Optional[str] = None,
    ) -> typing.List[PHONEME]:
        """SSML ``<w role>`` via espeak's own SSML mode
        (reference: mimic3_tts/voice.py:535-561)."""
        from xml.sax.saxutils import escape

        from ..text.espeak import language_to_espeak_voice

        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        role = (
            escape(word_role, {'"': "&quot;"}) if word_role else ""
        )
        phoneme_str = self._phonemizer.phonemize(
            f'<w role="{role}">{escape(word_text)}</w>',
            voice=language_to_espeak_voice(language),
            keep_clause_breakers=True,
            phoneme_separator="",
            punctuation_separator="",
            ssml=True,
        )
        return list(IPA.graphemes(phoneme_str))

    def say_as_to_phonemes(
        self,
        text: str,
        interpret_as: str,
        say_format: typing.Optional[str] = None,
        text_language: typing.Optional[str] = None,
    ) -> WORD_PHONEMES:
        """SSML ``<say-as>`` via espeak's own SSML mode
        (reference: mimic3_tts/voice.py:563-595)."""
        from xml.sax.saxutils import escape

        from ..text.espeak import language_to_espeak_voice

        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        word_separator = self.config.phonemes.word_separator
        fmt = (
            f'format="{escape(say_format, {chr(34): "&quot;"})}"'
            if say_format
            else ""
        )
        phoneme_str = self._phonemizer.phonemize(
            f'<say-as interpret-as='
            f'"{escape(interpret_as, {chr(34): "&quot;"})}" {fmt}>'
            f"{escape(text)}</say-as>",
            voice=language_to_espeak_voice(language),
            keep_clause_breakers=True,
            phoneme_separator="",
            punctuation_separator="",
            word_separator=word_separator,
            ssml=True,
        )
        return [
            list(IPA.graphemes(wp))
            for wp in phoneme_str.split(word_separator)
        ]


class HazmEspeakVoice(EspeakVoice):
    """Persian espeak voice with hazm text normalization/POS tagging
    (reference: mimic3_tts/voice.py:601-701).  Requires the optional
    ``hazm`` package; Ezafe markers are restored from POS tags before
    phonemization."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import gruut_lang_fa  # gated optional deps
        import hazm

        self._normalizer = hazm.Normalizer()
        self._sent_tokenizer = hazm.SentenceTokenizer()
        self._word_tokenizer = hazm.WordTokenizer()
        self._tagger = hazm.POSTagger(
            model=str(
                gruut_lang_fa.get_lang_dir() / "pos" / "postagger.model"
            )
        )

    def _fix_words(self, words):
        fixed = []
        for word, pos in self._tagger.tag(words):
            if word and pos and pos[-1] == "e":  # Ezafe construction
                if word[-1] != "ِ":
                    if word[-1] == "ه" and (
                        len(word) < 2 or word[-2] != "ا"
                    ):
                        word += "‌ی"
                    word += "ِ"
            fixed.append(word)
        return fixed

    def _preprocess(self, text: str):
        text = self._normalizer.normalize(text)
        return [
            self._fix_words(self._word_tokenizer.tokenize(sentence))
            for sentence in self._sent_tokenizer.tokenize(text)
        ]

    def text_to_phonemes(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> TEXT_TO_PHONEMES_RESULT:
        from ..text.espeak import language_to_espeak_voice

        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        word_separator = self.config.phonemes.word_separator
        for words in self._preprocess(text):
            phoneme_str = self._phonemizer.phonemize(
                " ".join(words),
                voice=language_to_espeak_voice(language),
                keep_clause_breakers=True,
                phoneme_separator="",
                word_separator=word_separator,
                punctuation_separator="",
            )
            sent_word_phonemes = [
                list(IPA.graphemes(wp))
                for wp in phoneme_str.split(word_separator)
            ]
            yield sent_word_phonemes, BreakType.UTTERANCE

    def word_to_phonemes(self, word_text, word_role=None,
                         text_language=None):
        word_text = self._fix_words([word_text])[0]
        return super().word_to_phonemes(
            word_text, word_role=word_role, text_language=text_language
        )


class SymbolsVoice(VitsVoice):
    """Characters-as-phonemes (reference: mimic3_tts/voice.py:707-717)."""

    def text_to_phonemes(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> TEXT_TO_PHONEMES_RESULT:
        word_separator = self.config.phonemes.word_separator
        word_phonemes = [
            list(IPA.graphemes(wp)) for wp in text.split(word_separator)
        ]
        yield word_phonemes, BreakType.UTTERANCE


class GruutVoice(VitsVoice):
    """gruut phonemization (reference: mimic3_tts/voice.py:413-474).
    Requires the optional ``gruut`` package."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import gruut  # gated optional dependency

        self._gruut = gruut

    def text_to_phonemes(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> TEXT_TO_PHONEMES_RESULT:
        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        for sentence in self._gruut.sentences(text, lang=language):
            sent_phonemes = [w.phonemes for w in sentence if w.phonemes]
            if sent_phonemes:
                yield sent_phonemes, BreakType.UTTERANCE

    def word_to_phonemes(
        self,
        word_text: str,
        word_role: typing.Optional[str] = None,
        text_language: typing.Optional[str] = None,
    ) -> typing.List[PHONEME]:
        from xml.sax.saxutils import escape

        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        role_attr = (
            f' role="{escape(word_role, {chr(34): "&quot;"})}"'
            if word_role
            else ""
        )
        ssml = f"<w{role_attr}>{escape(word_text)}</w>"
        sentence = next(
            iter(self._gruut.sentences(ssml, ssml=True, lang=language))
        )
        word = next(iter(sentence))
        return word.phonemes

    def say_as_to_phonemes(
        self,
        text: str,
        interpret_as: str,
        say_format: typing.Optional[str] = None,
        text_language: typing.Optional[str] = None,
    ) -> WORD_PHONEMES:
        from xml.sax.saxutils import escape

        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        fmt = (
            f' format="{escape(say_format, {chr(34): "&quot;"})}"'
            if say_format
            else ""
        )
        ssml = (
            f"<say-as interpret-as="
            f'"{escape(interpret_as, {chr(34): "&quot;"})}"{fmt}>'
            f"{escape(text)}</say-as>"
        )
        out: WORD_PHONEMES = []
        for sentence in self._gruut.sentences(ssml, ssml=True, lang=language):
            out.extend(w.phonemes for w in sentence if w.phonemes)
        return out


class EpitranVoice(VitsVoice):
    """epitran transliteration (reference: mimic3_tts/voice.py:723-774).
    Requires the optional ``epitran`` package."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        import epitran  # gated optional dependency

        self._epitran = epitran
        self._epis: typing.Dict[str, typing.Any] = {}

    def text_to_phonemes(
        self, text: str, text_language: typing.Optional[str] = None
    ) -> TEXT_TO_PHONEMES_RESULT:
        language = (
            text_language or self.config.text_language or DEFAULT_LANGUAGE
        )
        epi = self._epis.get(language)
        if epi is None:
            epi = self._epitran.Epitran(language)
            self._epis[language] = epi
        phoneme_str = epi.transliterate(text)
        splitter = (
            to_codepoints
            if self.config.phonemes.break_phonemes_into_codepoints
            else IPA.graphemes
        )
        all_word_phonemes = [
            list(splitter(wp)) for wp in phoneme_str.split()
        ]
        yield from _split_on_breaks(
            all_word_phonemes,
            self.config.phonemes.minor_break,
            self.config.phonemes.major_break,
            trailing_break=BreakType.MAJOR,
        )


_VOICE_CLASSES: typing.Dict[typing.Optional[Phonemizer], type] = {
    Phonemizer.ESPEAK: EspeakVoice,
    Phonemizer.SYMBOLS: SymbolsVoice,
    Phonemizer.GRUUT: GruutVoice,
    Phonemizer.EPITRAN: EpitranVoice,
}
