"""ctypes binding to espeak-ng for IPA phonemization.

The reference depends on the ``espeak_phonemizer`` package wrapping
libespeak-ng (reference: mimic3_tts/voice.py:480-598).  This is a direct
ctypes binding with the same observable behavior:

- IPA phonemes, words separated by a configurable separator,
- clause punctuation (``,.;:!?``) kept as trailing pseudo-phonemes when
  ``keep_clause_breakers=True`` (the VITS voices are trained with them).

Phonemization runs on the host CPU; availability is gated so the rest of
the framework works on machines without libespeak-ng.

Port copy of ``mimic3_tpu/text/espeak.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import re
import threading
import typing

# exactly the reference phonemizer's set — a superset would append
# pseudo-phonemes the voices were never trained with
_CLAUSE_BREAKERS = frozenset(",.;:!?")

# espeak language-switch markers like "(en)"/"(fr)" that leak into the
# phoneme stream when the engine changes language mid-text; stripped by
# default like the reference phonemizer
_LANG_SWITCH_RE = re.compile(r"\([^)]*\)")

# espeak-ng constants
_AUDIO_OUTPUT_SYNCHRONOUS = 0x02
_ESPEAKNG_PHONEMES_IPA = 0x02
_ESPEAK_CHARS_AUTO = 0
_ESPEAK_SSML = 0x10

_LIB_NAMES = (
    "espeak-ng",
    "libespeak-ng.so.1",
    "libespeak-ng.so",
    "libespeak.so.1",
)


class EspeakError(RuntimeError):
    pass


class EspeakPhonemizer:
    """Text -> IPA phoneme string via libespeak-ng.

    Thread-safety: libespeak-ng is a global-state C library; all calls are
    serialized behind a class-level lock (one phonemizer per process).
    """

    _lib: typing.ClassVar[typing.Optional[ctypes.CDLL]] = None
    _lock: typing.ClassVar[threading.Lock] = threading.Lock()
    _initialized: typing.ClassVar[bool] = False
    _current_voice: typing.ClassVar[typing.Optional[str]] = None

    @classmethod
    def _load(cls) -> ctypes.CDLL:
        if cls._lib is not None:
            return cls._lib
        last_err: typing.Optional[Exception] = None
        for name in _LIB_NAMES:
            path = ctypes.util.find_library(name) or name
            try:
                cls._lib = ctypes.CDLL(path)
                break
            except OSError as e:
                last_err = e
        if cls._lib is None:
            raise EspeakError(
                f"libespeak-ng not found (tried {_LIB_NAMES}): {last_err}"
            )
        lib = cls._lib
        lib.espeak_Initialize.restype = ctypes.c_int
        lib.espeak_Initialize.argtypes = [
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_int,
        ]
        lib.espeak_SetVoiceByName.restype = ctypes.c_int
        lib.espeak_SetVoiceByName.argtypes = [ctypes.c_char_p]
        lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        lib.espeak_TextToPhonemes.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int,
            ctypes.c_int,
        ]
        return lib

    @classmethod
    def is_available(cls) -> bool:
        try:
            cls._load()
            return True
        except EspeakError:
            return False

    def _ensure_init(self) -> None:
        cls = type(self)
        if not cls._initialized:
            lib = cls._load()
            rate = lib.espeak_Initialize(
                _AUDIO_OUTPUT_SYNCHRONOUS, 0, None, 0
            )
            if rate <= 0:
                raise EspeakError("espeak_Initialize failed")
            cls._initialized = True

    def phonemize(
        self,
        text: str,
        voice: str = "en-us",
        keep_clause_breakers: bool = True,
        phoneme_separator: str = "",
        word_separator: str = " ",
        punctuation_separator: str = "",
        ssml: bool = False,
        keep_language_flags: bool = False,
    ) -> str:
        """Phonemize ``text``; words joined by ``word_separator``.

        ``ssml=True`` passes espeak's SSML text mode (the reference
        voice layer uses it for ``<w role>`` / ``<say-as>`` wrapping).
        """
        # clause breakers are collected from the INPUT text in order
        # and paired with clause lines by index — the reference
        # phonemizer's exact (quirky) behavior: a '.' inside "3.50"
        # consumes a slot, so replicating it is what keeps phoneme ids
        # identical to what the voices were trained with
        breakers: typing.List[str] = (
            [c for c in text if c in _CLAUSE_BREAKERS]
            if (keep_clause_breakers and text)
            else []
        )
        cls = type(self)
        with cls._lock:
            self._ensure_init()
            lib = cls._load()
            if cls._current_voice != voice:
                if lib.espeak_SetVoiceByName(voice.encode()) != 0:
                    raise EspeakError(f"Unknown espeak voice: {voice}")
                cls._current_voice = voice

            utf8 = text.encode("utf-8")
            buf = ctypes.create_string_buffer(utf8)
            ptr = ctypes.c_void_p(ctypes.addressof(buf))
            text_ptr = ctypes.pointer(ptr)
            base = ctypes.addressof(buf)

            # IPA mode; separator codepoint in bits 8+ (0 = none)
            sep_code = ord(phoneme_separator) if phoneme_separator else 0
            mode = _ESPEAKNG_PHONEMES_IPA | (sep_code << 8)
            textmode = _ESPEAK_CHARS_AUTO | (
                _ESPEAK_SSML if ssml else 0
            )

            lines: typing.List[str] = []
            while text_ptr.contents.value:
                result = lib.espeak_TextToPhonemes(
                    text_ptr, textmode, mode
                )
                after = (
                    (text_ptr.contents.value - base)
                    if text_ptr.contents.value
                    else len(utf8)
                )
                decoded = (
                    result.decode("utf-8", errors="replace")
                    if result
                    else ""
                )
                for line in decoded.splitlines() or [""]:
                    if not keep_language_flags:
                        line = _LANG_SWITCH_RE.sub("", line)
                    lines.append(line.strip())
                if after >= len(utf8):
                    break

        # pair the i-th clause line with the i-th collected breaker;
        # an empty clause (punctuation-only input) keeps its breaker
        # as the whole line so the pseudo-phoneme is never dropped
        for i in range(min(len(lines), len(breakers))):
            if lines[i]:
                lines[i] = (
                    lines[i] + punctuation_separator + breakers[i]
                )
            else:
                lines[i] = breakers[i]
        joined = " ".join(line for line in lines if line)
        if word_separator != " ":
            joined = joined.replace(" ", word_separator)
        return joined


def language_to_espeak_voice(language: str) -> str:
    """``en_US`` -> ``en-us`` (reference: mimic3_tts/voice.py:595-598)."""
    return language.strip().lower().replace("_", "-")
