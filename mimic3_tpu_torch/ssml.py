"""SSML engine: executes a W3C-SSML subset against any TextToSpeechSystem.

Behavior-compatible with the reference's SSML support
(reference: opentts_abc/ssml.py:120-716).  Supported tags:
``<speak> <s> <p> <w>/<token> <sub> <phoneme> <break> <mark> <voice>
<say-as> <lang> <prosody volume|rate> <metadata>``.

Design: a single pre-order walk of the XML tree emits (start, text, end)
events; small stacks track voice / language / prosody nesting so closing
a tag restores the outer context.  Results stream out of sentence
boundaries incrementally — a long document starts producing audio after
its first sentence.

Port copy of ``mimic3_tpu/ssml.py``.
"""

from __future__ import annotations

import logging
import re
import typing
import xml.etree.ElementTree as etree
from dataclasses import dataclass, field

from .api import BaseResult, Phonemes, SayAs, TextToSpeechSystem, Word

_LOGGER = logging.getLogger(__name__)

_NS_RE = re.compile(r"^\{[^}]+\}")

DEFAULT_VOLUME = 100.0
DEFAULT_RATE = 1.0

VOLUME_NAMES: typing.Dict[str, float] = {
    "default": DEFAULT_VOLUME,
    "x-loud": DEFAULT_VOLUME,
    "loud": DEFAULT_VOLUME * 0.8,
    "medium": DEFAULT_VOLUME * 0.5,
    "soft": DEFAULT_VOLUME * 0.3,
    "x-soft": DEFAULT_VOLUME * 0.1,
    "silent": 0.0,
}

RATE_NAMES: typing.Dict[str, float] = {
    "default": DEFAULT_RATE,
    "x-fast": DEFAULT_RATE * 3,
    "fast": DEFAULT_RATE * 2,
    "medium": DEFAULT_RATE,
    "slow": DEFAULT_RATE * 0.5,
    "x-slow": DEFAULT_RATE * 0.25,
}


def _strip_ns(tag: str) -> str:
    return _NS_RE.sub("", tag)


def _attr(
    element: etree.Element, name: str, default: typing.Any = None
) -> typing.Any:
    for key, value in element.attrib.items():
        if _strip_ns(key) == name:
            return value
    return default


@dataclass
class _Prosody:
    volume: float = DEFAULT_VOLUME
    rate: float = DEFAULT_RATE


@dataclass
class SSMLSettings:
    """Named-constant maps for <prosody> values."""

    volume_map: typing.Mapping[str, float] = field(
        default_factory=lambda: dict(VOLUME_NAMES)
    )
    rate_map: typing.Mapping[str, float] = field(
        default_factory=lambda: dict(RATE_NAMES)
    )


class _End:
    """Marker for the end of an element during the tree walk."""

    __slots__ = ("element",)

    def __init__(self, element: etree.Element):
        self.element = element


def _walk(
    element: etree.Element,
) -> typing.Iterator[typing.Union[etree.Element, _End, str]]:
    """Pre-order walk yielding start elements, text chunks, and ends."""
    yield element
    if element.text and element.text.strip():
        yield element.text
    for child in element:
        yield from _walk(child)
    yield _End(element)
    if element.tail and element.tail.strip():
        yield element.tail


class SSMLSpeaker:
    """Drives a :class:`TextToSpeechSystem` from an SSML document."""

    def __init__(
        self,
        tts: TextToSpeechSystem,
        settings: typing.Optional[SSMLSettings] = None,
    ):
        self.tts = tts
        self.settings = settings or SSMLSettings()
        self._reset()

    def _reset(self) -> None:
        self._in_sentence = False
        self._in_metadata = 0
        self._word_elem: typing.Optional[etree.Element] = None
        self._sub_alias: typing.Optional[str] = None
        self._in_phoneme = False
        self._say_as: typing.Optional[typing.Tuple[str, str]] = None
        self._voice_stack: typing.List[str] = []
        self._lang_stack: typing.List[str] = []
        self._prosody_stack: typing.List[_Prosody] = []
        self._default_voice = self.tts.voice
        self._default_lang = self.tts.language

    # -- public ------------------------------------------------------------------

    def speak(
        self, ssml: typing.Union[str, etree.Element]
    ) -> typing.Iterable[BaseResult]:
        """Parse and speak an SSML document, yielding results per sentence."""
        if isinstance(ssml, etree.Element):
            root = ssml
        else:
            try:
                root = etree.fromstring(ssml)
            except etree.ParseError:
                # bare text / fragments: wrap in <speak>
                root = etree.fromstring(f"<speak>{ssml}</speak>")

        self._reset()

        for event in _walk(root):
            if isinstance(event, str):
                if not self._in_metadata:
                    self._on_text(event)
            elif isinstance(event, _End):
                yield from self._on_end(_strip_ns(event.element.tag))
            else:
                if not self._in_metadata:
                    yield from self._on_start(event)
                elif _strip_ns(event.tag) in ("metadata", "meta"):
                    self._in_metadata += 1

        if self._in_sentence:
            yield from self._end_sentence()

    # -- event handlers -------------------------------------------------------------

    def _on_start(
        self, elem: etree.Element
    ) -> typing.Iterable[BaseResult]:
        tag = _strip_ns(elem.tag)
        if tag == "s":
            self._begin_sentence()
        elif tag == "p":
            # paragraphs delimit sentences
            if self._in_sentence:
                yield from self._end_sentence()
        elif tag in ("w", "token"):
            self._word_elem = elem
        elif tag == "sub":
            self._sub_alias = _attr(elem, "alias", "")
        elif tag == "phoneme":
            self._ensure_sentence()
            self.tts.speak_tokens(
                [
                    Phonemes(
                        text=_attr(elem, "ph", ""),
                        alphabet=_attr(elem, "alphabet", ""),
                    )
                ]
            )
            self._in_phoneme = True
        elif tag == "break":
            time_ms = _parse_time_ms(_attr(elem, "time", ""))
            if time_ms > 0:
                self.tts.add_break(time_ms)
        elif tag == "mark":
            self.tts.set_mark(_attr(elem, "name", ""))
        elif tag == "voice":
            name = _attr(elem, "name", "")
            self._voice_stack.append(name)
            self.tts.voice = name
        elif tag == "say-as":
            self._say_as = (
                _attr(elem, "interpret-as", ""),
                _attr(elem, "format", ""),
            )
        elif tag == "lang":
            self._lang_stack.append(_attr(elem, "lang", ""))
        elif tag == "prosody":
            prosody = _Prosody(
                volume=self._prosody.volume, rate=self._prosody.rate
            )
            volume_str = _attr(elem, "volume")
            if volume_str is not None:
                prosody.volume = parse_volume(
                    volume_str,
                    current=prosody.volume,
                    volume_map=self.settings.volume_map,
                )
            rate_str = _attr(elem, "rate")
            if rate_str is not None:
                prosody.rate = parse_rate(
                    rate_str, rate_map=self.settings.rate_map
                )
            self._prosody_stack.append(prosody)
            self.tts.volume = prosody.volume
            self.tts.rate = prosody.rate
        elif tag in ("metadata", "meta"):
            self._in_metadata += 1
        else:
            _LOGGER.debug("Ignoring SSML tag <%s>", tag)
        return
        yield  # pragma: no cover — makes this a generator

    def _on_end(self, tag: str) -> typing.Iterable[BaseResult]:
        if self._in_metadata:
            if tag in ("metadata", "meta"):
                self._in_metadata -= 1
            return
        if tag == "s":
            yield from self._end_sentence()
        elif tag == "speak":
            if self._in_sentence:
                yield from self._end_sentence()
            else:
                yield from self.tts.end_utterance()
        elif tag in ("w", "token"):
            self._word_elem = None
        elif tag == "sub":
            self._sub_alias = None
        elif tag == "phoneme":
            self._in_phoneme = False
        elif tag == "voice":
            if self._voice_stack:
                self._voice_stack.pop()
            self.tts.voice = (
                self._voice_stack[-1]
                if self._voice_stack
                else self._default_voice
            )
        elif tag == "say-as":
            self._say_as = None
        elif tag == "lang":
            if self._lang_stack:
                self._lang_stack.pop()
        elif tag == "prosody":
            if self._prosody_stack:
                self._prosody_stack.pop()
            self.tts.volume = self._prosody.volume
            self.tts.rate = self._prosody.rate

    def _on_text(self, text: str) -> None:
        if self._in_phoneme:
            return  # spoken via the ph attribute already
        if self._sub_alias is not None:
            text = self._sub_alias
            self._sub_alias = None
        self._ensure_sentence()
        if self._word_elem is not None:
            self.tts.speak_tokens(
                [Word(text, role=_attr(self._word_elem, "role"))]
            )
        elif self._say_as is not None:
            interpret_as, say_format = self._say_as
            self.tts.speak_tokens(
                [
                    SayAs(
                        text=text,
                        interpret_as=interpret_as,
                        format=say_format or None,
                    )
                ]
            )
        else:
            self.tts.speak_text(text, text_language=self._lang)

    # -- helpers ------------------------------------------------------------------

    @property
    def _prosody(self) -> _Prosody:
        return self._prosody_stack[-1] if self._prosody_stack else _Prosody()

    @property
    def _lang(self) -> typing.Optional[str]:
        return self._lang_stack[-1] if self._lang_stack else None

    def _ensure_sentence(self) -> None:
        if not self._in_sentence:
            self._begin_sentence()

    def _begin_sentence(self) -> None:
        self._in_sentence = True
        self.tts.begin_utterance()

    def _end_sentence(self) -> typing.Iterable[BaseResult]:
        self._in_sentence = False
        yield from self.tts.end_utterance()


# ---------------------------------------------------------------------------
# Value parsing
# ---------------------------------------------------------------------------


def _parse_time_ms(time_str: str) -> int:
    """``200ms`` / ``1.5s`` -> milliseconds."""
    time_str = (time_str or "").strip()
    try:
        if time_str.endswith("ms"):
            return int(float(time_str[:-2]))
        if time_str.endswith("s"):
            return int(float(time_str[:-1]) * 1000)
    except ValueError:
        pass
    return 0


def parse_volume(
    volume_str: str,
    current: float = DEFAULT_VOLUME,
    volume_map: typing.Optional[typing.Mapping[str, float]] = None,
) -> float:
    """SSML <prosody volume>: names, absolute, +/- offsets, percents."""
    volume_map = volume_map or VOLUME_NAMES
    volume = current
    s = volume_str.strip().lower()
    named = volume_map.get(s)
    if named is not None:
        volume = named
    elif s:
        sign = 0
        if s[0] == "+":
            sign = 1
            s = s[1:]
        elif s[0] == "-":
            sign = -1
            s = s[1:]
        percent = s.endswith("%")
        if percent:
            s = s[:-1]
        try:
            value = float(s)
        except ValueError:
            return max(0.0, min(DEFAULT_VOLUME, volume))
        if percent:
            if sign:
                volume += sign * volume * (value / 100.0)
            else:
                volume = value
        elif sign:
            volume += sign * value
        else:
            volume = value
    return max(0.0, min(DEFAULT_VOLUME, volume))


def parse_rate(
    rate_str: str,
    rate_map: typing.Optional[typing.Mapping[str, float]] = None,
) -> float:
    """SSML <prosody rate>: names, absolute multipliers, percents."""
    rate_map = rate_map or RATE_NAMES
    s = rate_str.strip().lower()
    named = rate_map.get(s)
    if named is not None:
        return named
    if not s:
        return DEFAULT_RATE
    percent = s.endswith("%")
    if percent:
        s = s[:-1]
    try:
        value = float(s)
    except ValueError:
        return DEFAULT_RATE
    return value / 100.0 if percent else value
