"""Phoneme → id encoding.

A self-contained reimplementation of the ``phonemes2ids`` package the
reference depends on (called at reference mimic3_tts/voice.py:126-152 with
options from mimic3_tts/config.py:147-178).  These ids ARE the model input,
so the semantics here define the compatibility contract with trained
voices:

- optional per-phoneme mapping (``phoneme_map``),
- grapheme/tone separation,
- punctuation simplification (``;`` ``:`` → ``,``; ``?`` ``!`` → ``.``),
- blank-token insertion between words and/or tokens,
- optional BOS/EOS wrapping,
- silent skipping of unknown phonemes (``fail_on_missing=False``).

Port copy of ``mimic3_tpu/text/phonemes2ids.py``.
"""

from __future__ import annotations

import logging
import typing
from enum import Enum

from .ipa import IPA, split_tones

_LOGGER = logging.getLogger(__name__)

PHONEME = str
PHONEME_ID = int
WORD_PHONEMES = typing.List[typing.List[PHONEME]]


class BlankBetween(str, Enum):
    TOKENS = "tokens"
    WORDS = "words"
    TOKENS_AND_WORDS = "tokens_and_words"


DEFAULT_PUNCTUATION_MAP: typing.Dict[str, str] = {
    ";": ",",
    ":": ",",
    "?": ".",
    "!": ".",
}


def _split_keeping(
    phoneme: str, separators: typing.Sequence[str]
) -> typing.List[str]:
    """Split ``phoneme`` around every occurrence of any separator string,
    keeping the separators as their own tokens."""
    pieces = [phoneme]
    for sep in separators:
        if not sep:
            continue
        new_pieces: typing.List[str] = []
        for piece in pieces:
            if piece in separators:
                new_pieces.append(piece)
                continue
            while sep in piece:
                before, piece = piece.split(sep, 1)
                if before:
                    new_pieces.append(before)
                new_pieces.append(sep)
            if piece:
                new_pieces.append(piece)
        pieces = new_pieces
    return pieces


def phonemes2ids(
    word_phonemes: WORD_PHONEMES,
    phoneme_to_id: typing.Mapping[PHONEME, PHONEME_ID],
    pad: typing.Optional[str] = None,
    bos: typing.Optional[str] = None,
    eos: typing.Optional[str] = None,
    auto_bos_eos: bool = False,
    blank: typing.Optional[str] = None,
    blank_word: typing.Optional[str] = None,
    blank_between: typing.Union[str, BlankBetween] = BlankBetween.WORDS,
    blank_at_start: bool = True,
    blank_at_end: bool = True,
    simple_punctuation: bool = False,
    punctuation_map: typing.Optional[typing.Mapping[str, str]] = None,
    separate: typing.Optional[typing.Sequence[str]] = None,
    separate_graphemes: bool = False,
    separate_tones: bool = False,
    tone_before: bool = False,
    phoneme_map: typing.Optional[
        typing.Mapping[PHONEME, typing.Sequence[PHONEME]]
    ] = None,
    missing_func: typing.Optional[
        typing.Callable[[PHONEME], typing.Optional[typing.List[PHONEME_ID]]]
    ] = None,
    fail_on_missing: bool = False,
) -> typing.List[PHONEME_ID]:
    """Encode word phonemes (list of per-word phoneme lists) into model ids.

    ``pad`` is accepted for signature compatibility; it marks the padding
    symbol of the id table but is never inserted by the encoder itself.
    """
    del pad  # padding happens at batch-assembly time, not here

    if isinstance(blank_between, str):
        blank_between = BlankBetween(blank_between)

    # ------------------------------------------------------------------
    # 1) Per-phoneme text transforms
    # ------------------------------------------------------------------
    processed_words: WORD_PHONEMES = []
    for word in word_phonemes:
        out_word: typing.List[PHONEME] = []
        for phoneme in word:
            if not phoneme:
                continue

            sub_phonemes = [phoneme]

            if separate_graphemes:
                sub_phonemes = [
                    g for p in sub_phonemes for g in IPA.graphemes(p)
                ]

            if separate_tones:
                with_tones: typing.List[PHONEME] = []
                for p in sub_phonemes:
                    base, tone = split_tones(p)
                    if tone is None:
                        with_tones.append(p)
                    elif tone_before:
                        with_tones.extend((tone, base) if base else (tone,))
                    else:
                        with_tones.extend((base, tone) if base else (tone,))
                sub_phonemes = with_tones

            if separate:
                sub_phonemes = [
                    piece
                    for p in sub_phonemes
                    for piece in _split_keeping(p, list(separate))
                ]

            if phoneme_map:
                mapped: typing.List[PHONEME] = []
                for p in sub_phonemes:
                    to_p = phoneme_map.get(p)
                    if to_p is None:
                        mapped.append(p)
                    elif isinstance(to_p, str):
                        mapped.extend(to_p.split())
                    else:
                        mapped.extend(to_p)
                sub_phonemes = mapped

            if simple_punctuation:
                pmap = punctuation_map or DEFAULT_PUNCTUATION_MAP
                sub_phonemes = [pmap.get(p, p) for p in sub_phonemes]

            out_word.extend(p for p in sub_phonemes if p)

        if out_word:
            processed_words.append(out_word)

    # ------------------------------------------------------------------
    # 2) Ids with blank insertion
    # ------------------------------------------------------------------
    def to_id(phoneme: PHONEME) -> typing.Optional[typing.List[PHONEME_ID]]:
        maybe_id = phoneme_to_id.get(phoneme)
        if maybe_id is not None:
            return [maybe_id]
        if fail_on_missing:
            raise ValueError(f"Missing phoneme from id map: {phoneme!r}")
        if missing_func is not None:
            return missing_func(phoneme)
        _LOGGER.debug("Dropped missing phoneme: %r", phoneme)
        return None

    blank_id = phoneme_to_id.get(blank) if blank is not None else None
    blank_word_id = (
        phoneme_to_id.get(blank_word) if blank_word is not None else None
    )

    ids: typing.List[PHONEME_ID] = []

    word_ids: typing.List[typing.List[PHONEME_ID]] = []
    for word in processed_words:
        this_word: typing.List[PHONEME_ID] = []
        for phoneme in word:
            maybe_ids = to_id(phoneme)
            if maybe_ids:
                this_word.extend(maybe_ids)
        if this_word:
            word_ids.append(this_word)

    if blank_id is not None and blank_between == BlankBetween.TOKENS:
        # blank between every token (word boundaries are not special)
        tokens = [t for w in word_ids for t in w]
        if blank_at_start:
            ids.append(blank_id)
        for i, t in enumerate(tokens):
            ids.append(t)
            if (i < len(tokens) - 1) or blank_at_end:
                ids.append(blank_id)
    elif blank_id is not None and blank_between == BlankBetween.TOKENS_AND_WORDS:
        # blank between tokens, blank_word (or blank) between words
        word_sep_id = blank_word_id if blank_word_id is not None else blank_id
        if blank_at_start:
            ids.append(blank_id)
        for wi, w in enumerate(word_ids):
            for ti, t in enumerate(w):
                ids.append(t)
                if ti < len(w) - 1:
                    ids.append(blank_id)
            if wi < len(word_ids) - 1:
                ids.append(word_sep_id)
        if blank_at_end and word_ids:
            ids.append(blank_id)
    elif blank_id is not None:
        # BlankBetween.WORDS: blank between words only
        if blank_at_start:
            ids.append(blank_id)
        for wi, w in enumerate(word_ids):
            ids.extend(w)
            if (wi < len(word_ids) - 1) or blank_at_end:
                ids.append(blank_id)
    else:
        for w in word_ids:
            ids.extend(w)

    # ------------------------------------------------------------------
    # 3) BOS/EOS
    # ------------------------------------------------------------------
    if auto_bos_eos:
        if bos is not None:
            bos_id = phoneme_to_id.get(bos)
            if bos_id is not None and (not ids or ids[0] != bos_id):
                ids.insert(0, bos_id)
        if eos is not None:
            eos_id = phoneme_to_id.get(eos)
            if eos_id is not None and (not ids or ids[-1] != eos_id):
                ids.append(eos_id)

    return ids


# ---------------------------------------------------------------------------
# File formats
# ---------------------------------------------------------------------------


def load_phoneme_ids(
    phonemes_file: typing.Iterable[str],
) -> typing.Dict[PHONEME, PHONEME_ID]:
    """Load a ``phonemes.txt`` id table.

    Format: one ``<id> <phoneme>`` pair per line; the phoneme may itself be
    a space character, so only the trailing newline is stripped.  Lines that
    are empty or start with ``#`` at column 0 are comments (real entries
    start with a numeric id).
    """
    phoneme_to_id: typing.Dict[PHONEME, PHONEME_ID] = {}
    for line in phonemes_file:
        line = line.rstrip("\r\n")
        if (not line) or line.startswith("#") or " " not in line:
            # skip blanks/comments AND malformed lines (e.g. a
            # truncated trailing id) like the reference loader does,
            # instead of aborting the whole voice load
            continue
        id_str, phoneme = line.split(" ", maxsplit=1)
        phoneme_to_id[phoneme] = int(id_str)
    return phoneme_to_id


def load_phoneme_map(
    map_file: typing.Iterable[str],
) -> typing.Dict[PHONEME, typing.List[PHONEME]]:
    """Load a ``phoneme_map.txt`` file: ``<from> <to> [<to> ...]`` per line."""
    phoneme_map: typing.Dict[PHONEME, typing.List[PHONEME]] = {}
    for line in map_file:
        line = line.strip()
        if (not line) or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) >= 2:
            phoneme_map[parts[0]] = parts[1:]
    return phoneme_map
