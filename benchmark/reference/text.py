"""Text to phoneme ids for a ``symbols`` voice, from its own files.

The Mimic 3 ``symbols`` phonemizer takes each character of a word as a
phoneme; ``phonemes.txt`` maps each to an id (``<id> <symbol>`` per
line, the symbol may be a space).  The ids are those of
``phonemes2ids`` with the voice's ``phonemes`` settings: words split on
the word separator, punctuation simplified, unknown symbols dropped, a
blank between words and at both ends, then BOS and EOS.  Only the
settings a benchmark voice uses are implemented; any other raises.
"""

from __future__ import annotations

import typing
from pathlib import Path

_SIMPLE_PUNCTUATION = {";": ",", ":": ",", "?": ".", "!": "."}


def load_table(path: typing.Union[str, Path]) -> typing.Dict[str, int]:
    table: typing.Dict[str, int] = {}
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        if not line or line.startswith("#") or " " not in line:
            continue
        id_str, symbol = line.split(" ", 1)
        table[symbol] = int(id_str)
    return table


def text_to_ids(text: str, table: typing.Mapping[str, int],
                phonemes: typing.Mapping[str, typing.Any]) -> typing.List[int]:
    """Ids of one utterance of ``text`` for a voice whose ``config.json``
    has the ``phonemes`` section given."""
    if (phonemes.get("blank_between", "words") != "words"
            or phonemes.get("phoneme_map") or phonemes.get("separate")
            or phonemes.get("separate_tones")
            or phonemes.get("punctuation_map")):
        raise ValueError("phonemes settings outside the reference's subset")
    if not text.isascii():
        raise ValueError("the reference takes ASCII text only (one "
                         "grapheme per character)")
    words = []
    for word in text.split(phonemes.get("word_separator", "#")):
        symbols = list(word)
        if phonemes.get("simple_punctuation", False):
            symbols = [_SIMPLE_PUNCTUATION.get(s, s) for s in symbols]
        ids = [table[s] for s in symbols if s in table]
        if ids:
            words.append(ids)
    blank = table.get(phonemes.get("blank") or "")
    out: typing.List[int] = []
    if blank is None:
        for w in words:
            out += w
    else:
        if phonemes.get("blank_at_start", True):
            out.append(blank)
        for i, w in enumerate(words):
            out += w
            if i < len(words) - 1 or phonemes.get("blank_at_end", True):
                out.append(blank)
    if phonemes.get("auto_bos_eos", False):
        bos = table.get(phonemes.get("bos") or "")
        eos = table.get(phonemes.get("eos") or "")
        if bos is not None and (not out or out[0] != bos):
            out.insert(0, bos)
        if eos is not None and (not out or out[-1] != eos):
            out.append(eos)
    return out
