"""IPA string utilities: grapheme clustering, stress/break symbols.

A self-contained replacement for the small slice of ``gruut_ipa`` the
reference uses (``IPA.graphemes``, ``IPA.BREAK_MINOR``, ``IPA.BREAK_MAJOR``;
see reference mimic3_tts/voice.py:33,507 and mimic3_tts/config.py:173-174).

Grapheme clustering rule: the string is NFD-normalized and split before
every non-combining codepoint, so each cluster is one base codepoint plus
its trailing combining marks.  Modifier letters (length marks, stress) are
non-combining and therefore form their own clusters — matching the
phoneme inventories (``phonemes.txt``) shipped with Mimic 3 voices, which
list e.g. ``ː`` and ``ˈ`` as standalone symbols.

Port copy of ``mimic3_tpu/text/ipa.py``.
"""

from __future__ import annotations

import typing
import unicodedata


class IPA:
    """IPA symbol constants and helpers."""

    BREAK_MINOR = "|"  # U+007C — clause break (comma-like)
    BREAK_MAJOR = "‖"  # U+2016 — sentence break (period-like)
    BREAK_WORD = "#"

    STRESS_PRIMARY = "ˈ"  # U+02C8
    STRESS_SECONDARY = "ˌ"  # U+02CC

    ACCENT_ACUTE = "'"
    ACCENT_GRAVE = "²"

    # IPA tone letters U+02E5..U+02E9 plus Chao tone digits
    TONES = "˥˦˧˨˩"

    @staticmethod
    def is_stress(codepoint: str) -> bool:
        return codepoint in (IPA.STRESS_PRIMARY, IPA.STRESS_SECONDARY)

    @staticmethod
    def is_break(codepoint: str) -> bool:
        return codepoint in (IPA.BREAK_MINOR, IPA.BREAK_MAJOR, IPA.BREAK_WORD)

    @staticmethod
    def is_tone(codepoint: str) -> bool:
        # decimal digits (Nd) only, like the reference's \d regex —
        # isdigit() would also catch superscripts like '²', which are
        # accents, not tones, and would shift every later phoneme id
        return codepoint in IPA.TONES or codepoint.isdecimal()

    @staticmethod
    def graphemes(codepoints: str) -> typing.List[str]:
        """Split an IPA string into grapheme clusters.

        Each cluster is a non-combining codepoint followed by any combining
        marks (Unicode ``combining() > 0``).  Input is NFD-normalized first.
        """
        codepoints = unicodedata.normalize("NFD", codepoints)
        clusters: typing.List[str] = []
        cluster = ""
        for c in codepoints:
            if (unicodedata.combining(c) == 0) and cluster:
                clusters.append(cluster)
                cluster = ""
            cluster += c
        if cluster:
            clusters.append(cluster)
        return clusters


def split_tones(
    phoneme: str,
) -> typing.Tuple[str, typing.Optional[str]]:
    """Split trailing tone letters/digits off a phoneme.

    Returns ``(base, tone-or-None)``.
    """
    tone_chars: typing.List[str] = []
    base = phoneme
    while base and IPA.is_tone(base[-1]):
        tone_chars.insert(0, base[-1])
        base = base[:-1]
    if not tone_chars:
        return phoneme, None
    return base, "".join(tone_chars)
