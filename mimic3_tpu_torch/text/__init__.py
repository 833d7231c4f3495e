"""Host-side text front end: IPA utilities, phoneme-id encoding, phonemizers.

Phonemization is CPU work (espeak-ng is a C library; gruut is lexicon
lookups) and stays on the host; only phoneme-id arrays cross to the TPU.

Port copy of ``mimic3_tpu/text/__init__.py``.
"""

from .ipa import IPA  # noqa: F401
from .phonemes2ids import (  # noqa: F401
    load_phoneme_ids,
    load_phoneme_map,
    phonemes2ids,
)
