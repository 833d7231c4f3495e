"""Language display names and sample sentences for the voices API.

The reference exposes ``language_native``/``language_english`` and a
``sample_text`` per voice in ``/api/voices``
(reference: mimic3_http/app.py:236-257).  Names below cover every
language in the voice registry; sample sentences are our own short
phrases (just UI seed text for the web page).

Port copy of ``mimic3_tpu/server/lang.py``.
"""

from __future__ import annotations

import typing

# language code -> (native name, english name)
LANG_NAMES: typing.Dict[str, typing.Tuple[str, str]] = {
    "af_ZA": ("Afrikaans", "Afrikaans"),
    "bn": ("বাংলা", "Bengali"),
    "de_DE": ("Deutsch", "German"),
    "el_GR": ("Ελληνικά", "Greek"),
    "en_UK": ("English", "English (UK)"),
    "en_US": ("English", "English (US)"),
    "es_ES": ("Español", "Spanish"),
    "fa": ("فارسی", "Persian"),
    "fi_FI": ("Suomi", "Finnish"),
    "fr_FR": ("Français", "French"),
    "gu_IN": ("ગુજરાતી", "Gujarati"),
    "ha_NE": ("Hausa", "Hausa"),
    "hu_HU": ("Magyar", "Hungarian"),
    "it_IT": ("Italiano", "Italian"),
    "jv_ID": ("Basa Jawa", "Javanese"),
    "ko_KO": ("한국어", "Korean"),
    "ne_NP": ("नेपाली", "Nepali"),
    "nl": ("Nederlands", "Dutch"),
    "pl_PL": ("Polski", "Polish"),
    "ru_RU": ("Русский", "Russian"),
    "sw": ("Kiswahili", "Swahili"),
    "te_IN": ("తెలుగు", "Telugu"),
    "tn_ZA": ("Setswana", "Tswana"),
    "uk_UK": ("Українська", "Ukrainian"),
    "vi_VN": ("Tiếng Việt", "Vietnamese"),
    "yo": ("Yorùbá", "Yoruba"),
}

# short language code -> demo sentence for the web UI
SAMPLE_SENTENCES: typing.Dict[str, str] = {
    "af": "Goeie môre, hoe gaan dit met jou vandag?",
    "bn": "শুভ সকাল, আজ আপনি কেমন আছেন?",
    "de": "Guten Morgen, wie geht es dir heute?",
    "el": "Καλημέρα, πώς είσαι σήμερα;",
    "en": "It took me quite a long time to develop a voice, "
    "and now that I have it I'm not going to be silent.",
    "es": "Buenos días, ¿cómo estás hoy?",
    "fa": "صبح بخیر، امروز حال شما چطور است؟",
    "fi": "Hyvää huomenta, mitä sinulle kuuluu tänään?",
    "fr": "Bonjour, comment allez-vous aujourd'hui ?",
    "gu": "સુપ્રભાત, આજે તમે કેમ છો?",
    "ha": "Ina kwana, yaya kake a yau?",
    "hu": "Jó reggelt, hogy vagy ma?",
    "it": "Buongiorno, come stai oggi?",
    "jv": "Sugeng enjing, piye kabarmu dina iki?",
    "ko": "좋은 아침입니다. 오늘 기분이 어떠세요?",
    "ne": "शुभ प्रभात, आज तपाईंलाई कस्तो छ?",
    "nl": "Goedemorgen, hoe gaat het vandaag met je?",
    "pl": "Dzień dobry, jak się dzisiaj masz?",
    "ru": "Доброе утро, как вы себя чувствуете сегодня?",
    "sw": "Habari za asubuhi, hali yako ikoje leo?",
    "te": "శుభోదయం, ఈరోజు మీరు ఎలా ఉన్నారు?",
    "tn": "Dumela, o tsogile jang gompieno?",
    "uk": "Доброго ранку, як ти сьогодні?",
    "vi": "Chào buổi sáng, hôm nay bạn thế nào?",
    "yo": "Ẹ káàárọ̀, báwo ni o ṣe wà lónìí?",
}


def language_names(language: str) -> typing.Tuple[str, str]:
    names = LANG_NAMES.get(language)
    if names is None:
        return language, language
    return names


def sample_sentence(language: str) -> str:
    short = language.split("_", maxsplit=1)[0]
    return SAMPLE_SENTENCES.get(short, "")
