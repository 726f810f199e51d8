"""Whisper language inventory.

The code→name table is the public OpenAI Whisper language list (also at
reference whisperx/utils.py:8-127). **Order matters**: language token ids are
assigned in this order (sot+1+index), so this tuple is the single source of
truth for both the tokenizer and the writers.
"""

# fmt: off
LANGUAGE_CODES = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)

LANGUAGE_NAMES = (
    "english", "chinese", "german", "spanish", "russian", "korean", "french",
    "japanese", "portuguese", "turkish", "polish", "catalan", "dutch",
    "arabic", "swedish", "italian", "indonesian", "hindi", "finnish",
    "vietnamese", "hebrew", "ukrainian", "greek", "malay", "czech",
    "romanian", "danish", "hungarian", "tamil", "norwegian", "thai", "urdu",
    "croatian", "bulgarian", "lithuanian", "latin", "maori", "malayalam",
    "welsh", "slovak", "telugu", "persian", "latvian", "bengali", "serbian",
    "azerbaijani", "slovenian", "kannada", "estonian", "macedonian",
    "breton", "basque", "icelandic", "armenian", "nepali", "mongolian",
    "bosnian", "kazakh", "albanian", "swahili", "galician", "marathi",
    "punjabi", "sinhala", "khmer", "shona", "yoruba", "somali", "afrikaans",
    "occitan", "georgian", "belarusian", "tajik", "sindhi", "gujarati",
    "amharic", "yiddish", "lao", "uzbek", "faroese", "haitian creole",
    "pashto", "turkmen", "nynorsk", "maltese", "sanskrit", "luxembourgish",
    "myanmar", "tibetan", "tagalog", "malagasy", "assamese", "tatar",
    "hawaiian", "lingala", "hausa", "bashkir", "javanese", "sundanese",
    "cantonese",
)
# fmt: on

LANGUAGES = dict(zip(LANGUAGE_CODES, LANGUAGE_NAMES))

_ALIASES = {
    "burmese": "my",
    "valencian": "ca",
    "flemish": "nl",
    "haitian": "ht",
    "letzeburgesch": "lb",
    "pushto": "ps",
    "panjabi": "pa",
    "moldavian": "ro",
    "moldovan": "ro",
    "sinhalese": "si",
    "castilian": "es",
    "mandarin": "zh",
}

TO_LANGUAGE_CODE = {name: code for code, name in LANGUAGES.items()} | _ALIASES

LANGUAGES_WITHOUT_SPACES = ("ja", "zh")


def normalize_language(language):
    """Map a language name/alias/code to its canonical code, or None."""
    if language is None:
        return None
    lang = language.lower()
    if lang in LANGUAGES:
        return lang
    if lang in TO_LANGUAGE_CODE:
        return TO_LANGUAGE_CODE[lang]
    raise ValueError(f"Unsupported language: {language}")
