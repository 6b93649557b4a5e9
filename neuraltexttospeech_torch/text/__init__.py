"""Text front-end: normalization, cleaners, symbol tables, G2P encoding.

Also exposes the keithito-style functional API (``text_to_sequence``) used by
the Tacotron2/Grad-TTS/Flowtron lineages (``Grad-TTS_TF/text/__init__.py:22-63``).
"""

from .ascii import to_ascii
from .cleaners import (
    basic_cleaners,
    collapse_whitespace,
    english_cleaners,
    english_cleaners_v2,
    get_cleaner,
    transliteration_cleaners,
)
from .cmudict import CMUDict
from .numbers import normalize_numbers, number_to_words, ordinal_to_words
from .processing import TextProcessing, intersperse
from .symbols import ARPABET_SYMBOLS, get_pad_idx, get_symbols, symbols_to_ids

__all__ = [
    "ARPABET_SYMBOLS",
    "CMUDict",
    "TextProcessing",
    "basic_cleaners",
    "collapse_whitespace",
    "english_cleaners",
    "english_cleaners_v2",
    "get_cleaner",
    "get_pad_idx",
    "get_symbols",
    "intersperse",
    "normalize_numbers",
    "number_to_words",
    "ordinal_to_words",
    "symbols_to_ids",
    "text_to_sequence",
    "sequence_to_text",
    "to_ascii",
    "transliteration_cleaners",
]


def text_to_sequence(text: str, cleaner_names, symbol_set: str = "english_basic"):
    """Functional keithito-style API: clean then encode to symbol ids."""
    tp = TextProcessing(symbol_set=symbol_set, cleaner_names=cleaner_names)
    return tp.text_to_sequence(tp.clean_text(text))


def sequence_to_text(sequence, symbol_set: str = "english_basic"):
    return TextProcessing(symbol_set=symbol_set).sequence_to_text(sequence)
