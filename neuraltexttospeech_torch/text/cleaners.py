"""Cleaner pipelines — composable text transforms run at train and eval time.

Capability mirror of ``FastPitch_TF/common/text/cleaners.py:80-123`` (and the
keithito variants used by Tacotron2/Grad-TTS/Flowtron): ``basic_cleaners``,
``transliteration_cleaners``, ``english_cleaners`` and ``english_cleaners_v2``.
"""

from __future__ import annotations

import re

from .ascii import to_ascii
from .norm import (
    normalize_abbreviations,
    normalize_datestime,
    normalize_letters_and_numbers,
)
from .numbers import normalize_numbers

__all__ = [
    "basic_cleaners",
    "transliteration_cleaners",
    "english_cleaners",
    "english_cleaners_v2",
    "collapse_whitespace",
    "lowercase",
    "convert_to_ascii",
    "get_cleaner",
]

_WHITESPACE_RE = re.compile(r"\s+")


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return _WHITESPACE_RE.sub(" ", text)


def convert_to_ascii(text: str) -> str:
    return to_ascii(text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    return collapse_whitespace(lowercase(text))


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text."""
    return collapse_whitespace(lowercase(to_ascii(text)))


def english_cleaners(text: str) -> str:
    """English pipeline: ascii → lowercase → numbers → abbreviations."""
    text = to_ascii(text)
    text = lowercase(text)
    text = normalize_numbers(text)
    text = normalize_abbreviations(text)
    return collapse_whitespace(text)


def english_cleaners_v2(text: str) -> str:
    """Extended English pipeline (dates/times, letters+numbers, urls)."""
    text = to_ascii(text)
    text = normalize_datestime(text)
    text = normalize_letters_and_numbers(text)
    text = normalize_numbers(text)
    text = normalize_abbreviations(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    # '/' is not in the basic symbol set — read it as a pause/space.
    return re.sub(r"/+", " ", text)


_CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "transliteration_cleaners": transliteration_cleaners,
    "english_cleaners": english_cleaners,
    "english_cleaners_v2": english_cleaners_v2,
}


def get_cleaner(name: str):
    try:
        return _CLEANERS[name]
    except KeyError:
        raise ValueError(f"unknown cleaner: {name!r}") from None
