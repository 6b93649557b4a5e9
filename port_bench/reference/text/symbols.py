"""Symbol tables for text encoding.

The tables must match the reference exactly for checkpoint/vocab
compatibility (``FastPitch_TF/common/text/symbols.py:20-52`` — 148 symbols
for english_basic including the 84 '@'-prefixed ARPAbet phones from
``cmudict.py:9-19``).
"""

from __future__ import annotations

from typing import List

__all__ = ["ARPABET_SYMBOLS", "get_symbols", "get_pad_idx", "symbols_to_ids"]

# The 39 CMUdict phones with 0/1/2 stress variants on vowels (84 total).
_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
           "OW", "OY", "UH", "UW"]
_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N",
               "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH"]

ARPABET_SYMBOLS: List[str] = sorted(
    _VOWELS
    + [v + s for v in _VOWELS for s in ("0", "1", "2")]
    + _CONSONANTS
)

_PUNCTUATION = "!'(),.:;? "
_UPPER = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_LOWER = "abcdefghijklmnopqrstuvwxyz"


def get_symbols(symbol_set: str = "english_basic") -> List[str]:
    arpabet = ["@" + s for s in ARPABET_SYMBOLS]
    if symbol_set == "english_basic":
        return list("_" + "-" + _PUNCTUATION + _UPPER + _LOWER) + arpabet
    if symbol_set == "english_basic_lowercase":
        return list("_" + "-" + _PUNCTUATION + _LOWER) + arpabet
    if symbol_set == "english_expanded":
        math = "#%&*+-/[]()"
        special = "_@©°½—₩€$"
        accented = "áçéêëñöøćž"
        return list(_PUNCTUATION + math + special + accented + _UPPER + _LOWER) + arpabet
    raise ValueError(f"unknown symbol set: {symbol_set!r}")


def get_pad_idx(symbol_set: str = "english_basic") -> int:
    if symbol_set in {"english_basic", "english_basic_lowercase"}:
        return 0  # '_'
    raise ValueError(f"no pad index defined for symbol set {symbol_set!r}")


def symbols_to_ids(symbol_set: str = "english_basic") -> dict:
    return {s: i for i, s in enumerate(get_symbols(symbol_set))}
