"""Frozen copy of the port's character front end (cleaners, ASCII folding,
number and abbreviation expansion, the ``english_basic`` symbol table), with
the character path of ``TextProcessing.encode_text`` (no ARPAbet: the
benchmark's configurations encode characters).

The modules beside this file are verbatim copies of the port's
``text/ascii.py``, ``cleaners.py``, ``norm.py``, ``numbers.py``,
``symbols.py`` and ``unidecoder_data/``; ``tests/test_bench_frozen.py``
holds them to the origin as it stood when they were copied.
"""

from __future__ import annotations

import re
from typing import List

from .cleaners import collapse_whitespace, get_cleaner
from .numbers import CURRENCY_RE, expand_currency_text
from .symbols import get_symbols

__all__ = ["encode"]

_ARPA_SPLIT_RE = re.compile(r"{[^}]+}|\S+")


def encode(text: str, symbol_set: str = "english_basic",
           cleaners=("english_cleaners_v2",)) -> List[int]:
    """Raw text → symbol ids: currency expanded, each whitespace-delimited
    chunk cleaned, whitespace collapsed, characters outside the symbol table
    dropped."""
    table = {s: i for i, s in enumerate(get_symbols(symbol_set))}
    text = CURRENCY_RE.sub(expand_currency_text, text)
    chunks = []
    for chunk in _ARPA_SPLIT_RE.findall(text):
        for name in cleaners:
            chunk = get_cleaner(name)(chunk)
        chunks.append(chunk)
    text = collapse_whitespace(" ".join(chunks))
    return [table[s] for s in text if s in table]
