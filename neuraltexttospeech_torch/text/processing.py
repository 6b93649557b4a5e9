"""Text → symbol-id encoding with optional ARPAbet (phoneme) substitution.

Capability mirror of ``FastPitch_TF/common/text/text_processing.py:30-187``:
curly-brace ARPAbet segments, per-word probabilistic grapheme→phoneme
substitution via CMUdict with heteronym and possessive handling, cleaner
pipelines, and id round-tripping. The reference's NameError-level bugs
(``word``/``words`` mixups, ``result == s``) are implemented as intended.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from ..utils.profiling import span
from . import cleaners as _cleaners_mod
from .cmudict import CMUDict
from .numbers import CURRENCY_RE, expand_currency_text
from .symbols import get_symbols

__all__ = ["TextProcessing", "intersperse"]

# text enclosed in curly braces is treated as pre-encoded ARPAbet
_CURLY_RE = re.compile(r"(.*?)\{(.+?)\}(.*)")
# words (with optional apostrophe suffix) vs everything else
_WORDS_RE = re.compile(
    r"([a-zA-ZÀ-ž]+['][a-zA-ZÀ-ž]{1,2}|[a-zA-ZÀ-ž]+)|([{][^}]+[}]|[^a-zA-ZÀ-ž{}]+)"
)
# split into {arpabet groups} and whitespace-delimited chunks for cleaning
_ARPA_SPLIT_RE = re.compile(r"{[^}]+}|\S+")


class TextProcessing:
    def __init__(
        self,
        symbol_set: str = "english_basic",
        cleaner_names: Sequence[str] = ("english_cleaners_v2",),
        p_arpabet: float = 0.0,
        handle_arpabet: str = "word",
        handle_arpabet_ambiguous: str = "ignore",
        expand_currency: bool = True,
        cmudict: Optional[CMUDict] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        if isinstance(cleaner_names, str):
            cleaner_names = [cleaner_names]
        self.symbols = get_symbols(symbol_set)
        self.cleaner_names = list(cleaner_names)
        self.symbol_to_id = {s: i for i, s in enumerate(self.symbols)}
        self.id_to_symbol = dict(enumerate(self.symbols))
        self.expand_currency = expand_currency
        self.p_arpabet = p_arpabet
        self.handle_arpabet = handle_arpabet
        self.handle_arpabet_ambiguous = handle_arpabet_ambiguous
        self._rng = rng if rng is not None else np.random.default_rng()
        if cmudict is None and p_arpabet > 0:
            cmudict = CMUDict()
        self.cmudict = cmudict
        self._heteronyms = (
            set(cmudict.heteronyms) if cmudict is not None else set()
        )

    # -- encoding ------------------------------------------------------------

    def text_to_sequence(self, text: str) -> List[int]:
        """Encode cleaned text; {ARPAbet} groups map to phone ids."""
        sequence: List[int] = []
        while text:
            m = _CURLY_RE.match(text)
            if not m:
                sequence += self.symbols_to_sequence(text)
                break
            sequence += self.symbols_to_sequence(m.group(1))
            sequence += self.arpabet_to_sequence(m.group(2))
            text = m.group(3)
        return sequence

    def sequence_to_text(self, sequence: Sequence[int]) -> str:
        out = []
        for symbol_id in sequence:
            s = self.id_to_symbol.get(int(symbol_id))
            if s is None:
                continue
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            out.append(s)
        return "".join(out).replace("}{", " ")

    def symbols_to_sequence(self, symbols: str) -> List[int]:
        return [self.symbol_to_id[s] for s in symbols if s in self.symbol_to_id]

    def arpabet_to_sequence(self, text: str) -> List[int]:
        return self.symbols_to_sequence(["@" + s for s in text.split()])

    # -- cleaning ------------------------------------------------------------

    def clean_text(self, text: str) -> str:
        for name in self.cleaner_names:
            text = _cleaners_mod.get_cleaner(name)(text)
        return text

    # -- grapheme → phoneme ----------------------------------------------------

    def get_arpabet(self, word: str) -> str:
        """Return '{PHONES}' for `word` if unambiguously known, else `word`."""
        if self.cmudict is None or not self.cmudict.initialized:
            return word
        if word.lower() in self._heteronyms:
            return word

        arpabet_suffix = ""
        if len(word) > 2 and word.endswith("'s"):
            arpabet = self.cmudict.lookup(word)
            if arpabet is None:
                inner = self.get_arpabet(word[:-2])
                if inner.startswith("{"):
                    return inner[:-1] + " Z}"
                return word
        elif len(word) > 1 and word.endswith("s"):
            arpabet = self.cmudict.lookup(word)
            if arpabet is None:
                inner = self.get_arpabet(word[:-1])
                if inner.startswith("{"):
                    return inner[:-1] + " Z}"
                return word
        else:
            arpabet = self.cmudict.lookup(word)

        if arpabet is None:
            return word
        if len(arpabet) > 1:
            if self.handle_arpabet_ambiguous == "first":
                pron = arpabet[0]
            elif self.handle_arpabet_ambiguous == "random":
                pron = arpabet[int(self._rng.integers(len(arpabet)))]
            else:  # 'ignore'
                return word
        else:
            pron = arpabet[0]
        return "{" + pron + arpabet_suffix + "}"

    # -- public entry ----------------------------------------------------------

    def encode_text(self, text: str, return_all: bool = False):
        with span("text.encode"):
            if self.expand_currency:
                text = CURRENCY_RE.sub(expand_currency_text, text)
            # clean chunk-by-chunk so pre-encoded {ARPAbet} survives cleaning
            cleaned_chunks = [
                chunk if chunk.startswith("{") else self.clean_text(chunk)
                for chunk in _ARPA_SPLIT_RE.findall(text)
            ]
            text_clean = _cleaners_mod.collapse_whitespace(" ".join(cleaned_chunks))
            text = text_clean

            text_arpabet = ""
            if self.p_arpabet > 0 and self.handle_arpabet:
                words = _WORDS_RE.findall(text)
                if self.handle_arpabet == "sequence":
                    if self._rng.uniform() < self.p_arpabet:
                        text_arpabet = "".join(
                            self.get_arpabet(w) if w else other
                            for (w, other) in words
                        )
                        text = text_arpabet
                elif self.handle_arpabet == "word":
                    text_arpabet = "".join(
                        other
                        if not w
                        else (
                            self.get_arpabet(w)
                            if self._rng.uniform() < self.p_arpabet
                            else w
                        )
                        for (w, other) in words
                    )
                    text = text_arpabet
                else:
                    raise ValueError(
                        f"unsupported handle_arpabet: {self.handle_arpabet!r}"
                    )

            encoded = self.text_to_sequence(text)
            if return_all:
                return encoded, text_clean, text_arpabet
            return encoded


def intersperse(sequence: Sequence[int], item: int) -> List[int]:
    """Insert `item` between (and around) symbols — Grad-TTS blank-token trick
    (``Grad-TTS_TF/utils.py:9-13``): [a, b] → [item, a, item, b, item]."""
    out = [item] * (len(sequence) * 2 + 1)
    out[1::2] = list(sequence)
    return out
