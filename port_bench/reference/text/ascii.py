"""Unicode → ASCII transliteration ("unidecoder" capability).

Reference: ``FastPitch_TF/common/text/unidecoder/__init__.py:28-56`` — a
character-wise lookup through a vendored replacement table (1,927 pairs,
sindresorhus/transliterate) and a homoglyph map (codebox/homoglyph), with a
once-per-utterance warning for untranslatable characters.

This implementation layers three lookups so coverage strictly exceeds the
reference's: (1) the full vendored replacement table, (2) the homoglyph map
(priority flips with ``homoglyphs=True``, like the reference), (3) NFKD
decomposition stripping combining marks — which also covers precomposed
Latin the tables miss. Characters still untranslatable are dropped with an
optional warning.
"""

from __future__ import annotations

import unicodedata
import warnings

from .unidecoder_data import homoglyphs as _homoglyph_groups
from .unidecoder_data import replacements as _replacement_pairs

__all__ = ["to_ascii", "unidecoder"]

_REPLACEMENTS = {uni: asc for uni, asc in _replacement_pairs}
_HOMOGLYPHS = {g: asc for asc, glyphs in _homoglyph_groups.items()
               for g in glyphs}

# typographic extras the vendored table lacks
_EXTRA = {
    "…": "...", "‚": "'", "‛": "'", "„": '"', "‟": '"',
    "«": '"', "»": '"', "‹": "'", "›": "'",
    "·": "-", "•": "-", " ": " ",
    "©": "(c)", "®": "(r)", "™": "(tm)",
    "°": " degrees ",
    "½": " half ", "¼": " quarter ", "¾": " three quarters ",
    "×": "x", "÷": "/", "¢": " cents ",
}


_MAX_KEY = max(len(k) for k in _REPLACEMENTS)


def to_ascii(text: str, warn_dropped: bool = False,
             homoglyphs: bool = False) -> str:
    """Transliterate to ASCII; non-representable characters are dropped.

    ``homoglyphs=True`` prioritizes the lookalike-glyph map over the
    replacement table (reference ``unidecoder/__init__.py:40-43``). Unlike
    the reference's per-character loop, multi-character table keys (Cyrillic
    digraphs like 'ый' → 'iy') are matched longest-first.
    """
    out = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ord(ch) < 128:
            out.append(ch)
            i += 1
            continue
        # longest-match digraphs from the replacement table first
        seg_match = None
        for L in range(min(_MAX_KEY, n - i), 1, -1):
            seg = text[i:i + L]
            if seg in _REPLACEMENTS:
                seg_match = _REPLACEMENTS[seg]
                i += L
                break
        if seg_match is not None:
            out.append(seg_match)
            continue
        # explicit None checks: the table maps some keys (Cyrillic soft/hard
        # signs) to the EMPTY string, which is a valid replacement
        if homoglyphs:
            ch2 = _HOMOGLYPHS.get(ch)
            if ch2 is None:
                ch2 = _REPLACEMENTS.get(ch)
        else:
            ch2 = _REPLACEMENTS.get(ch)
            if ch2 is None:
                ch2 = _HOMOGLYPHS.get(ch)
        if ch2 is None:
            ch2 = _EXTRA.get(ch)
        if ch2 is None:
            decomp = unicodedata.normalize("NFKD", ch)
            ch2 = "".join(c for c in decomp if ord(c) < 128)
        if not ch2 and warn_dropped:
            warnings.warn(f"to_ascii dropped character {ch!r} (U+{ord(ch):04X})")
        out.append(ch2)
        i += 1
    return "".join(out)


def unidecoder(s: str, homoglyphs: bool = False) -> str:
    """Reference-named alias (``unidecoder(s, homoglyphs=False)``)."""
    return to_ascii(s, homoglyphs=homoglyphs)
