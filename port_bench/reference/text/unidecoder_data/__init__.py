"""Vendored public transliteration data tables (constant data, class (b)).

``replacements``: unicode → ASCII pairs from sindresorhus/transliterate
(MIT); ``homoglyphs``: ASCII → lookalike-glyph lists from codebox/homoglyph
(MIT). Same tables the reference vendors at
``FastPitch_TF/common/text/unidecoder/{replacements,homoglyphs}.py``.
"""

from .homoglyphs import homoglyphs
from .replacements import replacements

__all__ = ["replacements", "homoglyphs"]
