"""CMUdict (ARPAbet pronunciation dictionary) loader.

Capability mirror of ``FastPitch_TF/common/text/cmudict.py:24-116``: parses
the cmudict-0.7b format (latin-1, '(n)' alternate markers, two-space
word/pron separator), filters prons to the valid ARPAbet symbol set, and
exposes ``lookup``. No network download — the dictionary file path is
supplied by the caller or discovered via search paths (``$NTTS_DATA_DIR``
and ``./data/cmudict``).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional

from .symbols import ARPABET_SYMBOLS

__all__ = ["CMUDict", "default_cmudict_paths", "default_heteronyms_paths"]

_VALID = frozenset(ARPABET_SYMBOLS)
_ALT_RE = re.compile(r"\([0-9]+\)")


def default_cmudict_paths() -> List[str]:
    paths = []
    if os.environ.get("NTTS_DATA_DIR"):
        paths.append(os.path.join(os.environ["NTTS_DATA_DIR"], "cmudict-0.7b"))
    paths += [
        "data/cmudict/cmudict-0.7b",
    ]
    return paths


def default_heteronyms_paths() -> List[str]:
    paths = []
    if os.environ.get("NTTS_DATA_DIR"):
        paths.append(os.path.join(os.environ["NTTS_DATA_DIR"], "heteronyms"))
    paths += [
        "data/cmudict/heteronyms",
    ]
    return paths


def _first_existing(paths) -> Optional[str]:
    for p in paths:
        if p and Path(p).exists():
            return p
    return None


class CMUDict:
    def __init__(
        self,
        file_or_path=None,
        heteronyms_path: Optional[str] = None,
        keep_ambiguous: bool = True,
    ):
        self._entries: Dict[str, List[str]] = {}
        self.heteronyms: List[str] = []
        if file_or_path is None:
            file_or_path = _first_existing(default_cmudict_paths())
        if heteronyms_path is None:
            heteronyms_path = _first_existing(default_heteronyms_paths())
        if file_or_path is not None:
            self.initialize(file_or_path, heteronyms_path, keep_ambiguous)

    @property
    def initialized(self) -> bool:
        return bool(self._entries)

    def initialize(self, file_or_path, heteronyms_path, keep_ambiguous=True):
        if isinstance(file_or_path, (str, Path)):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries
        if heteronyms_path is not None and Path(heteronyms_path).exists():
            with open(heteronyms_path, encoding="utf-8") as f:
                self.heteronyms = [line.strip() for line in f]

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> Optional[List[str]]:
        """All ARPAbet pronunciations of `word`, or None if absent."""
        if not self._entries:
            return None
        return self._entries.get(word.upper())


def _parse(lines) -> Dict[str, List[str]]:
    entries: Dict[str, List[str]] = {}
    for line in lines:
        if not line:
            continue
        c = line[0]
        if not ("A" <= c <= "Z" or c == "'"):
            continue
        parts = line.split("  ")
        if len(parts) < 2:
            continue
        word = _ALT_RE.sub("", parts[0])
        phones = parts[1].strip().split(" ")
        if all(p in _VALID for p in phones):
            entries.setdefault(word, []).append(" ".join(phones))
    return entries
