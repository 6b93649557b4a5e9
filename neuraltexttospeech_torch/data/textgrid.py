"""Minimal Praat TextGrid parser (MFA output format).

The port's own copy of ``neuraltexttospeech_tpu/data/textgrid.py`` (:19), a
pure-Python module: it parses the long-form TextGrid text format into
(name → [(start, end, label)]) interval tiers, all that MFA emits, in place
of the reference's ``tgt`` dependency.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

__all__ = ["parse_textgrid", "Interval"]

Interval = Tuple[float, float, str]


def parse_textgrid(path_or_text: str) -> Dict[str, List[Interval]]:
    """Parse a TextGrid file path or raw text into interval tiers."""
    if "\n" not in path_or_text:
        with open(path_or_text, encoding="utf-8") as f:
            text = f.read()
    else:
        text = path_or_text

    tiers: Dict[str, List[Interval]] = {}
    cur_name = None
    cur: List[Interval] = []
    xmin = xmax = None
    label = None

    name_re = re.compile(r'name\s*=\s*"(.*)"')
    xmin_re = re.compile(r"xmin\s*=\s*([\d.eE+-]+)")
    xmax_re = re.compile(r"xmax\s*=\s*([\d.eE+-]+)")
    text_re = re.compile(r'text\s*=\s*"(.*)"')
    in_item = False

    for line in text.splitlines():
        line = line.strip()
        m = name_re.search(line)
        if m:
            if cur_name is not None:
                tiers[cur_name] = cur
            cur_name, cur = m.group(1), []
            in_item = False
            continue
        if line.startswith("intervals ["):
            in_item = True
            xmin = xmax = label = None
            continue
        if in_item:
            m = xmin_re.search(line)
            if m and xmin is None:
                xmin = float(m.group(1))
                continue
            m = xmax_re.search(line)
            if m and xmax is None:
                xmax = float(m.group(1))
                continue
            m = text_re.search(line)
            if m:
                label = m.group(1)
                if xmin is not None and xmax is not None:
                    cur.append((xmin, xmax, label))
                in_item = False
    if cur_name is not None:
        tiers[cur_name] = cur
    return tiers
