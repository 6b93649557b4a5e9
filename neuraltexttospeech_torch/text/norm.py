"""Rule-based text normalization passes (abbreviations, acronyms, dates/
times, letters-and-numbers).

Capability mirror of the reference's normalizer family
(``FastPitch_TF/common/text/{abbreviations,acronyms,datestime,
letters_and_numbers}.py``), table-driven in one module.
"""

from __future__ import annotations

import re
from typing import Optional

__all__ = [
    "normalize_abbreviations",
    "normalize_datestime",
    "normalize_letters_and_numbers",
    "normalize_acronyms",
    "spell_acronyms",
    "set_acronym_cmudict",
]

# --- abbreviations ----------------------------------------------------------

_TITLE_ABBREVIATIONS = {
    "mrs": "misess", "ms": "miss", "mr": "mister", "dr": "doctor",
    "st": "saint", "co": "company", "jr": "junior", "maj": "major",
    "gen": "general", "drs": "doctors", "rev": "reverend",
    "lt": "lieutenant", "hon": "honorable", "sgt": "sergeant",
    "capt": "captain", "esq": "esquire", "ltd": "limited",
    "col": "colonel", "ft": "fort", "sen": "senator", "etc": "et cetera",
}
_TITLE_RES = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in _TITLE_ABBREVIATIONS.items()
]
_NO_PERIOD_RE = re.compile(r"(No[.])(?=[ ]?[0-9])")
_PERCENT_RE = re.compile(r"([ ]?[%])")
_URL_RE = re.compile(r"([a-zA-Z])\.(com|gov|org)")


def normalize_abbreviations(text: str) -> str:
    text = _NO_PERIOD_RE.sub(
        lambda m: "Number" if m.group(0)[0] == "N" else "number", text
    )
    text = _PERCENT_RE.sub(" percent", text)
    text = text.replace("&", " and ").replace("@", " at ")
    text = _URL_RE.sub(lambda m: f"{m.group(1)} dot {m.group(2)}", text)
    for regex, expansion in _TITLE_RES:
        text = regex.sub(expansion, text)
    return text


# --- dates / times ----------------------------------------------------------

_AMPM_RE = re.compile(r"([0-9]|0[0-9]|1[0-9]|2[0-3]):?([0-5][0-9])?\s*([AaPp][Mm]\b)")


def normalize_datestime(text: str) -> str:
    """'9:30am' → '9 30 a.m.' ; '12 PM' → '12 p.m.' (minutes kept if nonzero)."""

    def repl(m: re.Match) -> str:
        hours, minutes, half = m.groups("0")
        out = hours
        if int(minutes) != 0:
            out += " " + minutes
        out += " a.m." if half[0].lower() == "a" else " p.m."
        return out

    return _AMPM_RE.sub(repl, text)


# --- letters-and-numbers mixtures (AK47, 4GB, 1920x1080) --------------------

_MIXED_RE = re.compile(r"((?:[a-zA-Z]+[0-9]|[0-9]+[a-zA-Z])[a-zA-Z0-9']*)")
_HARDWARE_RE = re.compile(
    r"([0-9]+(?:[.,][0-9]+)?)(?:\s?)(tb|gb|mb|kb|ghz|mhz|khz|hz|mm)",
    re.IGNORECASE,
)
_HARDWARE_UNITS = {
    "tb": "terabyte", "gb": "gigabyte", "mb": "megabyte", "kb": "kilobyte",
    "ghz": "gigahertz", "mhz": "megahertz", "khz": "kilohertz", "hz": "hertz",
    "mm": "millimeter", "cm": "centimeter", "km": "kilometer",
}
_DIMENSION_RE = re.compile(
    r"\b(\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?"
    r"(?:in|inch|m)?)\b|\b(\d+(?:[,.]\d+)?\s*[xX]\s*\d+(?:[,.]\d+)?(?:in|inch|m)?)\b"
)
_DIMENSION_UNITS = {"m": "meter", "in": "inch", "inch": "inch"}


def _split_digit_pairs(digits: str) -> str:
    """Read a short digit run pairwise ('1947' → '19 47', '305' → '3 05')."""
    if len(digits) > 2 and digits[-2] == "0":
        if digits[-1] == "0":
            return digits
        return " ".join([digits[:-2], digits[-2], digits[-1]])
    if len(digits) % 2 == 0:
        return " ".join(digits[i : i + 2] for i in range(0, len(digits), 2))
    if len(digits) > 2:
        return " ".join([digits[0]] + [digits[i : i + 2] for i in range(1, len(digits), 2)])
    return digits


def _expand_mixed(m: re.Match) -> str:
    pieces = [p for p in re.split(r"(\d+)", m.group(0)) if p != ""]
    # keep ordinal/possessive suffixes attached to their number: 1920s, 47's
    if (
        len(pieces) >= 2
        and pieces[-1] in ("'s", "s", "th", "nd", "st", "rd")
        and pieces[-2].isdigit()
    ):
        pieces[-2:] = [pieces[-2] + pieces[-1]]
    out = []
    for piece in pieces:
        if piece.isdigit() and len(piece) < 5:
            out.append(_split_digit_pairs(piece))
        else:
            out.append(piece)
    return " ".join(out)


def _expand_hardware(m: re.Match) -> str:
    quantity, unit = m.group(1), _HARDWARE_UNITS[m.group(2).lower()]
    if unit[-1] != "z" and float(quantity.replace(",", "")) > 1:
        return f"{quantity} {unit}s"
    return f"{quantity} {unit}"


def _expand_dimension(m: re.Match) -> str:
    text = "".join(g for g in m.groups() if g)
    text = text.replace(" x ", " by ").replace("x", " by ").replace("X", " by ")
    for suffix, unit in sorted(_DIMENSION_UNITS.items(), key=lambda kv: -len(kv[0])):
        if text.endswith(suffix) and text[: -len(suffix)].rstrip()[-1:].isdigit():
            return f"{text[: -len(suffix)]} {unit}"
    return text


def normalize_letters_and_numbers(text: str) -> str:
    text = _HARDWARE_RE.sub(_expand_hardware, text)
    text = _DIMENSION_RE.sub(_expand_dimension, text)
    text = _MIXED_RE.sub(_expand_mixed, text)
    return text


# --- acronyms ----------------------------------------------------------------

_LETTER_ARPABET = {
    "A": "EY1", "B": "B IY1", "C": "S IY1", "D": "D IY1", "E": "IY1",
    "F": "EH1 F", "G": "JH IY1", "H": "EY1 CH", "I": "AY1", "J": "JH EY1",
    "K": "K EY1", "L": "EH1 L", "M": "EH1 M", "N": "EH1 N", "O": "OW1",
    "P": "P IY1", "Q": "K Y UW1", "R": "AA1 R", "S": "EH1 S", "T": "T IY1",
    "U": "Y UW1", "V": "V IY1", "W": "D AH1 B AH0 L Y UW0", "X": "EH1 K S",
    "Y": "W AY1", "Z": "Z IY1", "s": "Z",
}
_ACRONYM_RE = re.compile(r"([a-z]*[A-Z][A-Z]+)s?\.?")
_ACRONYM_EXCEPTIONS = {"NVIDIA": "N.VIDIA"}
_NON_UPPERCASE_EXCEPTIONS = {"email": "e-mail"}
_NON_UPPERCASE_RE = re.compile(
    r"\b({})\b".format("|".join(_NON_UPPERCASE_EXCEPTIONS)), re.IGNORECASE
)

# Optional dictionary used to keep known pronounceable acronyms as words.
_acronym_cmudict = None


def set_acronym_cmudict(d) -> None:
    """Install a CMUDict used by normalize_acronyms for known-word lookups."""
    global _acronym_cmudict
    _acronym_cmudict = d


def _acronym_to_arpabet(m: re.Match) -> str:
    acronym = m.group(0).replace(".", "")
    acronym = "".join(acronym.split())
    prons = _acronym_cmudict.lookup(acronym) if _acronym_cmudict else None
    if prons is None:
        phones = ["{" + _LETTER_ARPABET[ch] + "}" for ch in acronym]
        # fold a trailing plural 's' into the last letter's phone group
        if len(phones) > 1 and phones[-1] == "{Z}":
            phones[-2] = phones[-2][:-1] + " " + phones[-1][1:]
            del phones[-1]
        return " ".join(phones)
    if len(prons) == 1:
        return "{" + prons[0] + "}"
    return acronym


def normalize_acronyms(text: str) -> str:
    """Expand all-caps acronyms to letter-by-letter ARPAbet groups."""
    return _ACRONYM_RE.sub(_acronym_to_arpabet, text)


def _spell_acronym(m: re.Match) -> str:
    body: Optional[str] = m.group(1)
    if body in _ACRONYM_EXCEPTIONS:
        out = _ACRONYM_EXCEPTIONS[body]
    else:
        out = ".".join(body) + "."
    if "s" in m.group(0):
        out += "'s"
    if out[-1] != "." and m.group(0)[-1] == ".":
        out += "."
    return out


def spell_acronyms(text: str) -> str:
    """Expand acronyms to dotted letters ('FBI' → 'F.B.I.')."""
    text = _NON_UPPERCASE_RE.sub(
        lambda m: _NON_UPPERCASE_EXCEPTIONS[m.group(0).lower()], text
    )
    return _ACRONYM_RE.sub(_spell_acronym, text)
