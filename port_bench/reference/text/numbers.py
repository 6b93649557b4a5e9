"""English number verbalization, self-contained (no `inflect` dependency).

Provides the capability surface of the reference's number normalizer
(``FastPitch_TF/common/text/numerical.py:43-181``): comma removal, currency,
decimals, ordinals, roman numerals, "NxM" dimensions, and plain numbers with
year-style pairwise reading. The reference leans on the `inflect` package
(not available here) and contains several NameError-level bugs (e.g.
``magnitude``/``_magnitude`` in ``_expand_currency``, ``num`` in
``_expand_number``); this module implements the intended behavior of its
NVIDIA/keithito lineage instead.
"""

from __future__ import annotations

import re

__all__ = [
    "number_to_words",
    "ordinal_to_words",
    "normalize_numbers",
    "expand_currency_text",
    "CURRENCY_RE",
]

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = ["", " thousand", " million", " billion", " trillion", " quadrillion"]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_below_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[ones]}"


def _three(n: int, andword: str) -> str:
    """0..999 → words; `andword` joins hundreds with the remainder."""
    if n < 100:
        return _two_below_100(n)
    hundreds, rest = divmod(n, 100)
    head = f"{_ONES[hundreds]} hundred"
    if rest == 0:
        return head
    joiner = f" {andword} " if andword else " "
    return head + joiner + _two_below_100(rest)


def number_to_words(
    value,
    andword: str = "and",
    zero: str = "zero",
    group: int = 0,
) -> str:
    """Spell a number.

    - ``group=2`` reads the digit string in pairs from the left (year style:
      1984 → "nineteen eighty-four", 1905 → "nineteen oh five" with
      ``zero='oh'``), matching how the reference calls inflect for years.
    - decimal strings are read with "point" followed by per-digit reading.
    """
    s = str(value).strip()
    negative = s.startswith("-")
    if negative:
        s = s[1:]

    if "." in s:
        whole, frac = s.split(".", 1)
        head = number_to_words(whole or "0", andword=andword, zero=zero)
        digits = " ".join(zero if d == "0" else _ONES[int(d)] for d in frac)
        out = f"{head} point {digits}"
        return ("minus " + out) if negative else out

    if group == 2:
        ds = s
        pairs = []
        i = 0
        while i < len(ds):
            chunk = ds[i : i + 2]
            i += 2
            n = int(chunk)
            if len(chunk) == 2 and chunk[0] == "0":
                word = zero if n == 0 else f"{zero} {_ONES[n]}"
                if n == 0:
                    word = f"{zero} {zero}" if chunk == "00" else zero
            elif n == 0:
                word = zero
            else:
                word = _two_below_100(n) if len(chunk) == 2 else _ONES[n]
            pairs.append(word)
        out = " ".join(pairs)
        return ("minus " + out) if negative else out

    n = int(s) if s else 0
    if n == 0:
        return zero
    chunks = []
    scale = 0
    while n > 0 and scale < len(_SCALES):
        n, rem = divmod(n, 1000)
        if rem:
            chunks.append(_three(rem, andword) + _SCALES[scale])
        scale += 1
    out = ", ".join(reversed(chunks))
    return ("minus " + out) if negative else out


def ordinal_to_words(text: str) -> str:
    """'21st' → 'twenty-first' (accepts a number+suffix string)."""
    digits = re.match(r"[0-9]+", text).group(0)
    words = number_to_words(int(digits))
    # Convert final word to its ordinal form.
    parts = re.split(r"([ \-])", words)
    last = parts[-1]
    if last in _ORDINAL_IRREGULAR:
        parts[-1] = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        parts[-1] = last[:-1] + "ieth"
    elif last == "hundred" or last.endswith(("thousand", "llion")):
        parts[-1] = last + "th"
    else:
        parts[-1] = last + "th"
    return "".join(parts)


# ---------------------------------------------------------------------------
# Regex-driven text normalization (reference numerical.py surface)
# ---------------------------------------------------------------------------

_MAGNITUDES = ["trillion", "billion", "million", "thousand", "hundred", "m", "b", "t"]
_MAGNITUDE_ABBREV = {"m": "million", "b": "billion", "t": "trillion"}
_CURRENCY_WORDS = {"$": "dollar", "£": "pound", "€": "euro", "₩": "won"}

COMMA_NUMBER_RE = re.compile(r"([0-9][0-9\,]+[0-9])")
DECIMAL_RE = re.compile(r"([0-9]+\.[0-9]+)")
CURRENCY_RE = re.compile(
    r"([\$€£₩])([0-9\.\,]*[0-9]+)(?:[ ]?({})(?=[^a-zA-Z]|$))?".format(
        "|".join(_MAGNITUDES)
    ),
    re.IGNORECASE,
)
ORDINAL_RE = re.compile(r"[0-9]+(st|nd|rd|th)")
ROMAN_RE = re.compile(
    r"\b(?=[MDCLXVI]+\b)M{0,4}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{2,3})\b"
)
MULTIPLY_RE = re.compile(r"(\b[0-9]+)(x)([0-9]+)")
NUMBER_RE = re.compile(r"[0-9]+")

_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500, "M": 1000}


def _spell_hundreds_style(text: str) -> str:
    """'2500' → 'twenty-five hundred' when it reads naturally that way."""
    number = float(text)
    if 1000 < number < 10000 and number % 100 == 0 and number % 1000 != 0:
        return number_to_words(int(number / 100)) + " hundred"
    return number_to_words(text)


def expand_currency_text(m: re.Match) -> str:
    currency = _CURRENCY_WORDS[m.group(1)]
    quantity = m.group(2).replace(",", "")
    magnitude = m.group(3)

    if magnitude is not None and magnitude.lower() in _MAGNITUDES:
        if len(magnitude) == 1:
            magnitude = _MAGNITUDE_ABBREV[magnitude.lower()]
        return f"{_spell_hundreds_style(quantity)} {magnitude} {currency}s"

    parts = quantity.split(".")
    if len(parts) > 2:
        return f"{quantity} {currency}s"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = currency if dollars == 1 else currency + "s"
        cent_unit = "cent" if cents == 1 else "cents"
        return (
            f"{_spell_hundreds_style(str(dollars))} {dollar_unit}, "
            f"{number_to_words(cents)} {cent_unit}"
        )
    if dollars:
        dollar_unit = currency if dollars == 1 else currency + "s"
        return f"{_spell_hundreds_style(str(dollars))} {dollar_unit}"
    if cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{number_to_words(cents)} {cent_unit}"
    return f"zero {currency}s"


def _expand_roman(m: re.Match) -> str:
    num = m.group(0)
    total = 0
    for i, c in enumerate(num):
        v = _ROMAN_VALUES[c]
        if i + 1 < len(num) and _ROMAN_VALUES[num[i + 1]] > v:
            total -= v
        else:
            total += v
    return str(total)


def _expand_plain_number(m: re.Match) -> str:
    number = int(m.group(0))
    if 1000 < number < 10000 and number % 100 == 0 and number % 1000 != 0:
        # Round "year-like" hundreds: 2500 → twenty-five hundred.
        text = number_to_words(number // 100) + " hundred"
    elif 1000 < number < 3000:
        if number == 2000:
            text = "two thousand"
        elif 2000 < number < 2010:
            text = "two thousand " + number_to_words(number % 100)
        elif number % 100 == 0:
            text = number_to_words(number // 100) + " hundred"
        else:
            text = number_to_words(number, andword="", zero="oh", group=2)
    else:
        text = number_to_words(number, andword="and")
        text = text.replace(",", "")
    return text.replace("-", " ")


def normalize_numbers(text: str) -> str:
    """The reference's normalize_numbers pass order, with intent-level fixes."""
    text = COMMA_NUMBER_RE.sub(lambda m: m.group(1).replace(",", ""), text)
    text = CURRENCY_RE.sub(expand_currency_text, text)
    text = DECIMAL_RE.sub(lambda m: m.group(1).replace(".", " point "), text)
    text = ORDINAL_RE.sub(lambda m: ordinal_to_words(m.group(0)), text)
    text = ROMAN_RE.sub(_expand_roman, text)
    text = MULTIPLY_RE.sub(lambda m: f"{m.group(1)} by {m.group(3)}", text)
    text = NUMBER_RE.sub(_expand_plain_number, text)
    return text
