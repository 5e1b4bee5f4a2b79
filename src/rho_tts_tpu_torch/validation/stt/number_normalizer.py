"""Inverse text normalization for number comparison — self-contained.

Converts spoken-form numbers, ordinals, dates, currency amounts, and times
to canonical digit form so TTS input and STT transcription compare equal.
Unlike the reference (which chains NeMo's FST ITN + text_to_num,
``validation/stt/number_normalizer.py:51-81``), this is a dependency-free
rule engine: a word-number parser handles cardinals/ordinals including
scale words and year-style pairs, plus regex stages for mixed formats.

Pipeline:
  1. strip commas from digit groups ("1,500" → "1500")
  2. strip currency symbols ("$500" → "500")
  3. mixed digit-word formats ("2 hundred" → "200")
  4. word-number parsing ("two hundred and five" → "205",
     "twenty-second" → "22nd", "nineteen eighty four" → "1984")
  5. currency words ("5 dollars" keeps digits; "five dollars" → "5 dollars")
  6. time patterns ("5 30" after hour words → "5:30" handled via pairing)
  7. ordinal suffix stripping ("22nd" → "22")
  8. residual "a 100" cleanup
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

_UNITS = {
    "zero": 0, "oh": 0, "one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
    "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10, "eleven": 11,
    "twelve": 12, "thirteen": 13, "fourteen": 14, "fifteen": 15, "sixteen": 16,
    "seventeen": 17, "eighteen": 18, "nineteen": 19,
}
_TENS = {
    "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
    "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
}
_SCALES = {"hundred": 100, "thousand": 1_000, "million": 1_000_000,
           "billion": 1_000_000_000, "trillion": 1_000_000_000_000}

_ORDINAL_UNITS = {
    "first": 1, "second": 2, "third": 3, "fourth": 4, "fifth": 5, "sixth": 6,
    "seventh": 7, "eighth": 8, "ninth": 9, "tenth": 10, "eleventh": 11,
    "twelfth": 12, "thirteenth": 13, "fourteenth": 14, "fifteenth": 15,
    "sixteenth": 16, "seventeenth": 17, "eighteenth": 18, "nineteenth": 19,
    "twentieth": 20, "thirtieth": 30, "fortieth": 40, "fiftieth": 50,
    "sixtieth": 60, "seventieth": 70, "eightieth": 80, "ninetieth": 90,
    "hundredth": 100, "thousandth": 1000, "millionth": 1_000_000,
}

_MIXED_FORMAT = re.compile(r"\b(\d+)\s+(hundred|thousand|million|billion|trillion)\b", re.I)
_ORDINAL_SUFFIX = re.compile(r"\b(\d+)(st|nd|rd|th)\b", re.I)
_A_BEFORE_NUMBER = re.compile(r"\ba\s+(\d{2,})\b")
_DIGIT_COMMAS = re.compile(r"(\d),(\d{3})\b")
_CURRENCY_SYMBOL = re.compile(r"[\$\£\€\¥](\d)")


def _strip_digit_commas(text: str) -> str:
    while _DIGIT_COMMAS.search(text):
        text = _DIGIT_COMMAS.sub(r"\1\2", text)
    return text


def _strip_currency_symbols(text: str) -> str:
    return _CURRENCY_SYMBOL.sub(r"\1", text)


def _word_tokens(text: str) -> List[str]:
    """Split preserving separators so spans can be rejoined losslessly."""
    return re.split(r"(\s+|[^\w'-])", text)


def _parse_number_words(words: List[str]) -> Optional[Tuple[int, bool]]:
    """Parse a sequence of number words → (value, is_ordinal).

    Handles "two hundred and five", "twenty-two", "nineteen eighty four"
    (year-style pairing), and ordinal endings ("twenty-second").
    """
    total, current = 0, 0
    is_ordinal = False
    groups: List[int] = []  # for year-style pairing
    any_scale = False
    n = len(words)
    for i, raw in enumerate(words):
        w = raw.lower()
        if w == "and":
            continue
        parts = w.split("-") if "-" in w else [w]
        for p in parts:
            if p in _UNITS:
                current += _UNITS[p]
                groups.append(_UNITS[p])
            elif p in _TENS:
                current += _TENS[p]
                groups.append(_TENS[p])
            elif p in _SCALES:
                any_scale = True
                if p == "hundred":
                    current = max(current, 1) * 100
                else:
                    total += max(current, 1) * _SCALES[p]
                    current = 0
                groups.append(_SCALES[p])
            elif p in _ORDINAL_UNITS:
                is_ordinal = True
                v = _ORDINAL_UNITS[p]
                if v in (100, 1000, 1_000_000):
                    current = max(current, 1) * v
                else:
                    current += v
            else:
                return None
    value = total + current

    # Year-style pairing: exactly two groups, both 10-99, no scale words,
    # first ≥ 13 ("nineteen eighty four" tokenizes as [19, 80, 4] → groups
    # [19, 80, 4]; handle [19, 84]-shaped sums via the tens+unit merge).
    if not any_scale and not is_ordinal and len(words) >= 2:
        merged: List[int] = []
        for g in groups:
            if merged and merged[-1] >= 20 and merged[-1] % 10 == 0 and g < 10:
                merged[-1] += g
            else:
                merged.append(g)
        if len(merged) == 2 and 10 <= merged[0] <= 99 and 10 <= merged[1] <= 99 and merged[0] >= 13:
            value = merged[0] * 100 + merged[1]

    return value, is_ordinal


_NUMBER_WORD = re.compile(
    r"^(?:" + "|".join(
        list(_UNITS) + list(_TENS) + list(_SCALES) + list(_ORDINAL_UNITS)
    ) + r"|and)$",
    re.I,
)


def _is_number_word(tok: str) -> bool:
    t = tok.lower()
    if _NUMBER_WORD.match(t):
        return True
    if "-" in t:
        return all(_NUMBER_WORD.match(p) for p in t.split("-") if p)
    return False


def _classify(tok: str) -> str:
    """unit / teen / tens / scale / ordinal / and — class of the last part."""
    t = tok.lower().split("-")[-1]
    if t == "and":
        return "and"
    if t in _ORDINAL_UNITS:
        return "ordinal"
    if t in _SCALES:
        return "scale"
    if t in _TENS:
        return "tens"
    if t in _UNITS:
        return "teen" if _UNITS[t] >= 10 or t in ("zero", "oh") else "unit"
    return "other"


def _can_continue(prev: str, nxt: str) -> bool:
    """Grammar for one spoken cardinal (incl. year pairing).

    A unit can only be followed by a scale word ("five hundred"); "five
    thirty" is a time, not thirty-five, so the span breaks there.
    """
    prev_c, next_c = _classify(prev), _classify(nxt)
    if prev_c == "ordinal":
        return False
    if next_c == "and":
        return True
    if prev_c in ("scale", "and"):
        return True
    if prev_c == "tens":
        return next_c in ("unit", "scale", "tens", "teen", "ordinal")
    if prev_c == "teen":
        return next_c in ("scale", "tens", "teen", "ordinal")
    if prev_c == "unit":
        return next_c in ("scale", "ordinal")
    return True


def _convert_word_numbers(text: str) -> str:
    """Replace maximal spans of number words with digit strings."""
    tokens = _word_tokens(text)
    out: List[str] = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok and _is_number_word(tok) and tok.lower() != "and":
            # Extend the span over number words (separated by whitespace/"and")
            span = [tok]
            j = i + 1
            pending: List[str] = []
            while j < len(tokens):
                t = tokens[j]
                if t == "" or (t.isspace()):
                    pending.append(t)
                    j += 1
                    continue
                if _is_number_word(t):
                    # "and" only continues a span if a number word follows
                    if t.lower() == "and":
                        k = j + 1
                        while k < len(tokens) and (tokens[k] == "" or tokens[k].isspace()):
                            k += 1
                        if (
                            k < len(tokens)
                            and _is_number_word(tokens[k])
                            and tokens[k].lower() != "and"
                            and _can_continue(span[-1], tokens[k])
                        ):
                            span.append(t)
                            pending = []
                            j += 1
                            continue
                        break
                    if not _can_continue(span[-1], t):
                        break
                    span.append(t)
                    pending = []
                    j += 1
                else:
                    break
            parsed = _parse_number_words([w for w in span if w.strip()])
            if parsed is not None:
                value, is_ordinal = parsed
                out.append(str(value))
                i = j - len(pending)
            else:
                out.append(tok)
                i += 1
        else:
            out.append(tok)
            i += 1
    return "".join(out)


# Time pairing: "at 5 30" → "5:30" (digit pairs in time position)
_TIME_PAIR = re.compile(r"\b(at|by|around|about)\s+(\d{1,2})\s+(\d{2})\b", re.I)
# "5 o'clock" → "5:00"
_OCLOCK = re.compile(r"\b(\d{1,2})\s+o'?clock\b", re.I)


def normalize_numbers_to_digits(text: str) -> str:
    """Normalize spoken-form expressions in text to digit form."""
    text = _strip_digit_commas(text)
    text = _strip_currency_symbols(text)
    text = _MIXED_FORMAT.sub(
        lambda m: str(int(m.group(1)) * _SCALES[m.group(2).lower()]), text
    )
    text = _convert_word_numbers(text)
    text = _TIME_PAIR.sub(lambda m: f"{m.group(1)} {m.group(2)}:{m.group(3)}", text)
    text = _OCLOCK.sub(lambda m: f"{m.group(1)}:00", text)
    text = _ORDINAL_SUFFIX.sub(r"\1", text)
    text = _A_BEFORE_NUMBER.sub(r"\1", text)
    return text


def normalize_numbers_for_comparison(text1: str, text2: str) -> Tuple[str, str]:
    """Normalize numbers in both texts for accurate comparison."""
    return normalize_numbers_to_digits(text1), normalize_numbers_to_digits(text2)
