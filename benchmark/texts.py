"""Seeded English sentences of an exact length in characters.

Every traffic generator draws its texts here, from its own ``numpy`` generator,
so the same seed gives the same texts.
"""

from __future__ import annotations

import numpy as np

WORDS = (
    "the of and to in is was that for it with as his on be at by had are but from or "
    "have an they which one you were her all she there would their we him been has when "
    "who will more no if out so said what up its about into than them can only other new "
    "some could time these two may then do first any my now such like our over man me even "
    "most made after also did many before must through back years where much your way well "
    "down should because each just those people how too little state good very make world "
    "still own see men work long get here between both life being under never day same "
    "another know while last might us great old year off come since against go came right "
    "used take three morning river garden window letter evening quiet bright stone music "
    "paper harbor winter summer station village mountain forest island market story voice "
    "careful gentle sudden distant golden narrow ancient simple friendly"
).split()


def sentence(rng: np.random.Generator, n_chars: int) -> str:
    """An English-looking sentence of exactly ``n_chars`` characters (ASCII)."""
    if n_chars < 2:
        raise ValueError(f"a sentence needs at least 2 characters, not {n_chars}")
    words, length = [], 0
    while length < n_chars:
        w = WORDS[int(rng.integers(len(WORDS)))]
        words.append(w)
        length += len(w) + 1
    body = " ".join(words)[: n_chars - 1]
    if body.endswith(" "):
        body = body[:-1] + "a"
    return body[0].upper() + body[1:] + "."
