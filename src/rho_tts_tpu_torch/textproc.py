"""Host-side text preprocessing: phonetic mapping and segmentation.

Long-form synthesis never scales a single model call's sequence; instead the
text is split at sentence/word boundaries under a per-provider character cap
(refined by free device memory), and the resulting audio segments are
re-joined on the device with equal-power crossfades. The port's own copy of
``rho_tts_tpu.textproc``: the same segments for the same text.
"""

from __future__ import annotations

from typing import Dict, List


def apply_phonetic_mapping(text: str, mapping: Dict[str, str]) -> str:
    """Replace words with phonetic respellings to improve pronunciation.

    Example: ``{"exocrine": "exo-crene"}``.
    """
    for original, phonetic in mapping.items():
        text = text.replace(original, phonetic)
    return text


def split_text_into_segments(
    text: str,
    max_chars: int,
    force_sentence_split: bool = True,
) -> List[str]:
    """Split text into segments at natural break points.

    Sentences (split on ``". "``) are greedily packed into segments no longer
    than ``max_chars``.  With ``force_sentence_split`` every sentence becomes
    its own segment (when there is more than one).  Over-long sentences are
    split at word boundaries; single over-long words are hard-cut.

    Parity: reference ``src/rho_tts/base_tts.py:538-585``.
    """
    sentences = text.split(". ")
    segments: List[str] = []
    current = ""

    for pos, sentence in enumerate(sentences):
        # Re-attach the delimiter to every sentence except the final one.
        # (The reference compares by value; comparing by position is
        # equivalent except for duplicate sentences, where by-position is
        # strictly more correct.)
        if pos != len(sentences) - 1:
            sentence += ". "

        force_split = force_sentence_split and len(sentences) > 1

        if force_split or len(current) + len(sentence) > max_chars:
            if current:
                segments.append(current.strip())
                current = sentence
            else:
                if len(sentence) > max_chars:
                    words = sentence.split()
                    current = ""
                    for word in words:
                        if len(current) + len(word) + 1 > max_chars:
                            if current:
                                segments.append(current.strip())
                                current = word
                            else:
                                segments.append(word[:max_chars])
                                current = ""
                        else:
                            current += " " + word if current else word
                else:
                    segments.append(sentence.strip())
        else:
            current += sentence

    if current.strip():
        segments.append(current.strip())

    return segments
