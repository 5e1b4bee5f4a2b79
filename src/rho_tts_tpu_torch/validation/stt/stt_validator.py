"""Speech-to-text validation: transcribe and fuzzy-match against the input.

Counterpart of ``rho_tts_tpu/validation/stt/stt_validator.py``. The
transcription backend is the port's Whisper (``models.whisper``), batched
on the device. Real checkpoint weights are required for meaningful
transcriptions; without them the transcriber is unavailable and validation
passes (the reference behaves the same when its model is unavailable —
transcription failure ⇒ pass), unless ``RHO_TTS_TPU_STT_ALLOW_RANDOM=1``
keeps the full compute path live on random weights.

Similarity scoring combines Jaccard-over-fuzzy-matched words, a
match-ratio, and difflib sequence similarity, taking the maximum (a
forgiving comparison that tolerates STT quirks). Levenshtein distance is a
pure-Python loop.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .number_normalizer import normalize_numbers_to_digits

logger = logging.getLogger(__name__)

# Lazy transcribers by device; set once the checkpoint lookup failed
_whisper: Dict[str, object] = {}
_whisper_failed = False

#: Transcriptions that raised and so passed the gate (the JAX package's
#: best-effort semantics; the chip smoke run requires 0).
failed_transcriptions = 0


def _normalize_text(text: str, enable_number_normalization: bool = True) -> str:
    """Lowercase, strip articles/punctuation, normalize numbers."""
    if enable_number_normalization:
        try:
            text = normalize_numbers_to_digits(text)
        except Exception as e:  # noqa: BLE001
            logger.warning("Number normalization failed: %s", e)

    text = text.lower()
    text = re.sub(r"\b(the|a|an)\b", " ", text)
    text = text.replace("-", " ")
    text = re.sub(r"[^\w\s']", " ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _device_of(audio, device) -> str:
    if isinstance(audio, torch.Tensor):
        return str(audio.device)
    return str(torch.device(device or "cuda"))


def _get_transcriber(device="cuda"):
    """Lazy-load the Whisper transcriber on ``device`` (needs real weights,
    or ``RHO_TTS_TPU_STT_ALLOW_RANDOM=1``)."""
    global _whisper_failed
    key = str(torch.device(device))
    if key in _whisper or _whisper_failed:
        return _whisper.get(key)
    try:
        from ...models.whisper import WhisperTranscriber

        model_path = os.environ.get("RHO_TTS_TPU_WHISPER_MODEL", "whisper-tiny")
        whisper = WhisperTranscriber.from_pretrained(model_path, device=key)
        if not whisper.has_real_weights:
            # RHO_TTS_TPU_STT_ALLOW_RANDOM=1 keeps the gate's full compute
            # path live on checkpoint-less hosts (throughput runs,
            # end-to-end pipeline tests); transcriptions are then not
            # meaningful, so pair it with text_similarity_threshold=0.
            if os.environ.get("RHO_TTS_TPU_STT_ALLOW_RANDOM") == "1":
                logger.warning(
                    "Whisper running with RANDOM weights (allowed by "
                    "RHO_TTS_TPU_STT_ALLOW_RANDOM) — transcriptions are not "
                    "meaningful; throughput/compute path only."
                )
            else:
                logger.warning(
                    "Whisper checkpoint not found (set RHO_TTS_TPU_WHISPER_MODEL to a "
                    "local dir) — STT validation will be skipped."
                )
                _whisper_failed = True
                return None
        _whisper[key] = whisper
    except Exception as e:  # noqa: BLE001
        logger.warning("Whisper unavailable: %s — STT validation will be skipped.", e)
        _whisper_failed = True
    return _whisper.get(key)


def transcribe_audio(audio: Union[str, Tuple], sample_rate: Optional[int] = None,
                     device=None) -> Optional[str]:
    """Transcribe a wav path or in-memory (waveform, sr) pair.

    Returns None when transcription is unavailable or fails. A tensor is
    transcribed on its device, host input on ``device`` (default "cuda").
    """
    global failed_transcriptions
    if isinstance(audio, tuple):
        audio, sample_rate = audio
    if isinstance(audio, str) and not os.path.exists(audio):
        logger.error("Audio file not found: %s", audio)
        return None

    model = _get_transcriber(_device_of(audio, device))
    if model is None:
        return None
    try:
        if isinstance(audio, str):
            from ...audio_io import load_wav

            audio, sample_rate = load_wav(audio)
        return model.transcribe(audio, sample_rate).strip()
    except Exception as e:  # noqa: BLE001
        failed_transcriptions += 1
        logger.warning("Error transcribing audio: %s", e)
        return None


def _levenshtein_distance(s1: str, s2: str) -> int:
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    if not s2:
        return len(s1)
    previous = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1):
        current = [i + 1]
        for j, c2 in enumerate(s2):
            current.append(min(previous[j + 1] + 1, current[j] + 1, previous[j] + (c1 != c2)))
        previous = current
    return previous[-1]


def _fuzzy_word_match(word1: str, word2: str, max_distance: int = 2) -> bool:
    """Words match if identical or within a length-adjusted edit distance."""
    if word1 == word2:
        return True
    if len(word1) < 3 or len(word2) < 3:
        return False
    adjusted = max_distance + (1 if len(word1) > 8 or len(word2) > 8 else 0)
    return _levenshtein_distance(word1, word2) <= adjusted


def calculate_text_similarity(original_text: str, transcribed_text: str) -> float:
    """Similarity in [0, 1]: max of Jaccard, match-ratio, sequence ratio."""
    from difflib import SequenceMatcher

    orig_norm = _normalize_text(original_text)
    trans_norm = _normalize_text(transcribed_text)

    orig_words = set(orig_norm.split())
    trans_words = set(trans_norm.split())
    if not orig_words or not trans_words:
        return 0.0

    exact = orig_words & trans_words
    fuzzy = 0
    for ow in orig_words - trans_words:
        for tw in trans_words - orig_words:
            if _fuzzy_word_match(ow, tw):
                fuzzy += 1
                break

    total = len(exact) + fuzzy
    union = len(orig_words | trans_words)
    jaccard = total / union if union else 0.0
    ratio = total / len(orig_words)
    seq = SequenceMatcher(None, orig_norm, trans_norm).ratio()
    return max(jaccard, ratio, seq)


def validate_audio_text_match_batch(
    audios,
    expected_texts,
    threshold: float = 0.85,
    device=None,
):
    """Batched validation: one transcription pass for the whole batch.

    ``audios`` is a list of (waveform, sample_rate) pairs or paths; tensors
    stay on their device (the first one's decides, host input goes to
    ``device``, default "cuda"). Returns a list of (is_valid, similarity,
    transcription) tuples.
    """
    global failed_transcriptions
    first = audios[0][0] if audios and isinstance(audios[0], tuple) else None
    model = _get_transcriber(_device_of(first, device))
    if model is None:
        return [(True, 0.0, None) for _ in audios]

    wavs, srs = [], []
    try:
        for a in audios:
            if isinstance(a, tuple):
                wav, sr = a
            else:
                from ...audio_io import load_wav

                wav, sr = load_wav(a)
            wavs.append(wav if isinstance(wav, torch.Tensor) else np.asarray(wav, np.float32))
            srs.append(sr)
        transcriptions = model.transcribe_batch(wavs, srs)
    except Exception as e:  # noqa: BLE001
        failed_transcriptions += 1
        logger.warning("Batched transcription failed: %s", e)
        return [(True, 0.0, None) for _ in audios]

    out = []
    for text, transcribed in zip(expected_texts, transcriptions):
        transcribed = (transcribed or "").strip()
        if not transcribed:
            out.append((True, 0.0, None))
            continue
        sim = calculate_text_similarity(text, transcribed)
        out.append((sim >= threshold, sim, transcribed))
    return out


def validate_audio_text_match(
    audio: Union[str, Tuple],
    expected_text: str,
    threshold: float = 0.85,
    device=None,
) -> Tuple[bool, float, Optional[str]]:
    """(is_valid, similarity, transcription) for audio vs expected text.

    Transcription failure is treated as a pass (True, 0.0, None) — the
    generation shouldn't be rejected because validation infra is down.
    """
    transcribed = transcribe_audio(audio, device=device)
    if transcribed is None:
        logger.warning("Transcription failed, skipping text validation")
        return True, 0.0, None

    similarity = calculate_text_similarity(expected_text, transcribed)
    return similarity >= threshold, similarity, transcribed
