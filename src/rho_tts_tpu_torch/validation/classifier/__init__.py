"""Accent-drift classifier: runtime prediction with per-voice model cache.

Counterpart of ``rho_tts_tpu/validation/classifier/__init__.py``. Predicts
P(bad) for generated audio from acoustic features (speaker embedding +
MFCC stats + F0 stats + formants, extracted on the device, see
``ops.features``). Model lookup order, the JAX package's: explicit path →
per-voice store (``~/.rho_tts_tpu/models/{voice_id}_classifier.pkl``) →
the ``RHO_TTS_TPU_CLASSIFIER_MODEL`` env var → bundled global model. The
same pickle files serve both packages.

A loaded forest is converted to tables (``forest_torch``) and scored on the
features' device; the tables move there once and stay.
"""

from __future__ import annotations

import logging
import os
import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Per-voice caches: cache_key -> model, optimal threshold, forest tables
_models: Dict[str, object] = {}
_thresholds: Dict[str, float] = {}
_forest_arrays: Dict[str, object] = {}

_DEFAULT_THRESHOLD = 0.18

ENV_MODEL_VAR = "RHO_TTS_TPU_CLASSIFIER_MODEL"


def get_model_path(voice_id: str) -> str:
    """Default per-voice model path."""
    return os.path.join(
        os.path.expanduser("~"), ".rho_tts_tpu", "models", f"{voice_id}_classifier.pkl"
    )


def clear_cache() -> None:
    """Drop all cached models (used by tests and the UI on retrain)."""
    _models.clear()
    _thresholds.clear()
    _forest_arrays.clear()


def _load_model(model_path: Optional[str] = None, voice_id: Optional[str] = None):
    cache_key = model_path if model_path is not None else (voice_id or "__global__")
    if cache_key in _models:
        return

    import joblib

    if model_path is None:
        if voice_id is not None:
            model_path = get_model_path(voice_id)
        else:
            model_path = os.environ.get(
                ENV_MODEL_VAR,
                os.path.join(os.path.dirname(__file__), "voice_quality_model.pkl"),
            )

    if not os.path.exists(model_path):
        if voice_id is not None:
            logger.debug(
                "No per-voice model for '%s' at %s — drift validation skipped.",
                voice_id,
                model_path,
            )
        else:
            logger.warning(
                "Voice quality model not found at %s. Drift validation unavailable; "
                "set %s or train a model.",
                model_path,
                ENV_MODEL_VAR,
            )
        return

    model_data = joblib.load(model_path)
    if isinstance(model_data, dict):
        _models[cache_key] = model_data["model"]
        _thresholds[cache_key] = model_data.get("optimal_threshold", _DEFAULT_THRESHOLD)
    else:
        _models[cache_key] = model_data
        _thresholds[cache_key] = _DEFAULT_THRESHOLD
    # Convert forests to tables where possible so drift scoring runs on the
    # device (sklearn otherwise)
    try:
        from .forest_torch import convert_forest

        arrays = convert_forest(_models[cache_key])
        if arrays is not None:
            _forest_arrays[cache_key] = arrays
    except Exception as exc:  # noqa: BLE001
        logger.debug("Forest conversion skipped: %s", exc)
    logger.info("Voice quality classifier loaded from %s", model_path)


def get_optimal_threshold(voice_id: Optional[str] = None) -> float:
    """Optimal decision threshold from model metadata."""
    _load_model(voice_id=voice_id)
    return _thresholds.get(voice_id or "__global__", _DEFAULT_THRESHOLD)


def _forest_on(cache_key: str, device):
    """The cached forest tables on ``device`` (moved there once), or None."""
    arrays = _forest_arrays.get(cache_key)
    if arrays is not None and arrays["left"].device != device:
        from .forest_torch import to_device

        arrays = _forest_arrays[cache_key] = to_device(arrays, device)
    return arrays


def predict_accent_drift_probability(
    audio: Union[str, np.ndarray, object],
    sample_rate: Optional[int] = None,
    voice_id: Optional[str] = None,
    model_path: Optional[str] = None,
    device=None,
) -> Optional[float]:
    """P(accent drift) in [0, 1] for audio, or None when unavailable.

    ``audio`` may be a file path or an in-memory waveform (then
    ``sample_rate`` is required). A tensor is scored on its device, host
    input on ``device`` (default ``"cuda"``).
    """
    _load_model(model_path, voice_id)
    cache_key = model_path if model_path is not None else (voice_id or "__global__")
    model = _models.get(cache_key)
    if model is None:
        logger.debug("No classifier model loaded, skipping accent drift prediction")
        return None

    from .trainer import extract_features

    feat = extract_features(audio, sample_rate=sample_rate, device=device)
    if feat is None:
        return None

    dev = audio.device if isinstance(audio, torch.Tensor) else torch.device(device or "cuda")
    arrays = _forest_on(cache_key, dev)
    if arrays is not None:
        from .forest_torch import predict_proba as forest_predict

        return float(forest_predict(arrays, feat)[0])

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*does not have valid feature names.*")
        prob = model.predict_proba([feat])[0][1]  # P(bad)
    return float(prob)


def predict_accent_drift_probability_batch(
    audios,
    sample_rate: int,
    voice_id: Optional[str] = None,
    model_path: Optional[str] = None,
    device=None,
):
    """P(accent drift) for a batch of in-memory waveforms.

    Returns a list of floats (None per clip whose features failed). The
    whole batch shares one feature pass and one forest/sklearn inference
    call — the validation hot path of the batched pipeline. Tensors are
    scored on their device, host arrays on ``device`` (default ``"cuda"``).
    """
    _load_model(model_path, voice_id)
    cache_key = model_path if model_path is not None else (voice_id or "__global__")
    model = _models.get(cache_key)
    if model is None:
        logger.debug("No classifier model loaded, skipping accent drift prediction")
        return [None] * len(audios)

    from .trainer import extract_features_batch_audio

    feats = extract_features_batch_audio(audios, sample_rate, device=device)
    ok_idx = [i for i, f in enumerate(feats) if f is not None]
    out: list = [None] * len(audios)
    if not ok_idx:
        return out
    x = np.stack([feats[i] for i in ok_idx])

    first = audios[0]
    dev = first.device if isinstance(first, torch.Tensor) else torch.device(device or "cuda")
    arrays = _forest_on(cache_key, dev)
    if arrays is not None:
        from .forest_torch import predict_proba as forest_predict

        probs = forest_predict(arrays, x).cpu().tolist()
    else:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "ignore", message=".*does not have valid feature names.*"
            )
            probs = model.predict_proba(x)[:, 1]
    for i, pr in zip(ok_idx, probs):
        out[i] = float(pr)
    return out
