"""UI runtime state: cached TTS instance, history, cancellation.

One live TTS engine at a time, cached on (voice_id, model_id); switching
voice or model tears the old instance down (``close()``, which releases the
GPU memory of its models) before building the new one. Constructor kwargs
are assembled from the model's defaults, per-voice+model overrides, and the
voice profile.

Counterpart of ``rho_tts_tpu/ui/state.py``.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Tuple

from . import config as cfgmod
from ..cancellation import CancellationToken
from .config import AppConfig, GenerationRecord, ModelConfig, VoiceProfile

logger = logging.getLogger(__name__)

# Constructor kwargs only ChatterboxTTS understands
_CHATTERBOX_ONLY_PARAMS = {"implementation", "temperature", "cfg_weight"}
# Constructor kwargs only QwenTTS understands
_QWEN_ONLY_PARAMS = {
    "speaker", "language", "batch_size", "sound_decay_threshold",
    # GPU serving knobs ("quantization" and "serving" are shared: both
    # providers quantize their talkers and serve through a slot batch —
    # Qwen via serving.ServingEngine, Chatterbox via
    # serving_cb.ChatterboxServingEngine)
    "parallelism", "n_devices", "draft_model_path", "speculative_gamma",
    "lora_path",
}


class AppState:
    """Mutable application state shared by the UI callbacks."""

    def __init__(self, config: Optional[AppConfig] = None, multi_user: bool = False):
        self.config = config if config is not None else cfgmod.load_config()
        self.multi_user = multi_user
        self._tts = None
        self._tts_key: Optional[Tuple[str, str]] = None
        self._lock = threading.Lock()
        self._history: Optional[List[GenerationRecord]] = None
        self._cancellation_token: Optional[CancellationToken] = None

    # -- Persistence (no-op in multi-user sessions) -------------------------

    def save(self) -> None:
        if not self.multi_user:
            cfgmod.save_config(self.config)

    def save_history(self) -> None:
        if not self.multi_user:
            cfgmod.save_history(self.history)

    # -- TTS instance cache --------------------------------------------------

    def build_tts_kwargs(self, model: ModelConfig, voice: VoiceProfile) -> Dict:
        """Assemble constructor kwargs: model defaults → saved overrides →
        voice profile attributes, filtered per provider."""
        kwargs: Dict = dict(model.default_params)
        kwargs.update(self.config.get_parameter_override(voice.id, model.id))
        kwargs["model_path"] = model.model_path

        if model.provider == "qwen":
            for k in _CHATTERBOX_ONLY_PARAMS:
                kwargs.pop(k, None)
            if voice.is_cloning:
                kwargs["reference_audio"] = voice.reference_audio
                kwargs["reference_text"] = voice.reference_text
            elif voice.speaker:
                kwargs["speaker"] = voice.speaker
            kwargs["language"] = voice.language
        elif model.provider == "chatterbox":
            for k in _QWEN_ONLY_PARAMS:
                kwargs.pop(k, None)
            kwargs.pop("model_path", None)
            if voice.is_cloning:
                kwargs["reference_audio"] = voice.reference_audio

        mapping = self.config.get_phonetic_mapping(voice.id, model.id)
        if mapping:
            kwargs["phonetic_mapping"] = dict(mapping)

        # Normalize UI serving-knob sentinels to constructor values
        if kwargs.get("quantization") in ("", "bf16", "none"):
            kwargs["quantization"] = None
        if kwargs.get("parallelism") in ("", "none"):
            kwargs["parallelism"] = None
        if not kwargs.get("draft_model_path"):
            kwargs.pop("draft_model_path", None)
        if not kwargs.get("lora_path"):
            kwargs.pop("lora_path", None)
        return kwargs

    def get_or_create_tts(self, model: ModelConfig, voice: VoiceProfile):
        """Return the cached engine for (voice, model), rebuilding on change."""
        key = (voice.id, model.id)
        with self._lock:
            if self._tts is not None and self._tts_key == key:
                return self._tts

            if self._tts is not None:
                logger.info("Switching TTS instance %s → %s", self._tts_key, key)
                try:
                    self._tts.close()
                except Exception:  # noqa: BLE001
                    pass
                self._tts = None
                self._tts_key = None

            from ..factory import TTSFactory

            kwargs = self.build_tts_kwargs(model, voice)
            tts = TTSFactory.get_tts_instance(provider=model.provider, **kwargs)
            tts.voice_id = voice.id
            self._tts = tts
            self._tts_key = key
            return tts

    def invalidate_tts(self) -> None:
        """Tear down the cached engine (e.g. after a settings change)."""
        with self._lock:
            if self._tts is not None:
                try:
                    self._tts.close()
                except Exception:  # noqa: BLE001
                    pass
            self._tts = None
            self._tts_key = None

    # -- History --------------------------------------------------------------

    @property
    def history(self) -> List[GenerationRecord]:
        if self._history is None:
            self._history = [] if self.multi_user else cfgmod.load_history()
        return self._history

    def add_record(self, record: GenerationRecord) -> None:
        self.history.append(record)
        self.save_history()

    def delete_record(self, record_id: str) -> bool:
        before = len(self.history)
        self._history = [r for r in self.history if r.id != record_id]
        if len(self._history) != before:
            self.save_history()
            return True
        return False

    def get_record(self, record_id: str) -> Optional[GenerationRecord]:
        return next((r for r in self.history if r.id == record_id), None)

    def clear_history(self) -> int:
        """Delete every history record; returns how many were removed.

        The Library tab's "Clear All History".
        """
        n = len(self.history)
        self._history = []
        if n:
            self.save_history()
        return n

    # -- Cancellation ----------------------------------------------------------

    def new_cancellation_token(self) -> CancellationToken:
        self._cancellation_token = CancellationToken()
        return self._cancellation_token

    def cancel_generation(self) -> None:
        if self._cancellation_token is not None:
            self._cancellation_token.cancel()
