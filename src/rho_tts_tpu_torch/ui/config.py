"""UI configuration: dataclasses, model catalog, JSON persistence.

Persists to ``~/.rho_tts_tpu_torch/config.json`` (voices, models, phonetic
mappings, per-voice+model parameter overrides) and ``history.json``
(generation records), overridable via the ``RHO_TTS_TPU_CONFIG`` /
``RHO_TTS_TPU_HISTORY`` env vars (the JAX package's names).

Counterpart of ``rho_tts_tpu/ui/config.py``: the same dataclasses, catalog
and JSON format, so a config or history that one package wrote, the other
loads and saves back byte for byte. Its own directory, so a GPU install
never overwrites a TPU install's files.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

CONFIG_ENV = "RHO_TTS_TPU_CONFIG"
HISTORY_ENV = "RHO_TTS_TPU_HISTORY"

APP_DIR = os.path.join(os.path.expanduser("~"), ".rho_tts_tpu_torch")
VOICES_DIR = os.path.join(APP_DIR, "voices")
DATASETS_DIR = os.path.join(APP_DIR, "datasets")
OUTPUTS_DIR = os.path.join(APP_DIR, "outputs")


# ---------------------------------------------------------------------------
# Provider model catalog
# ---------------------------------------------------------------------------

PROVIDER_MODELS: Dict[str, List[dict]] = {
    "qwen": [
        {
            "id": "qwen-1.7b-base",
            "label": "Qwen3-TTS 1.7B Base (voice cloning)",
            "model_path": "Qwen/Qwen3-TTS-12Hz-1.7B-Base",
            "needs_reference": True,
            "default_params": {
                "max_iterations": 10,
                "accent_drift_threshold": 0.17,
                "text_similarity_threshold": 0.85,
                "sound_decay_threshold": 0.3,
            },
        },
        {
            "id": "qwen-1.7b-custom",
            "label": "Qwen3-TTS 1.7B CustomVoice (named speakers)",
            "model_path": "Qwen/Qwen3-TTS-12Hz-1.7B-CustomVoice",
            "needs_reference": False,
            "default_params": {
                "max_iterations": 10,
                "accent_drift_threshold": 0.17,
                "text_similarity_threshold": 0.85,
                "sound_decay_threshold": 0.3,
            },
        },
        {
            "id": "qwen-0.6b-base",
            "label": "Qwen3-TTS 0.6B Base (voice cloning)",
            "model_path": "Qwen/Qwen3-TTS-12Hz-0.6B-Base",
            "needs_reference": True,
            "default_params": {
                "max_iterations": 10,
                "accent_drift_threshold": 0.17,
                "text_similarity_threshold": 0.85,
                "sound_decay_threshold": 0.3,
            },
        },
        {
            "id": "qwen-0.6b-custom",
            "label": "Qwen3-TTS 0.6B CustomVoice (named speakers)",
            "model_path": "Qwen/Qwen3-TTS-12Hz-0.6B-CustomVoice",
            "needs_reference": False,
            "default_params": {
                "max_iterations": 10,
                "accent_drift_threshold": 0.17,
                "text_similarity_threshold": 0.85,
                "sound_decay_threshold": 0.3,
            },
        },
    ],
    "chatterbox": [
        {
            "id": "chatterbox-standard",
            "label": "Chatterbox (standard)",
            "model_path": "chatterbox-standard",
            "needs_reference": False,
            "default_params": {
                "implementation": "standard",
                "max_iterations": 50,
                "accent_drift_threshold": 0.17,
                "text_similarity_threshold": 0.75,
                "temperature": 1.0,
                "cfg_weight": 0.6,
            },
        },
        {
            "id": "chatterbox-faster",
            "label": "Chatterbox (faster)",
            "model_path": "chatterbox-faster",
            "needs_reference": False,
            "default_params": {
                "implementation": "faster",
                "max_iterations": 50,
                "accent_drift_threshold": 0.17,
                "text_similarity_threshold": 0.75,
                "temperature": 1.0,
                "cfg_weight": 0.6,
            },
        },
    ],
}

QWEN_BUILTIN_SPEAKERS = [
    "Chelsie", "Aidan", "Vivian", "Ryan", "Aria", "Ethan", "Luna", "Harper", "James",
]


def builtin_voices() -> List["VoiceProfile"]:
    """Built-in named speakers (CustomVoice models) + default voices."""
    voices = [
        VoiceProfile(
            id=f"builtin-{name.lower()}",
            name=name,
            provider="qwen",
            speaker=name,
            is_builtin=True,
        )
        for name in QWEN_BUILTIN_SPEAKERS
    ]
    voices.append(
        VoiceProfile(
            id="builtin-chatterbox-default",
            name="Chatterbox Default",
            provider="chatterbox",
            is_builtin=True,
        )
    )
    return voices


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------


@dataclass
class VoiceProfile:
    """A voice: either a built-in named speaker or a cloning profile."""

    id: str
    name: str
    provider: str = "qwen"
    speaker: Optional[str] = None  # named speaker (CustomVoice)
    reference_audio: Optional[str] = None  # cloning reference
    reference_text: Optional[str] = None
    language: str = "English"
    is_builtin: bool = False

    @property
    def is_cloning(self) -> bool:
        return self.reference_audio is not None

    @classmethod
    def from_dict(cls, d: dict) -> "VoiceProfile":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class ModelConfig:
    """A model entry: provider + path + default generation parameters."""

    id: str
    label: str
    provider: str
    model_path: str
    needs_reference: bool = False
    default_params: Dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class GenerationRecord:
    """One generation, for the Library tab."""

    id: str
    text: str
    voice_id: str
    model_id: str
    output_path: Optional[str]
    timestamp: float
    duration_sec: float = 0.0
    format: str = "wav"
    speed: float = 1.0
    pitch_semitones: float = 0.0
    drift_prob: Optional[float] = None
    text_similarity: Optional[float] = None

    @classmethod
    def new(cls, **kwargs) -> "GenerationRecord":
        kwargs.setdefault("id", uuid.uuid4().hex[:12])
        kwargs.setdefault("timestamp", time.time())
        return cls(**kwargs)

    @classmethod
    def from_dict(cls, d: dict) -> "GenerationRecord":
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


def default_models() -> List[ModelConfig]:
    out = []
    for provider, entries in PROVIDER_MODELS.items():
        for e in entries:
            out.append(ModelConfig(provider=provider, **e))
    return out


@dataclass
class AppConfig:
    """Full persisted configuration."""

    voices: List[VoiceProfile] = field(default_factory=builtin_voices)
    models: List[ModelConfig] = field(default_factory=default_models)
    # phonetic mappings keyed by composite "voice::model"
    phonetic_mappings: Dict[str, Dict[str, str]] = field(default_factory=dict)
    # parameter overrides keyed by composite "voice::model"
    parameter_overrides: Dict[str, Dict] = field(default_factory=dict)
    last_voice_id: Optional[str] = None
    last_model_id: Optional[str] = None

    # -- Lookup helpers ----------------------------------------------------

    def get_voice(self, voice_id: str) -> Optional[VoiceProfile]:
        return next((v for v in self.voices if v.id == voice_id), None)

    def get_model(self, model_id: str) -> Optional[ModelConfig]:
        return next((m for m in self.models if m.id == model_id), None)

    @staticmethod
    def composite_key(voice_id: str, model_id: str) -> str:
        """Key for per-voice+model mappings/overrides."""
        return f"{voice_id}::{model_id}"

    def get_phonetic_mapping(self, voice_id: str, model_id: str) -> Dict[str, str]:
        return self.phonetic_mappings.get(self.composite_key(voice_id, model_id), {})

    def get_parameter_override(self, voice_id: str, model_id: str) -> Dict:
        return self.parameter_overrides.get(self.composite_key(voice_id, model_id), {})

    # -- Serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "voices": [asdict(v) for v in self.voices],
            "models": [asdict(m) for m in self.models],
            "phonetic_mappings": self.phonetic_mappings,
            "parameter_overrides": self.parameter_overrides,
            "last_voice_id": self.last_voice_id,
            "last_model_id": self.last_model_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "AppConfig":
        cfg = cls(
            voices=[VoiceProfile.from_dict(v) for v in d.get("voices", [])],
            models=[ModelConfig.from_dict(m) for m in d.get("models", [])],
            phonetic_mappings=d.get("phonetic_mappings", {}),
            parameter_overrides=d.get("parameter_overrides", {}),
            last_voice_id=d.get("last_voice_id"),
            last_model_id=d.get("last_model_id"),
        )
        if not cfg.voices:
            cfg.voices = builtin_voices()
        if not cfg.models:
            cfg.models = default_models()
        return cfg


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------


def config_path() -> str:
    return os.environ.get(CONFIG_ENV, os.path.join(APP_DIR, "config.json"))


def history_path() -> str:
    return os.environ.get(HISTORY_ENV, os.path.join(APP_DIR, "history.json"))


def load_config() -> AppConfig:
    path = config_path()
    if os.path.exists(path):
        try:
            with open(path) as f:
                return AppConfig.from_dict(json.load(f))
        except Exception as e:  # noqa: BLE001
            logger.warning("Failed to load config (%s), using defaults", e)
    return AppConfig()


def save_config(cfg: AppConfig) -> None:
    path = config_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)


def load_history() -> List[GenerationRecord]:
    path = history_path()
    if os.path.exists(path):
        try:
            with open(path) as f:
                return [GenerationRecord.from_dict(r) for r in json.load(f)]
        except Exception as e:  # noqa: BLE001
            logger.warning("Failed to load history (%s)", e)
    return []


def save_history(records: List[GenerationRecord]) -> None:
    path = history_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump([asdict(r) for r in records], f, indent=2)


def store_voice_audio(source_path: str, voice_id: str) -> str:
    """Copy a reference audio file into the managed voices directory."""
    os.makedirs(VOICES_DIR, exist_ok=True)
    ext = os.path.splitext(source_path)[1] or ".wav"
    dest = os.path.join(VOICES_DIR, f"{voice_id}{ext}")
    shutil.copy2(source_path, dest)
    return dest


def is_model_cached(model_path: str) -> bool:
    """Whether a HF model id appears in the local huggingface cache."""
    if os.path.isdir(model_path):
        return True
    try:
        cache = os.path.join(os.path.expanduser("~"), ".cache", "huggingface", "hub")
        needle = "models--" + model_path.replace("/", "--")
        return os.path.isdir(os.path.join(cache, needle))
    except Exception:  # noqa: BLE001
        return False
