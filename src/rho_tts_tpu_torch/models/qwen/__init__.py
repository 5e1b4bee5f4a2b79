"""Qwen3-TTS-class codec-LM model family (PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen``: an autoregressive talker
predicts codec tokens at 12.5 Hz, a residual code predictor fills the
other codebooks and the codec vocoder turns the codes into 24 kHz audio.
Voice adaptation: a full fine-tune (``train``), LoRA adapters (``lora``,
served by ``QwenTTSModel(lora_path=...)``) and draft distillation for
speculative decoding (``distill``).
"""

from . import distill, lora, train
from .config import PRESETS, CodecConfig, QwenTTSConfig, resolve_config
from .distill import distill_draft
from .lora import apply_lora, init_lora_train_state, load_lora, lora_train_step, save_lora
from .model import QwenTTSModel
from .train import (
    init_train_state,
    make_optimizer,
    restore_train_state,
    save_train_state,
    train_step,
)

__all__ = [
    "PRESETS", "CodecConfig", "QwenTTSConfig", "QwenTTSModel", "resolve_config",
    "train", "lora", "distill",
    "make_optimizer", "init_train_state", "train_step", "save_train_state",
    "restore_train_state",
    "apply_lora", "init_lora_train_state", "lora_train_step", "save_lora", "load_lora",
    "distill_draft",
]
