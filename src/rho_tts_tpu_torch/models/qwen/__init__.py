"""Qwen3-TTS-class codec-LM model family (PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen``: an autoregressive talker
predicts codec tokens at 12.5 Hz, a residual code predictor fills the
other codebooks and the codec vocoder turns the codes into 24 kHz audio.
"""

from .config import PRESETS, CodecConfig, QwenTTSConfig, resolve_config
from .model import QwenTTSModel

__all__ = ["PRESETS", "CodecConfig", "QwenTTSConfig", "QwenTTSModel", "resolve_config"]
