"""Chatterbox-class TTS model family (PyTorch port).

Counterpart of ``rho_tts_tpu/models/chatterbox``: a Llama-architecture AR
transformer generates 25 Hz speech tokens with classifier-free guidance
(voice conditioning from the shared speaker encoder), decoded to 24 kHz
audio by a conv vocoder, with a spread-spectrum watermark applied on the
device.
"""

from .model import PRESETS, ChatterboxConfig, ChatterboxModel

__all__ = ["PRESETS", "ChatterboxConfig", "ChatterboxModel"]
