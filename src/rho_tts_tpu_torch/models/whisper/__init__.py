"""Whisper (tiny-class) encoder-decoder for STT validation, in PyTorch.

Counterpart of ``rho_tts_tpu/models/whisper``: a batched log-mel frontend,
conv + transformer encoder, and greedy or beam decoding over a KV cache on
the device, so text-match validation runs beside generation.
"""

from .model import WhisperConfig, WhisperModel, WhisperTranscriber
