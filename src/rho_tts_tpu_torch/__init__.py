"""PyTorch/CUDA port of rho-tts-tpu for NVIDIA Hopper GPUs.

A second package beside ``rho_tts_tpu`` (the JAX reference, which this
package never imports). It mirrors the reference's module layout so each
module's counterpart is found under the same path. It covers the
Qwen3-TTS path end to end: ``TTSFactory`` -> the ``BaseTTS`` engine
(segmentation, retry and decay loops, the fused DSP finalize on the card,
speed/pitch, file output, streaming) -> the ``QwenTTS`` provider (named
speakers and voice cloning) -> ``QwenTTSModel`` (prompt -> prefill ->
chunked decode -> vocoder), with weight-only int8 or int4 talker weights or
w8a8 prefill, native checkpoints and the HF safetensors loader; the
Chatterbox family (``ChatterboxTTS``: CFG-pair decode, voice cloning, the
on-device watermark, candidates and CFG-pair serving); and hand-written
CUDA kernels for every kernel of the JAX package: prefill and decode
attention, the w8a8 matmul and the int4 matmul (``csrc/``, bound in
``ops/cuda/``).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.

Quick start (named speaker)::

    from rho_tts_tpu_torch import TTSFactory

    tts = TTSFactory.get_tts_instance(provider="qwen", speaker="Vivian",
                                      model_path="...CustomVoice...")
    result = tts.generate("Hello world!", "output.wav")
    result.audio        # 1-D float32 tensor on the card
    result.numpy()      # fetched to the host

Voice cloning::

    tts = TTSFactory.get_tts_instance(
        provider="qwen",
        reference_audio="voice_sample.wav",
        reference_text="Transcript of voice sample.",
    )
    result = tts.generate("Hello world!", "output.wav")

Streaming::

    for chunk in tts.stream("A longer text. In two sentences."):
        play(chunk.numpy())
"""

__version__ = "0.1.0"

from .cancellation import CancellationToken, CancelledException
from .engine import BaseTTS
from .exceptions import (
    AudioGenerationError,
    FormatConversionError,
    ModelLoadError,
    ProviderNotFoundError,
    RhoTTSError,
)
from .factory import TTSFactory
from .provider_info import ProviderInfo, VoiceInfo
from .result import GenerationResult

__all__ = [
    "BaseTTS",
    "CancellationToken",
    "CancelledException",
    "TTSFactory",
    "GenerationResult",
    "ProviderInfo",
    "VoiceInfo",
    "RhoTTSError",
    "ProviderNotFoundError",
    "ModelLoadError",
    "AudioGenerationError",
    "FormatConversionError",
    "__version__",
]
