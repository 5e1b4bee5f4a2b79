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
``ops/cuda/``). Around them, the host-only layers: subprocess isolation
(``isolation/``, the factory's route for a built-in whose dependencies
do not import), the Gradio web UI (``ui/``, :func:`launch_ui`), profiler
traces (``utils.profiling.start_trace``) and :func:`train_drift_classifier`.

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
    "launch_ui",
    "train_drift_classifier",
]


def launch_ui(**kwargs):
    """Launch the Gradio web UI. Requires the ``ui`` extra (gradio)."""
    from .ui import launch_ui as _launch_ui

    _launch_ui(**kwargs)


def train_drift_classifier(
    dataset_dir: str,
    voice_id: str | None = None,
    output_path: str | None = None,
    progress_callback=None,
):
    """Train a drift-detection classifier from a good/ + bad/ dataset dir.

    Args:
        dataset_dir: Directory containing 'good/' and 'bad/' subdirectories
            of .wav files.
        voice_id: Voice ID to associate with this model (per-voice store).
        output_path: Explicit path for the trained model.
        progress_callback: Optional callable receiving progress messages.

    Features are extracted on the GPU (the trainer's default device).
    """
    from .validation.classifier.trainer import train

    return train(
        dataset_dir=dataset_dir,
        voice_id=voice_id,
        output_path=output_path,
        progress_callback=progress_callback,
    )
