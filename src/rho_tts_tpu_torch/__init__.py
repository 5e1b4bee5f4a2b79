"""PyTorch/CUDA port of rho-tts-tpu for NVIDIA Hopper GPUs.

A second package beside ``rho_tts_tpu`` (the JAX reference, which this
package never imports). It mirrors the reference's module layout so each
module's counterpart is found under the same path. This slice covers the
Qwen3-TTS main path: prompt -> prefill -> chunked decode -> vocoder through
:meth:`rho_tts_tpu_torch.models.qwen.model.QwenTTSModel.synthesize`, with
hand-written CUDA kernels for prefill and decode attention
(``csrc/``, bound in ``ops/cuda/``).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
