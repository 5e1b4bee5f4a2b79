"""PyTorch/CUDA port of rho-tts-tpu for NVIDIA Hopper GPUs.

A second package beside ``rho_tts_tpu`` (the JAX reference, which this
package never imports). It mirrors the reference's module layout so each
module's counterpart is found under the same path. It covers the
Qwen3-TTS path: prompt -> prefill -> chunked decode -> vocoder through
:meth:`rho_tts_tpu_torch.models.qwen.model.QwenTTSModel.synthesize`, with
weight-only int8 or int4 talker weights or w8a8 prefill, native
checkpoints and the HF safetensors loader, and hand-written CUDA kernels
for every kernel of the JAX package: prefill and decode attention, the
w8a8 matmul and the int4 matmul (``csrc/``, bound in ``ops/cuda/``).

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
