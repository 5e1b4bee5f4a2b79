"""Polyphase windowed-sinc resampling in PyTorch.

Counterpart of ``rho_tts_tpu/ops/resample.py``: torchaudio's
``functional.resample`` with the default ``sinc_interp_hann`` method
(lowpass_filter_width=6, rolloff=0.99), one filter per output phase.

The JAX package applies the bank as a strided convolution. The port frames
the padded signal (a strided view, one frame per group of ``orig_freq``
input samples) and multiplies the frames by the bank with ``torch.matmul``
in float32. It deliberately avoids ``F.conv1d``: cuDNN convolutions may run
float32 in TF32 by PyTorch's default (``torch.backends.cudnn.allow_tf32``),
which would round the input to 10 mantissa bits; float32 matmuls do not use
TF32 unless the caller turns on ``torch.backends.cuda.matmul.allow_tf32``.

Used for playback-speed adjustment (reference ``base_tts.py:631-638``),
the pitch shifter, resampling reference audio to the codec's rate, and
(:func:`resample_batch`) the 16 kHz inputs of the Whisper and drift-feature
batch paths.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=64)
def _sinc_kernel_np(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                    rolloff: float = 0.99):
    """The (new_freq, kernel_width) filter bank (float32) and its half-width."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)

    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t *= np.pi
    scale = base_freq / orig_freq
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * window * scale
    return kernels.astype(np.float32), width


@lru_cache(maxsize=64)
def _sinc_kernel(orig_freq: int, new_freq: int, device: str) -> tuple:
    """The filter bank transposed to (kernel_width, new_freq) on ``device``."""
    bank, width = _sinc_kernel_np(orig_freq, new_freq)
    return torch.as_tensor(bank.T.copy(), device=device), width


def _resample_core(x: torch.Tensor, orig_freq: int, new_freq: int, target_length: int):
    """(L,) -> (target_length,): frames of the padded signal times the bank."""
    bank, width = _sinc_kernel(orig_freq, new_freq, str(x.device))
    padded = F.pad(x, (width, width + orig_freq))
    frames = padded.unfold(-1, bank.shape[0], orig_freq)  # (..., T, K)
    out = torch.matmul(frames, bank)  # (..., T, new_freq): phases interleave per frame
    return out.flatten(-2)[..., :target_length]


def resample(audio, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample a 1-D waveform from ``orig_freq`` to ``new_freq`` Hz."""
    a = torch.as_tensor(audio).to(torch.float32).reshape(-1)
    orig_freq, new_freq = int(orig_freq), int(new_freq)
    if orig_freq == new_freq or a.shape[-1] == 0:
        return a
    g = math.gcd(orig_freq, new_freq)
    of, nf = orig_freq // g, new_freq // g
    return _resample_core(a, of, nf, math.ceil(nf * a.shape[-1] / of))


def resample_batch(wavs: torch.Tensor, orig_freq: int, new_freq: int,
                   target_length: int) -> torch.Tensor:
    """Resample a (B, L) batch to ``target_length`` samples per row.

    One framed matmul for the whole batch, on the batch's device. At equal
    rates the rows are cut or zero-padded to ``target_length``; otherwise
    the output is cut at ``target_length`` (a shorter natural length stays
    shorter, as in the JAX package). Shared by the STT and drift-feature
    batch paths.
    """
    wavs = torch.as_tensor(wavs).to(torch.float32)
    orig_freq, new_freq = int(orig_freq), int(new_freq)
    if orig_freq == new_freq:
        cur = wavs.shape[-1]
        if cur >= target_length:
            return wavs[..., :target_length]
        return F.pad(wavs, (0, target_length - cur))
    g = math.gcd(orig_freq, new_freq)
    return _resample_core(wavs, orig_freq // g, new_freq // g, target_length)
