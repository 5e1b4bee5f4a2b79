"""Phase-vocoder pitch shifting in PyTorch.

Counterpart of ``rho_tts_tpu/ops/pitch.py``: torchaudio's
``functional.pitch_shift`` pipeline (n_fft=512, win=512, hop=128, Hann
window): STFT -> phase-vocoder time stretch by ``rate = 2**(-n_steps/12)``
-> ISTFT -> sinc resample back to the original rate -> trim/pad to the
original length, all on the waveform's device.

As in the JAX package, the resample ratio is the best rational of
denominator <= 64 to the irrational semitone rate (<= ~1 cent of pitch
error), which keeps the filter bank small. The stretch's time grid is
built with numpy, the JAX package's own source of it. One deliberate
difference: the phase vocoder's phase math runs in float64 (the JAX
package's runs in float32), so the result stays near the algorithm's exact
value at any length and does not depend on the device's order of
additions (see :func:`phase_vocoder`).

Capability parity: reference ``base_tts.py:640-648``.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import resample as resample_ops
from . import spectral


def rate_fraction(rate: float, max_denominator: int = 64) -> Tuple[int, int]:
    """Best (new, orig) rational approximation of a resample ratio."""
    frac = Fraction(rate).limit_denominator(max_denominator)
    return frac.numerator, frac.denominator


def phase_vocoder(spec: torch.Tensor, rate: float, phase_advance: torch.Tensor) -> torch.Tensor:
    """Time-stretch a complex spectrogram (freq, time) by ``rate``.

    Matches ``torchaudio.functional.phase_vocoder``: magnitude is linearly
    interpolated between neighboring frames; phase is accumulated from
    wrapped frame-to-frame deltas.
    """
    n_time = spec.shape[-1]
    time_steps = torch.as_tensor(
        np.arange(0.0, float(n_time), float(rate), dtype=np.float32), device=spec.device)
    alphas = torch.remainder(time_steps, 1.0)

    spec_pad = torch.cat([spec, spec.new_zeros((spec.shape[0], 2))], dim=-1)
    idx = time_steps.long()
    spec_a = spec_pad[:, idx]
    spec_b = spec_pad[:, idx + 1]

    # The phase grows by up to pi * hop a frame at the top bin, where an f32
    # ulp is ~3e-5 rad; over thousands of frames f32 phase math drifts from
    # the exact value (and a running f32 sum with the order of its
    # additions), so the phase is computed and summed in f64 and wrapped to
    # [0, 2 pi) before going back to f32.
    phase_advance = phase_advance.double()
    phase_0 = torch.angle(spec[..., :1].to(torch.complex128))
    phase = (torch.angle(spec_b.to(torch.complex128)) - torch.angle(spec_a.to(torch.complex128))
             - phase_advance)
    phase = phase - 2.0 * math.pi * torch.round(phase / (2.0 * math.pi))
    phase = phase + phase_advance
    phase = torch.cat([phase_0, phase[..., :-1]], dim=-1)
    phase_acc = torch.remainder(torch.cumsum(phase, dim=-1), 2.0 * math.pi).float()

    mag = alphas[None, :] * torch.abs(spec_b) + (1.0 - alphas[None, :]) * torch.abs(spec_a)
    return mag * torch.exp(1j * phase_acc)


def pitch_shift(audio, sample_rate: int, n_steps: float, bins_per_octave: int = 12,
                n_fft: int = 512) -> torch.Tensor:
    """Shift the pitch of a waveform by ``n_steps`` semitones."""
    a = torch.as_tensor(audio).to(torch.float32).reshape(-1)
    if a.shape[-1] == 0 or n_steps == 0.0:
        return a

    win_length = n_fft
    hop_length = win_length // 4
    window = spectral.hann_window(win_length, device=a.device)
    ori_len = int(a.shape[-1])
    rate = 2.0 ** (-float(n_steps) / bins_per_octave)

    spec = spectral.stft(a, n_fft, hop_length, win_length, window, center=True)
    phase_advance = torch.linspace(0.0, math.pi * hop_length, spec.shape[0],
                                   dtype=torch.float64, device=a.device)[:, None]
    spec_stretch = phase_vocoder(spec, rate, phase_advance)
    len_stretch = int(round(ori_len / rate))
    wav_stretch = spectral.istft(spec_stretch, n_fft, hop_length, win_length, window,
                                 length=len_stretch)
    new_f, orig_f = rate_fraction(rate)
    shifted = resample_ops.resample(wav_stretch, orig_f, new_f)

    if shifted.shape[-1] > ori_len:
        return shifted[:ori_len]
    return F.pad(shifted, (0, ori_len - shifted.shape[-1]))
