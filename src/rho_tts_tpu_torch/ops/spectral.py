"""Spectral primitives: STFT / ISTFT / mel filterbanks, in PyTorch.

Counterpart of ``rho_tts_tpu/ops/spectral.py``, written as that module is
(framing + window + ``torch.fft.rfft``), not through ``torch.stft``, whose
padding and centring conventions differ. The building blocks of the
phase-vocoder pitch shifter and of the log-mel / MFCC feature frontends.
Every function runs on its input's device; windows and filterbanks are
built on the host in float64 and placed on ``device`` as float32.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, periodic: bool = True, device=None) -> torch.Tensor:
    """Hann window matching ``torch.hann_window`` (periodic by default)."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1)))
    return torch.as_tensor(w[:win_length], dtype=torch.float32, device=device)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice signals (..., L) into overlapping frames, shape (..., T, frame_length)."""
    if x.shape[-1] < frame_length:
        return x.new_zeros((*x.shape[:-1], 0, frame_length))
    return x.unfold(-1, frame_length, hop)


def _padded_window(window, win_length: int, n_fft: int, device) -> torch.Tensor:
    if window is None:
        window = hann_window(win_length, device=device)
    window = torch.as_tensor(window, dtype=torch.float32, device=device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _pad_centre(x: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """``jnp.pad(x, (pad, pad), mode)`` with numpy's semantics, also for a
    signal shorter than the pad (reflected again at each end), which
    ``F.pad`` refuses: a gather with numpy's own padded index, over the
    last axis."""
    if mode == "constant":
        return F.pad(x, (pad, pad))
    if mode == "reflect" and pad < x.shape[-1]:  # a gather on the device, no index upload
        flat = x.reshape(-1, x.shape[-1])
        return F.pad(flat, (pad, pad), mode="reflect").reshape(*x.shape[:-1], -1)
    idx = np.pad(np.arange(x.shape[-1]), (pad, pad), mode=mode)
    return x[..., torch.as_tensor(idx, device=x.device)]


def stft(
    x: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    pad_mode: str = "reflect",
) -> torch.Tensor:
    """Short-time Fourier transform matching ``torch.stft`` semantics.

    ``x`` is (..., L); returns a complex tensor (..., n_fft//2 + 1, num_frames).
    """
    win_length = win_length or n_fft
    window = _padded_window(window, win_length, n_fft, x.device)
    if center:
        x = _pad_centre(x, n_fft // 2, pad_mode)
    frames = frame_signal(x, n_fft, hop_length) * window[None, :]
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    return spec.transpose(-1, -2)  # (..., freq, time)


def istft(
    spec: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: Optional[int] = None,
    window: Optional[torch.Tensor] = None,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add, matching ``torch.istft``.

    ``spec`` has shape (freq, time); output is a 1-D waveform. Assumes the
    forward transform used ``center=True``. The overlap-add is a ``fold``
    (each output sample sums its frames in a fixed order: deterministic on
    the GPU, unlike a scatter-add).
    """
    win_length = win_length or n_fft
    window = _padded_window(window, win_length, n_fft, spec.device)

    frames = torch.fft.irfft(spec.T, n=n_fft, dim=-1) * window[None, :]  # (T, n_fft)
    num_frames = frames.shape[0]
    expected_len = n_fft + hop_length * (num_frames - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        out = F.fold(cols.T[None], output_size=(1, expected_len), kernel_size=(1, n_fft),
                     stride=(1, hop_length))
        return out.reshape(-1)

    wav = overlap_add(frames)
    norm = overlap_add((window * window)[None, :].expand(num_frames, n_fft))
    wav = wav / torch.clamp_min(norm, 1e-11)

    # Undo the center padding
    start = n_fft // 2
    if length is not None:
        return wav[start: start + length]
    return wav[start: expected_len - start]


def _hz_to_mel(f: np.ndarray, htk: bool) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray, htk: bool) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    htk: bool = False,
    norm_slaney: bool = True,
    device=None,
) -> torch.Tensor:
    """Triangular mel filterbank, shape (n_mels, n_fft//2 + 1).

    Matches librosa's ``mel`` (slaney scale + slaney area normalization by
    default; set ``htk=True`` for the HTK scale used by some encoders).
    """
    fmax = fmax if fmax is not None else sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)

    mel_min = _hz_to_mel(np.array(fmin), htk)
    mel_max = _hz_to_mel(np.array(fmax), htk)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    if norm_slaney:
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        weights *= enorm[:, None]

    return torch.as_tensor(weights, dtype=torch.float32, device=device)


def dct_matrix(n_mfcc: int, n_mels: int, norm_ortho: bool = True, device=None) -> torch.Tensor:
    """Type-II DCT matrix (n_mfcc, n_mels), orthonormal like scipy/librosa."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2 * n[None, :] + 1) / (2.0 * n_mels))
    if norm_ortho:
        mat *= np.sqrt(1.0 / (2.0 * n_mels))
        mat[0, :] *= 1.0 / np.sqrt(2.0)
    return torch.as_tensor(mat, dtype=torch.float32, device=device)
