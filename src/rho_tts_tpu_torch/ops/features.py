"""Acoustic feature extraction in PyTorch: MFCC, F0 (YIN), LPC formants.

Counterpart of ``rho_tts_tpu/ops/features.py``: mel/MFCC and the YIN
difference function run as batched FFT programs on the input's device;
Levinson-Durbin recursion and polynomial root-finding (tiny, O(order²))
stay on the host in numpy, as there.

Filterbanks, windows and DCT matrices are built once per device and kept
(:func:`device_constant`), so a warm call uploads nothing from the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import spectral

MFCC_SR = 16000


@lru_cache(maxsize=32)
def device_constant(kind: str, device: str, *args):
    """Per-device constant tensors: ``("hann", n)``, ``("mel", sr, n_fft, n_mels)``,
    ``("dct", n_mfcc, n_mels)``."""
    if kind == "hann":
        return spectral.hann_window(*args, device=device)
    if kind == "mel":
        return spectral.mel_filterbank(*args, device=device)
    return spectral.dct_matrix(*args, device=device)


# ---------------------------------------------------------------------------
# MFCC (librosa-compatible defaults)
# ---------------------------------------------------------------------------


def _mfcc_db(wavs: torch.Tensor, sr: int, n_fft: int, hop: int, n_mels: int) -> torch.Tensor:
    """(..., L) -> (..., n_mels, T) mel power in dB, before the top-80 clamp.

    librosa>=0.10 (the reference's pin) zero-pads the centred STFT."""
    dev = str(wavs.device)
    spec = spectral.stft(wavs, n_fft, hop, n_fft, device_constant("hann", dev, n_fft),
                         center=True, pad_mode="constant")
    power = spec.abs() ** 2  # (..., freq, T)
    mels = torch.matmul(device_constant("mel", dev, sr, n_fft, n_mels), power)
    return 10.0 * torch.log10(torch.clamp_min(mels, 1e-10))


def _mfcc_core(wav: torch.Tensor, sr: int, n_mfcc: int, n_fft: int, hop: int,
               n_mels: int) -> torch.Tensor:
    db = _mfcc_db(wav, sr, n_fft, hop, n_mels)
    # power_to_db with ref=1.0, top_db=80 (librosa defaults)
    db = torch.maximum(db, db.max() - 80.0)
    return device_constant("dct", str(wav.device), n_mfcc, n_mels) @ db  # (n_mfcc, T)


def mfcc(wav, sr: int = MFCC_SR, n_mfcc: int = 13, n_fft: int = 2048, hop: int = 512,
         n_mels: int = 128, device=None) -> torch.Tensor:
    """MFCCs of a mono waveform, shape (n_mfcc, T), on the waveform's device
    (``device`` for host input, default ``"cuda"``)."""
    x = torch.as_tensor(wav).to(torch.float32)
    if not isinstance(wav, torch.Tensor):
        x = x.to(device or "cuda")
    return _mfcc_core(x, sr, n_mfcc, n_fft, hop, n_mels)


# ---------------------------------------------------------------------------
# F0 via YIN (batched frames on the device)
# ---------------------------------------------------------------------------


def _yin_cmnd(wav: torch.Tensor, frame_length: int, hop: int, tau_max: int):
    """Cumulative mean-normalized difference per frame.

    ``wav`` (..., L) -> (cmnd (..., T, tau_max+1), e0 (..., T)). The YIN
    difference d(tau) = e0 + e_tau - 2 corr(tau), with corr the FFT
    cross-correlation of the first half-window against the whole frame.
    """
    x = spectral.frame_signal(wav, frame_length, hop)  # (..., T, L)
    w = frame_length // 2
    n_fft = int(2 ** np.ceil(np.log2(frame_length + w)))
    head = x[..., :w]
    spec_head = torch.fft.rfft(head, n_fft, dim=-1)
    spec_full = torch.fft.rfft(x, n_fft, dim=-1)
    corr = torch.fft.irfft(torch.conj(spec_head) * spec_full, n_fft, dim=-1)[..., : w + 1]
    cumsum = torch.cumsum(x * x, dim=-1)
    e0 = cumsum[..., w - 1]  # energy of x[0:w]
    # energy of x[tau:tau+w] for tau in [0, w]
    padded = torch.nn.functional.pad(cumsum, (1, 0))
    e_tau = padded[..., w: 2 * w + 1] - padded[..., : w + 1]
    d = (e0[..., None] + e_tau - 2.0 * corr)[..., : tau_max + 1]
    # Cumulative mean normalization
    csum = torch.cumsum(d[..., 1:], dim=-1)
    tau_idx = torch.arange(1, d.shape[-1], device=d.device, dtype=d.dtype)
    cmnd = d[..., 1:] * tau_idx / torch.clamp_min(csum, 1e-12)
    cmnd = torch.cat([torch.ones_like(d[..., :1]), cmnd], dim=-1)
    return cmnd, e0


def f0_yin(
    wav,
    sr: int = MFCC_SR,
    fmin: float = 65.41,  # C2
    fmax: float = 2093.0,  # C7
    frame_length: int = 2048,
    hop: int = 512,
    threshold: float = 0.1,
    voiced_threshold: float = 0.5,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame F0 estimates and voiced mask (YIN).

    Returns (f0_hz (T,), voiced (T,) bool) on the host. Unvoiced frames
    carry NaN like librosa's pyin output so downstream mean/std can mask
    them. The CMND surface is computed on the waveform's device.
    """
    x = torch.as_tensor(wav).to(torch.float32)
    if not isinstance(wav, torch.Tensor):
        x = x.to(device or "cuda")
    if x.shape[-1] < frame_length:
        x = torch.nn.functional.pad(x, (0, frame_length - x.shape[-1]))
    tau_min = max(int(sr / fmax), 1)
    tau_max = min(int(sr / fmin) + 1, frame_length // 2)
    cmnd, e0 = _yin_cmnd(x, frame_length, hop, tau_max)
    return yin_pick(cmnd.cpu().numpy(), e0.cpu().numpy(), sr, tau_min, tau_max, frame_length,
                    threshold, voiced_threshold)


def yin_pick(
    cmnd: np.ndarray,
    e0: np.ndarray,
    sr: int,
    tau_min: int,
    tau_max: int,
    frame_length: int,
    threshold: float,
    voiced_threshold: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """YIN dip selection on the host, vectorized over frames.

    Semantics: per frame, the candidate lag is the first tau with
    CMND < ``threshold``, walked forward to its local minimum (classic YIN
    absolute-threshold step); if no dip crosses the threshold, the global
    argmin. A frame is voiced when the selected CMND value is below
    ``voiced_threshold`` and the frame has energy. The selected lag is
    refined by parabolic interpolation.
    """
    t_frames = cmnd.shape[0]
    f0 = np.full(t_frames, np.nan, np.float64)
    voiced = np.zeros(t_frames, bool)
    if t_frames == 0:
        return f0, voiced
    energy_gate = 1e-6 * (frame_length // 2)
    active = e0 >= energy_gate  # (T,)

    seg = cmnd[:, tau_min:tau_max]  # (T, R)
    below = seg < threshold
    has_below = below.any(axis=1)
    tau0 = tau_min + np.argmax(below, axis=1)  # first below-threshold lag

    # Walk to the dip's local minimum: the first tau >= tau0 where
    # c[tau+1] >= c[tau] (the loop's stop condition), bounded by tau_max-1.
    dec = cmnd[:, 1:tau_max] < cmnd[:, : tau_max - 1]  # dec[t, k] = c[k+1] < c[k]
    ks = np.arange(tau_max - 1)[None, :]
    stop = np.where((ks >= tau0[:, None]) & ~dec, ks, tau_max - 1)
    tau_walk = stop.min(axis=1)
    tau_argmin = tau_min + np.argmin(seg, axis=1)
    tau = np.where(has_below, tau_walk, tau_argmin)  # (T,)

    rows = np.arange(t_frames)
    c_tau = cmnd[rows, tau]
    is_voiced = active & (c_tau < voiced_threshold)

    # Parabolic interpolation around the selected lag (interior lags only)
    interior = (tau > 0) & (tau < tau_max - 1)
    a = cmnd[rows, np.maximum(tau - 1, 0)]
    c2 = cmnd[rows, np.minimum(tau + 1, cmnd.shape[1] - 1)]
    denom = a - 2.0 * c_tau + c2
    safe = np.where(np.abs(denom) > 1e-12, denom, 1.0)
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (a - c2) / safe, 0.0)
    shift = np.where(interior, shift, 0.0)

    f0_all = sr / (tau + shift)
    f0[is_voiced] = f0_all[is_voiced]
    voiced[:] = is_voiced
    return f0, voiced


# ---------------------------------------------------------------------------
# LPC formants (F1/F2), on the host
# ---------------------------------------------------------------------------


def _levinson(r: np.ndarray, order: int) -> np.ndarray:
    """Levinson-Durbin: autocorrelation → LPC coefficients [1, a1..ap]."""
    a = np.zeros(order + 1, np.float64)
    a[0] = 1.0
    err = r[0]
    if err <= 0:
        return a
    for i in range(1, order + 1):
        acc = r[i] + np.dot(a[1:i], r[1:i][::-1])
        k = -acc / err
        a_prev = a[: i + 1].copy()
        new = a_prev.copy()
        new[i] = k
        for j in range(1, i):
            new[j] = a_prev[j] + k * a_prev[i - j]
        a[: i + 1] = new
        err *= 1.0 - k * k
        if err <= 0:
            break
    return a


def formants_from_autocorr(r: np.ndarray, order: int, sr: int = MFCC_SR) -> Tuple[float, float]:
    """F1/F2 from a frame's autocorrelation ``r[0..order]``: the angles of the
    upper-half-plane roots of the LPC polynomial in (90 Hz, sr/4)."""
    a = _levinson(np.asarray(r, np.float64), order)
    roots = np.roots(a)
    roots = roots[roots.imag > 0]
    freqs = np.sort(np.angle(roots) * (sr / (2 * np.pi)))
    freqs = freqs[(freqs > 90) & (freqs < sr / 4)]
    f1 = float(freqs[0]) if len(freqs) > 0 else 0.0
    f2 = float(freqs[1]) if len(freqs) > 1 else 0.0
    return f1, f2


def estimate_formants(wav, sr: int = MFCC_SR) -> Tuple[float, float]:
    """F1/F2 from LPC analysis of a Hann-windowed mid-file 25 ms frame.

    Pre-emphasis flattens the spectral tilt. Host numpy (a tensor is
    fetched first).
    """
    if isinstance(wav, torch.Tensor):
        wav = wav.detach().cpu().numpy()
    y = np.asarray(wav, np.float64).reshape(-1)
    if y.size < 32:
        return 0.0, 0.0
    y_pre = np.append(y[0], y[1:] - 0.97 * y[:-1])

    frame_len = int(0.025 * sr)
    center = len(y_pre) // 2
    frame = y_pre[max(0, center - frame_len // 2): center + frame_len // 2]
    frame = frame * np.hanning(len(frame))

    order = max(12, sr // 1000 + 2)
    if frame.size <= order:
        return 0.0, 0.0
    # Autocorrelation method + Levinson-Durbin
    r = np.correlate(frame, frame, "full")[frame.size - 1: frame.size + order]
    return formants_from_autocorr(r, order, sr)


# ---------------------------------------------------------------------------
# Batched feature cores (bucketed shapes, valid-length masking)
#
# One device pass computes MFCC statistics and the YIN difference surface
# for a whole batch of utterances; the serial path above is the semantic
# reference (kept for single clips and as the test oracle).
# ---------------------------------------------------------------------------


def _mfcc_stats_batch(wavs: torch.Tensor, frame_counts: torch.Tensor, sr: int, n_mfcc: int,
                      n_fft: int, hop: int, n_mels: int):
    """Masked per-utterance MFCC mean/std.

    wavs: (B, L), zero past each row's valid length (the librosa>=0.10
    constant-pad boundary). frame_counts: (B,) valid frame counts
    (1 + n_valid // hop). Returns (mean (B, n_mfcc), std (B, n_mfcc)).
    """
    db = _mfcc_db(wavs, sr, n_fft, hop, n_mels)  # (B, M, T)
    t = db.shape[-1]
    mask = torch.arange(t, device=db.device)[None, :] < frame_counts[:, None]  # (B, T)
    db_max = torch.where(mask[:, None, :], db, -torch.inf).amax(dim=(1, 2))
    db = torch.maximum(db, db_max[:, None, None] - 80.0)
    mf = torch.matmul(device_constant("dct", str(wavs.device), n_mfcc, n_mels), db)  # (B, C, T)
    cnt = torch.clamp_min(frame_counts, 1).to(torch.float32)[:, None]
    m = torch.where(mask[:, None, :], mf, 0.0)
    mean = m.sum(-1) / cnt
    var = torch.where(mask[:, None, :], (mf - mean[..., None]) ** 2, 0.0).sum(-1) / cnt
    return mean, torch.sqrt(var)


def yin_pick_device(cmnd: torch.Tensor, e0: torch.Tensor, sr: int, tau_min: int, tau_max: int,
                    frame_length: int, threshold: float, voiced_threshold: float):
    """YIN dip selection as device ops (same math as :func:`yin_pick`).

    cmnd (…, T, tau_max+1), e0 (…, T) → (f0 (…, T) with 0 on unvoiced
    frames, voiced (…, T) bool). The (T, tau) CMND surface never leaves the
    device. ``argmax``/``argmin`` take the first extremum, as ``jnp``'s do.
    """
    energy_gate = 1e-6 * (frame_length // 2)
    active = e0 >= energy_gate

    seg = cmnd[..., tau_min:tau_max]
    below = seg < threshold
    has_below = below.any(dim=-1)
    tau0 = tau_min + torch.argmax(below.to(torch.uint8), dim=-1)

    dec = cmnd[..., 1:tau_max] < cmnd[..., : tau_max - 1]
    ks = torch.arange(tau_max - 1, device=cmnd.device)
    stop = torch.where((ks >= tau0[..., None]) & ~dec, ks, tau_max - 1)
    tau_walk = stop.amin(dim=-1)
    tau_argmin = tau_min + torch.argmin(seg, dim=-1)
    tau = torch.where(has_below, tau_walk, tau_argmin)

    c_tau = torch.gather(cmnd, -1, tau[..., None])[..., 0]
    is_voiced = active & (c_tau < voiced_threshold)

    interior = (tau > 0) & (tau < tau_max - 1)
    a = torch.gather(cmnd, -1, torch.clamp_min(tau - 1, 0)[..., None])[..., 0]
    c2 = torch.gather(cmnd, -1, torch.clamp_max(tau + 1, cmnd.shape[-1] - 1)[..., None])[..., 0]
    denom = a - 2.0 * c_tau + c2
    ok = denom.abs() > 1e-12
    shift = torch.where(ok, 0.5 * (a - c2) / torch.where(ok, denom, 1.0), 0.0)
    shift = torch.where(interior, shift, 0.0)

    f0 = sr / (tau + shift)
    return torch.where(is_voiced, f0, 0.0), is_voiced
