"""Waveform DSP on the waveform's device, in PyTorch.

Counterpart of ``rho_tts_tpu/ops/dsp.py``: the same math on tensors, on
the device the waveform lives on.

* The fused finalize (:func:`finalize_segment`, :func:`finalize_segments`)
  is masked math on fixed-capacity buffers: waveforms are zero-padded to a
  bucket multiple and every length, bound and offset stays a 0-d tensor on
  the device. Nothing between the waveform going in and the result coming
  out makes the host wait: no ``.item()``, ``bool()``, ``nonzero`` or copy
  from host memory; the bounds are ``argmax`` results, the slices gathers
  with index tensors, the conditions ``torch.where`` selects. Each call
  fetches one ``(length, decay_ratio)`` pair to the host (:func:`_fetch`);
  with ``defer_fetch=True`` it fetches nothing and returns the pair on the
  device, so a caller finalizing many items fetches all pairs at once.
* JAX's windowed primitives are reproduced with their semantics:
  ``lax.reduce_window`` sums are ``unfold(...).sum``, ``lax.dynamic_slice``
  and ``dynamic_update_slice`` clamp their start so the window fits (here
  by ``clamp`` on the start index), ``jnp.take(mode="clip")`` clamps its
  indices, ``nanmax``/``nanmin`` over masked windows become max/min over
  ``-inf``/``+inf`` fills.
* The loudness gains are computed on f32 tensors, as the JAX package traces
  them, not in Python doubles.
* The one-op helpers (:func:`trim_silence`, :func:`sound_decay_ratio`)
  return host-sized results and fetch their bounds to the host, as the JAX
  package's do; the streaming path uses them.

Reference semantics reproduced from ``src/rho_tts/base_tts.py`` (trim
:348-392, DC :394-399, fades :401-433, join :435-536, decay :297-323) and
``src/rho_tts/providers/qwen.py`` (loudness post-process :268-378).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

# Bucket granularity of the fixed-capacity buffers (samples).
BUCKET = 16384

#: device->host fetches made by this module (each one a ``_fetch`` call)
fetches = 0


def bucket_size(n: int) -> int:
    """Round a sample count up to the bucket granularity."""
    return max(BUCKET, ((int(n) + BUCKET - 1) // BUCKET) * BUCKET)


def _fetch(t: torch.Tensor) -> np.ndarray:
    """The module's only device->host transfer; counted in :data:`fetches`."""
    global fetches
    fetches += 1
    return t.detach().cpu().numpy()


def _pad_to(audio: torch.Tensor, capacity: int) -> torch.Tensor:
    n = audio.shape[-1]
    if n == capacity:
        return audio
    return F.pad(audio, (0, capacity - n))


def _as_f32_1d(audio) -> torch.Tensor:
    a = torch.as_tensor(audio)
    if a.dtype != torch.float32:
        a = a.to(torch.float32)
    if a.ndim == 2:
        a = a.reshape(-1) if 1 in a.shape else a.mean(dim=0)
    return a


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d tensor on ``device`` made by a fill: no host->device copy."""
    return torch.full((), value, dtype=dtype, device=device)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one f32 division (``float / Tensor`` would multiply by
    a reciprocal, which rounds differently)."""
    return torch.div(_scalar(num, den.dtype, den.device), den)


# ---------------------------------------------------------------------------
# Silence trimming
# ---------------------------------------------------------------------------


def _window_energy(buf: torch.Tensor, window: int, stride: int, capacity: int):
    """Windowed RMS of ``avg_pool1d(x**2, window, stride, padding=window//2)``
    (count_include_pad): window w averages ``window`` samples of the
    zero-padded signal from ``w*stride - padding``."""
    padding = window // 2
    padded = F.pad(buf * buf, (padding, window))  # front pad + safety tail
    n_windows_max = (capacity + 2 * padding - window) // stride + 1
    sums = padded.unfold(0, window, stride).sum(dim=-1)[:n_windows_max]
    return torch.sqrt(sums / window)


def _trim_scan(buf, length, threshold: float, window: int, stride: int, capacity: int):
    """(first, last, any_nonsilent) window indices, all 0-d device tensors."""
    padding = window // 2
    energy = _window_energy(buf, window, stride, capacity)
    n_windows = torch.clamp_min((length + 2 * padding - window) // stride + 1, 0)
    widx = torch.arange(energy.shape[0], device=buf.device)
    non_silent = (energy > threshold) & (widx < n_windows)
    as_int = non_silent.to(torch.int32)
    first = torch.argmax(as_int)  # the first maximum: the first non-silent window
    last = energy.shape[0] - 1 - torch.argmax(torch.flip(as_int, (0,)))
    return first, last, non_silent.any()


def trim_silence(
    audio,
    sample_rate: int,
    threshold_db: float = -50.0,
    from_start: bool = True,
    from_end: bool = True,
    enabled: bool = True,
):
    """Trim leading/trailing silence using windowed RMS energy.

    Parity: reference ``base_tts.py:348-392``. Window is 10 ms, stride is
    half a window, threshold is ``10**(threshold_db/20)``. When everything is
    below threshold, the first window worth of samples is returned. Fetches
    the bounds to the host (one transfer) to cut the result.
    """
    a = _as_f32_1d(audio)
    n = int(a.shape[-1])
    if not enabled or n == 0:
        return a

    window = int(sample_rate * 0.01)
    if window < 2:
        return a
    stride = window // 2
    if stride == 0:
        return a
    threshold = float(np.float32(10.0 ** (threshold_db / 20.0)))

    capacity = bucket_size(n)
    first, last, any_ns = _trim_scan(
        _pad_to(a, capacity), _scalar(n, torch.int64, a.device), threshold, window, stride,
        capacity,
    )
    first, last, any_ns = (int(v) for v in _fetch(torch.stack([first, last, any_ns.long()])))
    if not any_ns:
        return a[:window]

    start = (first * window // 2) if from_start else 0
    end = ((last + 2) * window // 2) if from_end else n
    start = max(0, min(start, n))
    end = max(start, min(end, n))
    return a[start:end]


# ---------------------------------------------------------------------------
# DC offset / fades
# ---------------------------------------------------------------------------


def remove_dc_offset(audio):
    """Subtract the mean. Parity: reference ``base_tts.py:394-399``."""
    a = _as_f32_1d(audio)
    if a.shape[-1] == 0:
        return a
    return a - torch.mean(a)


def _fade_theta(fade_samples: int, device) -> torch.Tensor:
    # torch.linspace(0, pi, fs)[i] == i * pi / (fs - 1)
    i = torch.arange(fade_samples, dtype=torch.float32, device=device)
    return i * (math.pi / max(fade_samples - 1, 1))


def apply_fades(
    audio,
    sample_rate: int,
    fade_duration_sec: float = 0.02,
    fade_in: bool = True,
    fade_out: bool = True,
):
    """Raised-cosine fade-in/out. Parity: reference ``base_tts.py:401-433``.

    If the waveform is shorter than two fades, it is returned unchanged.
    """
    a = _as_f32_1d(audio)
    n = int(a.shape[-1])
    if n == 0:
        return a
    fade_samples = int(sample_rate * fade_duration_sec)
    if fade_samples < 1 or n < fade_samples * 2:
        return a
    theta = _fade_theta(fade_samples, a.device)
    a = a.clone()
    if fade_in:
        a[:fade_samples] *= 0.5 * (1.0 - torch.cos(theta))
    if fade_out:
        a[n - fade_samples:] *= 0.5 * (1.0 + torch.cos(theta))
    return a


# ---------------------------------------------------------------------------
# Equal-power crossfade join
# ---------------------------------------------------------------------------


def _crossfade_pair(prev_tail: torch.Tensor, curr_head: torch.Tensor) -> torch.Tensor:
    """Equal-power crossfade: prev*cos(0..pi/2) + curr*cos(pi/2..0)."""
    overlap = prev_tail.shape[-1]
    i = torch.arange(overlap, dtype=torch.float32, device=prev_tail.device)
    theta = i * (math.pi / 2.0 / max(overlap - 1, 1))
    return prev_tail * torch.cos(theta) + curr_head * torch.cos(math.pi / 2.0 - theta)


def smooth_segment_join(
    segments: List,
    sample_rate: int,
    crossfade_duration_sec: float = 0.05,
    inter_sentence_pause_sec: float = 0.1,
    trim: bool = True,
    silence_threshold_db: float = -50.0,
    fade_duration_sec: float = 0.02,
) -> Optional[torch.Tensor]:
    """Join segments with per-segment trimming and equal-power crossfades.

    Parity: reference ``base_tts.py:435-536``. Boundary-position-aware
    trimming (first segment keeps its onset, last keeps its tail), DC
    removal per segment, crossfaded overlaps (skipped when the overlap would
    be <= 10 samples), an inter-sentence pause between interior joins, and a
    final global fade-in/out. The op-by-op chain: each trim fetches its
    bounds; :func:`finalize_segments` is the fused equivalent.
    """
    if len(segments) == 0:
        return None
    if len(segments) == 1:
        a = trim_silence(segments[0], sample_rate, silence_threshold_db, True, True, enabled=trim)
        a = remove_dc_offset(a)
        return apply_fades(a, sample_rate, fade_duration_sec, True, True)

    crossfade_samples = int(sample_rate * crossfade_duration_sec)
    last_i = len(segments) - 1
    processed = [
        remove_dc_offset(trim_silence(seg, sample_rate, silence_threshold_db, i > 0, i < last_i,
                                      enabled=trim))
        for i, seg in enumerate(segments)
    ]

    parts: List[torch.Tensor] = []
    for i, curr in enumerate(processed):
        if i == 0:
            if curr.shape[-1] > crossfade_samples:
                parts.append(curr[:-crossfade_samples])
            else:
                parts.append(curr)
            continue

        prev = processed[i - 1]
        overlap = min(crossfade_samples, int(prev.shape[-1]), int(curr.shape[-1]))

        # Intentional reference parity (base_tts.py:481-520): a segment
        # shorter than the crossfade can emit its tail twice, and a held-back
        # tail is dropped when the next overlap is <= 10; the fused join
        # reproduces both edge cases.
        if overlap > 10:
            parts.append(_crossfade_pair(prev[-overlap:], curr[:overlap]))
            if i < last_i and curr.shape[-1] > overlap + crossfade_samples:
                remaining = curr[overlap:-crossfade_samples]
            else:
                remaining = curr[overlap:]
            if remaining.shape[-1] > 0:
                parts.append(remaining)
            if inter_sentence_pause_sec > 0 and i < last_i:
                parts.append(torch.zeros(int(sample_rate * inter_sentence_pause_sec),
                                         dtype=torch.float32, device=curr.device))
        else:
            parts.append(curr)

    joined = torch.cat(parts, dim=-1)
    return apply_fades(joined, sample_rate, fade_duration_sec, True, True)


# ---------------------------------------------------------------------------
# Sound decay
# ---------------------------------------------------------------------------


def sound_decay_ratio(audio) -> float:
    """RMS of the last third over RMS of the first third.

    Parity: reference ``base_tts.py:297-323``. Returns 1.0 for empty/short
    audio or a silent opening. One host fetch.
    """
    a = _as_f32_1d(audio)
    n = int(a.shape[-1])
    third = n // 3
    if n == 0 or third < 1:
        return 1.0
    sq = a * a
    first_rms = torch.sqrt(sq[:third].sum() / float(third))
    last_rms = torch.sqrt(sq[n - third:].sum() / float(third))
    first_rms, last_rms = (float(v) for v in _fetch(torch.stack([first_rms, last_rms])))
    if first_rms < 1e-8:
        return 1.0
    return last_rms / first_rms


# ---------------------------------------------------------------------------
# Loudness post-processing (windowed decay correction + RMS norm + soft clip)
# ---------------------------------------------------------------------------


def _loudness_masked(buf, length, window_samples: int, max_windows: int, capacity: int,
                     target_rms_db: float, max_gain_db: float):
    """Decay correction + global RMS normalization + tanh soft clip over the
    first ``length`` samples of ``buf``; the padding stays exactly zero."""
    dev = buf.device
    n_f = length.to(torch.float32)
    valid = torch.arange(capacity, device=dev) < length
    x = torch.where(valid, buf, 0.0)

    overall_rms = torch.sqrt(torch.sum(x * x) / torch.clamp_min(n_f, 1.0))
    silent = overall_rms < 1e-8

    # --- Pass 1: windowed decay correction -------------------------------
    n_windows = length // window_samples
    apply_windowed = (length > window_samples * 2) & (n_windows >= 2)

    w = x[: max_windows * window_samples].reshape(max_windows, window_samples)
    win_idx = torch.arange(max_windows, device=dev)
    win_valid = win_idx < n_windows
    win_rms = torch.sqrt(torch.mean(w * w, dim=1))

    ref_rms = win_rms[0]
    max_gain_linear = torch.pow(10.0, _scalar(max_gain_db, torch.float32, dev) / 20.0)
    gains = torch.where(
        win_rms < 1e-8, 1.0,
        torch.minimum(ref_rms / torch.clamp_min(win_rms, 1e-12), max_gain_linear),
    )
    gains = torch.where(win_valid, gains, 1.0)
    # nanmax - nanmin over the valid windows
    gain_range = (torch.where(win_valid, gains, -math.inf).max()
                  - torch.where(win_valid, gains, math.inf).min())
    apply_windowed = apply_windowed & (ref_rms >= 1e-8) & (gain_range >= 0.05)

    # 3-tap moving average, applied twice; endpoints unchanged; only smooth
    # across valid windows (interior means index in [1, n_windows-2]).
    interior = (win_idx >= 1) & (win_idx < n_windows - 1)

    def smooth(g):
        avg = (torch.roll(g, 1) + g + torch.roll(g, -1)) / 3.0
        return torch.where(interior, avg, g)

    sm = smooth(smooth(gains))

    # Linear interpolation of the window-center gain curve to sample level
    # (np.interp semantics: clamp outside [first_center, last_center]).
    s = torch.arange(capacity, dtype=torch.float32, device=dev)
    pos = s / window_samples - 0.5  # fractional window index at each sample
    pos = torch.minimum(torch.clamp_min(pos, 0.0),
                        torch.clamp_min(n_windows.to(torch.float32) - 1.0, 0.0))
    lo = torch.floor(pos).long().clamp(0, max_windows - 1)
    hi = torch.minimum((lo + 1).clamp(0, max_windows - 1), torch.clamp_min(n_windows - 1, 0))
    frac = pos - lo.to(torch.float32)
    envelope = sm[lo] * (1.0 - frac) + sm[hi] * frac

    x1 = torch.where(apply_windowed, x * envelope, x)

    # --- Pass 2: global RMS normalization to target ------------------------
    rms = torch.sqrt(torch.sum(x1 * x1) / torch.clamp_min(n_f, 1.0))
    current_rms_db = 20.0 * torch.log10(torch.clamp_min(rms, 1e-30))
    gain_db = _scalar(target_rms_db, torch.float32, dev) - current_rms_db
    gain_linear = torch.pow(10.0, gain_db / 20.0)
    x2 = torch.where(rms > 1e-8, x1 * gain_linear, x1)

    # --- Pass 3: tanh soft clip -------------------------------------------
    max_amplitude = 0.95
    x3 = torch.tanh(x2 / max_amplitude) * max_amplitude

    out = torch.where(silent, x, x3)
    return torch.where(valid, out, 0.0)


def _loudness_capacity(n: int, window_samples: int):
    """(capacity, max_windows): the bucket, widened so the window reshape
    covers every valid sample."""
    capacity = bucket_size(n)
    max_windows = max(capacity // window_samples, 1)
    return max(capacity, max_windows * window_samples), max_windows


def loudness_postprocess(
    audio,
    sample_rate: int,
    target_rms_db: float = -23.0,
    window_sec: float = 2.0,
    max_gain_db: float = 18.0,
):
    """Three-pass loudness normalization with decay correction.

    Parity: reference ``qwen.py:268-378`` — (1) per-2s-window gain envelope
    (capped at +18 dB, double 3-tap smoothed, linearly interpolated to sample
    level) correcting volume decay, skipped when the gain spread is < 0.05;
    (2) global RMS normalization to -23 dBFS; (3) tanh soft clip at 0.95.
    Silent audio (< 1e-8 RMS) is returned unchanged. No host fetch.
    """
    a = _as_f32_1d(audio)
    n = int(a.shape[-1])
    if n == 0:
        return a
    window_samples = int(sample_rate * window_sec)
    capacity, max_windows = _loudness_capacity(n, window_samples)
    out = _loudness_masked(
        _pad_to(a, capacity), _scalar(n, torch.int64, a.device), window_samples, max_windows,
        capacity, float(target_rms_db), float(max_gain_db),
    )
    return out[:n]


# ---------------------------------------------------------------------------
# Fused finalize (device-side bounds, one host fetch)
# ---------------------------------------------------------------------------


def _masked_trim_bounds(buf, length, threshold: float, window: int, stride: int, capacity: int,
                        from_start: bool, from_end: bool):
    """Trim bounds on a masked buffer -> (start, end) 0-d device tensors.

    Same math as :func:`trim_silence`'s scan and its bound arithmetic
    (silent input keeps the first window)."""
    first, last, any_ns = _trim_scan(buf, length, threshold, window, stride, capacity)
    zero = torch.zeros_like(length)
    start = first * window // 2 if from_start else zero
    end = (last + 2) * window // 2 if from_end else length
    start = torch.where(any_ns, start, zero)
    end = torch.where(any_ns, end, torch.full_like(length, window))
    start = torch.minimum(torch.clamp_min(start, 0), length)
    end = torch.minimum(torch.maximum(end, start), length)
    return start, end


def _dynamic_slice(padded: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """``lax.dynamic_slice(padded, (start,), (size,))``: the start clamped
    into ``[0, len - size]``, then a gather."""
    start = start.clamp(0, padded.shape[0] - size)
    return padded[start + torch.arange(size, device=padded.device)]


def _masked_shift_dc(buf, start, new_len, capacity: int):
    """Slice [start, start+new_len) to offset 0, zero the rest, remove DC."""
    shifted = _dynamic_slice(F.pad(buf, (0, capacity)), start, capacity)
    valid = torch.arange(capacity, device=buf.device) < new_len
    x = torch.where(valid, shifted, 0.0)
    mean = torch.sum(x) / torch.clamp_min(new_len.to(torch.float32), 1.0)
    return torch.where(valid, x - mean, 0.0)


def _masked_fades(x, new_len, fade_samples: int):
    """Raised-cosine fades over the valid region (skip when too short)."""
    if fade_samples < 1:
        return x
    idx = torch.arange(x.shape[-1], device=x.device)
    valid = idx < new_len
    step = math.pi / max(fade_samples - 1, 1)
    theta_in = idx.to(torch.float32) * step
    gain_in = torch.where(idx < fade_samples, 0.5 * (1.0 - torch.cos(theta_in)), 1.0)
    theta_out = (idx - (new_len - fade_samples)).to(torch.float32) * step
    gain_out = torch.where((idx >= new_len - fade_samples) & valid,
                           0.5 * (1.0 + torch.cos(theta_out)), 1.0)
    return torch.where(new_len >= 2 * fade_samples, x * gain_in * gain_out, x)


def _masked_decay_ratio(x, new_len):
    idx = torch.arange(x.shape[-1], device=x.device)
    valid = idx < new_len
    third = new_len // 3
    denom = torch.clamp_min(third.to(torch.float32), 1.0)
    sq = x * x
    first_rms = torch.sqrt(torch.sum(torch.where(idx < third, sq, 0.0)) / denom)
    last_rms = torch.sqrt(torch.sum(torch.where((idx >= new_len - third) & valid, sq, 0.0)) / denom)
    return torch.where((third < 1) | (first_rms < 1e-8), 1.0,
                       last_rms / torch.clamp_min(first_rms, 1e-12))


def _finalize_core(buf, length, threshold: float, window: int, stride: int, fade_samples: int,
                   window_samples: int, max_windows: int, capacity: int, trim: bool,
                   loudness: bool, target_rms_db: float, max_gain_db: float):
    """Trim -> DC removal -> fades -> (loudness) -> decay ratio on one buffer.

    The same masked math as composing the individual ops. Returns
    (out_buffer, new_length, decay_ratio) on the device.
    """
    if trim:
        start, end = _masked_trim_bounds(buf, length, threshold, window, stride, capacity,
                                         from_start=True, from_end=True)
    else:
        start, end = torch.zeros_like(length), length
    new_len = end - start
    x = _masked_shift_dc(buf, start, new_len, capacity)
    x = _masked_fades(x, new_len, fade_samples)
    if loudness:
        x = _loudness_masked(x, new_len, window_samples, max_windows, capacity, target_rms_db,
                             max_gain_db)
    return x, new_len, _masked_decay_ratio(x, new_len)


def _meta(length, ratio) -> torch.Tensor:
    """The packed (valid_length, decay_ratio) pair, f64 so any length is exact."""
    return torch.stack([length.to(torch.float64), ratio.to(torch.float64)])


def _trim_windows(sample_rate: int, trim: bool):
    window = int(sample_rate * 0.01)
    stride = max(window // 2, 1)
    if window < 2:
        return False, 2, 1
    return trim, window, stride


def finalize_segment(
    audio,
    sample_rate: int,
    trim: bool = True,
    silence_threshold_db: float = -50.0,
    fade_duration_sec: float = 0.02,
    loudness: bool = False,
    target_rms_db: float = -23.0,
    loudness_window_sec: float = 2.0,
    max_gain_db: float = 18.0,
    defer_fetch: bool = False,
):
    """Single-segment finalize chain with one host fetch.

    Equivalent to ``smooth_segment_join([audio])`` (+ optional
    ``loudness_postprocess``) followed by ``sound_decay_ratio``. Returns
    (waveform, decay_ratio); with ``defer_fetch=True`` returns
    device-resident (padded_out, meta) where meta = [valid_length,
    decay_ratio] (f64) and fetches nothing.
    """
    a = _as_f32_1d(audio)
    n = int(a.shape[-1])
    if n == 0:
        if defer_fetch:
            return a, _meta(_scalar(0, torch.int64, a.device), _scalar(1.0, torch.float32, a.device))
        return a, 1.0
    trim, window, stride = _trim_windows(sample_rate, trim)
    window_samples = int(sample_rate * loudness_window_sec)
    capacity, max_windows = _loudness_capacity(n, window_samples)
    out, new_len, ratio = _finalize_core(
        _pad_to(a, capacity), _scalar(n, torch.int64, a.device),
        float(np.float32(10.0 ** (silence_threshold_db / 20.0))), window, stride,
        int(sample_rate * fade_duration_sec), window_samples, max_windows, capacity, bool(trim),
        bool(loudness), float(target_rms_db), float(max_gain_db),
    )
    meta = _meta(new_len, ratio)
    if defer_fetch:
        return out, meta
    length, ratio = _fetch(meta)
    return out[: int(length)], float(ratio)


# ---------------------------------------------------------------------------
# Fused multi-segment finalize: trim/DC per segment -> crossfade-concat ->
# fades -> (loudness) -> decay, with one host fetch.
# ---------------------------------------------------------------------------


def _finalize_join_core(segs, lengths, threshold: float, window: int, stride: int, cf: int,
                        pause_samples: int, fade_samples: int, window_samples: int,
                        max_windows: int, cap: int, total_cap: int, trim: bool, loudness: bool,
                        target_rms_db: float, max_gain_db: float):
    """N-segment join whose pieces match :func:`smooth_segment_join` exactly:
    boundary-aware trims, equal-power crossfades skipped at overlap <= 10,
    tail hold-back on interior segments, pauses between interior joins, then
    global fades (+ loudness) and the decay ratio. ``segs`` (K, cap) are
    zero-padded, ``lengths`` (K,) their true lengths on the device."""
    dev = segs.device
    k_segs = segs.shape[0]
    idx = torch.arange(cap, device=dev)

    # Per-segment trim + DC removal (boundary-position-aware)
    xs, lens = [], []
    for k in range(k_segs):
        buf, length = segs[k], lengths[k]
        if trim:
            start, end = _masked_trim_bounds(buf, length, threshold, window, stride, cap,
                                             from_start=(k > 0), from_end=(k < k_segs - 1))
        else:
            start, end = torch.zeros_like(length), length
        new_len = end - start
        xs.append(_masked_shift_dc(buf, start, new_len, cap))
        lens.append(new_len)

    # Piece list: (masked buffer, true length) in emit order
    pieces = []
    emit0 = torch.where(lens[0] > cf, lens[0] - cf, lens[0])
    pieces.append((torch.where(idx < emit0, xs[0], 0.0), emit0))
    cfi = torch.arange(cf, device=dev)
    zero = torch.zeros_like(lens[0])
    for k in range(1, k_segs):
        prev, lp = xs[k - 1], lens[k - 1]
        curr, lc = xs[k], lens[k]
        ov = torch.minimum(torch.minimum(torch.full_like(lp, cf), lp), lc)
        use = ov > 10

        # Equal-power crossfade of prev's tail with curr's head
        theta = cfi.to(torch.float32) * _div(
            math.pi / 2.0, torch.clamp_min(ov.to(torch.float32) - 1.0, 1.0))
        prev_tail = prev[(lp - ov + cfi).clamp(0, cap - 1)]  # jnp.take(mode="clip")
        mixed = prev_tail * torch.cos(theta) + curr[:cf] * torch.cos(math.pi / 2.0 - theta)
        cf_len = torch.where(use, ov, zero)
        pieces.append((torch.where(cfi < cf_len, mixed, 0.0), cf_len))

        # Remaining body of curr (head consumed by the crossfade; interior
        # segments hold back cf tail samples for the NEXT crossfade)
        start = torch.where(use, ov, zero)
        if k < k_segs - 1:
            tail_hold = torch.where(use & (lc > ov + cf), torch.full_like(lc, cf), zero)
        else:
            tail_hold = zero
        rem_len = torch.clamp_min(torch.where(use, lc - ov - tail_hold, lc), 0)
        rem = _dynamic_slice(F.pad(curr, (0, cap)), start, cap)
        pieces.append((torch.where(idx < rem_len, rem, 0.0), rem_len))

        if pause_samples > 0 and k < k_segs - 1:
            pieces.append((None, torch.where(use, torch.full_like(lc, pause_samples), zero)))

    # Assemble at running offsets: each piece is written where
    # lax.dynamic_update_slice would put it (start clamped so it fits) and
    # added; the pieces are masked, so every sum adds exact zeros elsewhere.
    j = torch.arange(total_cap, device=dev)
    out = torch.zeros((total_cap,), dtype=torch.float32, device=dev)
    offset = zero
    for buf, plen in pieces:
        if buf is not None:  # a pause adds zeros
            size = buf.shape[0]
            rel = j - offset.clamp(0, total_cap - size)
            inside = (rel >= 0) & (rel < size)
            out = out + torch.where(inside, buf[rel.clamp(0, size - 1)], 0.0)
        offset = offset + plen

    total_len = offset
    out = _masked_fades(out, total_len, fade_samples)
    if loudness:
        out = _loudness_masked(out, total_len, window_samples, max_windows, total_cap,
                               target_rms_db, max_gain_db)
    return out, total_len, _masked_decay_ratio(out, total_len)


def finalize_segments(
    segments: List,
    sample_rate: int,
    crossfade_duration_sec: float = 0.05,
    inter_sentence_pause_sec: float = 0.1,
    trim: bool = True,
    silence_threshold_db: float = -50.0,
    fade_duration_sec: float = 0.02,
    loudness: bool = False,
    target_rms_db: float = -23.0,
    loudness_window_sec: float = 2.0,
    max_gain_db: float = 18.0,
    defer_fetch: bool = False,
):
    """Fused finalize for ANY segment count: equivalent to
    ``smooth_segment_join(segments)`` (+ optional ``loudness_postprocess``)
    followed by ``sound_decay_ratio``, with one host fetch.

    Returns (waveform, decay_ratio); (None, 1.0) for an empty list. With
    ``defer_fetch=True`` returns device-resident (padded_out, meta) —
    see :func:`finalize_segment`.
    """
    if len(segments) == 0:
        return None, 1.0
    if len(segments) == 1:
        return finalize_segment(
            segments[0], sample_rate, trim=trim,
            silence_threshold_db=silence_threshold_db,
            fade_duration_sec=fade_duration_sec, loudness=loudness,
            target_rms_db=target_rms_db, loudness_window_sec=loudness_window_sec,
            max_gain_db=max_gain_db, defer_fetch=defer_fetch,
        )

    arrs = [_as_f32_1d(s) for s in segments]
    dev = arrs[0].device
    k = len(arrs)
    cap = bucket_size(max(max(int(a.shape[-1]) for a in arrs), 1))
    segs = torch.stack([_pad_to(a, cap) for a in arrs])
    # fills, not a copy from host memory (which would wait for the device)
    lengths = torch.stack([_scalar(int(a.shape[-1]), torch.int64, dev) for a in arrs])

    trim, window, stride = _trim_windows(sample_rate, trim)
    cf = int(sample_rate * crossfade_duration_sec)
    pause_samples = int(sample_rate * inter_sentence_pause_sec)
    window_samples = int(sample_rate * loudness_window_sec)

    # Output capacity: every piece write (cap-sized) fits at its offset, so
    # the clamp of the write's start never moves a piece.
    total_cap = bucket_size(k * cap + (k - 1) * (cf + pause_samples) + cap)
    max_windows = max(total_cap // window_samples, 1)
    total_cap = max(total_cap, max_windows * window_samples)

    out, total_len, ratio = _finalize_join_core(
        segs, lengths, float(np.float32(10.0 ** (silence_threshold_db / 20.0))), window, stride,
        cf, pause_samples, int(sample_rate * fade_duration_sec), window_samples, max_windows,
        cap, int(total_cap), bool(trim), bool(loudness), float(target_rms_db), float(max_gain_db),
    )
    meta = _meta(total_len, ratio)
    if defer_fetch:
        return out, meta
    length, ratio = _fetch(meta)
    return out[: int(length)], float(ratio)


# ---------------------------------------------------------------------------
# Streaming (causal) loudness for chunked synthesis
# ---------------------------------------------------------------------------


class StreamingLoudness:
    """Causal loudness normalization for chunked streaming synthesis.

    The one-shot :func:`loudness_postprocess` (reference parity,
    ``src/rho_tts/providers/qwen.py:268-378``) is global — it sees the whole
    utterance before computing the gain envelope. A stream cannot, so this
    applies per-chunk gain toward the same -23 dBFS target computed from
    the *running* RMS of all audio seen so far (the first chunk uses its
    own RMS), slew-limited between chunks to avoid audible gain steps, and
    finishes with the same 0.95 tanh soft clip. One 4-byte statistic (the
    chunk's sum of squares) crosses device->host per chunk; the audio stays
    on the device.
    """

    def __init__(self, target_rms_db: float = -23.0, max_gain_db: float = 18.0,
                 max_step_db: float = 3.0):
        self._target = 10.0 ** (target_rms_db / 20.0)
        self._max_gain = 10.0 ** (max_gain_db / 20.0)
        self._max_step = 10.0 ** (max_step_db / 20.0)
        self._sumsq = 0.0
        self._count = 0.0
        self._last_gain = None

    def process(self, chunk):
        """Device waveform chunk -> gain-corrected, soft-clipped chunk."""
        c = _as_f32_1d(chunk)
        self._sumsq += float(_fetch(torch.sum(c * c)))
        self._count += float(c.shape[-1])
        rms = (self._sumsq / max(self._count, 1.0)) ** 0.5
        if rms < 1e-8:
            return chunk
        gain = min(self._target / rms, self._max_gain)
        if self._last_gain is not None:
            lo, hi = self._last_gain / self._max_step, self._last_gain * self._max_step
            gain = min(max(gain, lo), hi)
        self._last_gain = gain
        c = c * float(np.float32(gain))
        # same soft clip as loudness_postprocess pass 3
        return torch.where(torch.abs(c) > 0.95, torch.tanh(c / 0.95) * 0.95, c)
