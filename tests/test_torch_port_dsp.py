"""Port parity of the waveform DSP: ``rho_tts_tpu_torch.ops`` vs the JAX package.

Each DSP function of the port runs on the same numpy inputs (made from a
seed) as its JAX counterpart, on the CPU. Tolerances, none looser than the
JAX package's own golden tests (``test_dsp_golden.py``,
``test_finalize_join.py``, ``test_pitch_speed_oracle.py``):

* trim: exact (the same samples are kept);
* DC removal 1e-6; fades 2e-7; crossfade join 5e-6; decay ratio 1e-6
  (relative); loudness 3e-5;
* fused ``finalize_segment(s)``, 1-3 segments, with and without loudness,
  all-silent and shorter-than-the-crossfade: 3e-5, decay ratio 1e-4, and
  the same length;
* ``StreamingLoudness`` over a chunk sequence 3e-5;
* resample 1e-5 (the JAX oracle test allows 2e-4); pitch shift 1e-4 (5e-3);
  STFT 1e-4 and iSTFT 1e-5.

Pitch shift is also held at a served item's length (15 s), where the JAX
package's f32 phase math drifts, against :func:`pitch_shift_f64`: the JAX
package's algorithm evaluated in float64 numpy, written independently of
both packages and itself held against ``test_pitch_speed_oracle.py``'s
direct oracle. Tolerance 1.5e-4: an f32 STFT's error in the angle of a
near-zero bin carries into every later frame of that bin (the port's phase
math is f64 and does not drift).

Also held: the fused finalize fetches to the host exactly once per call
(:data:`rho_tts_tpu_torch.ops.dsp.fetches`), none with ``defer_fetch``, and
the clamps of the join's slices never move a slice.
"""

import math

import numpy as np
import pytest
import torch

from rho_tts_tpu.ops import dsp as jdsp
from rho_tts_tpu.ops import pitch as jpitch
from rho_tts_tpu.ops import resample as jresample
from rho_tts_tpu.ops import spectral as jspectral
from rho_tts_tpu_torch.ops import dsp as tdsp
from rho_tts_tpu_torch.ops import pitch as tpitch
from rho_tts_tpu_torch.ops import resample as tresample
from rho_tts_tpu_torch.ops import spectral as tspectral
from test_pitch_speed_oracle import np_pitch_shift as direct_pitch_oracle

torch.set_num_threads(1)  # several test workers share the cores

SR = 24000


def _speechy(seconds, f0=220.0, seed=0, lead_silence=0.0, tail_silence=0.0, decay=0.0):
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    t = np.arange(n) / SR
    sig = 0.3 * np.sin(2 * np.pi * f0 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t))
    sig = sig * np.exp(-decay * t) + 0.005 * rng.standard_normal(n)
    lead = np.zeros(int(SR * lead_silence), np.float32)
    tail = np.zeros(int(SR * tail_silence), np.float32)
    return np.concatenate([lead, sig.astype(np.float32), tail])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, ref, atol):
    ours, ref = _np(ours), _np(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


@pytest.mark.parametrize("from_start,from_end", [(True, True), (False, True), (True, False)])
def test_trim_exact(from_start, from_end):
    x = _speechy(0.5, lead_silence=0.1, tail_silence=0.12, seed=1)
    ours = tdsp.trim_silence(x, SR, -50.0, from_start, from_end)
    ref = jdsp.trim_silence(x, SR, -50.0, from_start, from_end)
    _close(ours, ref, 0)


def test_trim_all_silent_keeps_first_window():
    x = np.zeros(3000, np.float32)
    _close(tdsp.trim_silence(x, SR), jdsp.trim_silence(x, SR), 0)


def test_dc_and_fades():
    x = _speechy(0.4, seed=2) + np.float32(0.05)
    _close(tdsp.remove_dc_offset(x), jdsp.remove_dc_offset(x), 1e-6)
    for fade_in, fade_out in ((True, True), (True, False), (False, True)):
        _close(tdsp.apply_fades(x, SR, 0.02, fade_in, fade_out),
               jdsp.apply_fades(x, SR, 0.02, fade_in, fade_out), 2e-7)
    short = x[:700]  # shorter than two fades: unchanged
    _close(tdsp.apply_fades(short, SR), short, 0)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_smooth_segment_join(k):
    segs = [_speechy(0.3 + 0.1 * i, f0=180 + 40 * i, seed=i, lead_silence=0.05,
                     tail_silence=0.06) for i in range(k)]
    _close(tdsp.smooth_segment_join(segs, SR), jdsp.smooth_segment_join(segs, SR), 5e-6)


def test_decay_ratio():
    for x in (_speechy(1.0, decay=2.0, seed=3), _speechy(0.2, seed=4)):
        assert tdsp.sound_decay_ratio(x) == pytest.approx(jdsp.sound_decay_ratio(x), rel=1e-6)
    assert tdsp.sound_decay_ratio(np.zeros(2, np.float32)) == 1.0


@pytest.mark.parametrize("seconds,decay", [(0.5, 0.0), (5.0, 0.6), (7.0, 0.0)])
def test_loudness(seconds, decay):
    x = _speechy(seconds, decay=decay, seed=5)
    _close(tdsp.loudness_postprocess(x, SR), jdsp.loudness_postprocess(x, SR), 3e-5)
    silent = np.zeros(5000, np.float32)
    _close(tdsp.loudness_postprocess(silent, SR), silent, 0)


FINALIZE_CASES = {
    "one": [_speechy(0.6, lead_silence=0.05, tail_silence=0.07, seed=6)],
    "one-long-decaying": [_speechy(4.5, decay=0.5, lead_silence=0.05, seed=7)],
    "two": [_speechy(0.6, f0=200, seed=8, tail_silence=0.05),
            _speechy(0.5, f0=260, seed=9, lead_silence=0.06)],
    "three": [_speechy(0.7, f0=200, seed=1, tail_silence=0.05),
              _speechy(0.5, f0=260, seed=2, lead_silence=0.06),
              _speechy(0.9, f0=150, seed=3, lead_silence=0.04, tail_silence=0.08)],
    "all-silent": [np.zeros(4000, np.float32), np.zeros(3000, np.float32)],
    "shorter-than-crossfade": [_speechy(0.5, seed=10), _speechy(0.03, seed=11),
                               _speechy(0.4, seed=12)],
}


@pytest.mark.parametrize("loudness", [False, True], ids=["plain", "loudness"])
@pytest.mark.parametrize("case", list(FINALIZE_CASES))
def test_finalize_segments(case, loudness):
    segs = FINALIZE_CASES[case]
    before = tdsp.fetches
    out, ratio = tdsp.finalize_segments(segs, SR, loudness=loudness)
    assert tdsp.fetches - before == 1  # one (length, ratio) fetch per call
    ref, ref_ratio = jdsp.finalize_segments(segs, SR, loudness=loudness)
    _close(out, ref, 3e-5)
    assert ratio == pytest.approx(float(ref_ratio), abs=1e-4)
    if len(segs) == 1:
        out1, ratio1 = tdsp.finalize_segment(segs[0], SR, loudness=loudness)
        _close(out1, out, 0)
        assert ratio1 == ratio


def test_finalize_defer_fetch_and_empty():
    segs = FINALIZE_CASES["two"]
    before = tdsp.fetches
    buf, meta = tdsp.finalize_segments(segs, SR, loudness=True, defer_fetch=True)
    assert tdsp.fetches == before  # nothing fetched until the caller asks
    out, ratio = tdsp.finalize_segments(segs, SR, loudness=True)
    assert int(meta[0]) == out.shape[0] and float(meta[1]) == ratio
    assert torch.equal(buf[: out.shape[0]], out) and not buf[out.shape[0]:].any()
    assert tdsp.finalize_segments([], SR) == (None, 1.0)
    empty, r = tdsp.finalize_segment(np.zeros(0, np.float32), SR)
    assert empty.shape == (0,) and r == 1.0


def test_join_slice_clamps_never_fire(monkeypatch):
    """The join's dynamic slices start inside their buffers, so the clamp
    reproducing ``lax.dynamic_slice``'s never moves one."""
    seen = []
    slice_fn = tdsp._dynamic_slice

    def watched(padded, start, size):
        seen.append(int(start) <= padded.shape[0] - size and int(start) >= 0)
        return slice_fn(padded, start, size)

    monkeypatch.setattr(tdsp, "_dynamic_slice", watched)
    for case in ("three", "shorter-than-crossfade"):
        tdsp.finalize_segments(FINALIZE_CASES[case], SR, loudness=True)
    assert seen and all(seen)


def test_streaming_loudness():
    x = _speechy(2.0, decay=0.8, seed=13)
    chunks = [x[i: i + 7680] for i in range(0, len(x), 7680)] + [np.zeros(900, np.float32)]
    ours, ref = tdsp.StreamingLoudness(), jdsp.StreamingLoudness()
    for c in chunks:
        _close(ours.process(torch.from_numpy(c)), ref.process(c), 3e-5)


@pytest.mark.parametrize("orig,new", [(16000, 24000), (24000, 12000), (24000, 36000)])
def test_resample(orig, new):
    x = _speechy(0.3, seed=14)
    _close(tresample.resample(x, orig, new), jresample.resample(x, orig, new), 1e-5)


@pytest.mark.parametrize("n_steps", [2.0, -2.0, 12.0])
def test_pitch_shift(n_steps):
    x = _speechy(0.3, seed=15)
    _close(tpitch.pitch_shift(x, SR, n_steps), jpitch.pitch_shift(x, SR, n_steps), 1e-4)
    _close(tpitch.pitch_shift(x, SR, 0.0), x, 0)


def _resample_f64(x, orig, new, width=6, rolloff=0.99):
    """Windowed-sinc resample (torchaudio's definition), all output samples at once."""
    g = math.gcd(orig, new)
    orig, new = orig // g, new // g
    base = min(orig, new) * rolloff
    out_len = int(math.ceil(new * len(x) / orig))
    m = np.arange(out_len, dtype=np.float64)[:, None]
    reach = width * orig / base
    n = np.floor(m * orig / new - reach) + np.arange(int(math.ceil(2 * reach)) + 2)[None, :]
    tau = (m / new - n / orig) * base
    ok = (np.abs(tau) < width) & (n >= 0) & (n < len(x))
    taps = np.where(ok, np.sinc(tau) * np.cos(tau * np.pi / width / 2.0) ** 2, 0.0)
    return (x[np.clip(n, 0, len(x) - 1).astype(np.int64)] * taps).sum(axis=1) * base / orig


def pitch_shift_f64(x, sr, n_steps, n_fft=512, hop=128, grid=np.float32):
    """The JAX package's pitch shift (STFT, phase vocoder, iSTFT, resample) in f64 numpy.

    ``grid`` is the dtype of the stretch's time grid: float32 as the JAX
    package builds it, float64 as the direct oracle does.
    """
    x = np.asarray(x, np.float64)
    rate = 2.0 ** (-float(n_steps) / 12.0)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    xp = np.pad(x, n_fft // 2, mode="reflect")
    frames = np.arange(1 + (len(xp) - n_fft) // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(xp[frames] * win, axis=1).T

    steps = np.arange(0.0, spec.shape[1], rate, dtype=grid).astype(np.float64)
    advance = np.linspace(0.0, np.pi * hop, spec.shape[0])[:, None]
    padded = np.pad(spec, ((0, 0), (0, 2)))
    a, b = padded[:, steps.astype(np.int64)], padded[:, steps.astype(np.int64) + 1]
    phase = np.angle(b) - np.angle(a) - advance
    phase = phase - 2.0 * np.pi * np.round(phase / (2.0 * np.pi)) + advance
    phase = np.cumsum(np.concatenate([np.angle(spec[:, :1]), phase[:, :-1]], axis=1), axis=1)
    alphas = (steps % 1.0)[None]
    stretched = (alphas * np.abs(b) + (1.0 - alphas) * np.abs(a)) * np.exp(1j * phase)

    out = np.fft.irfft(stretched.T, n=n_fft, axis=1) * win
    at = np.arange(out.shape[0])[:, None] * hop + np.arange(n_fft)[None, :]
    y, norm = np.zeros(at.max() + 1), np.zeros(at.max() + 1)
    np.add.at(y, at, out)
    np.add.at(norm, at, np.broadcast_to(win ** 2, at.shape))
    length = int(round(len(x) / rate))
    y = (y / np.maximum(norm, 1e-11))[n_fft // 2:][:length]
    y = np.pad(y, (0, length - len(y)))
    new_f, orig_f = jpitch.rate_fraction(rate)
    shifted = _resample_f64(y, orig_f, new_f)[: len(x)]
    return np.pad(shifted, (0, len(x) - len(shifted)))


@pytest.mark.parametrize("n_steps", [2.0, -2.0, 12.0])
def test_pitch_f64_oracle_is_the_direct_oracle(n_steps):
    x = _speechy(0.3, seed=15)
    _close(pitch_shift_f64(x, SR, n_steps, grid=np.float64),
           direct_pitch_oracle(x.astype(np.float64), SR, n_steps), 1e-12)


@pytest.mark.parametrize("n_steps", [2.0, -2.0, 12.0])
def test_pitch_shift_long_matches_f64_oracle(n_steps):
    x = _speechy(15.0, seed=15)
    ours = tpitch.pitch_shift(x, SR, n_steps).numpy().astype(np.float64)
    _close(ours, pitch_shift_f64(x, SR, n_steps), 1.5e-4)


def test_stft_istft_and_filterbanks():
    x = _speechy(0.2, seed=16)
    spec = tspectral.stft(torch.from_numpy(x), 512, 128)
    ref = jspectral.stft(x, 512, 128)
    _close(spec, ref, 1e-4)
    _close(tspectral.istft(spec, 512, 128, length=len(x)),
           jspectral.istft(ref, 512, 128, length=len(x)), 1e-5)
    _close(tspectral.istft(spec, 512, 128), jspectral.istft(ref, 512, 128), 1e-5)
    _close(tspectral.mel_filterbank(16000, 400, 80), jspectral.mel_filterbank(16000, 400, 80), 0)
    _close(tspectral.mel_filterbank(16000, 512, 40, htk=True),
           jspectral.mel_filterbank(16000, 512, 40, htk=True), 0)
    _close(tspectral.dct_matrix(13, 40), jspectral.dct_matrix(13, 40), 0)
    _close(tspectral.hann_window(400), jspectral.hann_window(400), 0)
    short = x[:160]  # shorter than the centre pad: reflected again, as numpy pads
    _close(tspectral.stft(torch.from_numpy(short), 512, 128), jspectral.stft(short, 512, 128), 1e-4)
    _close(tpitch.pitch_shift(short, SR, 2.0), jpitch.pitch_shift(short, SR, 2.0), 1e-4)
