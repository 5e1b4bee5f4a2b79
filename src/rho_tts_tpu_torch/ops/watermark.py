"""Inaudible spread-spectrum audio watermark (embed + detect), in PyTorch.

Counterpart of ``rho_tts_tpu/ops/watermark.py``: a seeded ±1 pseudo-noise
sequence is shaped by the signal's local RMS envelope (so it hides under
the program material) and added at a small level; detection correlates the
first difference of the audio against that of the same sequence and
reports a normalized score.

The chips are **position-indexed**: the chip at absolute sample position
``p`` depends only on ``(key, p)``. Block ``b`` of 1024 chips is
``prng.bernoulli(fold_in(PRNGKey(key), b), 0.5, (1024,))`` on the port's
threefry, bit for bit the JAX package's, so a streaming synthesizer can
mark each window at its absolute offset and get the chips of the
full-utterance embed. Everything runs on the waveform's device; ``offset``
is a Python int, so the embed reads nothing back.

The envelope is a centred windowed mean of x² from an f32 prefix sum over
the edge-padded signal, the JAX package's numerics (its cumulative sum is
ordered otherwise, so the two agree to f32 rounding, scaled down by the
0.003 strength in the output). The prefix sum runs in 1024-sample blocks,
then over the block totals, each as a scan over rows: torch scans a lone
1-D CUDA tensor with CUB, whose float sums depend on the timing of its
thread blocks, while a scan over rows adds in a fixed order, so the embed
gives the same bits on every call.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..utils import prng

DEFAULT_KEY = 0x5EED
_STRENGTH = 0.003  # ~ -50 dBFS relative to envelope
_ENV_WINDOW = 1024
_PN_BLOCK = 1024


def _pn_span(n: int, key: int, offset: int, device) -> torch.Tensor:
    """±1 f32 chips for absolute positions ``[offset, offset + n)``."""
    b = _PN_BLOCK
    nb = n // b + 2  # covers offset % b + n chips
    b0 = offset // b
    blocks = torch.arange(b0, b0 + nb, dtype=torch.int64, device=device)
    keys = prng.fold_in(prng.PRNGKey(key, device=device), blocks)  # (nb, 2)
    bits = prng.bernoulli(keys, 0.5, (b,))  # (nb, b)
    flat = torch.where(bits.reshape(-1), 1.0, -1.0)
    start = offset - b0 * b
    return flat[start: start + n]


def _row_cumsum(rows: torch.Tensor) -> torch.Tensor:
    """``cumsum(rows, dim=1)`` in a fixed order: a zero row is appended so
    that torch never takes its single-sequence scan."""
    return torch.cumsum(torch.cat([rows, torch.zeros_like(rows[:1])]), dim=1)[:-1]


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum of a 1-D tensor, bit-reproducible on the card."""
    n = x.shape[0]
    nb = -(-n // _ENV_WINDOW)
    within = _row_cumsum(F.pad(x, (0, nb * _ENV_WINDOW - n)).view(nb, _ENV_WINDOW))
    carry = _row_cumsum(within[None, :, -1])[0]  # running block totals
    return (within + F.pad(carry[:-1], (1, 0))[:, None]).reshape(-1)[:n]


def _flat(audio) -> torch.Tensor:
    a = audio if isinstance(audio, torch.Tensor) else torch.as_tensor(audio)
    return a.to(torch.float32).reshape(-1)


def apply_watermark(audio, key: int = DEFAULT_KEY, offset: int = 0) -> torch.Tensor:
    """Embed the watermark; returns the marked 1-D f32 waveform on the
    input's device. Inputs shorter than one envelope window (1024 samples)
    come back unchanged.

    ``offset`` is the waveform's absolute start position in the utterance
    (streaming windows pass their start sample, so the chips line up with
    the full-utterance embed).
    """
    a = _flat(audio)
    n = a.shape[-1]
    if n < _ENV_WINDOW:
        return a
    pn = _pn_span(n, key, int(offset), a.device)
    half = _ENV_WINDOW // 2
    x2 = a * a
    padded = F.pad(x2[None, None], (half, half), mode="replicate")[0, 0]
    csum = torch.cat([padded.new_zeros(1), _prefix_sum(padded)])
    window_sums = csum[_ENV_WINDOW:] - csum[:-_ENV_WINDOW]
    env = torch.sqrt(window_sums[:n] / _ENV_WINDOW)
    return a + pn * env * _STRENGTH


def detect_watermark(audio, key: int = DEFAULT_KEY, offset: int = 0) -> float:
    """Normalized detection score; above ~5 the watermark is present.

    ``offset``: absolute position of ``audio[0]`` in the original utterance
    (0 for a full recording; a known crop position re-aligns the chips).
    Reads the score back to the host.
    """
    a = _flat(audio)
    n = a.shape[-1]
    if n < _ENV_WINDOW:
        return 0.0
    pn = _pn_span(n, key, int(offset), a.device)
    # Whiten with a first-order difference to suppress the host signal,
    # then correlate against the equally-whitened PN template.
    resid = torch.diff(a, prepend=a[:1])
    tmpl = torch.diff(pn, prepend=pn[:1])
    num = torch.sum(resid * tmpl)
    den = torch.sqrt(torch.sum(resid * resid) * torch.sum(tmpl * tmpl)) + 1e-12
    return float(num / den * math.sqrt(n))
