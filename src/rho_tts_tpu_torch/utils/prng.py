"""Bit-exact threefry2x32 random streams of ``jax.random``, in plain torch.

The seeded sampler (``models.qwen.model._sample_token_seeded``) makes row
i's Gumbel noise a pure function of ``(seeds[i], frame)`` through
``jax.random`` keys. Reproducing those bits lets the port draw the same
tokens as the JAX package for the same seeds. Covered:

* ``PRNGKey(seed)``: the raw threefry key ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(key, data)``: ``threefry2x32(key, [0, data])``, vectorised
  over a tensor of ``data`` (one key per entry, as ``jax.vmap(fold_in)``);
* ``split(key, num)``: key i is ``threefry2x32(key, [i >> 32, i & 0xFFFFFFFF])``
  (the "fold-like" split of ``jax_threefry_partitionable=True``), so
  ``split(key, n)[i] == fold_in(key, i)``;
* ``random_bits(key, shape)`` as generated under
  ``jax_threefry_partitionable=True`` (the default of jax 0.9): element n
  is ``x0 ^ x1`` of ``threefry2x32(key, [n >> 32, n & 0xFFFFFFFF])``;
* ``uniform(key, shape, minval, maxval)`` for float32, ``bernoulli(key, p,
  shape)`` (``uniform(key, shape) < p``) and ``gumbel(key, shape)`` (the
  default "low" mode: ``-log(-log(uniform(tiny, 1)))``);
* ``randint(key, shape, minval, maxval)`` for int32: two 32-bit draws from
  ``split(key)``, reduced modulo the span in uint32 arithmetic.

The words are held in int64 tensors masked to 32 bits (torch's uint32 has
too few operators), so everything runs on any device as ordinary integer
ops. Keys are int64 tensors ``(..., 2)`` and every function broadcasts over
their leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block hash (20 rounds) on broadcastable uint32 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 tensor ``(2,)``."""
    seed = int(seed)
    # A select of two constants: no host->device copy, no host wait.
    first = torch.arange(2, device=device) == 0
    return torch.where(first, (seed >> 32) & MASK32, seed & MASK32)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` broadcast over ``key (..., 2)`` and ``data (...)``."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: keys ``(..., num, 2)``."""
    counts = torch.arange(int(num), dtype=torch.int64, device=key.device)
    k0, k1 = key[..., 0, None], key[..., 1, None]
    y0, y1 = threefry2x32(k0, k1, counts >> 32, counts & MASK32)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit words ``(..., *shape)`` (values in int64), partitionable layout."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    counts = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    k0, k1 = key[..., 0][expand], key[..., 1][expand]
    y0, y1 = threefry2x32(k0, k1, counts >> 32, counts & MASK32)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` for float32, bit for bit."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    # XLA fuses the scale and shift into one fused multiply-add (one
    # rounding); in float64 the f32 x f32 product is exact, so rounding the
    # sum once to float32 gives the same bits.
    scaled = (floats.double() * span + float(lo)).to(torch.float32)
    return torch.clamp_min(scaled, float(lo))


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p``, bit for bit:
    ``uniform(key, shape) < p`` in float32."""
    return uniform(key, shape) < float(np.float32(p))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, "low" mode)."""
    u = uniform(key, shape, minval=_TINY_F32, maxval=1.0)
    return -torch.log(-torch.log(u))


_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``, bit for bit.

    ``minval`` and ``maxval`` are Python ints (clipped to int32 as JAX
    clips them). Returns int64 values in ``[minval, maxval)``.
    """
    out_of_range = maxval > _INT32_MAX
    lo = min(max(int(minval), _INT32_MIN), _INT32_MAX)
    hi = min(max(int(maxval), _INT32_MIN), _INT32_MAX)
    span = (hi - lo) & MASK32
    if hi <= lo:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK32
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    if span == 0:  # a span of 2**32 wraps to 0: the remainders leave the bits as drawn
        offset = (higher * 0 + lower) & MASK32
    else:
        # uint32 arithmetic: every product and sum wraps at 2**32, the
        # multiplier's square too (65536**2 wraps to 0, so for spans above
        # 65536 the multiplier is 0 and only the lower draw counts).
        multiplier = (1 << 16) % span
        multiplier = ((multiplier * multiplier) & MASK32) % span
        offset = (((higher % span) * multiplier) & MASK32) + (lower % span)
        offset = (offset & MASK32) % span
    value = (lo + offset) & MASK32
    return torch.where(value >= (1 << 31), value - (1 << 32), value)
