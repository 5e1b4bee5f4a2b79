"""Port parity of the spread-spectrum watermark (``ops/watermark.py``).

The chips are position-indexed: block b of 1024 chips is
``bernoulli(fold_in(PRNGKey(key), b), 0.5)`` on the port's threefry, so they
must equal the JAX package's bit for bit at any offset, on and across block
edges. The embed adds ``chips * envelope * 0.003``; the envelope comes from
an f32 prefix sum in both packages (summed in another order), so the marked
waveform agrees within 1e-6. The four scenarios of
``tests/test_chatterbox_provider.py::TestWatermarkOp`` run on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.ops import watermark as jwm
from rho_tts_tpu_torch.ops import watermark as twm
from rho_tts_tpu_torch.utils import prng

torch.set_num_threads(1)  # several test workers share the cores

EMBED_TOL = 1e-6


def _signal(n, seed=0, period=20.0, noise=0.01):
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(np.arange(n) / period) + noise * rng.standard_normal(n)).astype(
        np.float32)


@pytest.mark.parametrize("n,offset", [
    (1024, 0), (1024, 1), (3000, 1023), (3000, 1024), (3000, 1025), (2048, 2047),
    (5000, 9000), (1500, 123_456), (100, 5000),
])
def test_chips_bit_equal_to_jax(n, offset):
    ref = np.asarray(jwm._pn_span(n, jwm.DEFAULT_KEY, jnp.int32(offset)))
    ours = twm._pn_span(n, twm.DEFAULT_KEY, offset, "cpu")
    assert ours.dtype == torch.float32 and ours.shape == (n,)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_window_chips_are_the_full_sequence_chips():
    full = twm._pn_span(6000, 123, 0, "cpu")
    for lo in (0, 511, 1024, 2500):
        np.testing.assert_array_equal(twm._pn_span(1000, 123, lo, "cpu"), full[lo:lo + 1000])


@pytest.mark.parametrize("seed,p,shape", [(0, 0.5, (1024,)), (42, 0.3, (7, 33)),
                                          (0x5EED, 0.9, (2, 1024))])
def test_bernoulli_bit_equal_to_jax(seed, p, shape):
    ref = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p, shape))
    ours = prng.bernoulli(prng.PRNGKey(seed), p, shape)
    assert ours.dtype == torch.bool
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_fold_in_over_a_vector_of_blocks_equals_vmap():
    blocks = np.arange(5, 13, dtype=np.int32)
    base = jax.random.PRNGKey(jwm.DEFAULT_KEY)
    ref = np.asarray(jax.vmap(lambda i: jax.random.fold_in(base, i))(jnp.asarray(blocks)))
    ours = prng.fold_in(prng.PRNGKey(jwm.DEFAULT_KEY), torch.from_numpy(blocks.astype(np.int64)))
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("n", [1023, 1024, 48_000])
@pytest.mark.parametrize("offset", [0, 1500])
def test_embed_matches_jax(n, offset):
    a = _signal(n, seed=n)
    ref = np.asarray(jwm.apply_watermark(a, offset=offset))
    ours = twm.apply_watermark(torch.from_numpy(a), offset=offset)
    assert ours.dtype == torch.float32 and ours.shape == (n,)
    np.testing.assert_allclose(ours.numpy(), ref, atol=EMBED_TOL, rtol=0)
    if n < 1024:
        np.testing.assert_array_equal(ours.numpy(), a)  # passes through unchanged


def test_detect_matches_jax():
    a = _signal(24_000, seed=5)
    marked = np.asarray(jwm.apply_watermark(a))
    for x, off in ((marked, 0), (a, 0), (marked[3000:20000], 3000), (a[:1000], 0)):
        ref = jwm.detect_watermark(x, offset=off)
        ours = twm.detect_watermark(torch.from_numpy(np.array(x)), offset=off)
        assert ours == pytest.approx(ref, rel=1e-4, abs=1e-4)


class TestWatermarkOp:
    """``tests/test_chatterbox_provider.py::TestWatermarkOp`` on the port."""

    def test_embed_detect_roundtrip(self):
        rng = np.random.default_rng(0)
        audio = torch.from_numpy((0.3 * np.sin(np.arange(24000) / 20)
                                  + 0.01 * rng.standard_normal(24000)).astype(np.float32))
        marked = twm.apply_watermark(audio)
        assert twm.detect_watermark(marked) > 5.0
        assert twm.detect_watermark(audio) < 5.0
        assert (marked - audio).abs().max().item() < 0.01  # inaudible: a tiny perturbation

    def test_wrong_key_not_detected(self):
        audio = torch.from_numpy((0.3 * np.sin(np.arange(24000) / 20)).astype(np.float32))
        marked = twm.apply_watermark(audio, key=123)
        assert twm.detect_watermark(marked, key=456) < 5.0

    def test_offset_windows_align_with_full_embed(self):
        """A window marked at its absolute offset carries the full embed's
        chips; only the envelope's +-512-sample edges differ."""
        rng = np.random.default_rng(1)
        audio = torch.from_numpy((0.3 * np.sin(np.arange(48000) / 17)
                                  + 0.01 * rng.standard_normal(48000)).astype(np.float32))
        full = twm.apply_watermark(audio)
        lo, hi = 10000, 30000
        win = twm.apply_watermark(audio[lo:hi], offset=lo)
        np.testing.assert_allclose(win[512:-512].numpy(), full[lo + 512: hi - 512].numpy(),
                                   atol=1e-6)

    def test_detect_on_known_offset_crop(self):
        rng = np.random.default_rng(2)
        audio = torch.from_numpy((0.3 * np.sin(np.arange(48000) / 23)
                                  + 0.01 * rng.standard_normal(48000)).astype(np.float32))
        crop = twm.apply_watermark(audio)[9000:33000]
        assert twm.detect_watermark(crop, offset=9000) > 5.0
        assert twm.detect_watermark(crop) < 5.0  # an unknown offset misaligns the chips
