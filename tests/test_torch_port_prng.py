"""Port parity: the torch threefry2x32 streams vs ``jax.random``.

The seeded sampler's noise must be bit-identical for the port to draw the
same tokens as the JAX package from the same seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.qwen import model as jmodel
from rho_tts_tpu_torch.models.qwen import model as tmodel
from rho_tts_tpu_torch.utils import prng

torch.set_num_threads(1)  # several test workers share the cores

SEEDS = [0, 1, 7, 0x5EED, 2**31 - 1, 123456789]
FRAMES = [0, 1, 2, 63, 64, 1000, 2**31 + 5]


def _key_np(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def test_prng_key_and_fold_in_identical():
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.PRNGKey(seed).numpy(), _key_np(jax.random.PRNGKey(seed))
        )
    base = jax.random.PRNGKey(0x5EED)
    ours = prng.fold_in(
        prng.fold_in(prng.PRNGKey(0x5EED), torch.tensor(SEEDS))[:, None, :],
        torch.tensor(FRAMES)[None, :],
    ).numpy()
    for i, s in enumerate(SEEDS):
        for j, f in enumerate(FRAMES):
            ref = jax.random.fold_in(jax.random.fold_in(base, np.uint32(s)), np.uint32(f))
            np.testing.assert_array_equal(ours[i, j], _key_np(ref), err_msg=f"seed {s} frame {f}")


@pytest.mark.parametrize("shape", [(1,), (50,), (3, 7)])
def test_random_bits_identical(shape):
    assert jax.config.jax_threefry_partitionable  # the stream the port reproduces
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
        ours = prng.random_bits(prng.PRNGKey(seed), shape).numpy()
        np.testing.assert_array_equal(ours, ref)


def test_uniform_and_gumbel_match():
    """uniform: identical bits. gumbel: <= 1e-6 relative, since -log(-log(u))
    goes through each library's own log (at most an ulp apart)."""
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        tkey = prng.PRNGKey(seed)
        u_ref = np.asarray(jax.random.uniform(key, (64,), minval=np.finfo(np.float32).tiny))
        u = prng.uniform(tkey, (64,), minval=float(np.finfo(np.float32).tiny)).numpy()
        np.testing.assert_array_equal(u, u_ref)
        g_ref = np.asarray(jax.random.gumbel(key, (64,)))
        g = prng.gumbel(tkey, (64,)).numpy()
        np.testing.assert_allclose(g, g_ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("top_k", [1, 5, 50])
def test_sample_token_seeded_identical(top_k):
    rng = np.random.default_rng(3)
    b, v = 6, 200
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    seeds = np.asarray([0, 1, 2, 3, 99, 2**31 - 2], np.int32)
    for frame in (0, 5, 300):
        frames = np.full((b,), frame, np.int32)
        ref = np.asarray(jmodel._sample_token_seeded(
            jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(frames), jnp.float32(0.9), top_k,
        ))
        ours = tmodel._sample_token_seeded(
            torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
            torch.from_numpy(frames.astype(np.int64)), 0.9, top_k,
        ).numpy()
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("num", [2, 3])
def test_split_identical_and_chained(num):
    """split(key, num) and the engine's chain (key, sub = split(key)) give
    jax.random.split's bits; under the partitionable layout key i is
    fold_in(key, i)."""
    for seed in SEEDS:
        key, tkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for _ in range(4):  # a chain, as BaseTTS.next_rng walks it
            ref = _key_np(jax.random.split(key, num))
            ours = prng.split(tkey, num).numpy()
            np.testing.assert_array_equal(ours, ref)
            np.testing.assert_array_equal(ours[1], prng.fold_in(tkey, 1).numpy())
            key, _ = jax.random.split(key)
            tkey = prng.split(tkey, 2)[0]


@pytest.mark.parametrize("shape,lo,hi", [
    ((5,), 0, np.iinfo(np.int32).max),  # _derive_row_seeds' range
    ((1,), 0, np.iinfo(np.int32).max),
    ((3, 4), -7, 100),
    ((7,), 3, 70000),
    ((6,), -2**31, 2**31 - 1),
    ((2,), 5, 5),  # empty range: minval, as JAX returns it
])
def test_randint_identical(shape, lo, hi):
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        for k, tk in ((key, prng.PRNGKey(seed)),
                      (jax.random.split(key)[1], prng.split(prng.PRNGKey(seed))[1])):
            ref = np.asarray(jax.random.randint(k, shape, lo, hi, jnp.int32))
            np.testing.assert_array_equal(prng.randint(tk, shape, lo, hi).numpy(), ref)


def test_derive_row_seeds_identical():
    for seed in SEEDS:
        key = jax.random.split(jax.random.PRNGKey(seed))[1]
        tkey = prng.split(prng.PRNGKey(seed))[1]
        for n in (1, 2, 5):
            np.testing.assert_array_equal(
                tmodel._derive_row_seeds(tkey, n).numpy(),
                np.asarray(jmodel._derive_row_seeds(key, n)),
            )
