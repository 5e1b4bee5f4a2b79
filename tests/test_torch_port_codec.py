"""Port parity: the codec (conv encoder, RVQ, vocoder) vs the JAX package.

JAX codec weights are carried over through ``from_jax`` (which converts the
conv layouts); both packages decode and encode the same codes and audio at
fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.qwen import codec as jcodec
from rho_tts_tpu.models.qwen.config import PRESETS as JPRESETS
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.qwen import codec as tcodec
from rho_tts_tpu_torch.models.qwen.config import PRESETS as TPRESETS

torch.set_num_threads(1)  # several test workers share the cores


@pytest.fixture(scope="module")
def codec_pair():
    cfg = JPRESETS["tiny"].codec
    shapes = jax.eval_shape(lambda: jcodec.init_codec(jax.random.PRNGKey(0), cfg, jnp.float32))
    rng = np.random.default_rng(0)

    def init(leaf):  # fan-in scaled weights, JAX layout (K, Cin, Cout)
        scale = 0.05 if leaf.shape[-1] == cfg.codebook_dim and leaf.shape[-2] == cfg.codebook_size \
            else 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * scale)

    jparams = jax.tree.map(init, shapes)
    tparams = from_jax.params_from_numpy(
        {"codec": jax.tree.map(np.asarray, jparams)}, device="cpu"
    )["codec"]
    assert dataclasses.asdict(TPRESETS["tiny"].codec) == dataclasses.asdict(cfg)
    return cfg, jparams, tparams


def test_conv_layouts_converted(codec_pair):
    cfg, jparams, tparams = codec_pair
    k, cin, cout = np.asarray(jparams["decoder"]["ups"][0]).shape
    assert tuple(tparams["decoder"]["ups"][0].shape) == (cin, cout, k)  # ConvTranspose1d
    k, cin, cout = np.asarray(jparams["decoder"]["conv_pre"]).shape
    assert tuple(tparams["decoder"]["conv_pre"].shape) == (cout, cin, k)  # Conv1d
    np.testing.assert_array_equal(
        tparams["rvq"]["codebooks"].numpy(), np.asarray(jparams["rvq"]["codebooks"])
    )


@pytest.mark.parametrize("stride,dilation,k", [(1, 1, 3), (1, 3, 3), (2, 1, 4), (4, 1, 8)])
def test_conv1d_matches_jax(stride, dilation, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 5)).astype(np.float32)
    w = rng.standard_normal((k, 5, 7)).astype(np.float32)
    ref = np.asarray(jcodec.conv1d(jnp.asarray(x), jnp.asarray(w), stride=stride, dilation=dilation))
    ours = tcodec.conv1d(
        torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(w.transpose(2, 1, 0).copy()),
        stride=stride, dilation=dilation,
    ).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("r,k", [(2, 4), (3, 6), (3, 5)])
def test_conv_transpose1d_matches_jax(r, k):
    """Includes an odd k - stride, where the extra right sample is cropped."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, 4)).astype(np.float32)
    w = rng.standard_normal((k, 4, 6)).astype(np.float32)
    ref = np.asarray(jcodec.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), stride=r))
    ours = tcodec.conv_transpose1d(
        torch.from_numpy(x.transpose(0, 2, 1).copy()), torch.from_numpy(w.transpose(1, 2, 0).copy()),
        stride=r,
    ).numpy().transpose(0, 2, 1)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_decode_from_codes_matches_jax(codec_pair):
    """fp32 waveform: 1e-4 (tests/test_torch_oracle.py's codec tolerance)."""
    cfg, jparams, tparams = codec_pair
    codes = np.random.default_rng(2).integers(0, cfg.codebook_size, (2, 9, cfg.n_codebooks))
    ref = np.asarray(jcodec.decode_from_codes(jparams, cfg, jnp.asarray(codes, jnp.int32)))
    ours = tcodec.decode_from_codes(tparams, cfg, torch.from_numpy(codes)).numpy()
    assert ours.shape == ref.shape == (2, 9 * cfg.hop)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_encode_to_codes_matches_jax(codec_pair):
    """Codes identical: the same nearest-neighbour search on 1e-5-close frames."""
    cfg, jparams, tparams = codec_pair
    wav = (np.random.default_rng(3).standard_normal((2, cfg.hop * 12)) * 0.3).astype(np.float32)
    ref = np.asarray(jcodec.encode_to_codes(jparams, cfg, jnp.asarray(wav)))
    ours = tcodec.encode_to_codes(tparams, cfg, torch.from_numpy(wav)).numpy()
    np.testing.assert_array_equal(ours, ref)
    frames_ref = np.asarray(jcodec.encode_frames(jparams["encoder"], cfg, jnp.asarray(wav)))
    frames = tcodec.encode_frames(tparams["encoder"], cfg, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(frames, frames_ref, atol=1e-4, rtol=1e-4)
