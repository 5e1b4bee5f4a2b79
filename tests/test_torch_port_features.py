"""Port parity of the acoustic features: ``rho_tts_tpu_torch.ops.features`` and
the drift trainer's feature paths against the JAX package's, on the CPU.

The same seeded numpy clips (harmonic tones plus noise, as
``tests/test_features_batch.py`` uses, so every YIN decision is clear) go
through both packages. Tolerances, absolute unless said otherwise:

* ``resample_batch``: 1e-6 (the same f32 polyphase sums in another order);
* MFCCs and their masked batch statistics: 2e-4 (the dB values reach ~500
  in magnitude: pocketfft and PyTorch's FFT round apart by ~1e-6 relative);
* the YIN CMND surface 1e-4 and ``e0`` 1e-5 relative; the voiced decisions
  identical, f0 1e-3 Hz;
* formants: identical (the same float64 numpy LPC on the same samples);
* the 286-d features of ``extract_features`` / ``extract_features_batch_audio``:
  the embedding 1e-4, the MFCC statistics 2e-4 (relative 1e-5), F0 and
  formants 1e-2 Hz, against the JAX function of the same name; the port's
  batched path against its serial path with the JAX golden test's bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.ops import features as jf
from rho_tts_tpu.ops import resample as jr
from rho_tts_tpu.validation.classifier import trainer as jtrainer
from rho_tts_tpu_torch.ops import features as tf
from rho_tts_tpu_torch.ops import resample as tr
from rho_tts_tpu_torch.validation.classifier import trainer as ttrainer

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these tests run many small ops, and parallel
    test workers each spinning a full thread pool contend for the cores
    (20x slower under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(freq, dur, sr=SR, amp=0.4, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(dur * sr)) / sr
    w = amp * np.sin(2 * np.pi * freq * t)
    if noise:
        w = w + noise * rng.standard_normal(t.size)
    return w.astype(np.float32)


def _mixed(seed):
    """A voiced tone, silence and noise: voiced, unvoiced and silent frames."""
    rng = np.random.default_rng(seed)
    return np.concatenate([_clip(220 + 40 * seed, 0.5, noise=0.01, seed=seed),
                           np.zeros(2000, np.float32),
                           0.2 * rng.standard_normal(8000).astype(np.float32)])


@pytest.mark.parametrize("orig,new,target", [(24000, 16000, 16000), (24000, 16000, 20000),
                                             (16000, 16000, 12000), (16000, 16000, 30000),
                                             (22050, 16000, 10000)])
def test_resample_batch(orig, new, target):
    x = np.random.default_rng(orig + target).standard_normal((3, 24000)).astype(np.float32)
    ref = np.asarray(jr.resample_batch(jnp.asarray(x), orig, new, target))
    ours = tr.resample_batch(torch.from_numpy(x), orig, new, target).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_mfcc(seed):
    w = _mixed(seed)
    ref = np.asarray(jf.mfcc(w))
    ours = tf.mfcc(w, device="cpu").numpy()
    assert ours.shape == ref.shape == (13, 1 + w.size // 512)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


def test_mfcc_stats_batch():
    clips = [_mixed(0), _clip(330, 1.1, noise=0.02, seed=2), _clip(150, 0.6, noise=0.05, seed=3)]
    width = 32768
    x = np.stack([np.pad(c, (0, width - c.size)) for c in clips])
    counts = np.array([1 + c.size // 512 for c in clips])
    ref = jf._mfcc_stats_batch(jnp.asarray(x), jnp.asarray(counts), SR, 13, 2048, 512, 128)
    ours = tf._mfcc_stats_batch(torch.from_numpy(x), torch.from_numpy(counts), SR, 13, 2048,
                                512, 128)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_yin_cmnd_and_pick(seed):
    w = _mixed(seed)
    tau_min = max(int(SR / 2093.0), 1)
    tau_max = min(int(SR / 65.41) + 1, 1024)
    c_ref, e_ref = (np.asarray(a) for a in jf._yin_cmnd(jnp.asarray(w), 2048, 512, tau_max))
    c_ours, e_ours = (a.numpy() for a in tf._yin_cmnd(torch.from_numpy(w), 2048, 512, tau_max))
    np.testing.assert_allclose(c_ours, c_ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(e_ours, e_ref, rtol=1e-5, atol=1e-7)
    # the host picker on the same surface: the same function, the same answer
    f_ref, v_ref = jf.yin_pick(c_ref, e_ref, SR, tau_min, tau_max, 2048, 0.1, 0.5)
    f_ours, v_ours = tf.yin_pick(c_ref, e_ref, SR, tau_min, tau_max, 2048, 0.1, 0.5)
    np.testing.assert_array_equal(v_ours, v_ref)
    np.testing.assert_array_equal(f_ours[v_ours], f_ref[v_ref])
    # the device picker on each package's own surface
    fd_ref, vd_ref = (np.asarray(a) for a in jf.yin_pick_device(
        jnp.asarray(c_ref), jnp.asarray(e_ref), SR, tau_min, tau_max, 2048, 0.1, 0.5))
    fd_ours, vd_ours = (a.numpy() for a in tf.yin_pick_device(
        torch.from_numpy(c_ours), torch.from_numpy(e_ours), SR, tau_min, tau_max, 2048, 0.1,
        0.5))
    assert vd_ref.any() and not vd_ref.all()  # voiced and unvoiced frames both occur
    np.testing.assert_array_equal(vd_ours, vd_ref)
    np.testing.assert_allclose(fd_ours, fd_ref, atol=1e-3, rtol=0)
    # f0_yin end to end
    f_ref, v_ref = jf.f0_yin(w)
    f_ours, v_ours = tf.f0_yin(w, device="cpu")
    np.testing.assert_array_equal(v_ours, v_ref)
    np.testing.assert_allclose(f_ours[v_ours], f_ref[v_ref], atol=1e-3, rtol=0)


@pytest.mark.parametrize("n", [20, 399, 16000, 20000])
def test_formants(n):
    w = _mixed(1)[:n]
    assert tf.estimate_formants(w) == jf.estimate_formants(w)
    assert tf.estimate_formants(torch.from_numpy(w)) == jf.estimate_formants(w)


def _assert_features_close(ours, ref):
    assert ours.shape == ref.shape == (286,)
    np.testing.assert_allclose(ours[:256], ref[:256], atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours[256:282], ref[256:282], atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(ours[282:], ref[282:], atol=1e-2, rtol=0)


@pytest.mark.parametrize("sr", [SR, 24000])
def test_extract_features_batch_audio(sr):
    clips = [_clip(220, 1.3, sr=sr, noise=0.01, seed=1), _clip(330, 2.1, sr=sr, noise=0.02, seed=2),
             _clip(150, 0.7, sr=sr, noise=0.05, seed=3)]
    before, fallbacks = ttrainer.fetches, ttrainer.serial_fallbacks
    ours = ttrainer.extract_features_batch_audio(clips, sr, device="cpu")
    assert ttrainer.fetches - before == 1 and ttrainer.serial_fallbacks == fallbacks
    ref = jtrainer.extract_features_batch_audio(clips, sr)
    for o, r in zip(ours, ref):
        _assert_features_close(o, r)
    # the batched path against the port's serial path (the JAX golden bounds)
    serial = [ttrainer.extract_features(c, sample_rate=sr, device="cpu") for c in clips]
    emb_tol, mf_tol, mf_rtol = (2e-4, 5e-3, 1e-3) if sr == SR else (2e-3, 2e-2, 5e-3)
    for s, b in zip(serial, ours):
        np.testing.assert_allclose(b[:256], s[:256], atol=emb_tol)
        np.testing.assert_allclose(b[256:282], s[256:282], atol=mf_tol, rtol=mf_rtol)
        if sr == SR:
            np.testing.assert_allclose(b[282:], s[282:], atol=1.0)


@pytest.mark.parametrize("sr", [SR, 24000])
def test_extract_features_serial(sr):
    c = _clip(260, 1.0, sr=sr, noise=0.02, seed=7)
    _assert_features_close(ttrainer.extract_features(c, sample_rate=sr, device="cpu"),
                           jtrainer.extract_features(c, sample_rate=sr))


def test_batch_edge_cases():
    assert ttrainer.extract_features_batch_audio([], SR, device="cpu") == []
    out = ttrainer.extract_features_batch_audio([torch.from_numpy(_clip(260, 1.0, seed=7))], SR)
    assert len(out) == 1 and out[0].shape == (286,)  # a CPU tensor runs on the CPU
    assert ttrainer.extract_features(np.zeros(10, np.float32)) is None  # no sample rate
