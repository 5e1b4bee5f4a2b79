"""Port parity of the GE2E speaker encoder: ``rho_tts_tpu_torch.models.speaker``
against ``rho_tts_tpu.models.speaker`` on the CPU.

* The default init is bit-equal: the port draws JAX's ``jax.random``
  splits and uniforms through ``utils.prng`` (XLA's fused multiply-add in
  ``uniform`` included), so a host without a checkpoint embeds the same in
  both packages.
* ``log_mel`` 1e-4 absolute (log power; the FFTs round apart by ~1e-6
  relative), ``preprocess`` 1e-6 (the same numpy VAD after a resample that
  rounds apart by ~1e-7), the LSTM forward ``_forward_windows`` and
  ``embed_utterance`` 1e-5 (L2-normalized 256-d outputs).
* ``load_pretrained`` of a synthetic resemblyzer state dict (``.pt``, raw
  and wrapped, and ``.npz``) gives the JAX package's tree; a JAX tree of
  random weights crosses ``from_jax.params_from_numpy`` unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.speaker import encoder as je
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.speaker import encoder as te
from rho_tts_tpu_torch.utils import prng
from test_torch_port_features import one_torch_thread  # noqa: F401 — fixture


def voice_like(f0, dur=1.2, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * dur)) / sr
    sig = sum((0.4 / (k + 1)) * np.sin(2 * np.pi * f0 * (k + 1) * t + rng.uniform(0, 6))
              for k in range(4))
    return (sig + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("seed", [0, 7])
def test_default_init_is_bit_equal(seed):
    ref = _np_tree(je.init_params(jax.random.PRNGKey(seed)))
    ours = te.init_params(prng.PRNGKey(seed))
    for r, o in zip(ref["lstm"], ours["lstm"]):
        for k in ("w_ih", "w_hh", "bias"):
            np.testing.assert_array_equal(o[k].numpy(), r[k])
    np.testing.assert_array_equal(ours["proj"].numpy(), ref["proj"])
    np.testing.assert_array_equal(ours["proj_bias"].numpy(), ref["proj_bias"])
    np.testing.assert_array_equal(te.SpeakerEncoder(seed=seed, device="cpu").params["proj"],
                                  ref["proj"])


@pytest.mark.parametrize("n", [1200, 16000, 40000])
def test_log_mel(n):
    w = voice_like(150)[:n] if n <= 19200 else np.tile(voice_like(150), 3)[:n]
    ref = np.asarray(je.log_mel(jnp.asarray(w)))
    ours = te.log_mel(torch.from_numpy(w)).numpy()
    assert ours.shape == ref.shape == (1 + n // 160, 40)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("sr", [16000, 24000])
def test_preprocess(sr):
    w = voice_like(180, sr=sr)
    padded = np.concatenate([np.zeros(sr, np.float32), w, np.zeros(sr // 3, np.float32)])
    ref = je.preprocess(padded, sr)
    ours = te.preprocess(padded, sr)
    assert ours.shape == ref.shape and ours.size < padded.size * 16000 // sr
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_forward_windows():
    rng = np.random.default_rng(0)
    params = je.init_params(jax.random.PRNGKey(3))
    tparams = from_jax.params_from_numpy(_np_tree(params), device="cpu")
    mels = rng.standard_normal((2, 400, 40)).astype(np.float32)
    mels[1, 250:] = 0.0  # the second utterance is shorter
    starts = np.array([[0, 80, 160, 240], [0, 80, 80, 80]], np.int32)
    valid = np.array([[True, True, True, True], [True, True, False, False]])
    ref = np.asarray(je._forward_windows(params, jnp.asarray(mels), jnp.asarray(starts),
                                         jnp.asarray(valid)))
    ours = te._forward_windows(tparams, torch.from_numpy(mels),
                               torch.from_numpy(starts).long(), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("f0,dur,sr", [(150, 1.2, 16000), (320, 0.2, 16000), (200, 2.5, 24000)])
def test_embed_utterance(f0, dur, sr):
    w = voice_like(f0, dur=dur, sr=sr, seed=int(f0))
    ref = je.SpeakerEncoder(seed=0).embed_utterance(w, sr)
    ours = te.SpeakerEncoder(seed=0, device="cpu")
    np.testing.assert_allclose(ours.embed_utterance(w, sr), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.embed_utterance(torch.from_numpy(w), sr), ref, atol=1e-5)
    batch = ours.embed_batch([w, w], [sr, sr])
    assert batch.shape == (2, 256)
    np.testing.assert_array_equal(batch[1], ours.embed_utterance(w, sr))


def _state_dict(seed):
    rng = np.random.default_rng(seed)
    h, d = te.HIDDEN, te.N_MELS
    state = {}
    for layer in range(te.LAYERS):
        din = d if layer == 0 else h
        state[f"lstm.weight_ih_l{layer}"] = rng.uniform(-0.06, 0.06, (4 * h, din))
        state[f"lstm.weight_hh_l{layer}"] = rng.uniform(-0.06, 0.06, (4 * h, h))
        state[f"lstm.bias_ih_l{layer}"] = rng.uniform(-0.06, 0.06, (4 * h,))
        state[f"lstm.bias_hh_l{layer}"] = rng.uniform(-0.06, 0.06, (4 * h,))
    state["linear.weight"] = rng.uniform(-0.05, 0.05, (te.EMBED, h))
    state["linear.bias"] = rng.uniform(-0.05, 0.05, (te.EMBED,))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in state.items()}


@pytest.mark.parametrize("fmt", ["pt", "wrapped", "npz"])
def test_load_pretrained(tmp_path, monkeypatch, fmt):
    state = _state_dict(1)
    path = str(tmp_path / ("w.npz" if fmt == "npz" else "w.pt"))
    if fmt == "npz":
        np.savez(path, **{k: v.numpy() for k, v in state.items()})
    else:
        torch.save({"model_state": state, "step": 3} if fmt == "wrapped" else state, path)
    ref = _np_tree(je.load_pretrained(path))
    ours = te.load_pretrained(path)
    for r, o in zip(ref["lstm"], ours["lstm"]):
        for k in ("w_ih", "w_hh", "bias"):
            np.testing.assert_allclose(o[k].numpy(), r[k], atol=0, rtol=0)
    np.testing.assert_array_equal(ours["proj"].numpy(), ref["proj"])
    np.testing.assert_array_equal(ours["proj_bias"].numpy(), ref["proj_bias"])
    # the env var route, both packages on the same file
    monkeypatch.setenv("RHO_TTS_TPU_SPEAKER_WEIGHTS", path)
    w = voice_like(170, seed=4)
    np.testing.assert_allclose(te.SpeakerEncoder(device="cpu").embed_utterance(w, 16000),
                               je.SpeakerEncoder().embed_utterance(w, 16000), atol=1e-5)


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        te.load_pretrained(str(tmp_path / "none.pt"))


def test_bridge_keeps_the_speaker_tree():
    tree = _np_tree(je.init_params(jax.random.PRNGKey(11)))
    ours = from_jax.params_from_numpy(tree, device="cpu")
    assert ours["lstm"][0]["w_ih"].shape == (40, 1024) and ours["proj"].shape == (256, 256)
    for r, o in zip(tree["lstm"], ours["lstm"]):
        np.testing.assert_array_equal(o["w_hh"].numpy(), r["w_hh"])
