"""Port parity of Whisper: ``rho_tts_tpu_torch.models.whisper`` against
``rho_tts_tpu.models.whisper`` on the CPU, on the JAX init's random weights
carried across by ``from_jax.params_from_numpy`` (which turns the conv
stem's (K, Cin, Cout) into torch's (Cout, Cin, K)).

* ``log_mel_spectrogram`` 1e-4 absolute (normalized log10 mel: the FFTs
  round apart by ~1e-6 relative);
* ``encode`` 2e-5 absolute at states of magnitude ~4 (f32, the same sums
  in another order); ``decoder_logits`` 1e-5;
* greedy and beam-5 token ids identical on the ``test`` preset, beam
  search selected by a stable descending sort (``lax.top_k`` ties go to the
  lower index); one ``tiny``-preset encode (2e-5) and beam-5 decode;
* an HF-named safetensors directory loads in both packages to the same
  network (logits 1e-5), and its ``tokenizer.json`` is picked up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.whisper import model as jw
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.whisper import model as tw
from test_torch_port_features import one_torch_thread  # noqa: F401 — fixture

N16 = tw.CHUNK_FRAMES * tw.HOP


def _wavs(n=2):
    t = np.arange(16000)
    out = [(0.1 * np.sin(t / f)).astype(np.float32) for f in (8, 11, 7)[:n]]
    out[-1] = out[-1] + 0.02 * np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    return out


def _pair(preset, seed=0):
    jm = jw.WhisperModel(jw.PRESETS[preset], seed=seed)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, tw.WhisperModel(tw.PRESETS[preset], params=tp, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _pair("test")


def _mels(wavs):
    batch = np.stack([np.pad(w, (0, N16 - w.size)) for w in wavs])
    return np.asarray(jax.vmap(jw.log_mel_spectrogram)(jnp.asarray(batch)))[:, :tw.CHUNK_FRAMES]


def test_bridge_converts_the_conv_stem(models):
    jm, tm = models
    w = np.asarray(jm.params["conv1"]["w"])  # (3, n_mels, d)
    assert tm.params["conv1"]["w"].shape == (64, 80, 3)
    np.testing.assert_array_equal(tm.params["conv1"]["w"].numpy(), w.transpose(2, 1, 0))
    np.testing.assert_array_equal(tm.params["dec_blocks"][1]["cross"]["k"]["w"].numpy(),
                                  np.asarray(jm.params["dec_blocks"][1]["cross"]["k"]["w"]))


@pytest.mark.parametrize("n", [16000, 123457, N16])
def test_log_mel_spectrogram(n):
    w = np.resize(_wavs(3)[2], n)
    ref = np.asarray(jw.log_mel_spectrogram(jnp.asarray(w)))
    ours = tw.log_mel_spectrogram(torch.from_numpy(w)).numpy()
    assert ours.shape == ref.shape == (n // tw.HOP, 80)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
    batch = tw.log_mel_spectrogram(torch.from_numpy(np.stack([w, 0.5 * w]))).numpy()
    np.testing.assert_allclose(batch[0], ours, atol=1e-6)  # per-row max in a batch


def test_encode_and_decoder_logits(models):
    jm, tm = models
    mels = _mels(_wavs())
    ref = np.asarray(jw.encode(jm.params, jm.cfg, jnp.asarray(mels)))
    ours = tw.encode(tm.params, tm.cfg, torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=0)
    toks = np.array([[997, 998, 999, 995, 5, 6, 7, 996], [997, 998, 999, 995, 900, 1, 2, 3]])
    ref_l = np.asarray(jw.decoder_logits(jm.params, jm.cfg, jnp.asarray(ref), jnp.asarray(toks)))
    ours_l = tw.decoder_logits(tm.params, tm.cfg, torch.from_numpy(ref),
                               torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(ours_l, ref_l, atol=1e-5, rtol=0)


@pytest.mark.parametrize("beam,max_tokens", [(1, 16), (5, 16), (3, 7), (5, 1)])
def test_decoded_tokens_identical(models, beam, max_tokens):
    jm, tm = models
    wavs = _wavs(3)
    ref = jm.transcribe_tokens_batch(wavs, max_tokens=max_tokens, beam_size=beam)
    before = tw.fetches
    ours = tm.transcribe_tokens_batch(wavs, max_tokens=max_tokens, beam_size=beam)
    assert tw.fetches - before == 1
    np.testing.assert_array_equal(ours, ref)


def test_beam_ties_keep_the_lower_index():
    x = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0, -torch.inf]])
    vals, idx = tw._top_k_stable(x, 3)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))


def test_tiny_preset_encode_and_beam():
    jm, tm = _pair("tiny", seed=1)
    wav = _wavs(1)[0]
    mels = _mels([wav])
    ref = np.asarray(jw.encode(jm.params, jm.cfg, jnp.asarray(mels)))
    ours = tw.encode(tm.params, tm.cfg, torch.from_numpy(mels)).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(tm.transcribe_tokens_batch([wav], max_tokens=6, beam_size=5),
                                  jm.transcribe_tokens_batch([wav], max_tokens=6, beam_size=5))


def _hf_checkpoint(path, cfg, seed=0):
    """A synthetic HF-named Whisper checkpoint (random values, HF layouts)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(seed)
    d = cfg.d_model
    t = {}

    def put(name, *shape, scale=0.05):
        t["model." + name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    put("encoder.conv1.weight", d, cfg.n_mels, 3)
    put("encoder.conv1.bias", d)
    put("encoder.conv2.weight", d, d, 3)
    put("encoder.conv2.bias", d)
    put("encoder.embed_positions.weight", tw.CHUNK_FRAMES // 2, d)
    put("decoder.embed_tokens.weight", cfg.vocab, d)
    put("decoder.embed_positions.weight", cfg.max_target_positions, d)

    def block(p, cross):
        names = ["self_attn"] + (["encoder_attn"] if cross else [])
        for a in names:
            for proj in ("q_proj", "v_proj", "out_proj"):
                put(f"{p}.{a}.{proj}.weight", d, d)
                put(f"{p}.{a}.{proj}.bias", d)
            put(f"{p}.{a}.k_proj.weight", d, d)
        for ln in ["self_attn_layer_norm", "final_layer_norm"] + (
                ["encoder_attn_layer_norm"] if cross else []):
            t[f"model.{p}.{ln}.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
            put(f"{p}.{ln}.bias", d)
        put(f"{p}.fc1.weight", 4 * d, d)
        put(f"{p}.fc1.bias", 4 * d)
        put(f"{p}.fc2.weight", d, 4 * d)
        put(f"{p}.fc2.bias", d)

    for i in range(cfg.encoder_layers):
        block(f"encoder.layers.{i}", False)
    for i in range(cfg.decoder_layers):
        block(f"decoder.layers.{i}", True)
    for p in ("encoder.layer_norm", "decoder.layer_norm"):
        t[f"model.{p}.weight"] = np.ones(d, np.float32)
        put(f"{p}.bias", d)
    save_file(t, str(path / "model.safetensors"))


def test_hf_checkpoint_loads_in_both(tmp_path):
    ckpt = tmp_path / "whisper-test"
    ckpt.mkdir()
    _hf_checkpoint(ckpt, tw.PRESETS["test"])
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel

    Tokenizer(WordLevel({"a": 0, "[UNK]": 1}, unk_token="[UNK]")).save(str(ckpt / "tokenizer.json"))
    ref = jw.WhisperTranscriber.from_pretrained(str(ckpt))
    ours = tw.WhisperTranscriber.from_pretrained(str(ckpt), device="cpu")
    assert ours.has_real_weights and ref.has_real_weights and ours.has_real_tokenizer
    assert ours.model.cfg == tw.PRESETS["test"]
    mels = _mels(_wavs(1))
    enc = np.asarray(jw.encode(ref.model.params, ref.model.cfg, jnp.asarray(mels)))
    np.testing.assert_allclose(
        tw.encode(ours.model.params, ours.model.cfg, torch.from_numpy(mels)).numpy(), enc,
        atol=2e-5)
    toks = np.array([[997, 998, 999, 995, 3]])
    np.testing.assert_allclose(
        tw.decoder_logits(ours.model.params, ours.model.cfg, torch.from_numpy(enc),
                          torch.from_numpy(toks)).numpy(),
        np.asarray(jw.decoder_logits(ref.model.params, ref.model.cfg, jnp.asarray(enc),
                                     jnp.asarray(toks))), atol=1e-5)


def test_transcriber_without_checkpoint_and_resampling(models, monkeypatch):
    assert tw.WhisperTranscriber.from_pretrained("whisper-test", device="cpu").has_real_weights \
        is False
    jm, tm = models
    ref, ours = jw.WhisperTranscriber(jm), tw.WhisperTranscriber(tm)
    monkeypatch.setenv("RHO_TTS_TPU_STT_BEAM", "1")
    wav24 = np.resize(_wavs(1)[0], 24000)
    assert ours.transcribe_batch([wav24, _wavs(1)[0]], [24000, 16000]) == \
        ref.transcribe_batch([wav24, _wavs(1)[0]], [24000, 16000])
    text = ours.transcribe(torch.from_numpy(wav24), 24000)
    assert text and all(c.isalpha() or c == " " for c in text)
