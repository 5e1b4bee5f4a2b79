"""Port parity of the validation loop wired into ``generate()``.

Both engines run with every validator live: the drift classifier found by
the JAX package's implicit lookup (a per-voice pickle under
``$HOME/.rho_tts_tpu/models/``, or ``RHO_TTS_TPU_CLASSIFIER_MODEL``), and
Whisper STT on random ``test`` weights under
``RHO_TTS_TPU_STT_ALLOW_RANDOM=1`` (the port's transcriber takes the JAX
transcriber's weights through ``from_jax``).

* The engine scenarios use the fake sine provider of
  ``test_torch_port_engine.py`` (its tone's pitch follows the text, and the
  pickled forest scores by pitch): one text passes the drift gate, one
  fails and is retried, best-by-drift; with a strict STT gate every
  segment is retried. The port makes the same calls, reports the same
  drift probability and text similarity, and its audio matches within
  3e-5; sequential and batched pipelines both.
* A ``tiny`` Qwen voice clone through both ``QwenTTS`` providers on the
  same fp32 weights (``test_torch_port_slice.py``'s), every segment failing
  a drift gate at 0.0: the same codes in every model call, the same
  lower-drift attempt kept, audio within 1e-4 (the fp32 network and
  vocoder, as ``test_torch_port_provider.py`` holds them).
* The reference embedding computed at a voice-clone load, and speaker
  similarity, match the JAX package's (1e-5; the encoder's default init is
  bit-equal).
"""

import time

import jax
import numpy as np
import pytest
import torch

import rho_tts_tpu_torch
from rho_tts_tpu.audio_io import save_wav
from rho_tts_tpu.validation import classifier as jclf
from rho_tts_tpu.validation.stt import stt_validator as jsv
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.whisper import model as tw
from rho_tts_tpu_torch.validation import classifier as tclf
from rho_tts_tpu_torch.validation.classifier import trainer as ttrainer
from rho_tts_tpu_torch.validation.stt import stt_validator as tsv
from test_torch_port_engine import PACKAGES, _fake_class, _observe
from test_torch_port_features import one_torch_thread  # noqa: F401 — fixture
from test_torch_port_slice import fp32_params, jax_prefill_kernel  # noqa: F401 — fixtures

VOICE = "port-voice"
# The fake provider's tone is 180 + 7 * (len(text) % 40) Hz: 257 Hz and 355 Hz.
TEXTS = ["Short text.", "A much longer text of thirty."]


def _forest_pickle(path):
    """An isotonic-calibrated forest over the 286-d features that scores by
    F0 mean (feature 282): P(bad) is high above ~300 Hz."""
    import joblib
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.ensemble import RandomForestClassifier

    rng = np.random.default_rng(0)
    x = np.zeros((240, 286))  # the other features never split a tree
    x[:, 282] = rng.uniform(100, 500, 240)
    y = ((x[:, 282] > 300) ^ (rng.uniform(size=240) < 0.1)).astype(int)
    model = CalibratedClassifierCV(
        RandomForestClassifier(n_estimators=12, max_depth=4, random_state=0),
        method="isotonic", cv=3).fit(x, y)
    joblib.dump({"model": model, "optimal_threshold": 0.3}, path)
    return str(path)


@pytest.fixture
def drift_model(request, tmp_path, monkeypatch):
    """The drift model by the JAX lookup: the per-voice store under HOME
    (``"home"``, the default), or ``RHO_TTS_TPU_CLASSIFIER_MODEL`` with no
    voice id (``"env"``)."""
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv(tclf.ENV_MODEL_VAR, raising=False)
    if getattr(request, "param", "home") == "home":
        store = home / ".rho_tts_tpu" / "models"
        store.mkdir(parents=True)
        _forest_pickle(store / f"{VOICE}_classifier.pkl")
        voice = VOICE
    else:
        monkeypatch.setenv(tclf.ENV_MODEL_VAR, _forest_pickle(tmp_path / "env.pkl"))
        voice = None
    for clf in (jclf, tclf):
        clf.clear_cache()
    yield voice
    for clf in (jclf, tclf):
        clf.clear_cache()


@pytest.fixture
def live_stt(monkeypatch):
    """Whisper ``test`` on random weights in both packages, the same weights."""
    monkeypatch.setenv("RHO_TTS_TPU_STT_ALLOW_RANDOM", "1")
    monkeypatch.setenv("RHO_TTS_TPU_WHISPER_MODEL", "whisper-test")
    monkeypatch.setenv("RHO_TTS_TPU_STT_BEAM", "5")
    for sv in (jsv, tsv):
        monkeypatch.setattr(sv, "_whisper_failed", False)
    monkeypatch.setattr(jsv, "_whisper", None)
    monkeypatch.setattr(tsv, "_whisper", {})
    jax_tr = jsv._get_transcriber()
    params = from_jax.params_from_numpy(jax.tree.map(np.asarray, jax_tr.model.params),
                                        device="cpu")
    tsv._whisper["cpu"] = tw.WhisperTranscriber(
        tw.WhisperModel(tw.PRESETS["test"], params=params, device="cpu"))
    yield


@pytest.fixture
def pinned_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5678)


def _run(which, batch, voice, stt_threshold):
    tts = _fake_class(PACKAGES[which], batch)()
    tts.voice_cloning = True
    tts.voice_id = voice
    tts.max_iterations = 2
    tts.accent_drift_threshold = 0.5
    tts.text_similarity_threshold = stt_threshold
    return tts, tts.generate(TEXTS)


@pytest.mark.parametrize("drift_model", ["home", "env"], indirect=True)
@pytest.mark.parametrize("batch", [False, True], ids=["sequential", "batched"])
@pytest.mark.parametrize("stt_threshold", [0.0, 1.01], ids=["stt-pass", "stt-fail"])
def test_engine_gates_like_jax(drift_model, live_stt, pinned_clock, monkeypatch, batch,
                               stt_threshold):
    name = "predict_accent_drift_probability" + ("_batch" if batch else "")
    drift_calls = {"jax": [], "port": []}
    for which, clf in (("jax", jclf), ("port", tclf)):
        def recording(*args, _inner=getattr(clf, name), _sink=drift_calls[which], **kwargs):
            out = _inner(*args, **kwargs)
            _sink.append(out)
            return out

        monkeypatch.setattr(clf, name, recording)
    fallbacks, failed = ttrainer.serial_fallbacks, tsv.failed_transcriptions
    ref_tts, ref_out = _run("jax", batch, drift_model, stt_threshold)
    tts, out = _run("port", batch, drift_model, stt_threshold)
    assert ttrainer.serial_fallbacks == fallbacks and tsv.failed_transcriptions == failed
    flat = lambda calls: [p for c in calls for p in (c if isinstance(c, list) else [c])]  # noqa
    probs, ref_probs = flat(drift_calls["port"]), flat(drift_calls["jax"])
    assert None not in probs and len(probs) == len(ref_probs) >= 2
    np.testing.assert_allclose(probs, ref_probs, atol=1e-6)
    assert min(probs) < 0.5 < max(probs)  # one text passes the drift gate, one fails
    ref, ours = _observe(ref_tts, ref_out), _observe(tts, out)
    assert ours["calls"] == ref["calls"] and len(ours["calls"]) > (1 if batch else 2)
    for o, r in zip(ours["results"], ref["results"]):
        assert o["drift_prob"] == pytest.approx(r["drift_prob"], abs=1e-6)
        assert o["text_similarity"] == r["text_similarity"]
        assert o["audio"].shape == r["audio"].shape
        np.testing.assert_allclose(o["audio"], r["audio"], atol=3e-5, rtol=0)


def test_unported_validation_is_gone():
    src = open(rho_tts_tpu_torch.engine.__file__).read()
    assert "item 8" not in src and "_warn_unported" not in src


@pytest.fixture(scope="module")
def qwen_models(fp32_params):  # noqa: F811
    from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
    from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
    from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel

    jm = JModel(JPRESETS["tiny"], params=fp32_params)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, TModel(TPRESETS["tiny"], params=tp, device="cpu")


def _reference_wav(tmp_path):
    sr = 24000
    t = np.arange(int(0.6 * sr)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 190 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
           + 0.01 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)
    path = str(tmp_path / "ref.wav")
    save_wav(path, wav, sr)
    return path


def test_qwen_clone_generate_matches_jax(qwen_models, jax_prefill_kernel,  # noqa: F811
                                         drift_model, live_stt, pinned_clock, tmp_path):
    from rho_tts_tpu.providers.qwen import QwenTTS as JQwenTTS
    from rho_tts_tpu_torch.providers.qwen import QwenTTS as TQwenTTS

    jm, tm = qwen_models
    ref_path = _reference_wav(tmp_path)
    kw = dict(device="cpu", seed=1234, model_path="tiny", reference_audio=ref_path,
              reference_text="a reference line", max_chars_per_segment=200, max_iterations=2,
              min_audio_sec=1.0, accent_drift_threshold=0.0, text_similarity_threshold=0.0)
    codes = {"jax": [], "port": []}
    out = {}
    for which, cls, model in (("jax", JQwenTTS, jm), ("port", TQwenTTS, tm)):
        tts = cls(**kw)
        tts.voice_id = drift_model
        tts._model = model
        inner = model._generate_codes_arrays

        def capture(*args, _inner=inner, _sink=codes[which], **kwargs):
            res = _inner(*args, **kwargs)
            _sink.append(np.asarray(res[0]).astype(np.int64))
            return res

        model._generate_codes_arrays = capture
        try:
            out[which] = tts.generate(["a cloned line of speech"])[0]
        finally:
            del model._generate_codes_arrays
    assert len(codes["port"]) == len(codes["jax"]) == 2  # every segment retried once
    for o, r in zip(codes["port"], codes["jax"]):
        np.testing.assert_array_equal(o, r)
    ours, ref = out["port"], out["jax"]
    assert ours.drift_prob == pytest.approx(float(ref.drift_prob), abs=1e-6)
    assert ours.text_similarity == ref.text_similarity
    assert ours.audio.shape == tuple(ref.audio.shape)
    np.testing.assert_allclose(ours.audio.numpy(), np.asarray(ref.audio), atol=1e-4, rtol=0)


def test_reference_embedding_and_similarity(tmp_path):
    from rho_tts_tpu.providers.qwen import QwenTTS as JQwenTTS
    from rho_tts_tpu_torch.providers.qwen import QwenTTS as TQwenTTS

    ref_path = _reference_wav(tmp_path)
    kw = dict(model_path="tiny", reference_audio=ref_path, reference_text="a line")
    ref = JQwenTTS(**kw)
    ref._initialize_reference_embedding()
    ours = TQwenTTS(device="cpu", **kw)
    ours._load_model()  # a voice-clone load computes the embedding
    assert ours.reference_embedding.shape == (256,)
    np.testing.assert_allclose(ours.reference_embedding, ref.reference_embedding, atol=1e-5)
    probe = (0.2 * np.sin(np.arange(12000) / 9)).astype(np.float32)
    assert ours._compute_speaker_similarity(torch.from_numpy(probe)) == pytest.approx(
        ref._compute_speaker_similarity(probe), abs=1e-5)
