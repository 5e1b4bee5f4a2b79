"""Port parity of the drift classifier: ``forest_torch``, the model cache and
lookup order, and ``train``, against ``rho_tts_tpu.validation.classifier``.

* Forest probabilities against sklearn and ``forest_jax``: plain 1e-6, and
  calibrated 1e-6 against JAX (the same tables, the same interpolation) and
  the JAX test's 2e-3 against sklearn.
* :func:`forest_torch.interp` against ``jnp.interp`` on tables with the
  edges sklearn's isotonic fit produces (repeated x thresholds, equal
  neighbours, points beyond both ends): 1e-7, and no NaN.
* The scenarios of ``tests/test_drift_api.py`` (cache keys, the per-voice
  store, ``RHO_TTS_TPU_CLASSIFIER_MODEL``, a bare pickle's default
  threshold) and of ``tests/test_classifier.py`` (train on a synthetic
  good/bad set, predict from memory and from a file) in both packages, with
  the same probabilities (1e-6: the same pickle, features within 1e-4).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.calibration import CalibratedClassifierCV
from sklearn.ensemble import RandomForestClassifier

from rho_tts_tpu.audio_io import save_wav
from rho_tts_tpu.validation import classifier as jclf
from rho_tts_tpu.validation.classifier import forest_jax
from rho_tts_tpu_torch.validation import classifier as tclf
from rho_tts_tpu_torch.validation.classifier import forest_torch, trainer
from test_torch_port_features import one_torch_thread  # noqa: F401 — fixture

SR = 16000


@pytest.fixture(autouse=True)
def fresh_cache():
    jclf.clear_cache()
    tclf.clear_cache()
    yield
    jclf.clear_cache()
    tclf.clear_cache()


def make_dataset(n=300, f=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2]) > 0).astype(int)
    return x, y


@pytest.mark.parametrize("calibrated", [False, True])
def test_forest_matches_sklearn_and_jax(calibrated):
    x, y = make_dataset(n=400)
    base = RandomForestClassifier(n_estimators=15 if calibrated else 25,
                                  max_depth=5 if calibrated else 6, random_state=0)
    model = CalibratedClassifierCV(base, method="isotonic", cv=3) if calibrated else base
    model.fit(x, y)
    xt, _ = make_dataset(n=50, seed=2)
    ours = forest_torch.predict_proba(forest_torch.convert_forest(model), xt).numpy()
    np.testing.assert_allclose(
        ours, forest_jax.predict_proba(forest_jax.convert_forest(model), xt), atol=1e-6)
    np.testing.assert_allclose(ours, model.predict_proba(xt)[:, 1],
                               atol=2e-3 if calibrated else 1e-6)
    single = forest_torch.predict_proba(forest_torch.convert_forest(model), xt[3]).numpy()
    np.testing.assert_allclose(single, ours[3:4], atol=1e-7)


def test_unsupported_model_returns_none():
    from sklearn.linear_model import LogisticRegression

    x, y = make_dataset(n=50)
    assert forest_torch.convert_forest(LogisticRegression().fit(x, y)) is None


INTERP_TABLES = [
    # sklearn-like isotonic tables: repeated x thresholds and flat runs
    ([0.1, 0.1, 0.3, 0.3, 0.3, 0.7, 0.9, 0.9], [0.0, 0.2, 0.2, 0.5, 0.6, 0.6, 0.8, 1.0]),
    ([0.0, 0.25, 0.25, 1.0], [0.0, 0.1, 0.9, 1.0]),
    ([0.5, 0.5], [0.2, 0.7]),  # every x equal
    ([0.4], [0.6]),  # one point: a fold whose isotonic fit has one threshold
    ([0.2, 0.4, 0.6], [0.3, 0.3, 0.9]),
]


@pytest.mark.parametrize("xp,fp", INTERP_TABLES)
def test_interp_matches_jnp(xp, fp):
    xp, fp = np.asarray(xp, np.float32), np.asarray(fp, np.float32)
    q = np.concatenate([xp, np.nextafter(xp, np.float32(2)), np.nextafter(xp, np.float32(-1)),
                        np.linspace(-0.5, 1.5, 41, dtype=np.float32)]).astype(np.float32)
    ref = np.asarray(jnp.interp(q, xp, fp))
    ours = forest_torch.interp(torch.from_numpy(q)[None], torch.from_numpy(xp)[None],
                               torch.from_numpy(fp)[None]).numpy()[0]
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-7, rtol=0)
    # between distinct thresholds (and beyond the ends) it is np.interp
    inner = np.isin(q, xp, invert=True)
    np.testing.assert_allclose(ours[inner], np.interp(q[inner], xp, fp), atol=1e-6)


def make_model_file(path, threshold=0.33, seed=0):
    import joblib

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((30, 286))
    y = (x[:, 0] > 0).astype(int)
    rf = RandomForestClassifier(n_estimators=3, max_depth=3, random_state=seed).fit(x, y)
    joblib.dump({"model": rf, "optimal_threshold": threshold}, path)
    return str(path)


def test_explicit_path_and_voice_id_use_distinct_cache_keys(tmp_path, monkeypatch):
    p1 = make_model_file(tmp_path / "a.pkl", threshold=0.11)
    p2 = make_model_file(tmp_path / "b.pkl", threshold=0.22)
    for clf in (jclf, tclf):
        monkeypatch.setattr(clf, "get_model_path", lambda vid: p2)
        clf._load_model(model_path=p1)
        clf._load_model(voice_id="voiceX")
        assert p1 in clf._models and "voiceX" in clf._models
        assert clf._thresholds[p1] == pytest.approx(0.11)
        assert clf._thresholds["voiceX"] == pytest.approx(0.22)
        assert set(clf._forest_arrays) == {p1, "voiceX"}


def test_missing_per_voice_model_is_silent():
    for clf in (jclf, tclf):
        assert clf.predict_accent_drift_probability(
            np.zeros(SR, np.float32), sample_rate=SR, voice_id="missing-voice") is None
        assert clf.predict_accent_drift_probability_batch(
            [np.zeros(SR, np.float32)], SR, voice_id="missing-voice") == [None]
        assert clf.get_optimal_threshold("missing-voice") == pytest.approx(0.18)


def test_env_var_model_lookup(tmp_path, monkeypatch):
    p = make_model_file(tmp_path / "envmodel.pkl", threshold=0.44)
    monkeypatch.setenv(tclf.ENV_MODEL_VAR, p)
    assert jclf.get_optimal_threshold() == tclf.get_optimal_threshold() == pytest.approx(0.44)


def test_raw_model_pickle_uses_default_threshold(tmp_path):
    import joblib

    x, y = make_dataset(n=30, f=286, seed=1)
    p = str(tmp_path / "raw.pkl")
    joblib.dump(RandomForestClassifier(n_estimators=3, max_depth=3).fit(x, y), p)
    tclf._load_model(model_path=p)
    assert tclf._thresholds[p] == pytest.approx(0.18)


def make_clip(kind: str, seed: int) -> np.ndarray:
    """'good' = low-pitch harmonic voice; 'bad' = high-pitch noisy voice."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * 0.8)) / SR
    if kind == "good":
        f0 = 130 + rng.uniform(-10, 10)
        sig = sum((0.5 / (k + 1)) * np.sin(2 * np.pi * f0 * (k + 1) * t) for k in range(4))
        sig += 0.01 * rng.standard_normal(t.size)
    else:
        f0 = 420 + rng.uniform(-30, 30)
        sig = np.sin(2 * np.pi * f0 * t) + 0.3 * rng.standard_normal(t.size)
    return (0.5 * sig / np.abs(sig).max()).astype(np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("drift_ds")
    for kind in ("good", "bad"):
        (root / kind).mkdir()
        for i in range(8):
            save_wav(str(root / kind / f"{kind}_{i}.wav"), make_clip(kind, i), SR)
    return str(root)


def test_train_and_predict_match_jax(dataset, tmp_path):
    import joblib

    messages = []
    path = trainer.train(dataset, output_path=str(tmp_path / "clf.pkl"),
                         progress_callback=messages.append, device="cpu")
    assert os.path.exists(path) and any("saved" in m for m in messages)
    data = joblib.load(path)
    assert 0.0 < data["optimal_threshold"] < 1.0 and "brier_score" in data
    wav_path = str(tmp_path / "t.wav")
    save_wav(wav_path, make_clip("good", 123), SR)
    for clip in (make_clip("good", 99), make_clip("bad", 99)):
        ours = tclf.predict_accent_drift_probability(clip, sample_rate=SR, model_path=path,
                                                     device="cpu")
        ref = jclf.predict_accent_drift_probability(clip, sample_rate=SR, model_path=path)
        assert ours == pytest.approx(ref, abs=1e-6) and 0.0 <= ours <= 1.0
    ours = tclf.predict_accent_drift_probability(wav_path, model_path=path, device="cpu")
    assert ours == pytest.approx(jclf.predict_accent_drift_probability(wav_path, model_path=path),
                                 abs=1e-6)
    clips = [make_clip("good", 5), make_clip("bad", 6)]
    ours = tclf.predict_accent_drift_probability_batch(clips, SR, model_path=path, device="cpu")
    ref = jclf.predict_accent_drift_probability_batch(clips, SR, model_path=path)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_train_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        trainer.train(str(tmp_path / "nope"), device="cpu")
    root = tmp_path / "small"
    for kind in ("good", "bad"):
        (root / kind).mkdir(parents=True)
        save_wav(str(root / kind / "a.wav"), make_clip(kind, 0), SR)
    with pytest.raises(ValueError, match="Not enough samples"):
        trainer.train(str(root), device="cpu")
