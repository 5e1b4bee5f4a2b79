"""Port parity of STT validation: ``rho_tts_tpu_torch.validation.stt`` against
``rho_tts_tpu.validation.stt`` on the CPU.

* The number normalizer is a copy: every string literal of
  ``tests/test_number_normalizer.py`` and ``tests/test_text_similarity.py``
  normalizes identically in both packages, and every pair of neighbouring
  literals has the same Levenshtein distance, fuzzy match and similarity.
* The gate's lazy transcriber follows the JAX env knobs:
  ``RHO_TTS_TPU_WHISPER_MODEL`` (a preset name or an HF directory),
  ``RHO_TTS_TPU_STT_ALLOW_RANDOM`` and ``RHO_TTS_TPU_STT_BEAM``. With random
  ``test`` weights under ``RHO_TTS_TPU_STT_ALLOW_RANDOM=1`` both packages
  transcribe the same text (the port's weights carried over from the JAX
  transcriber through ``from_jax``), and without it both pass unchecked.
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from rho_tts_tpu.validation.stt import number_normalizer as jnn
from rho_tts_tpu.validation.stt import stt_validator as jsv
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.whisper import model as tw
from rho_tts_tpu_torch.validation.stt import number_normalizer as tnn
from rho_tts_tpu_torch.validation.stt import stt_validator as tsv
from test_torch_port_features import one_torch_thread  # noqa: F401 — fixture


def _literals(*names):
    out = []
    for name in names:
        path = os.path.join(os.path.dirname(__file__), name)
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and node.value.strip() and not node.value.startswith(("rho_tts", "test_")):
                out.append(node.value)
    return sorted(set(out))


CASES = _literals("test_number_normalizer.py", "test_text_similarity.py")


def test_cases_were_found():
    assert len(CASES) > 60 and "twenty-two" in CASES


@pytest.mark.parametrize("text", CASES)
def test_normalizers_match(text):
    assert tnn.normalize_numbers_to_digits(text) == jnn.normalize_numbers_to_digits(text)
    assert tsv._normalize_text(text) == jsv._normalize_text(text)


@pytest.mark.parametrize("a,b", list(zip(CASES, CASES[1:])))
def test_similarity_matches(a, b):
    assert tnn.normalize_numbers_for_comparison(a, b) == \
        jnn.normalize_numbers_for_comparison(a, b)
    assert tsv._levenshtein_distance(a, b) == jsv._levenshtein_distance(a, b)
    for wa, wb in zip(a.lower().split(), b.lower().split()):
        assert tsv._fuzzy_word_match(wa, wb) == jsv._fuzzy_word_match(wa, wb)
    assert tsv.calculate_text_similarity(a, b) == jsv.calculate_text_similarity(a, b)


@pytest.fixture
def fresh_gates(monkeypatch):
    for sv in (jsv, tsv):
        monkeypatch.setattr(sv, "_whisper_failed", False)
    monkeypatch.setattr(jsv, "_whisper", None)
    monkeypatch.setattr(tsv, "_whisper", {})
    monkeypatch.setenv("RHO_TTS_TPU_WHISPER_MODEL", "whisper-test")
    monkeypatch.setenv("RHO_TTS_TPU_STT_BEAM", "5")
    yield


def _bridge_weights():
    """The port's transcriber on the JAX transcriber's random weights."""
    jsv._get_transcriber()
    params = from_jax.params_from_numpy(jax.tree.map(np.asarray, jsv._whisper.model.params),
                                        device="cpu")
    tsv._get_transcriber("cpu").model.params = params


def test_gate_with_allow_random(fresh_gates, monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_STT_ALLOW_RANDOM", "1")
    _bridge_weights()
    failed = tsv.failed_transcriptions
    wav = (0.1 * np.sin(np.arange(24000) / 8)).astype(np.float32)
    ref = jsv.validate_audio_text_match((wav, 24000), "hello world", threshold=0.0)
    before = tw.fetches
    ours = tsv.validate_audio_text_match((torch.from_numpy(wav), 24000), "hello world",
                                         threshold=0.0)
    assert tw.fetches - before == 1
    assert ours[2] is not None and ours == ref and ours[0]
    texts = ["hello world", "a second line of text"]
    wavs = [wav, 0.5 * wav[:16000]]
    ref_b = jsv.validate_audio_text_match_batch([(w, 24000) for w in wavs], texts, 0.0)
    ours_b = tsv.validate_audio_text_match_batch([(torch.from_numpy(w), 24000) for w in wavs],
                                                 texts, 0.0)
    assert ours_b == ref_b and all(t is not None for _, _, t in ours_b)
    assert tsv.transcribe_audio((torch.from_numpy(wav), 24000)) == jsv.transcribe_audio(
        (wav, 24000))
    assert tsv.failed_transcriptions == failed


def test_gate_without_allow_random_passes(fresh_gates, monkeypatch, tmp_path):
    monkeypatch.delenv("RHO_TTS_TPU_STT_ALLOW_RANDOM", raising=False)
    wav = (0.1 * np.sin(np.arange(16000) / 8)).astype(np.float32)
    for sv, kw in ((jsv, {}), (tsv, {"device": "cpu"})):
        ok, sim, text = sv.validate_audio_text_match((wav, 16000), "hello world", **kw)
        assert text is None and ok and sim == 0.0  # failure => pass (parity)
        assert sv.validate_audio_text_match_batch([(wav, 16000)], ["x"], **kw) == \
            [(True, 0.0, None)]
        assert sv._whisper_failed
    assert tsv.transcribe_audio(str(tmp_path / "missing.wav")) is None


def test_failed_transcription_passes_and_is_counted(fresh_gates, monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_STT_ALLOW_RANDOM", "1")
    tr = tsv._get_transcriber("cpu")

    def broken(*args, **kwargs):
        raise RuntimeError("no device")

    monkeypatch.setattr(tr, "transcribe_batch", broken)
    before = tsv.failed_transcriptions
    out = tsv.validate_audio_text_match_batch([(np.zeros(1600, np.float32), 16000)], ["x"],
                                              device="cpu")
    assert out == [(True, 0.0, None)] and tsv.failed_transcriptions == before + 1
