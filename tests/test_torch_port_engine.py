"""Port parity of the engine: ``rho_tts_tpu_torch.engine.BaseTTS`` vs the JAX package's.

The scenarios of ``tests/test_pipeline.py`` (and the batched pipeline the
Qwen provider takes) run through both engines with the same fake provider,
a numpy sine whose amplitude comes from the engine's key chain
(``next_rng``): the threefry keys of both packages are the same bits, so
the same audio comes back. Retries reseed from ``time.time``, which is
pinned here. In each case the port makes the same ``_generate_audio``
calls, in the same order, picks the same segments (the same metadata) and
its final audio matches the JAX engine's within 3e-5; the WAV files are
byte-identical. After a pitch shift the tolerance is 5e-4 (the JAX oracle
test's is 5e-3): the fake provider's pure tone leaves most STFT bins near
zero, whose angles come from rounding, so the phase vocoder is
ill-conditioned on it. Both packages lie about 3e-4 from the f64 value of
the same algorithm there (``test_pitch_tolerance_is_the_inputs_conditioning``).
"""

import asyncio
import time
from types import SimpleNamespace
from unittest.mock import patch

import numpy as np
import pytest
import torch

import rho_tts_tpu
import rho_tts_tpu_torch
import rho_tts_tpu_torch.audio_io
from rho_tts_tpu.ops import pitch as jpitch
from rho_tts_tpu_torch.ops import dsp as tdsp
from rho_tts_tpu_torch.ops import pitch as tpitch
from test_torch_port_dsp import pitch_shift_f64

torch.set_num_threads(1)  # several test workers share the cores

SR = 8000

PACKAGES = {"jax": SimpleNamespace(pkg=rho_tts_tpu), "port": SimpleNamespace(pkg=rho_tts_tpu_torch)}


def _sine(text: str, key, row: int) -> np.ndarray:
    """0.5 s of a text-dependent tone, its level from the key, with silent edges."""
    key = np.asarray(key).astype(np.int64)
    amp = 0.15 + 0.3 * ((int(key[0]) + int(key[1]) + row) % 997) / 997.0
    t = np.arange(int(0.5 * SR)) / SR
    tone = amp * np.sin(2 * np.pi * (180.0 + 7.0 * (len(text) % 40)) * t)
    return np.concatenate([np.zeros(300), tone, np.zeros(400)]).astype(np.float32)


def _fake_class(ns, batch: bool):
    class FakeTTS(ns.pkg.BaseTTS):
        supports_batch_generation = batch

        def __init__(self, **kwargs):
            super().__init__(device="cpu", **kwargs)
            self.max_chars_per_segment = 100
            self._max_chars_explicit = True
            self.calls = []

        def _generate_audio(self, text, **kwargs):
            self.calls.append(text)
            key = self.next_rng()
            if isinstance(text, list):
                return [_sine(t, key, i) for i, t in enumerate(text)]
            return _sine(text, key, 0)

        @property
        def sample_rate(self):
            return SR

    return FakeTTS


def _audio(a):
    if a is None:
        return None
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _observe(tts, out):
    items = out if isinstance(out, list) else [out]
    results = []
    for r in items:
        if r is None:
            results.append(None)
            continue
        results.append(dict(
            audio=_audio(r.audio), sample_rate=r.sample_rate, duration_sec=r.duration_sec,
            segments_count=r.segments_count, drift_prob=r.drift_prob,
            text_similarity=r.text_similarity, decay_ratio=r.decay_ratio,
            wav=None if r.path is None else open(r.path, "rb").read(),
        ))
    return {"calls": list(tts.calls), "list": isinstance(out, list), "results": results}


# -- Scenarios: (ns, make, tmp) -> (tts, generate() output) ------------------


def single_in_memory(ns, make, tmp):
    tts = make()
    return tts, tts.generate("Hello world")


def saves_wav(ns, make, tmp):
    tts = make()
    return tts, tts.generate("Hello world", str(tmp / "out.wav"))


def list_mode(ns, make, tmp):
    tts = make()
    return tts, tts.generate(["One thing", "Another thing"], str(tmp / "batch"))


def segmentation(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    return tts, tts.generate("First sentence. Second sentence. Third sentence")


def phonetic_mapping(ns, make, tmp):
    tts = make(phonetic_mapping={"exocrine": "exo-crene"})
    return tts, tts.generate("the exocrine gland")


def cancel_before(ns, make, tmp):
    tts = make()
    token = ns.pkg.CancellationToken()
    token.cancel()
    return tts, tts.generate("Hello", cancellation_token=token)


def cancel_during(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    token = ns.pkg.CancellationToken()
    inner = tts._generate_audio

    def cancelling(text, **kw):
        token.cancel()  # cancel after the first segment generates
        return inner(text, **kw)

    tts._generate_audio = cancelling
    return tts, tts.generate("One. Two. Three", cancellation_token=token)


def oom_retry(ns, make, tmp):
    tts = make()
    tts.max_iterations = 3
    inner = tts._generate_audio
    state = {"n": 0}

    def oom_once(text, **kw):
        state["n"] += 1
        if state["n"] == 1:
            tts.calls.append("OOM")
            raise RuntimeError("CUDA error: out of memory")
        return inner(text, **kw)

    tts._generate_audio = oom_once
    with patch.object(tts, "_validate_accent_drift", return_value=(0.0, True)), \
            patch.object(tts, "_validate_text_match", return_value=(True, 1.0, None)):
        return tts, tts.generate("Hello")


def generic_error_exhausts(ns, make, tmp):
    tts = make()
    tts.max_iterations = 2

    def always_fail(text, **kw):
        tts.calls.append(text)
        raise RuntimeError("resource exhausted: device oom")

    tts._generate_audio = always_fail
    return tts, tts.generate("Hello")


def validation_retry_until_pass(ns, make, tmp):
    tts = make()
    tts.max_iterations = 5
    tts.voice_cloning = True
    with patch.object(tts, "_validate_accent_drift",
                      side_effect=[(0.9, False), (0.8, False), (0.05, True)]), \
            patch.object(tts, "_validate_text_match", return_value=(True, 1.0, None)):
        return tts, tts.generate("Hello")


def validation_exhausted_best_by_drift(ns, make, tmp):
    tts = make()
    tts.max_iterations = 3
    with patch.object(tts, "_validate_accent_drift",
                      side_effect=[(0.9, False), (0.3, False), (0.8, False)]), \
            patch.object(tts, "_validate_text_match", return_value=(True, 1.0, None)):
        return tts, tts.generate("Hello")


def text_validation_retry(ns, make, tmp):
    tts = make()
    tts.max_iterations = 3
    with patch.object(tts, "_validate_accent_drift", return_value=(0.0, True)), \
            patch.object(tts, "_validate_text_match",
                         side_effect=[(False, 0.2, "wrong words"), (True, 0.95, "hello")]):
        return tts, tts.generate("Hello")


def decay_retry(ns, make, tmp):
    tts = make()
    tts.max_decay_retries = 3
    with patch.object(tts, "_validate_sound_decay",
                      side_effect=[(0.1, False), (0.1, False), (0.9, True)]):
        return tts, tts.generate("Hello")


def decay_persisted(ns, make, tmp):
    tts = make()
    tts.max_decay_retries = 2
    with patch.object(tts, "_validate_sound_decay", return_value=(0.05, False)):
        return tts, tts.generate("Hello")


def progress_callback(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    messages = []
    out = tts.generate("One. Two", progress_callback=messages.append)
    tts.calls.extend(messages)
    return tts, out


def metadata_worst_case(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    tts.max_iterations = 2
    with patch.object(tts, "_validate_accent_drift", side_effect=[(0.1, True), (0.4, True)]), \
            patch.object(tts, "_validate_text_match",
                         side_effect=[(True, 0.99, None), (True, 0.9, None)]):
        return tts, tts.generate("One. Two")


def speed(ns, make, tmp):
    tts = make()
    return tts, [tts.generate("Hello"), tts.generate("Hello", speed=2.0),
                 tts.generate("Hello", speed=1.5)]


def pitch(ns, make, tmp):
    tts = make()
    return tts, tts.generate("Hello there", pitch_semitones=2.0)


def context_manager(ns, make, tmp):
    closed = []
    tts = make()
    tts.close = lambda: closed.append(True)
    with tts as t:
        out = t.generate("Hello")
    tts.calls.append(f"closed {closed}")
    return tts, out


def async_generate(ns, make, tmp):
    tts = make()

    async def run():
        return await tts.async_generate("Hello world")

    return tts, asyncio.run(run())


def stream_per_segment(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    return tts, list(tts.stream("One. Two. Three"))


def stream_cancellation(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    token = ns.pkg.CancellationToken()
    gen = tts.stream("One. Two. Three", cancellation_token=token)
    first = next(gen)
    token.cancel()
    return tts, [first] + list(gen)


# Batched pipeline (supports_batch_generation, the Qwen provider's path)


def batched_list_mode(ns, make, tmp):
    tts = make()
    tts.force_sentence_split = True
    tts.batch_size = 3
    return tts, tts.generate(["One item. Two sentences.", "Second item", "Third. And more. End"],
                             str(tmp / "b"))


def batched_validation_retry(ns, make, tmp):
    tts = make()
    tts.max_iterations = 3
    tts.voice_cloning = True
    drifts = [(0.9, False), (0.1, True), (0.2, True), (0.05, True)]
    with patch.object(tts, "_validate_accent_drift", side_effect=drifts), \
            patch.object(tts, "_validate_text_match_batch",
                         side_effect=lambda a, sr, t: [(True, 1.0, None)] * len(a)):
        return tts, tts.generate(["Alpha", "Beta", "Gamma"])


def batched_decay_retry(ns, make, tmp):
    tts = make()
    tts.max_decay_retries = 3
    verdicts = iter([(0.1, False), (0.9, True), (0.2, False), (0.95, True)])
    with patch.object(tts, "_validate_sound_decay", side_effect=lambda a: next(verdicts)):
        return tts, tts.generate(["Alpha", "Beta"])


SCENARIOS = {f.__name__: (f, False) for f in (
    single_in_memory, saves_wav, list_mode, segmentation, phonetic_mapping, cancel_before,
    cancel_during, oom_retry, generic_error_exhausts, validation_retry_until_pass,
    validation_exhausted_best_by_drift, text_validation_retry, decay_retry, decay_persisted,
    progress_callback, metadata_worst_case, speed, pitch, context_manager, async_generate,
    stream_per_segment, stream_cancellation,
)}
SCENARIOS.update({f.__name__: (f, True) for f in (
    batched_list_mode, batched_validation_retry, batched_decay_retry,
)})


@pytest.fixture
def pinned_clock(monkeypatch):
    """Retries reseed from ``int(time.time() * 1000) % 100000``: pin it."""
    monkeypatch.setattr(time, "time", lambda: 1234.5678)


def _run(name, which, tmp_path):
    fn, batch = SCENARIOS[name]
    ns = PACKAGES[which]
    tmp = tmp_path / which
    tmp.mkdir()
    tts, out = fn(ns, _fake_class(ns, batch), tmp)
    return tts, out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_scenario_matches_jax(name, pinned_clock, tmp_path):
    ref_tts, ref_out = _run(name, "jax", tmp_path)
    tts, out = _run(name, "port", tmp_path)
    ref, ours = _observe(ref_tts, ref_out), _observe(tts, out)
    assert ours["calls"] == ref["calls"]  # same generate calls, same order
    assert ours["list"] == ref["list"] and len(ours["results"]) == len(ref["results"])
    atol = PITCH_ATOL if name == "pitch" else 3e-5
    for o, r in zip(ours["results"], ref["results"]):
        assert (o is None) == (r is None)
        if r is None:
            continue
        for k in ("sample_rate", "duration_sec", "segments_count", "drift_prob",
                  "text_similarity"):
            assert o[k] == r[k], k
        if r["decay_ratio"] is None:
            assert o["decay_ratio"] is None
        else:
            assert o["decay_ratio"] == pytest.approx(float(r["decay_ratio"]), abs=1e-4)
        assert o["audio"].shape == r["audio"].shape and o["audio"].dtype == np.float32
        np.testing.assert_allclose(o["audio"], r["audio"], atol=atol, rtol=0)
        assert o["wav"] == r["wav"]  # byte-identical files (or both in memory)
    _check_expectations(name, tts, out)


PITCH_ATOL = 5e-4


def test_pitch_tolerance_is_the_inputs_conditioning(pinned_clock):
    """The pitch scenario's input, shifted by each package, against the f64 value.

    Neither package can be held closer to the other than each lies to the
    exact value of their common algorithm on this input.
    """
    audio = _fake_class(PACKAGES["port"], False)().generate("Hello there").numpy()
    exact = pitch_shift_f64(audio, SR, 2.0)
    ours = tpitch.pitch_shift(audio, SR, 2.0).numpy().astype(np.float64)
    ref = np.asarray(jpitch.pitch_shift(audio, SR, 2.0), np.float64)
    np.testing.assert_allclose(ours, exact, atol=PITCH_ATOL, rtol=0)
    np.testing.assert_allclose(ref, exact, atol=PITCH_ATOL, rtol=0)


def _check_expectations(name, tts, out):
    """The port's own result, as ``tests/test_pipeline.py`` states it."""
    GR = rho_tts_tpu_torch.GenerationResult
    if name == "single_in_memory":
        assert isinstance(out, GR) and out.path is None and out.segments_count == 1
        assert isinstance(out.audio, torch.Tensor) and out.audio.device.type == "cpu"
        assert out.numpy().dtype == np.float32 and out.duration_sec == out.audio.shape[0] / SR
    elif name == "saves_wav":
        audio, sr = rho_tts_tpu_torch.audio_io.load_wav(out.path)
        assert sr == SR
        expect = rho_tts_tpu_torch.audio_io._to_int16(out.numpy()).astype(np.float32) / 32768.0
        np.testing.assert_array_equal(audio, expect)  # the WAV holds the int16 of result.audio
    elif name == "list_mode":
        assert [r.path.rsplit("/", 1)[-1] for r in out] == ["batch_0.wav", "batch_1.wav"]
    elif name == "segmentation":
        assert out.segments_count == 3 and len(tts.calls) == 3
    elif name == "phonetic_mapping":
        assert tts.calls == ["the exo-crene gland"]
    elif name in ("cancel_before", "generic_error_exhausts"):
        assert out is None
        assert len(tts.calls) == (0 if name == "cancel_before" else 2)
    elif name == "cancel_during":
        assert out is None and len(tts.calls) == 1
    elif name == "oom_retry":
        assert out is not None and tts.calls == ["OOM", "Hello"]
    elif name == "validation_retry_until_pass":
        assert len(tts.calls) == 3 and out.drift_prob == pytest.approx(0.05)
    elif name == "validation_exhausted_best_by_drift":
        assert out.drift_prob == pytest.approx(0.3)
    elif name == "text_validation_retry":
        assert len(tts.calls) == 2 and out.text_similarity == pytest.approx(0.95)
    elif name == "decay_retry":
        assert len(tts.calls) == 3 and out.decay_ratio == pytest.approx(0.9)
    elif name == "decay_persisted":
        assert len(tts.calls) == 2 and out.decay_ratio == pytest.approx(0.05)
    elif name == "progress_callback":
        assert any("segment 1/2" in m for m in tts.calls[2:])
    elif name == "metadata_worst_case":
        assert out.drift_prob == pytest.approx(0.4) and out.text_similarity == pytest.approx(0.9)
    elif name == "speed":
        assert out[1].duration_sec == pytest.approx(out[0].duration_sec / 2.0, rel=0.05)
    elif name == "context_manager":
        assert tts.calls[-1] == "closed [True]"
    elif name == "stream_per_segment":
        assert len(out) == 3 and all(r.segments_count == 1 for r in out)
    elif name == "stream_cancellation":
        assert len(out) == 1
    elif name == "batched_list_mode":
        assert [r.segments_count for r in out] == [2, 1, 3]
        assert tts.calls == [["One item.", "Two sentences.", "Second item"],
                             ["Third.", "And more.", "End"]]
    elif name == "batched_validation_retry":
        assert tts.calls == [["Alpha", "Beta", "Gamma"], ["Alpha"]]
    elif name == "batched_decay_retry":
        assert tts.calls == [["Alpha", "Beta"], ["Alpha"], ["Alpha"]]


def test_unsupported_format_raises():
    tts = _fake_class(PACKAGES["port"], False)()
    with pytest.raises(rho_tts_tpu_torch.FormatConversionError):
        tts.generate("Hello", format="aiff")
    assert tts.calls == []


def test_value_error_propagates():
    tts = _fake_class(PACKAGES["port"], False)()

    def bad(text, **kw):
        raise ValueError("reference_text is required")

    tts._generate_audio = bad
    with pytest.raises(ValueError):
        tts.generate("Hello")


def test_compressed_format_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setattr(rho_tts_tpu_torch.audio_io.shutil, "which", lambda name: None)
    tts = _fake_class(PACKAGES["port"], False)()
    with pytest.raises(rho_tts_tpu_torch.FormatConversionError):
        tts.generate("Hello", str(tmp_path / "out.mp3"), format="mp3")


def test_key_chain_and_fused_fetches():
    """next_rng chains jax.random.split's bits; a batch of items is
    finalized with one host fetch."""
    import jax

    port = _fake_class(PACKAGES["port"], True)(seed=4242)
    ref = _fake_class(PACKAGES["jax"], True)(seed=4242)
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(port.next_rng()),
                                      np.asarray(jax.random.key_data(ref.next_rng())
                                                 if hasattr(jax.random, "key_data")
                                                 else ref.next_rng()).astype(np.int64))
    items = [[_sine("a b", [1, 2], 0), _sine("c", [3, 4], 0)], [_sine("d", [5, 6], 0)]]
    before = tdsp.fetches
    finals = port._finalize_items(items)
    assert tdsp.fetches - before == 1 and len(finals) == 2


def test_unported_validation_backends_raise(tmp_path, monkeypatch):
    """Validation is ported: without a drift model or a Whisper checkpoint
    every gate passes, as in the JAX package (an explicit missing model
    path, a checkpoint-less Whisper directory), on the batched path and on
    the served path (``supports_serving_generation``) alike."""
    from rho_tts_tpu_torch.validation import classifier as tclf
    from rho_tts_tpu_torch.validation.stt import stt_validator as tsv

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv(tclf.ENV_MODEL_VAR, raising=False)
    monkeypatch.delenv("RHO_TTS_TPU_STT_ALLOW_RANDOM", raising=False)
    monkeypatch.setattr(tsv, "_whisper", {})
    monkeypatch.setattr(tsv, "_whisper_failed", False)
    tclf.clear_cache()
    tts = _fake_class(PACKAGES["port"], False)()
    tts.voice_cloning = True
    tts.voice_id = "no-such-voice"
    assert tts._validate_accent_drift(np.zeros(10, np.float32), SR) == (0.0, True)
    tts.drift_model_path = str(tmp_path / "drift.pkl")
    assert tts._validate_accent_drift_batch([np.zeros(10, np.float32)], SR) == [(0.0, True)]
    monkeypatch.setenv("RHO_TTS_TPU_WHISPER_MODEL", str(tmp_path))  # no safetensors there
    assert tts._validate_text_match(np.zeros(10, np.float32), SR, "x") == (True, 0.0, None)
    tts.max_iterations = 2
    out = tts.generate("Hello")
    assert out is not None and tts.calls == ["Hello"] and out.drift_prob == 0.0
    tts.supports_serving_generation = True
    submits = []

    def serving_submit(text):  # a serving request that resolved at once
        submits.append(text)
        return SimpleNamespace(wav=_sine(text, [7, 8], 0), error=None, cancelled=False,
                               add_done_callback=lambda fn: fn(None))

    tts._serving_submit = serving_submit
    out = tts.generate("Hello")
    assert out is not None and out.drift_prob == 0.0
    assert submits == ["Hello"] and tts.calls == ["Hello"]  # no _generate_audio call
