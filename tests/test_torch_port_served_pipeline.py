"""Port parity of the served pipeline (``engine._generate_segments_served``).

The Qwen scenarios of ``tests/test_served_pipeline.py`` run through both
engines: a fake provider whose ``_serving_submit`` returns scripted futures
pins the retry and fallback semantics (one submit per segment, only the
failing segment resubmitted, exhaustion -> best by drift, errors,
cancellation, a retire burst validated as one batch), with the same
submits, metadata and audio (3e-5, the DSP chain's parity) in both. Then
``QwenTTS(serving=True)`` and ``QwenTTS(draft_model_path=...)`` on the
``tiny`` preset run end to end against the JAX provider over the same fp32
weights: the per-request seeds of the serving engine and the key chain of
the speculative route are the same bits, so the finalized audio agrees
within 1e-4.
"""

import threading
import time
from unittest.mock import patch

import numpy as np
import pytest
import torch

import rho_tts_tpu
import rho_tts_tpu_torch
from rho_tts_tpu.providers.qwen import QwenTTS as JQwenTTS
from rho_tts_tpu_torch.providers.qwen import QwenTTS as TQwenTTS
from test_torch_port_parallel_ranks import within
from test_torch_port_slice import jax_prefill_kernel  # noqa: F401 — fixture
from test_torch_port_speculative import fp32_tree, model_pair

torch.set_num_threads(1)  # several test workers share the cores

SR = 8000


def sine(amp=0.5, dur=0.4):
    t = np.arange(int(SR * dur)) / SR
    return (amp * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


class FakeReq:
    """Minimal ServeRequest stand-in: resolves at once (or via .fire())."""

    def __init__(self, wav=None, error=None, defer=False):
        self.wav = wav
        self.error = error
        self.cancelled = False
        self._cbs = []
        self._fired = not defer

    def add_done_callback(self, fn):
        if self._fired:
            fn(self)
        else:
            self._cbs.append(fn)

    def fire(self):
        self._fired = True
        for fn in self._cbs:
            fn(self)
        self._cbs = []

    def cancel(self):
        self.cancelled = True


def served_fake(pkg):
    class ServedFakeTTS(pkg.BaseTTS):
        supports_batch_generation = True
        supports_serving_generation = True

        def __init__(self, **kw):
            super().__init__(device="cpu", **kw)
            self.max_chars_per_segment = 100
            self._max_chars_explicit = True
            self.force_sentence_split = True
            self.submits = []
            self.script = {}  # text -> FakeReq factories, popped per try

        def _serving_submit(self, text):
            self.submits.append(text)
            factories = self.script.get(text)
            if factories:
                return factories.pop(0)()
            return FakeReq(wav=sine())

        def _generate_audio(self, text, **kw):  # pragma: no cover
            raise AssertionError("served pipeline must not call _generate_audio")

        @property
        def sample_rate(self):
            return SR

    return ServedFakeTTS()


PKGS = (rho_tts_tpu, rho_tts_tpu_torch)


def both(setup, text, **gen_kw):
    """Run ``setup(tts)`` then ``tts.generate(text)`` in both packages; the
    same submits and metadata, audio within 3e-5. Returns the port's result."""
    outs = []
    for pkg in PKGS:
        tts = served_fake(pkg)
        with setup(tts):
            result = tts.generate(text, **gen_kw)
        outs.append((tts, result))
    (jtts, ref), (tts, ours) = outs
    assert sorted(tts.submits) == sorted(jtts.submits)
    if ref is None:
        assert ours is None
        return tts, ours
    assert ours.segments_count == ref.segments_count
    for key in ("drift_prob", "text_similarity"):
        assert getattr(ours, key) == pytest.approx(getattr(ref, key))
    a = ours.audio.numpy() if isinstance(ours.audio, torch.Tensor) else ours.audio
    assert a.shape == np.asarray(ref.audio).shape
    np.testing.assert_allclose(a, np.asarray(ref.audio), atol=3e-5, rtol=0)
    return tts, ours


class _Gates:
    """Patch the batch validators of one provider (a context manager)."""

    def __init__(self, drift=None, stt=None, script=None, **attrs):
        self.drift, self.stt, self.script, self.attrs = drift, stt, script, attrs

    def __call__(self, tts):
        for k, v in self.attrs.items():
            setattr(tts, k, v)
        if self.script:
            tts.script = {t: list(fs) for t, fs in self.script().items()}
        drift = self.drift() if callable(self.drift) else None
        stt = self.stt() if callable(self.stt) else None
        self._patches = [
            patch.object(tts, "_validate_accent_drift_batch",
                         side_effect=drift or (lambda auds, sr: [(0.05, True)] * len(auds))),
            patch.object(tts, "_validate_text_match_batch",
                         side_effect=stt or (lambda a, sr, t: [(True, 1.0, None)] * len(a))),
        ]
        return self

    def __enter__(self):
        for p in self._patches:
            p.__enter__()

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.__exit__(*exc)


def test_served_happy_path_one_submit_per_segment():
    tts, result = both(_Gates(), "One. Two. Three. Four")
    assert result.segments_count == 4
    assert sorted(tts.submits) == sorted(["One.", "Two.", "Three.", "Four"])


def test_served_drift_failure_resubmits_only_that_segment():
    def drift():
        per_text = {}

        def fn(audios, sr):
            out = []
            for a in audios:
                key = round(float(np.asarray(a)[10]), 6)  # identified by amplitude
                tries = per_text.get(key, 0) + 1
                per_text[key] = tries
                bad = key == pytest.approx(round(float(sine(0.9)[10]), 6)) and tries <= 2
                out.append((0.9 if bad else 0.05, not bad))
            return out
        return fn

    gates = _Gates(drift=drift, max_iterations=3, voice_cloning=True,
                   script=lambda: {"B.": [lambda: FakeReq(wav=sine(0.9))] * 3})
    tts, _ = both(gates, "A. B. C")
    assert [tts.submits.count(t) for t in ("A.", "B.", "C")] == [1, 3, 1]


def test_served_stt_failure_resubmits():
    def stt():
        calls = {"n": 0}

        def fn(auds, sr, txts):
            out = []
            for t in txts:
                if t == "B.":
                    calls["n"] += 1
                    out.append((calls["n"] > 1, 0.2 if calls["n"] == 1 else 0.95, "b"))
                else:
                    out.append((True, 1.0, None))
            return out
        return fn

    tts, result = both(_Gates(stt=stt, max_iterations=2, voice_cloning=True), "A. B. C")
    assert tts.submits.count("B.") == 2
    assert result.text_similarity == pytest.approx(0.95)


def test_served_exhaustion_falls_back_to_best_by_drift():
    def drift():
        it = iter([0.9, 0.6])  # both tries fail; the second is the best
        return lambda auds, sr: [(next(it), False)] * len(auds)

    tts, result = both(_Gates(drift=drift, max_iterations=2, voice_cloning=True),
                       "Hello there")
    assert result.drift_prob == pytest.approx(0.6)
    assert tts.submits == ["Hello there"] * 2


def test_served_generation_error_retries_then_succeeds():
    def script():
        return {"Hello there": [lambda: FakeReq(error=RuntimeError("transient")),
                                lambda: FakeReq(wav=sine())]}

    tts, _ = both(_Gates(script=script, max_iterations=3, voice_cloning=True), "Hello there")
    assert len(tts.submits) == 2


def test_served_value_error_propagates():
    for pkg in PKGS:
        tts = served_fake(pkg)
        tts.script = {"Hello there": [lambda: FakeReq(error=ValueError("bad config"))]}
        with pytest.raises(ValueError, match="bad config"):
            tts.generate("Hello there")


def test_served_cancellation():
    for pkg in PKGS:
        tts = served_fake(pkg)
        tts.max_iterations = 2
        tts.voice_cloning = True
        token = pkg.CancellationToken()
        req = FakeReq(wav=sine(), defer=True)
        tts.script = {"Hello there": [lambda: req]}

        def fire_later():
            time.sleep(0.1)
            token.cancel()
            req.fire()

        t = threading.Thread(target=fire_later, daemon=True)
        t.start()
        try:
            assert tts.generate("Hello there", cancellation_token=token) is None
            assert req.cancelled
        finally:
            within(t.join, 30)


def test_served_deferred_burst_validated_in_one_batch():
    """Requests retiring together coalesce into one drift-batch call."""
    for pkg in PKGS:
        tts = served_fake(pkg)
        tts.max_iterations = 2
        tts.voice_cloning = True
        reqs = [FakeReq(wav=sine(), defer=True) for _ in range(3)]
        it = iter(reqs)
        tts.script = {t: [lambda it=it: next(it)] for t in ("A.", "B.", "C")}
        batch_sizes = []

        def drift(auds, sr, sizes=batch_sizes):
            sizes.append(len(auds))
            return [(0.05, True)] * len(auds)

        def fire_all(reqs=reqs):
            time.sleep(0.15)
            for r in reqs:
                r.fire()

        t = threading.Thread(target=fire_all, daemon=True)
        t.start()
        try:
            with patch.object(tts, "_validate_accent_drift_batch", side_effect=drift), \
                    patch.object(tts, "_validate_text_match_batch",
                                 side_effect=lambda a, sr, x: [(True, 1.0, None)] * len(a)):
                assert tts.generate("A. B. C") is not None
        finally:
            within(t.join, 30)
        assert batch_sizes == [3]


# -- Real-model integration (tiny preset, CPU) --------------------------------


@pytest.fixture(scope="module")
def models():
    return {"tiny": model_pair("tiny", fp32_tree("tiny", 0)),
            "draft": model_pair("draft", fp32_tree("draft", 123))}


COMMON = dict(device="cpu", model_path="tiny-CustomVoice", speaker="Vivian", seed=321,
              max_iterations=1, min_audio_sec=1.0)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_qwen_serving_pipeline_matches_jax(models, jax_prefill_kernel, tmp_path):  # noqa: F811
    outs = []
    for i, cls in enumerate((JQwenTTS, TQwenTTS)):
        tts = cls(**COMMON, max_chars_per_segment=20, serving=True, serving_slots=2,
                  serving_max_prompt=128, serving_max_frames=128)
        tts._model = models["tiny"][i]
        try:
            result = tts.generate("Hello there. Nice to meet you", str(tmp_path / f"{i}.wav"))
            assert result is not None and result.segments_count == 2
            # the serving engine, not the static batch path, did the work
            assert tts._serving is not None and tts._serving.requests_done >= 2
            outs.append(result)
        finally:
            tts.close()
        assert tts._serving is None
    ref, ours = outs
    assert isinstance(ours.audio, torch.Tensor) and ours.audio.shape == tuple(ref.audio.shape)
    np.testing.assert_allclose(_np(ours.audio), _np(ref.audio), atol=1e-4, rtol=0)


def test_qwen_speculative_provider_matches_jax(models, jax_prefill_kernel):  # noqa: F811
    """A single-segment generate() routes through the draft (``synthesize_
    speculative``) with the next key of the engine's chain; stream() keeps
    per-segment results."""
    outs = []
    for i, cls in enumerate((JQwenTTS, TQwenTTS)):
        tts = cls(**COMMON, draft_model_path="draft", speculative_gamma=2)
        tts.trim_silence = False
        tts._model, tts._draft_model = models["tiny"][i], models["draft"][i]
        calls = []
        inner = tts._model.synthesize_speculative

        def counting(*args, inner=inner, calls=calls, **kw):
            calls.append(args[0])
            return inner(*args, **kw)

        tts._model.synthesize_speculative = counting
        try:
            result = tts.generate("speculative provider path")
            assert calls == ["speculative provider path"]
            assert tts._stream_audio_chunks("x") is None
        finally:
            del tts._model.synthesize_speculative
        outs.append(result)
    ref, ours = outs
    assert ours.audio.shape == tuple(ref.audio.shape) and ours.duration_sec > 0
    np.testing.assert_allclose(_np(ours.audio), _np(ref.audio), atol=1e-4, rtol=0)


def test_serving_submit_routes_the_voice(models):
    """CustomVoice needs a named speaker, Base reference audio (as
    ``_generate_audio``); the request carries the provider's voice."""
    tts = TQwenTTS(**COMMON, serving=True, serving_slots=1, serving_max_prompt=64,
                   serving_max_frames=64)
    tts._model = models["tiny"][1]
    try:
        req = tts._serving_submit("routed")
        req.result(timeout=120)
        floor = int(tts.min_audio_sec * tts._model.config.codec.frame_rate)
        assert (req.speaker, req.language) == ("Vivian", "English")
        assert req.min_frames == min(floor, req.max_frames) and req.n_frames == req.max_frames
        tts.speaker = None
        with pytest.raises(ValueError, match="named speaker"):
            tts._serving_submit("no voice")
    finally:
        tts.close()
