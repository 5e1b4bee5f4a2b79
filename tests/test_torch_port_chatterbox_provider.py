"""Port parity of the Chatterbox provider (``providers/chatterbox.py``).

The scenarios of ``tests/test_chatterbox_provider.py`` (default voice, a
voice clone with its prompt cache, provider info, determinism per seed, the
watermark) run through the JAX package's ``ChatterboxTTS`` and the port's,
each holding the ``tiny`` model of the pair built from the same fp32
weights (``test_torch_port_chatterbox.cb_pair``). The engines draw each
call's key from the same threefry chain, so the decode tokens are identical
and the finalized waveforms agree within 1e-4. Then the factory route, the
candidate loop under bench.py's forced drift failures (the same candidate
accepted) and ``serving=True``, in both packages.
"""

import numpy as np
import pytest
import torch

from rho_tts_tpu.audio_io import save_wav
from rho_tts_tpu.engine import BaseTTS as JBaseTTS
from rho_tts_tpu.providers.chatterbox import ChatterboxTTS as JChatterboxTTS
from rho_tts_tpu_torch import TTSFactory
from rho_tts_tpu_torch.engine import BaseTTS as TBaseTTS
from rho_tts_tpu_torch.models.chatterbox import model as tcb
from rho_tts_tpu_torch.ops.watermark import apply_watermark
from rho_tts_tpu_torch.providers.chatterbox import ChatterboxTTS as TChatterboxTTS
from test_torch_port_chatterbox import cb_fp32_tree, cb_pair, jax_prefill_kernel  # noqa: F401

torch.set_num_threads(1)  # several test workers share the cores

SR = 24000
WAV_TOL = 1e-4
COMMON = dict(device="cpu", implementation="tiny", max_chars_per_segment=200, max_iterations=1,
              min_audio_sec=0.03, seed=1234)


@pytest.fixture(scope="module")
def models(jax_prefill_kernel):  # noqa: F811
    return cb_pair(cb_fp32_tree(0))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_ref(tmp_path):
    t = np.arange(SR) / SR
    path = str(tmp_path / "ref.wav")
    save_wav(path, (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), SR)
    return path


def _capture_tokens(model, sink):
    """Record the tokens of every ``_decode_all`` call of ``model``."""
    inner = model._decode_all

    def wrapped(*args, **kwargs):
        toks, done = inner(*args, **kwargs)
        sink.append((_np(toks).astype(np.int64), _np(done)))
        return toks, done

    model._decode_all = wrapped
    return lambda: delattr(model, "_decode_all")


def both(models, run, classes=(JChatterboxTTS, TChatterboxTTS), **kw):
    """``run(tts)`` through the JAX provider, then the port's, each holding
    its model of the pair; returns ``[(result, tokens), ...]``."""
    outs = []
    for cls, model in zip(classes, models):
        tts = cls(**dict(COMMON, **kw))
        tts.model = model
        toks = []
        restore = _capture_tokens(model, toks)
        try:
            outs.append((run(tts), toks))
        finally:
            restore()
            tts.close()
        assert tts.model is None and not tts._prompt_cache
    return outs


def assert_same(outs):
    (ref, ref_toks), (ours, our_toks) = outs
    assert len(ref_toks) == len(our_toks) >= 1
    for (rt, rd), (ot, od) in zip(ref_toks, our_toks):
        np.testing.assert_array_equal(ot, rt)
        np.testing.assert_array_equal(od, rd)
    if isinstance(ref, list):
        assert isinstance(ours, list) and len(ours) == len(ref)
    else:
        ref, ours = [ref], [ours]
    for r, o in zip(ref, ours):
        assert isinstance(o.audio, torch.Tensor) and o.audio.dtype == torch.float32
        assert tuple(o.audio.shape) == tuple(r.audio.shape) and o.sample_rate == r.sample_rate
        np.testing.assert_allclose(_np(o.audio), _np(r.audio), atol=WAV_TOL, rtol=0)


def test_invalid_implementation_and_parallelism(caplog):
    """``parallelism`` builds the provider: without a process group the
    world is one rank, which warns and leaves the model unmeshed, as the
    JAX provider does on one device (worlds of 2 ranks generate in
    ``test_torch_port_parallel_providers.py``); an unknown mode raises."""
    with pytest.raises(ValueError, match="Invalid implementation"):
        TChatterboxTTS(device="cpu", implementation="turbo")
    with pytest.raises(ValueError, match="Unknown parallelism"):
        TChatterboxTTS(device="cpu", implementation="tiny", parallelism="pipeline")
    with caplog.at_level("WARNING"):
        tts = TChatterboxTTS(device="cpu", implementation="tiny", parallelism="data")
    assert tts.parallelism == "data" and tts.model.mesh is None
    assert "only 1 device" in caplog.text
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            TChatterboxTTS(implementation="tiny")


def test_default_voice_generates_like_jax(models):
    outs = both(models, lambda tts: tts.generate("Hello from chatterbox"))
    assert outs[1][0].sample_rate == SR
    assert_same(outs)


def test_voice_clone_with_prompt_cache_like_jax(models, tmp_path):
    ref = make_ref(tmp_path)

    def run(tts):
        assert tts.voice_cloning and tts.reference_embedding is not None
        r1 = tts.generate("First generation")
        cached = tts._prompt_cache[ref]  # conditionals cached per reference path
        r2 = tts.generate("Second generation")
        np.testing.assert_array_equal(tts._prompt_cache[ref], cached)
        run.cached.append(np.asarray(cached))
        return [r1, r2]

    run.cached = []
    outs = both(models, run, reference_audio=ref)
    np.testing.assert_allclose(run.cached[1], run.cached[0], atol=1e-5)
    assert_same(outs)


def test_provider_info_like_jax():
    ours, ref = TChatterboxTTS.provider_info(), JChatterboxTTS.provider_info()
    assert ours.name == ref.name == "chatterbox"
    assert ours.supports_voice_cloning and ours.supported_languages == ref.supported_languages
    assert [v.id for v in ours.builtin_voices] == [v.id for v in ref.builtin_voices]


def test_generation_deterministic_per_seed_like_jax(models):
    def run(tts):
        waves = []
        for _ in range(2):
            tts.seed = 111
            tts._set_seeds()
            waves.append(_np(tts._generate_audio("determinism check")))
        np.testing.assert_allclose(waves[0], waves[1], atol=1e-6)
        return waves[0]

    (ref, ref_toks), (ours, our_toks) = both(models, run)
    for (rt, _), (ot, _) in zip(ref_toks, our_toks):
        np.testing.assert_array_equal(ot, rt)
    np.testing.assert_allclose(ours, ref, atol=WAV_TOL, rtol=0)


def test_watermark_present(models, monkeypatch):
    """``generate()`` returns the raw sliced vocode plus the watermark,
    exactly, and the JAX model's output within 1e-4."""
    import jax

    jm, tm = models
    captured = {}
    inner = tcb._vocode

    def spy(params, cfg, toks):
        captured["raw"] = inner(params, cfg, toks)
        return captured["raw"]

    monkeypatch.setattr(tcb, "_vocode", spy)
    kw = dict(min_new_tokens=160, max_new_tokens=256)
    wav = tm.generate("watermark exactness", seed=7, **kw)
    raw = captured["raw"][0, : wav.shape[0]]
    assert wav.shape[0] >= 1024 and not torch.equal(wav, raw)  # something was added
    assert torch.equal(wav, apply_watermark(raw))
    ref = np.asarray(jm.generate("watermark exactness", seed=7, rng=jax.random.PRNGKey(0), **kw))
    np.testing.assert_allclose(wav.numpy(), ref, atol=WAV_TOL, rtol=0)


def test_factory_route_builds_the_port_provider(tmp_path):
    ref = make_ref(tmp_path)
    tts = TTSFactory.get_tts_instance("chatterbox", device="cpu", implementation="tiny",
                                      reference_audio=ref, candidates_per_iteration=2,
                                      serving=True, quantization="int8")
    try:
        assert isinstance(tts, TChatterboxTTS)
        assert tts.model.device.type == "cpu" and tts.model.quantization == "int8"
        assert tts.sample_rate == SR and tts.candidates_per_iteration == 2
        assert tts.supports_serving_generation and tts.voice_cloning
    finally:
        tts.close()


def _failing(base_cls, engine_cls, fails):
    """bench.py's ``FailingChatterboxTTS``: the first ``fails`` drift
    validations of each ``generate()`` are rejected."""

    class Failing(base_cls):
        def generate(self, *a, **kw):
            self._seen = 0
            self.verdicts = []
            return super().generate(*a, **kw)

        def _inject(self, results):
            out = []
            for p, ok in results:
                out.append((0.99, False) if self._seen < fails else (p, ok))
                self._seen += 1
            self.verdicts.extend(ok for _, ok in out)
            return out

        def _validate_accent_drift(self, audio, sample_rate):
            return self._inject([super()._validate_accent_drift(audio, sample_rate)])[0]

        def _validate_accent_drift_batch(self, audios, sample_rate):
            self.__dict__["_validate_accent_drift"] = \
                engine_cls._validate_accent_drift.__get__(self)
            try:
                real = super()._validate_accent_drift_batch(audios, sample_rate)
            finally:
                del self.__dict__["_validate_accent_drift"]
            return self._inject(real)

    return Failing


def test_candidates_with_forced_failures_accept_the_same_candidate(models, tmp_path):
    ref = make_ref(tmp_path)
    rounds = []

    def run(tts):
        inner = tts._generate_audio_candidates

        def counted(text, k):
            rounds.append(k)
            cands = inner(text, k)
            run.cands.append([_np(c) for c in cands])
            return cands

        tts._generate_audio_candidates = counted
        result = tts.generate("Candidates under forced drift failures")
        run.verdicts.append(list(tts.verdicts))
        return result

    run.cands, run.verdicts = [], []
    classes = (_failing(JChatterboxTTS, JBaseTTS, 2), _failing(TChatterboxTTS, TBaseTTS, 2))
    outs = both(models, run, classes=classes, reference_audio=ref, max_iterations=4,
                candidates_per_iteration=3)
    assert rounds == [3, 3]  # one round of 3 in each package
    assert run.verdicts[0] == run.verdicts[1] == [False, False, True]  # candidate 2 accepted
    for r, o in zip(run.cands[0], run.cands[1]):
        np.testing.assert_allclose(o, r, atol=WAV_TOL, rtol=0)
    assert_same(outs)


def test_serving_pipeline_matches_jax(models, tmp_path):
    def run(tts):
        result = tts.generate("Hello there. Nice to meet you", str(tmp_path / "out.wav"))
        assert result is not None and result.segments_count == 2
        assert tts._serving is not None and tts._serving.requests_done >= 2
        return result

    outs = []
    for cls, model in zip((JChatterboxTTS, TChatterboxTTS), models):
        tts = cls(**dict(COMMON, max_chars_per_segment=20), serving=True, serving_slots=2,
                  serving_max_prompt=64, serving_max_frames=128)
        tts.model = model
        try:
            outs.append(run(tts))
        finally:
            tts.close()
        assert tts._serving is None
    ref, ours = outs
    assert isinstance(ours.audio, torch.Tensor) and tuple(ours.audio.shape) == \
        tuple(ref.audio.shape)
    np.testing.assert_allclose(_np(ours.audio), _np(ref.audio), atol=WAV_TOL, rtol=0)
