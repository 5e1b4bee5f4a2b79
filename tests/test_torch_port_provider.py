"""Port parity of the provider: ``QwenTTS.generate()`` / ``stream()`` in both packages.

``QwenTTS`` on ``tiny-CustomVoice`` (named speaker) and on ``tiny`` (Base:
voice cloning from a WAV written at the model's own rate) runs in both
packages over the same fp32 weights: ``tts._model`` is the JAX model, or
the port's model built from the same tree through
``from_jax.params_from_numpy`` (the ``fp32_params`` of
``test_torch_port_slice.py``). The JAX prefill runs its Pallas kernel in
interpret mode, the attention the port's prefill reproduces.

The engine draws each call's row seeds from its threefry key chain in both
packages, so the codes of every model call (captured around
``_generate_codes_arrays``) must be identical, the reference codes of the
cloned voice too; the finalized waveforms, and ``stream()``'s concatenated
chunks, agree within 1e-4 absolute (fp32 network and vocoder, the DSP
chain's own 3e-5 on top). No near-tie flip occurs with these seeds and
texts; one would show as a code mismatch and is reported here, not hidden
by a looser check.
"""

import numpy as np
import pytest
import torch

from rho_tts_tpu.audio_io import save_wav
from rho_tts_tpu.models.qwen import PRESETS as JPRESETS
from rho_tts_tpu.models.qwen.model import QwenTTSModel as JModel
from rho_tts_tpu.providers.qwen import QwenTTS as JQwenTTS
from rho_tts_tpu_torch import TTSFactory, from_jax
from rho_tts_tpu_torch.models.qwen import PRESETS as TPRESETS
from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel as TModel
from rho_tts_tpu_torch.providers.qwen import QwenTTS as TQwenTTS
from test_torch_port_slice import fp32_params, jax_prefill_kernel  # noqa: F401 — fixtures

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = ["port parity for the provider", "a second, slightly longer line of text here"]
COMMON = dict(device="cpu", seed=1234, max_chars_per_segment=200, max_iterations=1,
              min_audio_sec=1.0)


@pytest.fixture(scope="module")
def models(fp32_params):  # noqa: F811
    import jax

    jm = JModel(JPRESETS["tiny"], params=fp32_params)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, jm.params), device="cpu")
    return jm, TModel(TPRESETS["tiny"], params=tp, device="cpu")


def _capture_codes(model, sink):
    """Record the codes of every ``_generate_codes_arrays`` call."""
    inner = model._generate_codes_arrays

    def wrapped(*args, **kwargs):
        out = inner(*args, **kwargs)
        sink.append(np.asarray(out[0]).astype(np.int64))
        return out

    model._generate_codes_arrays = wrapped


def _pair(models, **kw):
    jm, tm = models
    ref, ours = JQwenTTS(**COMMON, **kw), TQwenTTS(**COMMON, **kw)
    ref._model, ours._model = jm, tm
    return ref, ours


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_results_match(ours, ref):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.audio.shape == tuple(r.audio.shape) and o.sample_rate == r.sample_rate
        assert o.segments_count == r.segments_count and o.duration_sec == r.duration_sec
        np.testing.assert_allclose(_np(o.audio), _np(r.audio), atol=1e-4, rtol=0)
        assert o.decay_ratio == pytest.approx(float(r.decay_ratio), abs=1e-4)


def _generate_both(models, texts, **kw):
    jm, tm = models
    ref, ours = _pair(models, **kw)
    ref_codes, our_codes = [], []
    _capture_codes(jm, ref_codes)
    _capture_codes(tm, our_codes)
    try:
        out_ref, out = ref.generate(texts), ours.generate(texts)
    finally:
        del jm._generate_codes_arrays, tm._generate_codes_arrays
    assert len(our_codes) == len(ref_codes) >= 1
    for o, r in zip(our_codes, ref_codes):
        np.testing.assert_array_equal(o, r)  # identical codes, every call
    return out, out_ref


def test_named_speaker_generate(models, jax_prefill_kernel):  # noqa: F811
    out, out_ref = _generate_both(models, TEXTS, speaker="Aria",
                                  model_path="tiny-CustomVoice")
    _assert_results_match(out, out_ref)
    assert all(isinstance(r.audio, torch.Tensor) and r.audio.dtype == torch.float32
               for r in out)


def test_voice_clone_generate(models, jax_prefill_kernel, tmp_path):  # noqa: F811
    jm, tm = models
    sr = TPRESETS["tiny"].codec.sample_rate
    t = np.arange(int(0.05 * sr)) / sr  # 150 codec frames at tiny's hop of 8
    ref_wav = (0.3 * np.sin(2 * np.pi * 190 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
               + 0.01 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)
    path = str(tmp_path / "ref.wav")
    save_wav(path, ref_wav, sr)  # at the model's own rate: no resample in the way
    np.testing.assert_array_equal(tm._reference_codes(path), np.asarray(jm._reference_codes(path)))
    out, out_ref = _generate_both(models, TEXTS[:1], model_path="tiny",
                                  reference_audio=path, reference_text="a reference line")
    _assert_results_match(out, out_ref)
    # the prompt holds the reference codes: the clone's prompt is longer
    arrays, lens, _ = tm._build_prompt_arrays(TEXTS[:1], None, "English", path, "a reference line")
    assert arrays["code_mask"].sum() == len(tm._reference_codes(path))


def test_stream_matches_jax(models, jax_prefill_kernel):  # noqa: F811
    ref, ours = _pair(models, speaker="Aria", model_path="tiny-CustomVoice")
    pieces_ref = list(ref.stream(TEXTS[1]))
    pieces = list(ours.stream(TEXTS[1]))
    assert len(pieces) == len(pieces_ref) >= 2  # chunked: more than one piece
    full_ref = np.concatenate([_np(p.audio) for p in pieces_ref])
    full = np.concatenate([_np(p.audio) for p in pieces])
    assert full.shape == full_ref.shape
    np.testing.assert_allclose(full, full_ref, atol=1e-4, rtol=0)


def test_stream_decodes_the_one_shot_codes(models):
    """stream() decodes over a cache as long as a one-shot decode's: the same codes."""
    from rho_tts_tpu_torch.models.qwen import model as qmodel

    _, tm = models
    ours = TQwenTTS(**COMMON, speaker="Aria", model_path="tiny-CustomVoice")
    ours._model = tm
    streamed = []
    inner = qmodel._decode_chunk

    def capturing(*args, **kwargs):
        out = inner(*args, **kwargs)
        streamed.append(out[0])
        return out

    qmodel._decode_chunk = capturing
    try:
        assert len(list(ours.stream(TEXTS[1]))) >= 2
    finally:
        qmodel._decode_chunk = inner
    ours._set_seeds()  # the key chain stream() started from
    _, voice = ours._route()
    with torch.inference_mode():
        codes, _, _ = tm._generate_codes_arrays(
            [TEXTS[1]], seeds=qmodel._derive_row_seeds(ours.next_rng(), 1), **voice)
    streamed = torch.cat(streamed, dim=1)
    assert streamed.shape[1] >= 2 * qmodel._chunk()
    assert torch.equal(streamed, codes[:, 1:1 + streamed.shape[1]])


def test_factory_returns_the_port_provider():
    tts = TTSFactory.get_tts_instance("qwen", device="cpu", speaker="Vivian",
                                      model_path="tiny-CustomVoice")
    assert isinstance(tts, TQwenTTS) and tts.device == "cpu"
    assert tts.sample_rate == TPRESETS["tiny"].codec.sample_rate
    assert TTSFactory.list_providers() == ["chatterbox", "qwen"]
    info = TTSFactory.get_provider_info("qwen")
    assert info.supports_voice_cloning and "Vivian" in [v.id for v in info.builtin_voices]
    assert TQwenTTS().device == "cuda"  # the port's default device


@pytest.mark.parametrize("kw,item", [
    (dict(serving=True), None),
    (dict(draft_model_path="tiny"), None),
    (dict(parallelism="data"), "item 12"),
])
def test_unported_options_raise(kw, item, caplog):
    """Every option builds the provider now: ``serving=True`` and
    ``draft_model_path`` (held against the JAX provider in
    ``test_torch_port_served_pipeline.py``; ``lora_path`` in
    ``test_torch_port_lora.py``) and ``parallelism`` (ROADMAP ``item``
    12): without a process group the world is one rank, so the model loads
    unmeshed with a warning (worlds of 2 ranks generate in
    ``test_torch_port_parallel_providers.py``); an unknown mode raises."""
    tts = TQwenTTS(device="cpu", model_path="tiny-CustomVoice", speaker="Aria", **kw)
    assert tts.supports_serving_generation == bool(kw.get("serving"))
    assert tts.draft_model_path == kw.get("draft_model_path")
    if item is None:
        return
    with caplog.at_level("WARNING"):
        model = tts._load_model()
    assert tts.parallelism == "data" and model.mesh is None
    assert "only 1 device" in caplog.text
    with pytest.raises(ValueError, match="Unknown parallelism"):
        TQwenTTS(device="cpu", model_path="tiny-CustomVoice", parallelism="pipeline")


def test_parallelism_routes_a_draft_and_stream_as_jax(models, jax_prefill_kernel,  # noqa: F811
                                                     monkeypatch):
    """``parallelism`` set with a draft, in a world of one (no process
    group: the model stays unmeshed, but the flag is set in both packages):
    a one-segment ``generate()`` runs the batch and not speculative decoding
    (JAX ``providers/qwen.py:290``), and ``stream()`` yields whole segments
    (``:376``): codes identical, audio within 1e-4 of the JAX provider's."""
    kw = dict(speaker="Aria", model_path="tiny-CustomVoice", parallelism="data",
              draft_model_path="draft")
    for model in models:
        monkeypatch.setattr(model, "synthesize_speculative",
                            lambda *a, **k: pytest.fail("speculative decode under parallelism"))
    out, out_ref = _generate_both(models, TEXTS[0], **kw)
    _assert_results_match([out], [out_ref])
    ref, ours = _pair(models, **kw)
    assert ours._stream_audio_chunks(TEXTS[1]) is None
    assert ref._stream_audio_chunks(TEXTS[1]) is None
    pieces_ref, pieces = list(ref.stream(TEXTS[1])), list(ours.stream(TEXTS[1]))
    assert len(pieces) == len(pieces_ref) == 1  # one segment, whole
    np.testing.assert_allclose(_np(pieces[0].audio), _np(pieces_ref[0].audio), atol=1e-4, rtol=0)
    assert ours._draft_model is None  # never loaded


def test_chatterbox_is_not_ported():
    """The factory's "chatterbox" route builds the port's ``ChatterboxTTS``
    (its parity with the JAX provider is held in
    ``test_torch_port_chatterbox_provider.py``); nothing raises any more."""
    from rho_tts_tpu_torch.providers.chatterbox import ChatterboxTTS

    tts = TTSFactory.get_tts_instance("chatterbox", device="cpu", implementation="tiny")
    assert isinstance(tts, ChatterboxTTS) and tts.model.device.type == "cpu"
    assert TTSFactory.get_provider_info("chatterbox").name == "chatterbox"
