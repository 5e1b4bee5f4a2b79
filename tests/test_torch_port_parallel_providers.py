"""Port parity of ``QwenTTS`` / ``ChatterboxTTS(parallelism=...)`` in a world of 2.

A spawned gloo world of 2 ranks (``test_torch_port_parallel_ranks.start_world``)
builds each provider with ``parallelism="data"`` and ``"tensor"``: the
provider finds the process group, loads its model (the fp32 ``tiny``
weights, carried over from the JAX tree) and puts it on a mesh of the
world's two ranks (``(2, 1)`` for data, ``(1, 2)`` for tensor: the
``tiny`` talkers have 2 KV heads). Every rank's ``generate()`` returns the
whole result, and its waveforms agree with the JAX provider's on the same
mesh of its virtual devices within 1e-4.

With a ``draft_model_path`` the flag keeps the JAX routing: a one-segment
``generate()`` runs the meshed batch (no speculative decode) and
``stream()`` yields whole segments (no chunked streaming), each within
1e-4 of the JAX provider on its mesh.

The same holds for ``serving=True``: three segments on two slots go
through each family's serving engine, started on its background thread in
every rank, with the second rank's segments arriving late and one at a
time, so the first rank schedules requests the second has not submitted
yet.
"""

import os
import time

import numpy as np
import pytest
import torch

from test_torch_port_parallel_ranks import (WORLD_TIMEOUT_S, assert_ranks_agree,
                                            reap_worlds, start_world)  # noqa: F401 — fixture

torch.set_num_threads(1)  # several test workers share the cores

QWEN_TEXTS = ["Hello there, this is a meshed provider.", "A second line"]
CB_TEXT = "Hello from chatterbox"
QWEN = dict(device="cpu", seed=1234, max_chars_per_segment=200, max_iterations=1,
            min_audio_sec=1.0, speaker="Aria", model_path="tiny-CustomVoice")
CB = dict(device="cpu", implementation="tiny", max_chars_per_segment=200, max_iterations=1,
          min_audio_sec=0.03, seed=1234)
MODES = ["data", "tensor"]
SERVED = dict(max_chars_per_segment=20, serving=True, serving_slots=2, serving_max_prompt=128,
              serving_max_frames=128)
SERVED_TEXT = "Hello there. Nice to meet you. A third line here."
SERVED_CASES = [("qwen", "data"), ("qwen", "tensor"), ("cb", "data")]
DRAFT = dict(draft_model_path="draft")
STREAM_KW = dict(max_chars_per_segment=20)  # SERVED_TEXT in three segments
WAV_TOL = 1e-4


def _served(cls, kw, mode, rank=0):
    """One served generate() of ``SERVED_TEXT``: the waveform and the
    engine's (admission groups, requests done), the engine closed."""
    tts = cls(**{**kw, **SERVED}, parallelism=mode, n_devices=2)
    return tts, lambda: _served_run(tts, rank)


def _served_run(tts, rank):
    if rank:  # the second rank's segments arrive late, one at a time
        submit = tts._serving_submit

        def late(text):
            time.sleep(0.3)
            return submit(text)

        tts._serving_submit = late
    try:
        res = tts.generate(SERVED_TEXT)
        assert res.segments_count == 3
        eng = tts._serving
        # (the JAX engine counts no admission groups)
        return np.asarray(res.audio), (getattr(eng, "admissions", 0), eng.requests_done)
    finally:
        tts.close()


def _draft_and_stream(tts, stream_tts, model=None):
    """A one-segment ``generate()`` with a draft under ``parallelism``, and
    ``stream()``'s pieces of ``SERVED_TEXT``: the waveforms as numpy."""
    if model is not None:
        tts._model = stream_tts._model = model
    one = [np.asarray(tts.generate(QWEN_TEXTS[1]).audio)]
    pieces = [np.asarray(p.audio) for p in stream_tts.stream(SERVED_TEXT)]
    assert tts._draft_model is None and stream_tts._draft_model is None  # never loaded
    return one, pieces


def providers_world(rank, n, qtree, cbtree):
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models.chatterbox import model as tcb
    from rho_tts_tpu_torch.models.qwen import PRESETS
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel
    from rho_tts_tpu_torch.providers.chatterbox import ChatterboxTTS
    from rho_tts_tpu_torch.providers.qwen import QwenTTS

    qp = from_jax.params_from_numpy(qtree, device="cpu")
    cp = from_jax.params_from_numpy(cbtree, device="cpu")
    # The providers load these weights where they would load a checkpoint.
    QwenTTSModel.from_pretrained = classmethod(
        lambda cls, *a, **k: cls(PRESETS["tiny"], params=qp, device="cpu",
                                 model_path="tiny-CustomVoice"))
    tcb.ChatterboxModel.from_pretrained = classmethod(
        lambda cls, *a, **k: cls(tcb.PRESETS["tiny"], params=cp, device="cpu"))
    out = {}
    for mode in MODES:
        tts = QwenTTS(**QWEN, parallelism=mode)
        res = tts.generate(QWEN_TEXTS)
        m = tts._model
        out[f"qwen_{mode}"] = [r.audio.numpy() for r in res]
        out[f"qwen_{mode}_mesh"] = (m.mesh.shape, m.tp_axis is not None)
        out[f"qwen_{mode}_draft"], out[f"qwen_{mode}_stream"] = _draft_and_stream(
            QwenTTS(**QWEN, parallelism=mode, **DRAFT),
            QwenTTS(**{**QWEN, **STREAM_KW}, parallelism=mode, **DRAFT))
        tts = ChatterboxTTS(**CB, parallelism=mode)
        out[f"cb_{mode}"] = [tts.generate(CB_TEXT).audio.numpy()]
        out[f"cb_{mode}_mesh"] = (tts.model.mesh.shape, tts.model.tp_axis is not None)
        tts.close()
    for family, mode in SERVED_CASES:
        cls, kw = (QwenTTS, QWEN) if family == "qwen" else (ChatterboxTTS, CB)
        _tts, run = _served(cls, kw, mode, rank)
        wav, counts = run()
        out[f"served_{family}_{mode}"] = [wav]
        out[f"served_{family}_{mode}_counts"] = counts
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax

    from rho_tts_tpu.models.chatterbox import model as jcb
    from rho_tts_tpu.models.qwen import PRESETS
    from rho_tts_tpu.models.qwen.model import QwenTTSModel
    from rho_tts_tpu.parallel import enable_parallelism
    from rho_tts_tpu.providers.chatterbox import ChatterboxTTS
    from rho_tts_tpu.providers.qwen import QwenTTS
    from test_torch_port_chatterbox import cb_fp32_tree
    from test_torch_port_speculative import fp32_tree

    saved = os.environ.get("RHO_TTS_TPU_FUSED_ATTENTION")
    os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = "1"  # the JAX prefill kernel, interpret mode
    jax.clear_caches()
    qtree, cbtree = fp32_tree("tiny", 0), cb_fp32_tree(0)
    ranks = start_world(tmp_path_factory.mktemp("providers"), 2, providers_world,
                        jax.tree.map(np.asarray, qtree), jax.tree.map(np.asarray, cbtree),
                        timeout=WORLD_TIMEOUT_S)
    ref = {}
    try:
        for mode in MODES:
            jm = QwenTTSModel(PRESETS["tiny"], params=qtree)
            enable_parallelism(jm, mode, 2)
            tts = QwenTTS(**QWEN, parallelism=mode, n_devices=2)
            tts._model = jm
            ref[f"qwen_{mode}"] = [np.asarray(r.audio) for r in tts.generate(QWEN_TEXTS)]
            ref[f"qwen_{mode}_draft"], ref[f"qwen_{mode}_stream"] = _draft_and_stream(
                QwenTTS(**QWEN, parallelism=mode, n_devices=2, **DRAFT),
                QwenTTS(**{**QWEN, **STREAM_KW}, parallelism=mode, n_devices=2, **DRAFT), jm)
            tts = ChatterboxTTS(**CB, parallelism=mode, n_devices=2)
            cm = jcb.ChatterboxModel(jcb.PRESETS["tiny"], params=cbtree)
            enable_parallelism(cm, mode, 2)
            tts.model = cm
            ref[f"cb_{mode}"] = [np.asarray(tts.generate(CB_TEXT).audio)]
        for family, mode in SERVED_CASES:
            if family == "qwen":
                tts, run = _served(QwenTTS, QWEN, mode)
                tts._model = QwenTTSModel(PRESETS["tiny"], params=qtree)
                enable_parallelism(tts._model, mode, 2)
            else:
                tts, run = _served(ChatterboxTTS, CB, mode)
                tts.model = jcb.ChatterboxModel(jcb.PRESETS["tiny"], params=cbtree)
                enable_parallelism(tts.model, mode, 2)
            ref[f"served_{family}_{mode}"] = [run()[0]]
        return ranks.join(), ref
    finally:
        if saved is None:
            del os.environ["RHO_TTS_TPU_FUSED_ATTENTION"]
        else:
            os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = saved
        jax.clear_caches()


@pytest.mark.parametrize("family", ["qwen", "cb"])
@pytest.mark.parametrize("mode", MODES)
def test_provider_parallelism_generates_like_jax(world, family, mode):
    ranks, ref = world
    key = f"{family}_{mode}"
    assert_ranks_agree(ranks, key)
    shape, tensor = ranks[0][f"{key}_mesh"]
    assert shape == ({"data": 2, "model": 1} if mode == "data" else {"data": 1, "model": 2})
    assert tensor == (mode == "tensor")
    ours = ranks[0][key]
    assert len(ours) == len(ref[key])
    for o, r in zip(ours, ref[key]):
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_allclose(o, r, atol=WAV_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["draft", "stream"])
@pytest.mark.parametrize("mode", MODES)
def test_provider_parallelism_keeps_jax_routing(world, mode, kind):
    """``draft``: one segment through the meshed batch, not speculative
    decoding; ``stream``: three whole segments, not chunks. Within 1e-4 of
    the JAX provider on its mesh, the same on both ranks."""
    ranks, ref = world
    key = f"qwen_{mode}_{kind}"
    assert_ranks_agree(ranks, key)
    ours = ranks[0][key]
    assert len(ours) == len(ref[key]) == (1 if kind == "draft" else 3)
    for o, r in zip(ours, ref[key]):
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_allclose(o, r, atol=WAV_TOL, rtol=0)


@pytest.mark.parametrize("family,mode", SERVED_CASES)
def test_provider_serving_over_mesh_matches_jax(world, family, mode):
    ranks, ref = world
    key = f"served_{family}_{mode}"
    assert_ranks_agree(ranks, key)
    assert_ranks_agree(ranks, f"{key}_counts")
    admissions, done = ranks[0][f"{key}_counts"]
    assert admissions > 1 and done == 3  # three segments on two slots
    (ours,), (theirs,) = ranks[0][key], ref[key]
    assert ours.shape == theirs.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=WAV_TOL, rtol=0)
