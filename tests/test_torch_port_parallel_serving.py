"""Port parity of mesh serving for both families over spawned worlds.

Worlds of gloo ranks (``test_torch_port_parallel_ranks.start_world``), the
JAX package's engines on its virtual CPU devices, the same fp32 ``tiny``
weights, greedy decoding (the pins of ``tests/test_serving.py`` and
``tests/test_serving_cb.py``, ``TestMeshServing``):

* a world of 2, DP ``(2, 1)``: ``ServingEngine`` and
  ``ChatterboxServingEngine`` serve bit for bit what one process serves
  (codes and waveforms, a streamed request among them) and JAX's DP
  engines' codes; ``n_slots`` not a multiple of ``data`` raises; the
  one-shot ``ChatterboxModel`` on the mesh decodes the unmeshed waveform;
* a world of 4, TP ``(2, 2)``: both engines' greedy codes equal the
  same-mesh one-shot decode and JAX's TP engines'; the one-shot Chatterbox
  ``generate`` equals its candidate batch row for row.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_port_parallel_ranks import (WORLD_TIMEOUT_S, assert_ranks_agree,
                                            reap_worlds, start_world)  # noqa: F401 — fixture

torch.set_num_threads(1)  # several test workers share the cores

TEXTS = [
    "hello world",
    "a second, longer request in another slot",
    "third request joins later",
    "the fourth one rides a recycled slot",
]
CB_TEXT = "chatterbox on a mesh"
WAV_TOL = 1e-4
SERVE = dict(max_prompt=64, max_frames=128)


# ---------------------------------------------------------------------------
# The port's side (every rank)
# ---------------------------------------------------------------------------


def _served(reqs):
    """(codes, waveform) of each finished request, on the host."""
    return [(np.asarray(r.codes), r.result(timeout=5)[0].numpy()) for r in reqs]


def serve_qwen(engine_cls, m, n_slots=2):
    eng = engine_cls(m, n_slots=n_slots, top_k=1, **SERVE)
    reqs = [eng.submit(t, min_frames=8, max_frames=96, stream=(i == 1))
            for i, t in enumerate(TEXTS)]
    eng.run_until_idle()
    return reqs


def serve_cb(engine_cls, m, n_slots=2):
    eng = engine_cls(m, n_slots=n_slots, chunk=32, **SERVE)
    reqs = [eng.submit(t, min_frames=8, max_frames=96, seed=i, stream=(i == 1))
            for i, t in enumerate(TEXTS)]
    eng.run_until_idle()
    return reqs


def cb_tokens(model, text, seed, min_new=8, max_new=96):
    """The one-shot decode's tokens up to the first EOS (``generate``'s
    path before the vocoder), on the port."""
    st = model._start_decode(text, None, 1.0, 0.6, max_new, None, min_new, None, seeds=[seed])
    with torch.inference_mode():
        toks, done = model._decode_all(st, 1.0, 0.6, min_new, None)
    toks, done = toks.numpy(), done.numpy()
    d = np.nonzero(done[0])[0]
    return toks[0, :max(int(d[0]) if d.size else done.shape[1], 1)]


def serving_world(rank, n, qtree, cbtree):
    from rho_tts_tpu_torch import from_jax
    from rho_tts_tpu_torch.models.chatterbox import model as tcb
    from rho_tts_tpu_torch.models.qwen import PRESETS
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel
    from rho_tts_tpu_torch.parallel import inference, mesh
    from rho_tts_tpu_torch.serving import ServingEngine
    from rho_tts_tpu_torch.serving_cb import ChatterboxServingEngine

    qp = from_jax.params_from_numpy(qtree, device="cpu")
    cp = from_jax.params_from_numpy(cbtree, device="cpu")
    cb_cfg = dataclasses.replace(tcb.PRESETS["tiny"], top_k=1)

    def qmodel():
        return QwenTTSModel(PRESETS["tiny"], params=qp, device="cpu")

    def cbmodel():
        return tcb.ChatterboxModel(cb_cfg, params=cp, device="cpu")

    gen = dict(seed=3, min_new_tokens=8, max_new_tokens=96)
    out = {}
    if n == 2:
        dp = mesh.create_mesh(2, model_parallel=1)
        out["q_ref"] = _served(serve_qwen(ServingEngine, qmodel()))
        m = qmodel()
        inference.enable_data_parallel(m, dp)
        out["q_dp"] = _served(serve_qwen(ServingEngine, m))
        try:
            ServingEngine(m, n_slots=3, **SERVE)
        except ValueError as e:
            out["slots_error"] = str(e)
        out["cb_ref"] = _served(serve_cb(ChatterboxServingEngine, cbmodel()))
        out["cb_ref_generate"] = [cbmodel().generate(CB_TEXT, **gen).numpy()]
        m = cbmodel()
        inference.enable_data_parallel(m, dp)
        out["cb_dp"] = _served(serve_cb(ChatterboxServingEngine, m))
        out["cb_dp_generate"] = [m.generate(CB_TEXT, **gen).numpy()]
    else:
        tp = mesh.create_mesh(4, model_parallel=2)
        m = qmodel()
        inference.enable_tensor_parallel(m, tp)
        out["q_tp_oneshot"] = [m.generate_codes([t], min_frames=8, max_frames=96,
                                                temperature=1.0, top_k=1)[0] for t in TEXTS]
        out["q_tp"] = _served(serve_qwen(ServingEngine, m))
        m = cbmodel()
        inference.enable_tensor_parallel(m, tp)
        out["cb_tp_oneshot"] = [cb_tokens(m, t, seed=i) for i, t in enumerate(TEXTS)]
        out["cb_tp"] = _served(serve_cb(ChatterboxServingEngine, m))
        out["cb_tp_generate"] = [m.generate(CB_TEXT, seed=s, min_new_tokens=8,
                                            max_new_tokens=96).numpy() for s in (3, 4)]
        out["cb_tp_candidates"] = [w.numpy() for w in m.generate_candidates(
            CB_TEXT, 2, seeds=[3, 4], min_new_tokens=8, max_new_tokens=96)]
    return out


# ---------------------------------------------------------------------------
# The JAX side and the comparisons
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax

    from rho_tts_tpu.models.chatterbox import model as jcb
    from rho_tts_tpu.models.qwen import PRESETS
    from rho_tts_tpu.models.qwen.model import QwenTTSModel
    from rho_tts_tpu.parallel import create_mesh, inference
    from rho_tts_tpu.serving import ServingEngine
    from rho_tts_tpu.serving_cb import ChatterboxServingEngine
    from test_torch_port_chatterbox import cb_fp32_tree
    from test_torch_port_speculative import fp32_tree

    saved = os.environ.get("RHO_TTS_TPU_FUSED_ATTENTION")
    os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = "1"  # the JAX prefill kernel, interpret mode
    jax.clear_caches()
    qtree, cbtree = fp32_tree("tiny", 0), cb_fp32_tree(0)
    nq, ncb = jax.tree.map(np.asarray, qtree), jax.tree.map(np.asarray, cbtree)
    cb_cfg = dataclasses.replace(jcb.PRESETS["tiny"], top_k=1)
    out = {}
    try:
        for n, mode in ((2, "data"), (4, "tensor")):
            world = start_world(tmp_path_factory.mktemp(f"serve{n}"), n, serving_world, nq, ncb,
                                timeout=WORLD_TIMEOUT_S)
            mesh_ = create_mesh(n, model_parallel=1 if mode == "data" else 2)
            qm = QwenTTSModel(PRESETS["tiny"], params=qtree)
            getattr(inference, f"enable_{mode}_parallel")(qm, mesh_)
            cm = jcb.ChatterboxModel(cb_cfg, params=cbtree)
            getattr(inference, f"enable_{mode}_parallel")(cm, mesh_)
            ref = {"q": serve_qwen(ServingEngine, qm), "cb": serve_cb(ChatterboxServingEngine, cm)}
            out[n] = (world.join(), ref)
    finally:
        if saved is None:
            del os.environ["RHO_TTS_TPU_FUSED_ATTENTION"]
        else:
            os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = saved
        jax.clear_caches()
    return out


def assert_same_served(ours, ref_reqs, waves=True):
    """Codes equal the JAX engine's token for token, waveforms within 1e-4."""
    assert len(ours) == len(ref_reqs)
    for (codes, wav), r in zip(ours, ref_reqs):
        np.testing.assert_array_equal(codes, np.asarray(r.codes))
        if waves:
            np.testing.assert_allclose(wav, np.asarray(r.result(timeout=5)[0]), atol=WAV_TOL,
                                       rtol=0)


@pytest.mark.parametrize("family", ["q", "cb"])
def test_dp_serving_is_bit_exact_against_one_process_and_matches_jax(worlds, family):
    ranks, ref = worlds[2]
    assert_ranks_agree(ranks, f"{family}_dp")
    ours, one = ranks[0][f"{family}_dp"], ranks[0][f"{family}_ref"]
    for (c, w), (c1, w1) in zip(ours, one):
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(w, w1)
    assert_same_served(ours, ref[family])


def test_dp_serving_checks_slot_divisibility(worlds):
    ranks, _ = worlds[2]
    assert all("multiple of the mesh data axis (2)" in r["slots_error"] for r in ranks)


def test_cb_oneshot_on_a_dp_mesh_equals_unmeshed(worlds):
    ranks, _ = worlds[2]
    assert_ranks_agree(ranks, "cb_dp_generate")
    np.testing.assert_array_equal(ranks[0]["cb_dp_generate"][0], ranks[0]["cb_ref_generate"][0])


@pytest.mark.parametrize("family", ["q", "cb"])
def test_tp_serving_matches_same_mesh_oneshot_and_jax(worlds, family):
    """TP reorders the f32 sums, so the engine's pin is the same-mesh
    one-shot decode (as in the JAX tests), plus JAX's TP engine's codes."""
    ranks, ref = worlds[4]
    assert_ranks_agree(ranks, f"{family}_tp")
    ours = ranks[0][f"{family}_tp"]
    for (codes, _), one in zip(ours, ranks[0][f"{family}_tp_oneshot"]):
        n = min(codes.shape[0], one.shape[0])
        assert n > 0
        np.testing.assert_array_equal(codes[:n], one[:n])
    assert_same_served(ours, ref[family])


def test_cb_tp_generate_matches_its_candidates(worlds):
    """The one-shot TP decode: ``generate(seed=s)`` equals row s of the
    candidate batch (the k-row CFG batch survives the head split)."""
    ranks, _ = worlds[4]
    assert_ranks_agree(ranks, "cb_tp_generate")
    for g, c in zip(ranks[0]["cb_tp_generate"], ranks[0]["cb_tp_candidates"]):
        assert g.shape == c.shape and g.size > 0
        np.testing.assert_allclose(g, c, atol=1e-5, rtol=0)
