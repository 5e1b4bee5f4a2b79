"""Port parity of the Chatterbox model (``models/chatterbox``).

The ``tiny`` preset runs in both packages over the same fp32 weights (drawn
with numpy, carried over by ``from_jax.params_from_numpy``). The JAX
prefill runs its Pallas kernel in interpret mode, the attention the port's
prefill reproduces. Sampling noise is a pure function of (seed, frame) in
both packages and the CFG mix is rounded once in both, so the tokens must be
identical, greedy and sampled, with and without voice conditionals, under a
minimum-length floor and under the cache caps; waveforms (vocoder and
watermark) agree within 1e-4. No near-tie flip occurs with these seeds and
texts; one would show as a token mismatch and is reported here, not hidden.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models.chatterbox import model as jcb
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models.chatterbox import model as tcb
from rho_tts_tpu_torch.parallel import inference, mesh
from rho_tts_tpu_torch.utils import prng
from test_torch_port_parallel import world_of_one  # noqa: F401 — fixture

torch.set_num_threads(1)  # several test workers share the cores

WAV_TOL = 1e-4
TEXT = "chatterbox port parity"


def cb_fp32_tree(seed: int = 0):
    """fp32 weights of the tiny JAX tree, drawn with numpy at the init's scales."""
    shapes = jax.eval_shape(lambda: jcb.init_params(jax.random.PRNGKey(0), jcb.PRESETS["tiny"]))
    rng = np.random.default_rng(seed)

    def init(path, leaf):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if leaf.ndim == 1 or names[-1] in ("attn_norm", "mlp_norm"):
            scale, shift = 0.1, 1.0  # norms around 1
        elif names[0] == "codec" and names[1] == "rvq":
            scale, shift = 0.05, 0.0
        elif names[0] == "codec":
            scale, shift = 1.0 / np.sqrt(np.prod(leaf.shape[:-1])), 0.0  # (K, Cin, Cout)
        elif names[0] in ("talker", "lm_head"):
            scale, shift = 1.0 / np.sqrt(leaf.shape[-2]), 0.0
        elif names[0] == "spk_proj":
            scale, shift = 0.05, 0.0
        else:
            scale, shift = 0.02, 0.0
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(np.float32) * scale + shift)

    return jax.tree_util.tree_map_with_path(init, shapes)


def cb_pair(params, top_k=None, quantization=None):
    """The JAX model and the port on the same weights (``top_k`` overrides
    the preset's, 1 meaning greedy)."""
    jcfg, tcfg = jcb.PRESETS["tiny"], tcb.PRESETS["tiny"]
    if top_k is not None:
        jcfg, tcfg = dataclasses.replace(jcfg, top_k=top_k), dataclasses.replace(tcfg, top_k=top_k)
    jm = jcb.ChatterboxModel(jcfg, params=params, quantization=quantization)
    tp = from_jax.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jm, tcb.ChatterboxModel(tcfg, params=tp, quantization=quantization, device="cpu")


@pytest.fixture(scope="module")
def jax_prefill_kernel():
    saved = os.environ.get("RHO_TTS_TPU_FUSED_ATTENTION")
    os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = "1"  # read at trace time
    jax.clear_caches()
    yield
    if saved is None:
        del os.environ["RHO_TTS_TPU_FUSED_ATTENTION"]
    else:
        os.environ["RHO_TTS_TPU_FUSED_ATTENTION"] = saved
    jax.clear_caches()


@pytest.fixture(scope="module")
def params():
    return cb_fp32_tree(0)


@pytest.fixture(scope="module")
def pair(jax_prefill_kernel, params):
    return cb_pair(params)


@pytest.fixture(scope="module")
def greedy(jax_prefill_kernel, params):
    return cb_pair(params, top_k=1)


def speaker_vector(seed: int = 4) -> np.ndarray:
    v = np.random.default_rng(seed).standard_normal(256).astype(np.float32)
    return v / np.linalg.norm(v)


def tokens(model, torch_side: bool, **kw):
    """The decode tokens up to the first EOS (the path ``generate`` runs
    before vocoding)."""
    kw = dict(dict(audio_prompt_path=None, temperature=1.0, cfg_weight=0.6, max_new_tokens=None,
                   max_cache_len=None, min_new_tokens=0, rng=None), **kw)
    seeds = kw.pop("seeds", None)
    if kw["rng"] is None and not torch_side:
        kw["rng"] = jax.random.PRNGKey(0)  # the JAX generate()'s default key
    st = model._start_decode(**kw, seeds=seeds)
    args = (st, kw["temperature"], kw["cfg_weight"], kw["min_new_tokens"], None)
    if torch_side:
        with torch.inference_mode():
            toks, done = model._decode_all(*args)
        toks, done = toks.numpy(), done.numpy()
    else:
        toks, done = model._decode_all(*args)
        toks = np.asarray(toks)
    d = np.nonzero(done[0])[0]
    end = max(int(d[0]) if d.size else done.shape[1], 1)
    return toks[0, :end]


def both_keys(seed):
    return jax.random.PRNGKey(seed), prng.PRNGKey(seed)


def test_from_jax_converts_the_chatterbox_tree(pair):
    _jm, tm = pair
    p = tm.params
    assert set(p) == {"text_embed", "speech_embed", "spk_proj", "talker", "lm_head", "codec"}
    cfg = tcb.PRESETS["tiny"]
    assert p["text_embed"].shape == (cfg.text_vocab, 64)
    assert p["speech_embed"].shape == (cfg.speech_vocab, 64) and p["spk_proj"].shape == (256, 64)
    assert p["lm_head"].shape == (64, cfg.speech_vocab)
    assert p["talker"]["blocks"]["wqkv"].shape == (2, 64, (4 + 2 * 2) * 16)
    assert p["codec"]["rvq"]["codebooks"].shape == (1, 64, 32)
    assert p["codec"]["decoder"]["ups"][0].shape == (32, 16, 8)  # (Cin, Cout, K)
    assert p["codec"]["decoder"]["conv_pre"].shape == (32, 32, 7)  # (Cout, Cin, K)
    assert dict(tm.named_parameters())["talker.blocks.wqkv"] is p["talker"]["blocks"]["wqkv"]


@pytest.mark.parametrize("with_speaker", [False, True])
def test_prefill_logits_match_jax(pair, with_speaker, monkeypatch):
    jm, tm = pair
    out = {}

    def spy(mod, key):
        inner = mod._prefill

        def wrapped(*args, **kwargs):
            res = inner(*args, **kwargs)
            out[key] = (np.asarray(res[0]), np.asarray(res[3]))
            return res

        monkeypatch.setattr(mod, "_prefill", wrapped)

    spy(jcb, "jax")
    spy(tcb, "port")
    spk = speaker_vector() if with_speaker else None
    for m, torch_side in ((jm, False), (tm, True)):
        m.conditionals = spk
        with torch.inference_mode():
            m._start_decode(TEXT, None, 1.0, 0.6, None, None, 0, None, candidates=2,
                            seeds=[1, 2])
        m.conditionals = None
    assert out["port"][0].shape == out["jax"][0].shape == (4, tcb.PRESETS["tiny"].speech_vocab)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])  # key_valid


CASES = {
    "greedy": dict(kw=dict(max_new_tokens=200), greedy=True),
    "sampled, speaker, floor": dict(kw=dict(seeds=[7], min_new_tokens=40, temperature=0.9,
                                            cfg_weight=0.4), speaker=True),
    "sampled from a key": dict(kw=dict(rng=5, max_new_tokens=300)),
    "faster caps": dict(kw=dict(seeds=[3], min_new_tokens=100, max_new_tokens=400,
                                max_cache_len=200)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_jax(pair, greedy, case):
    spec = CASES[case]
    jm, tm = greedy if spec.get("greedy") else pair
    spk = speaker_vector() if spec.get("speaker") else None
    kw = dict(spec["kw"])
    jkw, tkw = dict(kw), dict(kw)
    if "rng" in kw:
        jkw["rng"], tkw["rng"] = both_keys(kw["rng"])
    jm.conditionals = tm.conditionals = spk
    try:
        ref = tokens(jm, False, text=TEXT, **jkw)
        ours = tokens(tm, True, text=TEXT, **tkw)
        np.testing.assert_array_equal(ours, ref)
        if "max_cache_len" in kw:  # the cap: one 128-step chunk after the 64-slot prompt
            assert ref.shape[0] <= 1 + tcb.CHUNK
        gen_kw = {k: v for k, v in jkw.items() if k != "seeds"}
        seed = kw["seeds"][0] if "seeds" in kw else None
        ref_wav = np.asarray(jm.generate(TEXT, seed=seed, **gen_kw))
        ours_wav = tm.generate(TEXT, seed=seed, **{k: v for k, v in tkw.items() if k != "seeds"})
    finally:
        jm.conditionals = tm.conditionals = None
    assert ours_wav.dtype == torch.float32 and ours_wav.shape == ref_wav.shape
    assert ours_wav.shape[0] == ref.shape[0] * tcb.PRESETS["tiny"].codec.hop
    np.testing.assert_allclose(ours_wav.numpy(), ref_wav, atol=WAV_TOL, rtol=0)


def test_generate_candidates_match_generate_and_jax(pair):
    jm, tm = pair
    seeds = [11, 22, 33]
    kw = dict(min_new_tokens=20, max_new_tokens=160, temperature=0.9)
    ours = tm.generate_candidates(TEXT, 3, seeds=seeds, **kw)
    ref = jm.generate_candidates(TEXT, 3, seeds=seeds, **kw)
    assert len(ours) == 3
    for i, s in enumerate(seeds):
        one = tm.generate(TEXT, seed=s, **kw)
        assert ours[i].shape == one.shape == np.asarray(ref[i]).shape
        np.testing.assert_allclose(ours[i].numpy(), one.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[i]), atol=WAV_TOL, rtol=0)


def test_stream_chunks_match_jax_and_generate(pair, monkeypatch):
    jm, tm = pair
    kw = dict(min_new_tokens=192, max_new_tokens=256, temperature=0.9, context_frames=16)
    ref = [np.asarray(p) for p, _sr in jm.stream_chunks(TEXT, seed=9, **kw)]
    seen = []
    inner = tcb._decode_chunk

    def capture(*args, **kwargs):
        res = inner(*args, **kwargs)
        seen.append(res[0][0].clone())
        return res

    monkeypatch.setattr(tcb, "_decode_chunk", capture)
    ours = [p for p, _sr in tm.stream_chunks(TEXT, seed=9, **kw)]
    stream_toks = torch.cat(seen)
    seen.clear()
    kw.pop("context_frames")
    full = tm.generate(TEXT, seed=9, **kw)
    assert len(ours) == len(ref) >= 2  # incremental: audio before the end
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, atol=WAV_TOL, rtol=0)
    # The same tokens as the one-shot decode; the concatenation is its
    # waveform up to the window edges' envelope and vocoder context (the
    # JAX package's own bound for this test), interior samples to 1e-4.
    n = full.shape[0] // tcb.PRESETS["tiny"].codec.hop - 1
    assert torch.equal(stream_toks[:n], torch.cat(seen)[:n])
    streamed = torch.cat(ours)
    assert streamed.shape == full.shape
    np.testing.assert_allclose(streamed.numpy(), full.numpy(), atol=2e-2)
    assert np.isclose(streamed.numpy(), full.numpy(), atol=1e-4).mean() > 0.99


def test_int8_tokens_match_jax(jax_prefill_kernel, params):
    jm, tm = cb_pair(params, quantization="int8")
    assert tm.quantization == "int8"
    assert tm.params["talker"]["blocks"]["wqkv"]["q"].dtype == torch.int8
    kw = dict(seeds=[5], min_new_tokens=30, max_new_tokens=130)
    np.testing.assert_array_equal(tokens(tm, True, text=TEXT, **kw),
                                  tokens(jm, False, text=TEXT, **kw))


def test_native_checkpoint_round_trip(pair, tmp_path):
    _jm, tm = pair
    tm.save_checkpoint(str(tmp_path / "dense"))
    loaded = tcb.ChatterboxModel.from_pretrained(device="cpu", model_path=str(tmp_path / "dense"))
    assert loaded.cfg is tcb.PRESETS["tiny"] and loaded.quantization is None
    for (name, a), (_n, b) in zip(tm.named_parameters(), loaded.named_parameters()):
        assert torch.equal(a, b), name
    kw = dict(seed=2, min_new_tokens=8, max_new_tokens=64)
    assert torch.equal(loaded.generate(TEXT, **kw), tm.generate(TEXT, **kw))

    q = tcb.ChatterboxModel(tcb.PRESETS["tiny"], params=tm.params, quantization="int8",
                            device="cpu")
    q.save_checkpoint(str(tmp_path / "int8"))
    served = tcb.ChatterboxModel.from_pretrained(device="cpu", model_path=str(tmp_path / "int8"))
    assert served.quantization == "int8"
    assert torch.equal(served.generate(TEXT, **kw), q.generate(TEXT, **kw))
    with pytest.raises(ValueError, match="quantization"):
        tcb.ChatterboxModel.from_pretrained(device="cpu", model_path=str(tmp_path / "int8"),
                                            quantization="int4")
    from rho_tts_tpu_torch.models.qwen import QwenTTSModel

    with pytest.raises(ValueError, match="family"):
        QwenTTSModel.from_pretrained(str(tmp_path / "int8"), device="cpu")


def _t3_tensors(cfg, rng):
    """A synthetic upstream T3 state dict (HF (out, in) linears), with
    voice-encoder and vocoder tensors the converter must leave out."""
    t = cfg.talker
    h, qd, kvd = t.hidden, t.q_heads * t.head_dim, t.kv_heads * t.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    out = {
        "t3.text_emb.weight": w(cfg.text_vocab, h),
        "t3.speech_emb.weight": w(cfg.speech_vocab, h),
        "t3.speech_head.weight": w(cfg.speech_vocab, h),
        "t3.cond_enc.spkr_enc.weight": w(h, 256),
        "t3.tfmr.norm.weight": 1.0 + w(h),
        "ve.lstm.weight_ih_l0": w(4, 4),
        "s3gen.flow.weight": w(4, 4),
    }
    for i in range(t.layers):
        p = f"t3.tfmr.layers.{i}."
        out.update({
            p + "self_attn.q_proj.weight": w(qd, h), p + "self_attn.k_proj.weight": w(kvd, h),
            p + "self_attn.v_proj.weight": w(kvd, h), p + "self_attn.o_proj.weight": w(h, qd),
            p + "mlp.gate_proj.weight": w(t.ffn, h), p + "mlp.up_proj.weight": w(t.ffn, h),
            p + "mlp.down_proj.weight": w(h, t.ffn),
            p + "input_layernorm.weight": 1.0 + w(h),
            p + "post_attention_layernorm.weight": 1.0 + w(h),
        })
    return out


def _t3_leaves(tree):
    keys = ("text_embed", "speech_embed", "spk_proj", "lm_head")
    leaves = {k: tree[k] for k in keys}
    leaves.update({f"blocks.{k}": v for k, v in tree["talker"]["blocks"].items()})
    leaves["final_norm"] = tree["talker"]["final_norm"]
    return leaves


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_t3_checkpoint_converts_like_jax(tmp_path, fmt):
    from safetensors.numpy import save_file

    from rho_tts_tpu.models.chatterbox.weights import load_checkpoint as jload
    from rho_tts_tpu_torch.models.chatterbox.weights import load_checkpoint as tload

    tensors = _t3_tensors(tcb.PRESETS["tiny"], np.random.default_rng(0))
    if fmt == "safetensors":
        save_file(tensors, str(tmp_path / "model.safetensors"))
        path = str(tmp_path)
    else:
        path = str(tmp_path / "t3_cfg.pt")
        torch.save({"model": {k: torch.from_numpy(v) for k, v in tensors.items()}}, path)
    ref = _t3_leaves(jload(path, jcb.PRESETS["tiny"]))
    ours = _t3_leaves(tload(path, tcb.PRESETS["tiny"], device="cpu"))
    assert set(ours) == set(ref)
    for name, r in ref.items():
        r = np.asarray(r.astype(jnp.float32))
        o = ours[name].float().numpy()
        assert o.shape == r.shape, name
        np.testing.assert_array_equal(o, r, err_msg=name)
    # The T3 weights landed (not the random init): the head is the transposed speech head.
    np.testing.assert_allclose(ours["lm_head"].float().numpy(),
                               tensors["t3.speech_head.weight"].T, atol=1e-2)
    model = tcb.ChatterboxModel.from_pretrained(device="cpu", implementation="tiny",
                                                model_path=path)
    assert torch.equal(model.params["text_embed"], tload(path, tcb.PRESETS["tiny"],
                                                         device="cpu")["text_embed"])


def test_entry_points_default_to_cuda_and_mesh_raises(pair, world_of_one):
    """Without ``device=`` the model goes to the card. A model on a mesh no
    longer raises: over meshes of one (a gloo world of one) its data- and
    tensor-parallel decodes draw the unmeshed tokens and waveform; worlds of
    2 and 4 ranks are ``test_torch_port_parallel_serving.py``."""
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises((RuntimeError, AssertionError)):
            tcb.ChatterboxModel(tcb.PRESETS["tiny"])
        with pytest.raises((RuntimeError, AssertionError)):
            tcb.ChatterboxModel.from_pretrained(implementation="tiny")
    _jm, tm = pair
    ref = tm.generate(TEXT, max_new_tokens=64, seed=5)
    for mode in ("data", "tensor"):
        m = tcb.ChatterboxModel(tm.cfg, params=tm.params, device="cpu")
        getattr(inference, f"enable_{mode}_parallel")(m, mesh.create_mesh(1, model_parallel=1))
        assert m.mesh is not None
        assert torch.equal(m.generate(TEXT, max_new_tokens=64, seed=5), ref)
