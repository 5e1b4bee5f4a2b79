"""The state-space hybrid talker (granite-4.0-h: Mamba-2 mixers beside NoPE GQA
attention, 72 routed experts behind a softmax router plus a shared expert,
muP multipliers) against the benchmark's plain float32 reference
(``benchmark/reference/granite_talker.py``).

On the CPU, at the ``granite-tiny`` sizes in float32 (KV caches too; a scan
chunk of 8, shorter than the prompt): the prefill's logits at every prompt
position, then decoding through the KV cache, the convolution state and the
scan state across two chunks, against the reference's full forward; rows
left-padded to different lengths in one batch; the chunked scan and the
decode step's plain version against the reference's recurrence; the
softmax-top-k router and the shared expert; each multiplier (residual,
input embedding, attention scale) shown to matter; greedy codes against the
reference's argmax chain; the decode step through a graph's buffers (a
replay standing for the step) against the eager step; the spans; and every
path that does not support such a talker raising ``NotImplementedError``.

On the card (``-m chip``; skipped without one): ``ssm_step`` against its
plain version at the published widths at 1, 8 and 64 rows, launched twice
bit for bit; ``add_rms_norm`` at the Mamba gated norm's 8,192 and with a
residual multiplier; both attention kernels with the default scale bit for
bit as with that scale given; and the ``granite-4.0-h-small`` decode step
replayed as a CUDA graph, bit for bit against the eager step. Run on the
card with ``python -m pytest tests/test_torch_port_granite_talker.py -m chip -s``.
"""

import contextlib
import dataclasses
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import granite, registry  # noqa: E402
from benchmark.reference import granite_talker as ref  # noqa: E402
from rho_tts_tpu_torch.models import transformer as tfm  # noqa: E402
from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel  # noqa: E402
from rho_tts_tpu_torch.models.qwen import model as qmodel  # noqa: E402
from rho_tts_tpu_torch.ops.cuda import ssm_step as ssm  # noqa: E402

torch.set_num_threads(1)  # several test workers share the cores

TEXT, SPEAKER = "A short line to speak.", "Vivian"
TOL = 1e-4  # float32 on both sides: sums taken in another order

#: ``granite-tiny`` in the benchmark's terms (the published config's keys)
CFG = dict(
    registry.load_config("granite-4.0-h-small-tts-bf16"), name="granite-tiny", hidden_size=64,
    num_hidden_layers=6, layer_types=["mamba", "mamba", "attention", "mamba", "attention", "mamba"],
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=32, shared_intermediate_size=32,
    num_local_experts=8, num_experts_per_tok=3, mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
    mamba_chunk_size=8, attention_multiplier=0.0625, text_vocab=512, code_predictor_hidden=32,
    codec={"sample_rate": 24000, "upsample_rates": [4, 2], "n_codebooks": 2,
           "codebook_size": 64, "codebook_dim": 32, "decoder_channels": [32, 16, 8],
           "encoder_channels": [8, 16, 32], "resblock_dilations": [1, 3, 9]})


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _tree(seed=1234):
    """The benchmark's weights from ``seed`` in float32."""
    return _f32(granite.make_params(CFG, seed, "cpu"))


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def model(tree):
    return QwenTTSModel(PRESETS["granite-tiny"], params=tree, device="cpu")


def test_the_tiny_preset_is_the_configuration_the_tests_use():
    got = PRESETS["granite-tiny"].talker
    assert got == granite.program_config(CFG).talker
    assert (got.attn_layers, got.mamba_layers, got.moe_layers, got.ssm_chunk) == (2, 4, 6, 8)
    big = PRESETS["granite-4.0-h-small"].talker
    assert (big.attn_layers, big.mamba_layers, big.moe_layers, big.head_dim) == (4, 36, 40, 128)
    assert (big.ssm_inner, big.ssm_conv_dim, big.router, big.rope) == (8192, 8448, "softmax", False)
    assert [i for i, k in enumerate(big.schedule) if k != "mamba"] == [5, 15, 25, 35]
    conv, scan = tfm.make_ssm_state(big, 8, "meta")
    assert conv.shape == (36, 8, 3, 8448) and scan.shape == (36, 8, 128, 64, 128)
    # a preset's random weights: granite's attention has no QK-norm, LFM2's has
    gen = torch.Generator().manual_seed(0)
    assert set(tfm.init_hybrid(gen, got, "cpu")["attn"]) == {"attn_norm", "wqkv", "wo"}
    lfm2 = tfm.init_hybrid(gen, PRESETS["lfm2-tiny"].talker, "cpu")["attn"]
    assert {"q_norm", "k_norm"} <= set(lfm2)
    # the dense and LFM2 presets keep their arithmetic: no multiplier, no Mamba state
    for name in ("1.7B", "lfm2-8b-a1b"):
        t = PRESETS[name].talker
        assert (t.rope, t.attn_scale, t.residual_multiplier, t.embedding_multiplier,
                t.router, t.shared_ffn, t.mamba_layers) == (True, 0.0, 1.0, 1.0, "sigmoid", 0, 0)
        assert tfm.make_ssm_state(t, 1) is None


def _prompt(model, texts):
    arrays, lens, p = model._build_prompt_arrays(texts, SPEAKER, "English", None, None)
    return {k: torch.from_numpy(v) for k, v in arrays.items()}, lens, p


def _program_logits(model, texts, codes, chunk):
    """Per row: the logits of every real prompt position from the prefill,
    then of every step decoded one token at a time through the caches and
    the Mamba states, teacher-forced on ``codes`` ``(B, steps, nq)``, in
    chunks of ``chunk`` steps (each chunk's first step at a cache slot set
    from the host, as ``_decode_chunk`` sets it)."""
    cfg, params = model.config, model.params
    a, lens, p = _prompt(model, texts)
    b, steps = codes.shape[:2]
    ck, cv = tfm.make_kv_cache(cfg.talker, b, p + steps, dtype=torch.float32)
    kv = torch.zeros((b, p + steps), dtype=torch.bool)
    state = tfm.make_ssm_state(cfg.talker, b)
    emb = qmodel.prompt_embeds(params, cfg, a["ids_slotted"], a["text_mask"],
                               a["codes_slotted"], a["code_mask"], a["spk_ids"], a["spk_mask"],
                               a["attn_mask"])
    h, _ = tfm.stack_forward(params["talker"], cfg.talker, qmodel._talker_input(cfg, emb),
                             a["rope_pos"], kv_caches=(ck, cv), cache_len=0,
                             attn_mask=a["attn_mask"], key_valid=kv, fused_prefill=True,
                             ssm_state=state)
    kv[:, :p] = a["attn_mask"]
    out = [[(h[i, p - n:] @ params["lm_head"])] for i, n in enumerate(lens)]
    for t in range(steps - 1):
        slot0 = torch.tensor(p + t - t % chunk)
        e = sum(params["audio_embed"][q][codes[:, t, q]] for q in range(codes.shape[2]))
        pos = torch.tensor(lens)[:, None] + t
        h, _ = tfm.stack_forward(params["talker"], cfg.talker,
                                 qmodel._talker_input(cfg, e[:, None]), pos,
                                 kv_caches=(ck, cv), cache_len=slot0 + t % chunk, key_valid=kv,
                                 uniform_slot=True, ssm_state=state)
        kv[:, p + t] = True
        for i in range(b):
            out[i].append(h[i, -1:] @ params["lm_head"])
    return [torch.cat(rows) for rows in out], lens


def _reference_logits(tree, text, codes, cfg=CFG):
    with ref.run_float32():
        seq = torch.cat([ref.base.prompt_embeds(tree, cfg, text, SPEAKER),
                         ref.base.code_embeds(tree, codes[:-1])])
        return ref.talker_hidden(tree, cfg, [seq])[0] @ tree["lm_head"]


def _codes(b, steps, seed=0):
    return torch.randint(0, 64, (b, steps, 2), generator=torch.Generator().manual_seed(seed))


def test_prefill_then_two_chunks_of_decode_match_the_full_forward(model, tree):
    codes = _codes(1, 9)
    got, lens = _program_logits(model, [TEXT], codes, chunk=4)
    assert lens[0] > 2 * PRESETS["granite-tiny"].talker.ssm_chunk  # the scan crosses chunks
    want = _reference_logits(tree, TEXT, codes[0])
    assert got[0].shape == want.shape == (lens[0] + 8, 67)
    torch.testing.assert_close(got[0], want, rtol=TOL, atol=TOL)


def test_rows_left_padded_to_different_lengths_in_one_batch(model, tree):
    texts = ["Hi.", TEXT, "A third row, which is the longest of the three by far."]
    codes = _codes(3, 6, seed=1)
    got, lens = _program_logits(model, texts, codes, chunk=3)
    assert len(set(lens)) == 3
    for i, text in enumerate(texts):
        torch.testing.assert_close(got[i], _reference_logits(tree, text, codes[i]),
                                   rtol=TOL, atol=TOL)


def _scan_inputs(b, t, seed):
    """Random ``in_proj`` outputs ``(b, t, W)`` of the tiny Mamba layer, in f32."""
    cfg = PRESETS["granite-tiny"].talker
    width = 2 * cfg.ssm_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    return torch.randn((b, t, width), generator=torch.Generator().manual_seed(seed))


def test_the_chunked_scan_and_the_decode_step_are_the_recurrence(tree):
    """From a nonzero state: a prefill of 21 positions (three chunks of 8,
    the last ragged, a left pad in one row), then five decode steps through
    ``ssm_step``'s plain version, against the reference's recurrence over
    the 26 positions, output and final states."""
    cfg = PRESETS["granite-tiny"].talker
    p = {k: v[1] for k, v in tree["talker"]["mamba"].items()}
    z = _scan_inputs(2, 26, seed=5)
    valid = torch.ones((2, 26), dtype=torch.bool)
    valid[1, :4] = False
    conv0 = torch.randn((2, 3, cfg.ssm_conv_dim), generator=torch.Generator().manual_seed(6))
    s0 = torch.randn((2, 8, 16, 16), generator=torch.Generator().manual_seed(7)) * 0.1
    conv, scan = conv0.clone(), s0.clone()
    outs = [tfm.ssm_prefill(z[:, :21], conv, scan, p, cfg, valid[:, :21])]
    for t in range(21, 26):
        outs.append(ssm.ssm_step(z[:, t], conv, scan, p["conv_w"], p["conv_b"], p["dt_bias"],
                                 p["A_log"], p["D"])[:, None])
    with ref.run_float32():
        want, state = ref.mamba_scan(_f32(p), CFG, z, valid, conv0, s0)
    got = torch.cat(outs, dim=1)
    torch.testing.assert_close(got[valid], want[valid], rtol=TOL, atol=1e-5)
    torch.testing.assert_close(scan, state, rtol=TOL, atol=1e-5)
    # the convolution's state: the last three inputs to it (xBC before the convolution)
    torch.testing.assert_close(conv, z[:, -3:, cfg.ssm_inner: 2 * cfg.ssm_inner + 32])


def test_left_padding_leaves_the_states_untouched():
    """Positions that ``attn_mask`` marks as padding are no step: the states
    after a padded prefill equal those after the real positions alone."""
    cfg = PRESETS["granite-tiny"].talker
    p = {k: v[0] for k, v in _tree(seed=9)["talker"]["mamba"].items()}
    z = _scan_inputs(1, 19, seed=8)
    states = []
    for pad in (0, 5):
        zp = torch.cat([torch.randn((1, pad, z.shape[-1])), z], dim=1)
        valid = torch.arange(19 + pad)[None] >= pad
        conv, scan = (s[0] for s in tfm.make_ssm_state(cfg, 1))
        y = tfm.ssm_prefill(zp, conv, scan, p, cfg, valid)
        states.append((y[:, pad:], conv, scan))
    for a, b in zip(*states):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_the_routed_experts_take_the_softmax_of_the_top_logits(tree):
    cfg = PRESETS["granite-tiny"].talker
    moe = {k: v[2] for k, v in tree["talker"]["moe"].items()}
    h = torch.randn((7, 64), generator=torch.Generator().manual_seed(3))
    idx, w = tfm.route_experts(h, moe["router"], None, cfg)
    logits = h @ moe["router"]
    top = logits.topk(3, dim=-1)
    assert torch.equal(idx, top.indices)
    torch.testing.assert_close(w, torch.softmax(top.values, dim=-1))
    torch.testing.assert_close(w.sum(-1), torch.ones(7))
    with ref.run_float32():
        ref_idx, ref_w = ref.route(moe, CFG, h)
    assert torch.equal(idx, ref_idx)
    torch.testing.assert_close(w, ref_w)


def test_the_expert_layer_is_routed_plus_shared(tree):
    """The layer's delta is the routed experts' mix plus the shared SwiGLU on
    the same normed input, each as the reference computes it; without the
    shared expert the delta differs by exactly it."""
    cfg = PRESETS["granite-tiny"].talker
    moe = {k: v[4] for k, v in tree["talker"]["moe"].items()}
    x = torch.randn((2, 5, 64), generator=torch.Generator().manual_seed(4))
    _, delta = tfm._moe_block(moe, cfg, x, None, None)
    h = tfm.rms_norm(x, moe["mlp_norm"], cfg.rms_eps).reshape(10, 64)
    with ref.run_float32():
        want = ref._ffn(moe, CFG, h[None])[0]
        shared = ref._swiglu(h, moe["shared_w_gate"], moe["shared_w_up"], moe["shared_w_down"])
    torch.testing.assert_close(delta.reshape(10, 64), want, rtol=TOL, atol=1e-6)
    _, routed = tfm._moe_block(moe, dataclasses.replace(cfg, shared_ffn=0), x, None, None)
    torch.testing.assert_close(delta - routed, shared.view(2, 5, 64), rtol=TOL, atol=1e-6)


#: each multiplier: the program's field, its neutral value there (the default
#: scale: 1 / sqrt(head_dim)), the reference's key and the value it then means
MULTIPLIERS = {
    "residual": ("residual_multiplier", 1.0, "residual_multiplier", 1.0),
    "embedding": ("embedding_multiplier", 1.0, "embedding_multiplier", 1.0),
    "attention-scale": ("attn_scale", 0.0, "attention_multiplier", 1 / math.sqrt(16)),
}


@pytest.mark.parametrize("which", list(MULTIPLIERS))
def test_each_multiplier_matters(tree, which):
    """The program with one multiplier left at its neutral value no longer
    agrees with the reference, which applies it; the reference without it
    agrees again."""
    field, neutral, key, plain = MULTIPLIERS[which]
    codes = _codes(1, 5, seed=2)
    talker = dataclasses.replace(PRESETS["granite-tiny"].talker, **{field: neutral})
    cfg = dataclasses.replace(PRESETS["granite-tiny"], talker=talker)
    got = _program_logits(QwenTTSModel(cfg, params=tree, device="cpu"), [TEXT], codes, 2)[0][0]
    assert not torch.allclose(got, _reference_logits(tree, TEXT, codes[0]), rtol=TOL, atol=TOL)
    without = dict(CFG, **{key: plain})
    torch.testing.assert_close(got, _reference_logits(tree, TEXT, codes[0], without),
                               rtol=TOL, atol=TOL)


def test_greedy_codes_are_the_references_argmax_chain(monkeypatch, model, tree):
    """Greedy (top_k 1) codes over f32 caches, across three decode chunks:
    at every frame the served primary and residual codes are the
    reference's argmax given the frames before, so the two chains are one."""
    monkeypatch.setattr(tfm, "kv_cache_dtype", lambda *a: torch.float32)
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    codes = model.generate_codes([TEXT], speaker=SPEAKER, min_frames=24, max_frames=24,
                                 top_k=1, seeds=[3])[0]
    assert codes.shape == (25, 2)  # the prompt's frame and three chunks of 8
    with ref.run_float32():
        g = ref.served_gaps(tree, CFG, [{"text": TEXT, "speaker": SPEAKER,
                                         "codes": torch.from_numpy(codes),
                                         "judge_primary": True}], 24)[0]
    assert g["primary_tokens"] == 25 and g["residual_tokens"] == 24
    assert g["primary_gap"] == 0.0 and g["residual_gap"] == 0.0


def test_spans_carry_the_distinct_experts_and_the_scan_chunks(monkeypatch, model):
    from rho_tts_tpu_torch.utils import profiling

    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    profiling.reset()
    model.synthesize(["one row", "and another"], speaker=SPEAKER, min_frames=16, max_frames=16,
                     seeds=[1, 2])
    chunks = [s for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
    assert len(chunks) == 2
    for s in chunks:
        touched = np.asarray(s["attrs"]["experts_touched"])
        assert touched.shape == (8, 6)  # steps x expert layers (every layer)
        assert (touched >= 3).all() and (touched <= 6).all()  # 2 rows x top 3 of 8
    prefill = [s for s in profiling.spans() if s["name"] == "qwen/prefill"]
    assert [s["attrs"]["ssm_chunks"] for s in prefill] == [64 // 8]  # one 64-slot prompt


def _replay_is_the_step(monkeypatch):
    """The CPU stands in for a card: the model hands out graphs, and a
    capture runs the step once and keeps it as the graph, whose replay runs
    it again (as ``test_torch_port_decode_graph.py`` does)."""
    def capture(self, step, leaves, stream):
        step()
        self.graph, self.leaves = types.SimpleNamespace(replay=step), leaves

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    # the process's graph counters, restored after the test: later tests read them
    monkeypatch.setattr(qmodel, "graph_captures", qmodel.graph_captures)
    monkeypatch.setattr(qmodel, "graph_replays", qmodel.graph_replays)
    monkeypatch.setattr(QwenTTSModel, "_graphable", lambda self: True)
    monkeypatch.setattr(qmodel._StepGraph, "capture", capture)
    monkeypatch.setattr(qmodel, "_decode_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)


def test_the_graph_buffers_hold_the_mamba_states_and_give_the_eager_codes(monkeypatch, model):
    """Through a graph's buffers (the Mamba convolution and scan states in
    the arena beside the KV caches, zeroed by each call) a sampled call and
    a stream give the eager loop's codes and audio, and the expert counters
    the eager step's."""
    from rho_tts_tpu_torch.utils import profiling

    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    texts = ["hello there", "a second, longer row"]

    def run():
        profiling.reset()
        waves = model.synthesize(texts, speaker=SPEAKER, min_frames=24, max_frames=24, top_k=8,
                                 seeds=[4, 5])[0]
        again = model.synthesize(texts, speaker=SPEAKER, min_frames=24, max_frames=24, top_k=8,
                                 seeds=[4, 5])[0]
        pieces = [w for w, _ in model.stream_chunks(texts[1], min_frames=24, max_frames=24,
                                                    top_k=8, seed=6)]
        spans = [s["attrs"] for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
        return waves + again, pieces, spans

    eager = run()
    _replay_is_the_step(monkeypatch)
    graphed = run()
    # a call of two rows captures its key, the second replays it; the stream (one row) is
    # another key
    assert [s["graph"] for s in graphed[2]] == (["capture"] + ["replay"] * 5 + ["capture"]
                                                + ["replay"] * 2)
    graphs = model._step_graphs
    graph = graphs._graphs[next(iter(graphs._graphs))]
    t = model.config.talker
    conv, scan = graph.ssm_state
    assert conv.shape == tfm.ssm_conv_shape(t, 2) and scan.shape == tfm.ssm_scan_shape(t, 2)
    assert graph.conv_state is None
    for buf in (conv, scan):
        assert buf.untyped_storage().data_ptr() == graphs._arena.data_ptr()
    for ours, want in list(zip(graphed[0], eager[0])) + list(zip(graphed[1], eager[1])):
        assert torch.equal(ours, want)
    assert [s["experts_touched"] for s in graphed[2]] == [s["experts_touched"] for s in eager[2]]


def _raises(fn):
    with pytest.raises(NotImplementedError, match="state-space"):
        fn()


def test_paths_without_support_raise_naming_the_talker_kind(model):
    from rho_tts_tpu_torch.models.qwen import distill, lora, train
    from rho_tts_tpu_torch.parallel import inference
    from rho_tts_tpu_torch.serving import ServingEngine

    cfg = model.config
    dense = QwenTTSModel(PRESETS["draft"], device="cpu")
    for q in ("int8", "int4"):
        _raises(lambda: QwenTTSModel(cfg, params=model.params, quantization=q, device="cpu"))
    _raises(lambda: ServingEngine(model, n_slots=2))
    _raises(lambda: model.synthesize_speculative(TEXT, dense))
    for enable in (inference.enable_data_parallel, inference.enable_tensor_parallel,
                   inference.enable_sequence_parallel):
        _raises(lambda: enable(model, None))
    _raises(lambda: train.init_train_state(cfg, device="cpu"))
    batch = {"text_ids": torch.zeros((1, 4), dtype=torch.int64),
             "codes": torch.zeros((1, 4, 2), dtype=torch.int64),
             "codes_mask": torch.ones((1, 4), dtype=torch.bool)}
    _raises(lambda: train.loss_and_grads(model.params, cfg, batch))
    _raises(lambda: lora.init_lora(cfg, model.params))
    _raises(lambda: QwenTTSModel(cfg, params=model.params, lora_path="/nonexistent",
                                 device="cpu"))
    _raises(lambda: distill.distill_draft(model, dense, n_texts=2, steps=1))
    with pytest.raises(NotImplementedError, match="Mamba-2"):
        tfm.stack_forward(model.params["talker"], cfg.talker, torch.zeros((1, 2, 64)),
                          torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="needs ssm_state"):
        ck, cv = tfm.make_kv_cache(cfg.talker, 1, 4, dtype=torch.float32)
        tfm.stack_forward(model.params["talker"], cfg.talker, torch.zeros((1, 2, 64)),
                          torch.zeros((1, 2), dtype=torch.int64), kv_caches=(ck, cv),
                          fused_prefill=True)


def test_the_config_refuses_a_mamba_layer_without_its_sizes():
    with pytest.raises(ValueError, match="ssm_heads"):
        tfm.TransformerConfig(hidden=64, layers=2, layer_types=("mamba", "full_attention"))
    with pytest.raises(ValueError, match="router"):
        tfm.TransformerConfig(router="relu")


def test_ssm_step_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks on card-sized inputs that lie on the CPU (the
    device check comes last)."""
    rows, heads, p, n, taps = 2, 4, 64, 128, 4
    di, cd = heads * p, heads * p + 2 * n
    good = dict(zxbcdt=torch.zeros((rows, di + cd + heads), dtype=torch.bfloat16),
                conv_state=torch.zeros((rows, taps - 1, cd)),
                ssm_state=torch.zeros((rows, heads, p, n)),
                conv_w=torch.zeros((cd, taps), dtype=torch.bfloat16),
                conv_b=torch.zeros((cd,), dtype=torch.bfloat16), dt_bias=torch.zeros(heads),
                a_log=torch.zeros(heads), d=torch.zeros(heads))
    with pytest.raises(ValueError, match="CUDA device"):
        ssm._check(**good)
    bad = {
        "zxbcdt-f32": (dict(zxbcdt=good["zxbcdt"].float()), TypeError),
        "state-bf16": (dict(ssm_state=good["ssm_state"].bfloat16()), TypeError),
        "state-64": (dict(ssm_state=torch.zeros((rows, heads, p, 64))), ValueError),
        "taps-5": (dict(conv_w=torch.zeros((cd, 5), dtype=torch.bfloat16)), ValueError),
        "width": (dict(zxbcdt=good["zxbcdt"][:, 1:]), ValueError),
        "conv-strided": (dict(conv_state=torch.zeros((rows, cd, taps - 1)).transpose(1, 2)),
                         ValueError),
    }
    for name, (over, err) in bad.items():
        with pytest.raises(err, match="ssm_step"):
            ssm._check(**dict(good, **over))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


def _mamba_layer(device, seed):
    """One Mamba layer of granite-4.0-h-small's widths: the kernel's
    parameters and a random ``in_proj`` output source."""
    big = PRESETS["granite-4.0-h-small"].talker
    gen = torch.Generator(device="cpu").manual_seed(seed)
    p = {k: v[0].to(device) for k, v in tfm.init_mamba(
        gen, dataclasses.replace(big, layer_types=("mamba",), layers=1, hidden=64), "cpu").items()
        if k in ("conv_w", "conv_b", "dt_bias", "A_log", "D")}
    p["conv_b"] = (torch.randn(p["conv_b"].shape, generator=gen) * 0.1).to(device, torch.bfloat16)
    return big, p, gen


@pytest.mark.chip
@pytest.mark.parametrize("rows", [1, 8, 64])
def test_ssm_step_matches_its_plain_version_at_the_published_widths(cuda_card, rows):
    """128 heads of 64, a state of 128, 4 taps: ten steps from a random state,
    the kernel and the plain version each on its own copy of the states.
    The states' update rounds as the plain version's; the read-out's sum
    over the state runs in another order. Two launches on the same inputs:
    the same bits (the tickets reset themselves)."""
    big, p, gen = _mamba_layer(cuda_card, rows)
    width = 2 * big.ssm_inner + 2 * big.ssm_state + big.ssm_heads
    conv = torch.randn((rows, 3, big.ssm_conv_dim), generator=gen).to(cuda_card)
    scan = (torch.randn((rows, 128, 64, 128), generator=gen) * 0.1).to(cuda_card)
    states = {"kernel": (conv.clone(), scan.clone()), "plain": (conv.clone(), scan.clone())}
    with torch.inference_mode():
        before = ssm.launches
        for step in range(10):
            z = torch.randn((rows, 1, width), generator=gen).to(cuda_card, torch.bfloat16)[:, 0]
            got = ssm.ssm_step(z, *states["kernel"], p["conv_w"], p["conv_b"], p["dt_bias"],
                               p["A_log"], p["D"])
            want = ssm.reference_ssm_step(z, *states["plain"], p["conv_w"], p["conv_b"],
                                          p["dt_bias"], p["A_log"], p["D"])
            torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        c1, s1 = (t.clone() for t in states["kernel"])
        again = ssm.ssm_step(z, c1, s1, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"])
        c2, s2 = (t.clone() for t in states["kernel"])
        once = ssm.ssm_step(z, c2, s2, p["conv_w"], p["conv_b"], p["dt_bias"], p["A_log"], p["D"])
    torch.cuda.synchronize()
    assert ssm.launches - before == 12
    for ours, theirs in zip(states["kernel"], states["plain"]):
        torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-6)
    assert torch.equal(again, once) and torch.equal(c1, c2) and torch.equal(s1, s2)
    print({"rows": rows, "max_out_diff": float((got.float() - want.float()).abs().max()),
           "max_state_diff": float((states["kernel"][1] - states["plain"][1]).abs().max())})


@pytest.mark.chip
@pytest.mark.parametrize("rows", [8, 512])
def test_add_rms_norm_takes_the_gated_norm_and_the_residual_multiplier(cuda_card, rows):
    """Rows of 8,192 (the Mamba gated norm), and a residual add scaled by
    0.22 at 4,096: the residual bit-equal to the plain version, the norm
    within one bf16 unit in the last place; a scale of 1 is the add."""
    from rho_tts_tpu_torch.ops.cuda import add_rms_norm as arn

    gen = torch.Generator(device="cpu").manual_seed(rows)
    for d, scale in ((8192, 1.0), (4096, 0.22)):
        x = torch.randn((rows, d), generator=gen).to(cuda_card, torch.bfloat16)
        delta = torch.randn((rows, d), generator=gen).to(cuda_card, torch.bfloat16)
        w = (1 + 0.1 * torch.randn(d, generator=gen)).to(cuda_card)
        with torch.inference_mode():
            res, out = arn.add_rms_norm(x, delta, w, 1e-5, scale)
            want_res, want = arn.reference_add_rms_norm(x, delta, w, 1e-5, scale)
            if scale == 1.0:
                assert torch.equal(arn.add_rms_norm(x, delta, w, 1e-5)[0], x + delta)
        torch.cuda.synchronize()
        assert torch.equal(res, want_res)
        ulp = (want.float().abs() * 2.0 ** -7).clamp_min(1e-30)
        assert bool(((out.float() - want.float()).abs() <= ulp).all())


@pytest.mark.chip
def test_both_attention_kernels_keep_their_default_scale_bit_for_bit(cuda_card):
    """With no scale, each kernel's bits are those it gives with the scale
    it always computed (1 / sqrtf(head_dim) in f32) passed in; a given scale
    (granite's 1/128) agrees with the plain version."""
    from rho_tts_tpu_torch.ops.cuda import attention as attn
    from rho_tts_tpu_torch.ops.cuda import decode_attention as dec

    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(cuda_card, torch.bfloat16)

    d = 128
    default = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    q, k, v = rnd(8, 64, 32, d), rnd(8, 64, 8, d), rnd(8, 64, 8, d)
    mask = torch.ones((8, 64), dtype=torch.bool, device=cuda_card)
    mask[3, :10] = False
    qd, kc, vc = rnd(8, 1, 32, d), rnd(8, 320, 8, d), rnd(8, 320, 8, d)
    dmask = torch.rand((8, 320), generator=gen).to(cuda_card) > 0.2
    with torch.inference_mode():
        assert torch.equal(attn.fused_gqa_attention(q, k, v, mask),
                           attn.fused_gqa_attention(q, k, v, mask, scale=default))
        assert torch.equal(dec.decode_gqa_attention(qd, kc, vc, dmask),
                           dec.decode_gqa_attention(qd, kc, vc, dmask, scale=default))
        got = attn.fused_gqa_attention(q, k, v, mask, scale=1 / 128)
        want = attn.reference_gqa_attention(q, k, v, mask, scale=1 / 128)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
        got = dec.decode_gqa_attention(qd, kc, vc, dmask, scale=1 / 128)
        want = dec.reference_decode_attention(qd, kc, vc, dmask, scale=1 / 128)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.chip
def test_the_granite_step_replays_bit_for_bit(cuda_card):
    """``granite-4.0-h-small`` (the benchmark's weights from a seed, bf16,
    64 GB on the card once) at the benchmark cell's shape, 8 rows of 120-220
    characters pinned to 192 frames: the first call of the key captures
    once, every later chunk replays, and the codes, the waveforms and the
    expert counts equal the same step run eagerly; 36 ``ssm_step`` launches
    a step."""
    from rho_tts_tpu_torch.utils import profiling

    words = "a quiet river carries the morning light past the old stone mill and on".split()
    texts = [" ".join(words[(i + j) % len(words)] for j in range(60))[:n]
             for i, n in enumerate(np.round(np.linspace(120, 220, 8)).astype(int))]
    model = granite.build_model(registry.load_config("granite-4.0-h-small-tts-bf16"), 3,
                                cuda_card)

    def call(temperature):
        got = []
        generate = model._generate_codes_arrays

        def keep(*args, **kwargs):
            out = generate(*args, **kwargs)
            got.append(out[0].clone())
            return out

        model._generate_codes_arrays = keep
        profiling.reset()
        try:
            waves, _ = model.synthesize(texts, speaker="Vivian", min_frames=192, max_frames=192,
                                        temperature=temperature, top_k=50, seeds=list(range(8)))
        finally:
            del model._generate_codes_arrays
        torch.cuda.synchronize()
        chunks = [s["attrs"] for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
        return got[0], waves, chunks

    captures, launches = qmodel.graph_captures, ssm.launches
    warm = call(0.0)
    assert qmodel.graph_captures - captures == 1
    sampled = call(0.9)
    assert qmodel.graph_captures - captures == 1
    assert [c["graph"] for c in sampled[2]] == ["replay"] * 3
    assert ssm.launches - launches == 36  # the capture's eager first step
    model._step_graphs.acquire = lambda *args: None
    eager_greedy, eager_sampled = call(0.0), call(0.9)
    assert [c["graph"] for c in eager_sampled[2]] == ["eager"] * 3
    assert ssm.launches - launches == 36 + 2 * 36 * 192  # three chunks of 64 steps a call
    for ours, want in ((warm, eager_greedy), (sampled, eager_sampled)):
        assert torch.equal(ours[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(ours[1], want[1]))
        assert [c["experts_touched"] for c in ours[2]] == [c["experts_touched"] for c in want[2]]
    touched = np.asarray([c["experts_touched"] for c in sampled[2]])
    print({"experts_touched_mean_by_layer": touched.mean(axis=(0, 1)).round(2).tolist(),
           "memory_peak_bytes": torch.cuda.max_memory_allocated()})
    assert touched.shape == (3, 64, 40) and touched.min() >= 10 and touched.max() <= 72
