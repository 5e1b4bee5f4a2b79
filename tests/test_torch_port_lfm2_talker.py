"""The hybrid talker (LFM2-MoE: short convolutions beside GQA attention,
routed experts) against the benchmark's plain float32 reference
(``benchmark/reference/lfm2_talker.py``).

On the CPU, at the ``lfm2-tiny`` sizes in float32 (KV caches too): the
prefill's logits at every prompt position, then decoding through the KV
cache and the short-convolution state across two chunks, against the
reference's full forward; rows left-padded to different lengths in one
batch; routing with a nonzero expert bias; the experts kernel's plain
version against the reference's experts; greedy codes against the
reference's argmax chain; the decode step through a graph's buffers (a
replay standing for the step) against the eager step; and every path that
does not support such a talker raising ``NotImplementedError``.

On the card (``-m chip``; skipped without one): the experts kernel against
its plain version at 1, 8, 64 and 200 rows (two windows of its scan) with
the weights of every expert no row chose set to NaN, and its chosen-expert
flags, and the hybrid decode step of ``lfm2-8b-a1b`` replayed
as a CUDA graph, bit for bit against the eager step, one capture a key. Run
on the card with ``python -m pytest tests/test_torch_port_lfm2_talker.py -m chip -s``.
"""

import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import lfm2  # noqa: E402
from benchmark.reference import lfm2_talker as ref  # noqa: E402
from rho_tts_tpu_torch.models import transformer as tfm  # noqa: E402
from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel  # noqa: E402
from rho_tts_tpu_torch.models.qwen import model as qmodel  # noqa: E402
from rho_tts_tpu_torch.ops.cuda import moe_experts  # noqa: E402

torch.set_num_threads(1)  # several test workers share the cores

TEXT, SPEAKER = "A short line to speak.", "Vivian"
TOL = 1e-4  # float32 on both sides: sums taken in another order

#: ``lfm2-tiny`` in the benchmark's terms (the published config's keys)
CFG = {
    "name": "lfm2-tiny", "hidden_size": 64, "num_hidden_layers": 6,
    "layer_types": ["conv", "conv", "full_attention", "conv", "full_attention", "conv"],
    "num_attention_heads": 4, "num_key_value_heads": 2, "intermediate_size": 128,
    "moe_intermediate_size": 32, "num_experts": 8, "num_experts_per_tok": 3,
    "num_dense_layers": 2, "conv_L_cache": 3, "conv_bias": False, "norm_eps": 1e-5,
    "rope_theta": 1000000, "norm_topk_prob": True, "routed_scaling_factor": 1,
    "use_expert_bias": True, "text_vocab": 512, "n_speakers": 16, "code_predictor_hidden": 32,
    "codec": {"sample_rate": 24000, "upsample_rates": [4, 2], "n_codebooks": 2,
              "codebook_size": 64, "codebook_dim": 32, "decoder_channels": [32, 16, 8],
              "encoder_channels": [8, 16, 32], "resblock_dilations": [1, 3, 9]},
}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _tree(seed=1234):
    """The benchmark's weights from ``seed`` in float32 (an expert bias of
    N(0, 0.05))."""
    return _f32(lfm2.make_params(CFG, seed, "cpu"))


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def model(tree):
    return QwenTTSModel(lfm2.program_config(CFG), params=tree, device="cpu")


def test_the_tiny_preset_is_the_configuration_the_tests_use():
    got, want = PRESETS["lfm2-tiny"].talker, lfm2.program_config(CFG).talker
    assert got == want
    assert (got.attn_layers, got.conv_layers, got.moe_layers) == (2, 4, 4)
    big = PRESETS["lfm2-8b-a1b"].talker
    assert (big.attn_layers, big.conv_layers, big.moe_layers, big.head_dim) == (6, 18, 22, 64)
    assert [i for i, k in enumerate(big.schedule) if k != "conv"] == [2, 6, 10, 14, 18, 21]
    # the dense presets keep one kind of layer and their caches
    dense = PRESETS["1.7B"].talker
    assert not dense.hybrid and dense.attn_layers == dense.layers == 28
    assert tfm.make_kv_cache(dense, 1, 4)[0].shape == (28, 1, 4, 8, 128)
    assert tfm.make_conv_state(dense, 1) is None


def _prompt(model, texts):
    arrays, lens, p = model._build_prompt_arrays(texts, SPEAKER, "English", None, None)
    return {k: torch.from_numpy(v) for k, v in arrays.items()}, lens, p


def _caches(cfg, b, s):
    ck, cv = tfm.make_kv_cache(cfg.talker, b, s, dtype=torch.float32)
    return ck, cv, torch.zeros((b, s), dtype=torch.bool), tfm.make_conv_state(cfg.talker, b)


def _program_logits(model, texts, codes, chunk):
    """Per row: the logits of every real prompt position from the prefill,
    then of every step decoded one token at a time through the caches,
    teacher-forced on ``codes`` ``(B, steps, nq)``, in chunks of ``chunk``
    steps (each chunk's first step at a cache slot set from the host, as
    ``_decode_chunk`` sets it)."""
    cfg, params = model.config, model.params
    a, lens, p = _prompt(model, texts)
    b, steps = codes.shape[:2]
    ck, cv, kv, conv = _caches(cfg, b, p + steps)
    emb = qmodel.prompt_embeds(params, cfg, a["ids_slotted"], a["text_mask"],
                               a["codes_slotted"], a["code_mask"], a["spk_ids"], a["spk_mask"],
                               a["attn_mask"])
    h, _ = tfm.stack_forward(params["talker"], cfg.talker, emb, a["rope_pos"], kv_caches=(ck, cv),
                             cache_len=0, attn_mask=a["attn_mask"], key_valid=kv,
                             fused_prefill=True, conv_state=conv)
    kv[:, :p] = a["attn_mask"]
    out = [[(h[i, p - n:] @ params["lm_head"])] for i, n in enumerate(lens)]
    for t in range(steps - 1):
        slot0 = torch.tensor(p + t - t % chunk)
        e = sum(params["audio_embed"][q][codes[:, t, q]] for q in range(codes.shape[2]))
        pos = torch.tensor(lens)[:, None] + t
        h, _ = tfm.stack_forward(params["talker"], cfg.talker, e[:, None], pos,
                                 kv_caches=(ck, cv), cache_len=slot0 + t % chunk, key_valid=kv,
                                 uniform_slot=True, conv_state=conv)
        kv[:, p + t] = True
        for i in range(b):
            out[i].append(h[i, -1:] @ params["lm_head"])
    return [torch.cat(rows) for rows in out], lens


def _reference_logits(tree, text, codes):
    with ref.run_float32():
        seq = torch.cat([ref.base.prompt_embeds(tree, CFG, text, SPEAKER),
                         ref.base.code_embeds(tree, codes[:-1])])
        return ref.talker_hidden(tree, CFG, seq) @ tree["lm_head"]


def _codes(b, steps, seed=0):
    return torch.randint(0, 64, (b, steps, 2), generator=torch.Generator().manual_seed(seed))


def test_prefill_then_two_chunks_of_decode_match_the_full_forward(model, tree):
    codes = _codes(1, 9)
    got, lens = _program_logits(model, [TEXT], codes, chunk=4)
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


def test_routing_follows_the_expert_bias():
    """The bias moves the choice, not the weights: a large bias on one expert
    makes every token choose it, its weight still the sigmoid's share, and
    the forward still matches the reference's."""
    cfg = lfm2.program_config(CFG).talker
    biased = _tree(seed=5)
    moe = biased["talker"]["moe"]
    moe["expert_bias"].zero_()
    moe["expert_bias"][:, 5] = 10.0
    h = torch.randn((7, 64), generator=torch.Generator().manual_seed(3))
    idx, w = tfm.route_experts(h, moe["router"][0], moe["expert_bias"][0], cfg)
    assert (idx == 5).any(dim=1).all()
    s = torch.sigmoid(h @ moe["router"][0])
    torch.testing.assert_close(w, s.gather(1, idx) / (s.gather(1, idx).sum(1, keepdim=True)
                                                      + 1e-6))
    unbiased = tfm.route_experts(h, moe["router"][0], torch.zeros(8), cfg)[0]
    assert not torch.equal(idx, unbiased)
    m = QwenTTSModel(lfm2.program_config(CFG), params=biased, device="cpu")
    codes = _codes(1, 5, seed=2)
    got, _ = _program_logits(m, [TEXT], codes, chunk=2)
    torch.testing.assert_close(got[0], _reference_logits(biased, TEXT, codes[0]),
                               rtol=TOL, atol=TOL)


def test_the_kernels_plain_version_is_the_reference_moe(tree):
    moe = {k: v[1] for k, v in tree["talker"]["moe"].items()}
    h = torch.randn((11, 64), generator=torch.Generator().manual_seed(4))
    cfg = lfm2.program_config(CFG).talker
    idx, w = tfm.route_experts(h, moe["router"], moe["expert_bias"], cfg)
    got = moe_experts.moe_experts(h, idx, w, moe["w_gate"], moe["w_up"], moe["w_down"])
    with ref.run_float32():
        want = ref._experts(moe, CFG, h)
    torch.testing.assert_close(got, want, rtol=TOL, atol=1e-6)


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
        g = ref.served_gaps(tree, CFG, TEXT, SPEAKER, torch.from_numpy(codes), 24, True)
    assert g["primary_tokens"] == 25 and g["residual_tokens"] == 24
    assert g["primary_gap"] == 0.0 and g["residual_gap"] == 0.0


def test_spans_carry_the_distinct_experts_of_each_step(monkeypatch, model):
    from rho_tts_tpu_torch.utils import profiling

    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    profiling.reset()
    model.synthesize(["one row", "and another"], speaker=SPEAKER, min_frames=16, max_frames=16,
                     seeds=[1, 2])
    chunks = [s for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
    assert len(chunks) == 2
    for s in chunks:
        touched = np.asarray(s["attrs"]["experts_touched"])
        assert touched.shape == (8, 4)  # steps x expert layers
        assert (touched >= 3).all() and (touched <= 6).all()  # 2 rows x top 3 of 8


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


def test_the_graph_buffers_hold_the_conv_state_and_give_the_eager_codes(monkeypatch, model):
    """Through a graph's buffers (the short-convolution state in the arena
    beside the KV caches) a sampled call and a stream give the eager loop's
    codes and audio, and the expert counters the eager step's."""
    from rho_tts_tpu_torch.utils import profiling

    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    texts = ["hello there", "a second, longer row"]

    def run():
        profiling.reset()
        waves = model.synthesize(texts, speaker=SPEAKER, min_frames=12, max_frames=24, top_k=8,
                                 seeds=[4, 5])[0]
        pieces = [w for w, _ in model.stream_chunks(texts[1], min_frames=12, max_frames=24,
                                                    top_k=8, seed=6)]
        spans = [s["attrs"] for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
        return waves, pieces, spans

    eager = run()
    _replay_is_the_step(monkeypatch)
    graphed = run()
    assert [s["graph"] for s in graphed[2]] == ["capture", "replay", "replay"] * 2
    graph = model._step_graphs._graphs[next(iter(model._step_graphs._graphs))]
    t = model.config.talker
    assert graph.conv_state.shape == (t.conv_layers, 2, tfm.CONV_TAPS - 1, t.hidden)
    assert graph.conv_state.untyped_storage().data_ptr() == model._step_graphs._arena.data_ptr()
    for ours, want in list(zip(graphed[0], eager[0])) + list(zip(graphed[1], eager[1])):
        assert torch.equal(ours, want)
    assert [s["experts_touched"] for s in graphed[2]] == [s["experts_touched"] for s in eager[2]]


def _raises(fn):
    with pytest.raises(NotImplementedError,
                       match="short-convolution, state-space or expert layers"):
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
    with pytest.raises(NotImplementedError, match="hybrid"):
        tfm.stack_forward(model.params["talker"], cfg.talker, torch.zeros((1, 2, 64)),
                          torch.zeros((1, 2), dtype=torch.int64))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("rows", [1, 8, 64, 200])
def test_the_experts_kernel_matches_its_plain_version_and_reads_no_untouched_expert(
        cuda_card, rows):
    """LFM2-8B-A1B's expert layer (H 2048, 32 experts of 1792, top 4) in
    bf16: every expert no row chose holds NaN, so a read of one would show
    in the output. Launched twice: the same bits. The flags of the chosen
    experts are written for every expert, over a buffer of -1."""
    gen = torch.Generator(device=cuda_card).manual_seed(rows)
    e, h, f, k = 32, 2048, 1792, 4

    def w(*shape, scale):
        return (torch.randn(shape, generator=gen, device=cuda_card) * scale).to(torch.bfloat16)

    w_gate, w_up = w(e, h, f, scale=h ** -0.5), w(e, h, f, scale=h ** -0.5)
    w_down = w(e, f, h, scale=f ** -0.5)
    x = w(rows, h, scale=1.0)
    # a skewed choice: rows pick among experts 0-13 only
    scores = torch.rand((rows, 14), generator=gen, device=cuda_card)
    weight, idx = torch.topk(scores, k, dim=-1)
    weight = (weight / weight.sum(-1, keepdim=True)).float().contiguous()
    untouched = torch.ones(e, dtype=torch.bool, device=cuda_card)
    untouched[idx.reshape(-1)] = False
    assert untouched.sum() >= 18
    for t in (w_gate, w_up, w_down):
        t[untouched] = float("nan")
    touched = torch.full((e,), -1, dtype=torch.int32, device=cuda_card)
    with torch.inference_mode():
        before = moe_experts.launches
        got = moe_experts.moe_experts(x, idx, weight, w_gate, w_up, w_down, touched)
        again = moe_experts.moe_experts(x, idx, weight, w_gate, w_up, w_down)
        want = moe_experts.grouped_experts(x, idx, weight, w_gate, w_up, w_down)
    torch.cuda.synchronize()
    assert moe_experts.launches - before == 4
    assert torch.isfinite(got).all() and torch.equal(got, again)
    assert torch.equal(touched, (~untouched).int())
    # bf16 gate/up products rounded before SiLU in the plain version, not in the kernel
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2 * float(want.abs().max()))


@pytest.mark.chip
def test_the_hybrid_step_replays_bit_for_bit(cuda_card):
    """``lfm2-8b-a1b`` (random weights, bf16) at the benchmark cell's shape,
    8 rows of 120-220 characters pinned to 192 frames: the first call of
    the key captures once, every later chunk replays, and the codes, the
    waveforms and the expert counts equal the same step run eagerly."""
    from rho_tts_tpu_torch.utils import profiling

    words = "a quiet river carries the morning light past the old stone mill and on".split()
    texts = [" ".join(words[(i + j) % len(words)] for j in range(60))[:n]
             for i, n in enumerate(np.round(np.linspace(120, 220, 8)).astype(int))]
    model = QwenTTSModel(PRESETS["lfm2-8b-a1b"], seed=3, device=cuda_card)

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

    captures, launches = qmodel.graph_captures, moe_experts.launches
    warm = call(0.0)
    assert qmodel.graph_captures - captures == 1
    sampled = call(0.9)
    assert qmodel.graph_captures - captures == 1
    assert [c["graph"] for c in sampled[2]] == ["replay"] * 3
    assert moe_experts.launches - launches == 2 * 22  # the capture's eager first step
    model._step_graphs.acquire = lambda *args: None
    eager_greedy, eager_sampled = call(0.0), call(0.9)
    assert [c["graph"] for c in eager_sampled[2]] == ["eager"] * 3
    for ours, want in ((warm, eager_greedy), (sampled, eager_sampled)):
        assert torch.equal(ours[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(ours[1], want[1]))
        assert [c["experts_touched"] for c in ours[2]] == [c["experts_touched"] for c in want[2]]
    touched = np.asarray([c["experts_touched"] for c in sampled[2]])
    print({"experts_touched_mean_by_layer": touched.mean(axis=(0, 1)).round(2).tolist()})
    assert touched.shape == (3, 64, 22) and touched.min() >= 4 and touched.max() <= 32
