"""The hybrid talker's configuration (``lfm2-8b-a1b-tts-bf16``) in the benchmark:
its weights and control, the reference against the program in float32,
``roofline_hybrid.py`` against counts by hand, and the cell run whole on the
CPU at a small size, ``correct`` for the program and refused for the control
and for planted faults."""

from __future__ import annotations

import copy
import math
import time

import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from test_bench_run import _fault

from benchmark import lfm2, registry, roofline, roofline_hybrid, run
from benchmark.reference import lfm2_talker as ref

CELL = "lfm2-8b-a1b-tts-bf16.batch8"
FULL = registry.load_config("lfm2-8b-a1b-tts-bf16")
SEED = 2**31 + 77
#: the configuration at a CPU size: its keys as published, smaller widths,
#: one period of the layer pattern, the program's ``tiny`` codec
TINY = dict(
    FULL, hidden_size=256, num_attention_heads=4, num_key_value_heads=2, intermediate_size=512,
    moe_intermediate_size=128, num_experts=8, num_experts_per_tok=3, num_hidden_layers=6,
    layer_types=["conv", "conv", "full_attention", "conv", "full_attention", "conv"],
    num_dense_layers=2, text_vocab=512, code_predictor_hidden=128,
    codec={"sample_rate": 24000, "upsample_rates": [4, 2], "n_codebooks": 2,
           "codebook_size": 64, "codebook_dim": 32, "decoder_channels": [32, 16, 8],
           "encoder_channels": [8, 16, 32], "resblock_dilations": [1, 3, 9]})
SECONDS = 4.0


def _resolved():
    resolved = registry.resolve(CELL)
    cell = copy.deepcopy(resolved["cell"])
    cell["traffic"]["params"].update(batch=2, frames=64, chars=[20, 40])
    resolved["cell"], resolved["config"] = cell, dict(TINY)
    return resolved


def _run(trace=False, **kw):
    return run.run_cell(_resolved(), SEED, SECONDS, trace, "cpu", time.time(), **kw)[0]


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def test_the_configuration_is_the_programs_preset():
    from rho_tts_tpu_torch.models.qwen import PRESETS

    program = lfm2.program_config(FULL)
    assert program.talker == PRESETS["lfm2-8b-a1b"].talker
    assert program.text_vocab == PRESETS["lfm2-8b-a1b"].text_vocab == FULL["vocab_size"]
    assert FULL["reduced"] == [] and FULL["quantization"] == "none"
    z = lfm2.sizes(FULL)
    assert (z["attn"], z["conv"], z["dense"], z["moe"], z["head_dim"]) == (6, 18, 2, 22, 64)


def test_weights_are_the_same_for_the_same_seed_and_the_control_rounds_the_talker():
    a, b = lfm2.make_params(TINY, 2**33 + 1, "cpu"), lfm2.make_params(TINY, 2**33 + 1, "cpu")
    c = lfm2.make_params(TINY, 2**33 + 1, "cpu", control=True)
    moe = a["talker"]["moe"]
    assert torch.equal(moe["w_down"], b["talker"]["moe"]["w_down"])
    assert moe["w_gate"].dtype == torch.bfloat16 and moe["expert_bias"].dtype == torch.float32
    assert moe["expert_bias"].abs().max() > 0
    for kind, name in (("moe", "w_up"), ("moe", "router"), ("conv", "in_proj"), ("attn", "wo"),
                       ("ffn", "w_down")):
        w, wc = a["talker"][kind][name].float(), c["talker"][kind][name].float()
        assert not torch.equal(w, wc)
        # one float8 scale an output channel: every value a float8 number times it
        scale = w.abs().amax(dim=-2, keepdim=True) / 448.0
        q = wc / scale
        torch.testing.assert_close(q.to(torch.float8_e4m3fn).float(), q, rtol=1e-2, atol=1e-2)
    for kind, name in (("conv", "conv_w"), ("moe", "expert_bias"), ("attn", "q_norm")):
        assert torch.equal(a["talker"][kind][name], c["talker"][kind][name])
    assert torch.equal(a["lm_head"], c["lm_head"])


def test_the_reference_against_the_program_in_float32():
    """Prefill and three cached decode steps of the program (float32 weights
    and caches) against one causal forward of the reference."""
    from rho_tts_tpu_torch.models import transformer as tfm
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel, _prefill

    tree = _f32(lfm2.make_params(TINY, 1234, "cpu"))
    model = QwenTTSModel(lfm2.program_config(TINY), params=tree, device="cpu")
    text, speaker = "A short line to speak.", "Vivian"
    arrays, lens, p = model._build_prompt_arrays([text], speaker, "English", None, None)
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    steps, cfg = 4, model.config
    ck, cv = tfm.make_kv_cache(cfg.talker, 1, p + steps, dtype=torch.float32)
    kv = torch.zeros((1, p + steps), dtype=torch.bool)
    conv = tfm.make_conv_state(cfg.talker, 1)
    logits, ck, cv, kv = _prefill(tree, cfg, a["ids_slotted"], a["text_mask"], a["codes_slotted"],
                                  a["code_mask"], a["spk_ids"], a["spk_mask"], a["rope_pos"],
                                  a["attn_mask"], ck, cv, kv, conv_state=conv)
    codes = torch.randint(0, 64, (steps, 2), generator=torch.Generator().manual_seed(0))
    got = [logits[0]]
    for t in range(steps - 1):
        emb = tree["audio_embed"][0][codes[t:t + 1, 0]] + tree["audio_embed"][1][codes[t:t + 1, 1]]
        h, _ = tfm.stack_forward(tree["talker"], cfg.talker, emb[:, None, :],
                                 torch.tensor([[lens[0] + t]]), kv_caches=(ck, cv),
                                 cache_len=p + t, key_valid=kv, conv_state=conv)
        kv[:, p + t] = True
        got.append((h[:, -1] @ tree["lm_head"])[0])
    with ref.run_float32():
        seq = torch.cat([ref.base.prompt_embeds(tree, TINY, text, speaker),
                         ref.base.code_embeds(tree, codes[:-1])])
        want = ref.talker_hidden(tree, TINY, seq)[lens[0] - 1:] @ tree["lm_head"]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_roofline_hybrid_against_counts_by_hand():
    # per row: 18 short convolutions (in 2048 x 6144, out 2048 x 2048), 6 attention
    # layers (qkv 2048 x (32 + 16) x 64, o 2048 x 2048), 2 dense SwiGLUs of 7168,
    # 22 expert layers (router 2048 x 32, 4 experts of 3 x 2048 x 1792)
    assert roofline_hybrid.row_matmul_params(FULL) == (
        18 * 4 * 2048 * 2048 + 6 * (2048 * 3072 + 2048 * 2048) + 2 * 3 * 2048 * 7168
        + 22 * (2048 * 32 + 4 * 3 * 2048 * 1792))
    assert roofline_hybrid.row_matmul_params(FULL) == 1_423_310_848
    heads = 2048 * 2051 + 15 * (4096 * 1024 + 1024 * 2048)
    assert roofline_hybrid.head_params(FULL) == heads
    assert roofline_hybrid.decode_row_flops(FULL) == 2 * (1_423_310_848 + heads) + 2 * 18 * 3 * 2048
    # attention over the 6 attention layers at head_dim 64
    att = roofline_hybrid.attention_config(FULL)
    assert att == {"talker": {"layers": 6, "q_heads": 32, "kv_heads": 8, "head_dim": 64}}
    assert roofline_hybrid.decode_step_flops(FULL, [300] * 8) == 8 * (
        roofline_hybrid.decode_row_flops(FULL) + 4 * 6 * 32 * 64 * 300)
    n_bytes, ops = roofline.decode_attention_work(att, [100], 512)
    assert n_bytes == 2 * 32 * 64 * 2 + 512 + 2 * 100 * 8 * 64 * 2 and ops == 4 * 100 * 32 * 64
    # the experts kernel: 8 rows that chose 21 experts (32 slots)
    n_bytes, ops = roofline_hybrid.expert_work(FULL, 8, 21)
    assert n_bytes == (21 * 3 * 2048 * 1792 * 2 + 8 * 2048 * 2 + 2 * 32 * 1792 * 2
                       + 32 * 2048 * 4 + 32 * 12)
    assert ops == 2 * 32 * 3 * 2048 * 1792
    assert roofline.bound_s(n_bytes, ops)[1] == "bytes"
    # the talker's matmul weights: experts 7.751 G of 8.205 G
    sizes = {path[1]: 0 for path, _, _ in lfm2.talker_layout(FULL)}
    for path, shape, _ in lfm2.talker_layout(FULL):
        sizes[path[1]] += math.prod(shape)
    assert sizes["moe"] == 22 * 32 * 3 * 2048 * 1792 + 22 * 2048 * 32
    assert sum(sizes.values()) == 8_205_500_416


def test_the_traced_chunk_counts_the_experts_the_program_ran():
    gen = registry.load_generator("closed_batch_lfm2")
    st = {"what": "decode_chunk", "steps": 2, "row_keys0": [150, 160], "cache_len": 448}
    out = gen.stretch_work(FULL, dict(st), [[5] * 22, [7] * 22])
    assert out["attention_calls"] == 2 * 6 and out["expert_calls"] == 44
    assert out["expert_bytes"] == 22 * (roofline_hybrid.expert_work(FULL, 2, 5)[0]
                                        + roofline_hybrid.expert_work(FULL, 2, 7)[0])
    assert "expert_bytes" not in gen.stretch_work(FULL, dict(st), None)


def test_the_cell_runs_whole_on_the_cpu():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(r["checks"]) == {"primary_gap_mean", "residual_gap_mean", "waveform_rel_err",
                                "expert_rel_err"}
    traced = _run(trace=True)
    assert {"busy_s", "window_s"} <= set(traced["device"]) and "breakdown" in traced


def test_the_control_is_not_correct():
    """The talker's weights in float8, the reference's vocoder in float8."""
    r = _run(control=True)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("what", ["token", "residual", "waveform", "half_batch"])
def test_a_fault_makes_the_run_incorrect(monkeypatch, what):
    _fault(monkeypatch, CELL, what)
    assert _run()["correct"] is False


def test_a_fault_in_one_expert_slot_makes_the_run_incorrect(monkeypatch):
    """Each decode step's first row loses its last expert: the expert layers
    held on their own inputs refuse it."""
    from rho_tts_tpu_torch.models import transformer as tfm

    kernel = tfm.moe_experts

    def dropped(h, idx, weight, *rest):
        weight = weight.clone()
        weight[0, -1] = 0.0
        return kernel(h, idx, weight, *rest)

    monkeypatch.setattr(tfm, "moe_experts", dropped)
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["expert_rel_err"]["value"] > r["checks"]["expert_rel_err"]["limit"]
