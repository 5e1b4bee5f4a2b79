"""The state-space hybrid talker's configuration (``granite-4.0-h-small-tts-bf16``)
in the benchmark: its weights and control, the reference against the program
in float32, ``roofline_granite.py`` against counts by hand, and the cell run
whole on the CPU at a small size, ``correct`` for the program and refused for
the control and for planted faults (among them a scan state kept in bf16 and
a dropped residual multiplier)."""

from __future__ import annotations

import copy
import math
import time

import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from test_bench_run import _fault

from benchmark import granite, registry, roofline, roofline_granite, run
from benchmark.reference import granite_talker as ref

CELL = "granite-4.0-h-small-tts-bf16.batch8"
FULL = registry.load_config("granite-4.0-h-small-tts-bf16")
SEED = 2**31 + 77
#: the configuration at a CPU size: its keys as published, smaller widths,
#: six layers with both kinds of mixer, the program's ``tiny`` codec
TINY = dict(
    FULL, hidden_size=256, num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
    shared_intermediate_size=128, num_local_experts=8, num_experts_per_tok=3,
    num_hidden_layers=6, layer_types=["mamba", "mamba", "attention", "mamba", "attention", "mamba"],
    mamba_n_heads=8, mamba_d_head=64, mamba_d_state=32, mamba_chunk_size=32,
    attention_multiplier=1 / 64, text_vocab=512, code_predictor_hidden=128,
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

    program = granite.program_config(FULL)
    assert program.talker == PRESETS["granite-4.0-h-small"].talker
    assert program.text_vocab == PRESETS["granite-4.0-h-small"].text_vocab == FULL["vocab_size"]
    assert FULL["reduced"] == [] and FULL["quantization"] == "none"
    z = granite.sizes(FULL)
    assert (z["attn"], z["mamba"], z["head_dim"], z["ssm_inner"], z["in_proj"]) == (
        4, 36, 128, 8192, 16768)
    assert [i for i, k in enumerate(FULL["layer_types"]) if k == "attention"] == [5, 15, 25, 35]


def test_the_talker_holds_32_billion_parameters():
    """The talker's matmul weights by part, as the configuration's sizes give
    them: 64 GB in bf16, drawn into one buffer."""
    parts = {}
    for (_t, kind, name), shape, _scale in granite.talker_layout(FULL):
        part = "shared" if name.startswith("shared") else "router" if name == "router" else kind
        parts[part] = parts.get(part, 0) + math.prod(shape)
    assert parts["moe"] == 40 * 72 * 3 * 4096 * 768 == 27_179_089_920
    assert parts["mamba"] == 36 * (4096 * 16768 + 8192 * 4096) == 3_680_501_760
    assert parts["shared"] == 40 * 3 * 4096 * 1536 and parts["attn"] == 4 * 41_943_040
    assert sum(parts.values()) == 31_794_135_040  # and the 0.41 G text embedding: 32.21 G


def test_weights_are_the_same_for_the_same_seed_and_the_control_rounds_the_talker():
    a, b = granite.make_params(TINY, 2**33 + 1, "cpu"), granite.make_params(TINY, 2**33 + 1, "cpu")
    c = granite.make_params(TINY, 2**33 + 1, "cpu", control=True)
    mamba = a["talker"]["mamba"]
    assert torch.equal(mamba["in_proj"], b["talker"]["mamba"]["in_proj"])
    assert torch.equal(mamba["A_log"], b["talker"]["mamba"]["A_log"])
    assert mamba["A_log"].dtype == torch.float32 and "expert_bias" not in a["talker"]["moe"]
    assert 0.0 <= float(mamba["A_log"].min()) and float(mamba["A_log"].max()) <= math.log(16)
    dt = torch.nn.functional.softplus(mamba["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001
    for kind, name in (("moe", "w_up"), ("moe", "router"), ("moe", "shared_w_down"),
                       ("mamba", "in_proj"), ("mamba", "out_proj"), ("attn", "wqkv")):
        w, wc = a["talker"][kind][name].float(), c["talker"][kind][name].float()
        assert not torch.equal(w, wc)
        # one float8 scale an output channel: every value a float8 number times it
        scale = w.abs().amax(dim=-2, keepdim=True) / 448.0
        q = wc / scale
        torch.testing.assert_close(q.to(torch.float8_e4m3fn).float(), q, rtol=1e-2, atol=1e-2)
    for kind, name in (("mamba", "conv_w"), ("mamba", "dt_bias"), ("mamba", "gate_norm")):
        assert torch.equal(a["talker"][kind][name], c["talker"][kind][name])
    assert torch.equal(a["lm_head"], c["lm_head"])


def test_the_reference_against_the_program_in_float32():
    """Prefill (two scan chunks) and three cached decode steps of the program
    (float32 weights and caches) against one causal forward of the reference."""
    from rho_tts_tpu_torch.models import transformer as tfm
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel, _prefill, _talker_input

    tree = _f32(granite.make_params(TINY, 1234, "cpu"))
    model = QwenTTSModel(granite.program_config(TINY), params=tree, device="cpu")
    text, speaker = "A short line to speak, a little longer.", "Vivian"
    arrays, lens, p = model._build_prompt_arrays([text], speaker, "English", None, None)
    assert lens[0] > TINY["mamba_chunk_size"]
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    steps, cfg = 4, model.config
    ck, cv = tfm.make_kv_cache(cfg.talker, 1, p + steps, dtype=torch.float32)
    kv = torch.zeros((1, p + steps), dtype=torch.bool)
    ssm = tfm.make_ssm_state(cfg.talker, 1)
    logits, ck, cv, kv = _prefill(tree, cfg, a["ids_slotted"], a["text_mask"], a["codes_slotted"],
                                  a["code_mask"], a["spk_ids"], a["spk_mask"], a["rope_pos"],
                                  a["attn_mask"], ck, cv, kv, ssm_state=ssm)
    codes = torch.randint(0, 64, (steps, 2), generator=torch.Generator().manual_seed(0))
    got = [logits[0]]
    for t in range(steps - 1):
        emb = tree["audio_embed"][0][codes[t:t + 1, 0]] + tree["audio_embed"][1][codes[t:t + 1, 1]]
        h, _ = tfm.stack_forward(tree["talker"], cfg.talker, _talker_input(cfg, emb[:, None, :]),
                                 torch.tensor([[lens[0] + t]]), kv_caches=(ck, cv),
                                 cache_len=p + t, key_valid=kv, ssm_state=ssm)
        kv[:, p + t] = True
        got.append((h[:, -1] @ tree["lm_head"])[0])
    with ref.run_float32():
        seq = torch.cat([ref.base.prompt_embeds(tree, TINY, text, speaker),
                         ref.base.code_embeds(tree, codes[:-1])])
        want = ref.talker_hidden(tree, TINY, [seq])[0][lens[0] - 1:] @ tree["lm_head"]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_roofline_granite_against_counts_by_hand():
    # per row: 36 Mamba layers (in 4096 x 16768, out 8192 x 4096), 4 attention layers
    # (qkv 4096 x (32 + 16) x 128, o 4096 x 4096), 40 expert layers (router 4096 x 72,
    # 10 experts of 3 x 4096 x 768, a shared one of 3 x 4096 x 1536)
    params = (36 * (4096 * 16768 + 8192 * 4096) + 4 * (4096 * 6144 + 4096 * 4096)
              + 40 * (4096 * 72 + 10 * 3 * 4096 * 768 + 3 * 4096 * 1536))
    assert roofline_granite.row_matmul_params(FULL) == params == 8_389_918_720
    heads = 4096 * 2051 + 15 * (8192 * 2048 + 2048 * 2048)
    assert roofline_granite.head_params(FULL) == heads
    scan = 128 * 64 * 128
    assert roofline_granite.ssm_row_ops(FULL) == 2 * 4 * 8448 + 5 * scan
    assert roofline_granite.decode_row_flops(FULL) == (2 * (params + heads)
                                                       + 36 * (2 * 4 * 8448 + 5 * scan))
    att = roofline_granite.attention_config(FULL)
    assert att == {"talker": {"layers": 4, "q_heads": 32, "kv_heads": 8, "head_dim": 128}}
    assert roofline_granite.decode_step_flops(FULL, [300] * 8) == 8 * (
        roofline_granite.decode_row_flops(FULL) + 4 * 4 * 32 * 128 * 300)
    # the experts kernel: 8 rows that chose 50 experts (80 slots)
    n_bytes, ops = roofline_granite.expert_work(FULL, 8, 50)
    assert n_bytes == (50 * 3 * 4096 * 768 * 2 + 8 * 4096 * 2 + 2 * 80 * 768 * 2
                       + 80 * 4096 * 4 + 80 * 12)
    assert ops == 2 * 80 * 3 * 4096 * 768
    assert roofline.bound_s(n_bytes, ops)[1] == "bytes"
    # the Mamba kernel over 8 rows: S (4.19 MB a row) read and written in f32
    n_bytes, ops = roofline_granite.ssm_step_work(FULL, 8)
    assert n_bytes == (8 * scan * 8 + 8 * 16768 * 2 + 8 * 3 * 8448 * 8 + 8448 * 5 * 2
                       + 3 * 128 * 4 + 8 * 8192 * 2)
    assert ops == 8 * (2 * 4 * 8448 + 5 * scan)
    bound, by = roofline_granite.ssm_step_bound_s(n_bytes, ops)
    assert by == "bytes" and 19e-6 < bound < 21e-6


def test_the_traced_chunk_counts_the_experts_and_the_mamba_launches():
    gen = registry.load_generator("closed_batch_granite")
    st = {"what": "decode_chunk", "steps": 2, "row_keys0": [150, 160], "cache_len": 448}
    out = gen.stretch_work(FULL, dict(st), [[50] * 40, [55] * 40])
    assert out["attention_calls"] == 2 * 4 and out["expert_calls"] == 80
    assert out["ssm_calls"] == 2 * 36
    assert out["ssm_bytes"] == 72 * roofline_granite.ssm_step_work(FULL, 2)[0]
    assert out["expert_bytes"] == 40 * (roofline_granite.expert_work(FULL, 2, 50)[0]
                                        + roofline_granite.expert_work(FULL, 2, 55)[0])
    assert "expert_bytes" not in gen.stretch_work(FULL, dict(st), None)


def test_the_metrics_read_the_traced_chunk():
    """The Mamba kernel's roofline and share, from a stretch by hand; no
    reading where the launches do not match the Mamba layers' steps."""
    roof = registry.load_metric("ssm_step.roofline.batch")
    share = registry.load_metric("ssm.share.batch")
    gen = registry.load_generator("closed_batch_granite")
    st = gen.stretch_work(FULL, {"what": "decode_chunk", "steps": 2, "row_keys0": [150] * 8,
                                 "cache_len": 448}, None)
    kernel = "void (anonymous namespace)::ssm_step_kernel<64>((anonymous namespace)::Args)"
    st.update(busy_ns=10_000_000, by_name={kernel: {"ns": 72 * 40_000, "count": 72}})
    record = {"stretch": st}
    assert share.read(record) == pytest.approx(28.8)
    bound = roofline_granite.ssm_step_bound_s(st["ssm_bytes"], st["ssm_ops"])[0]
    assert roof.read(record) == pytest.approx(100 * bound / (72 * 40e-6))
    assert 45 < roof.read(record) < 55  # ~20 us of bytes in 40 us
    st["by_name"][kernel]["count"] = 71
    assert roof.read(record) is None
    assert roof.read({"stretch": dict(st, what="serve")}) is None


def test_the_cell_runs_whole_on_the_cpu():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(r["checks"]) == {"primary_gap_mean", "residual_gap_mean", "waveform_rel_err",
                                "expert_rel_err", "ssm_rel_err"}
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


def _bf16_state(fn):
    """``fn`` (the program's Mamba decode step or prefill scan), its f32 scan
    state rounded to bf16 after each call."""
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        state = args[2]  # (zxbcdt, conv_state, ssm_state, ...)
        state.copy_(state.to(torch.bfloat16))
        return out
    return run


def test_a_scan_state_kept_in_bf16_makes_the_run_incorrect(monkeypatch):
    """The scan's state rounded to bf16 at every call: the Mamba layers held
    on their own inputs refuse it."""
    from rho_tts_tpu_torch.models import transformer as tfm

    monkeypatch.setattr(tfm, "ssm_step", _bf16_state(tfm.ssm_step))
    monkeypatch.setattr(tfm, "ssm_prefill", _bf16_state(tfm.ssm_prefill))
    r = _run()
    assert r["correct"] is False
    assert r["checks"]["ssm_rel_err"]["value"] > r["checks"]["ssm_rel_err"]["limit"]


def test_a_dropped_residual_multiplier_makes_the_run_incorrect(monkeypatch):
    """Each sublayer's output added at full weight (the residual multiplier
    dropped where the program adds it): the gaps refuse it."""
    from rho_tts_tpu_torch.models import transformer as tfm

    add_norm = tfm._add_norm
    monkeypatch.setattr(tfm, "_add_norm",
                        lambda x, delta, w, eps, scale=1.0: add_norm(x, delta, w, eps))
    assert _run()["correct"] is False
