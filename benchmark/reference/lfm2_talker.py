"""Plain reference of the codec-LM TTS model with LFM2-8B-A1B's decoder as its talker, in float32.

The talker is the public ``lfm2_moe`` decoder the configuration file names
(``configs/lfm2-8b-a1b-tts-bf16.json``): a schedule of gated short-convolution
and GQA attention layers, each followed by a dense SwiGLU (the first
``num_dense_layers``) or by ``num_experts`` routed SwiGLU experts, then one
final RMSNorm. Everything around the talker (the prompt, the audio head, the
residual code predictor, the vocoder) is ``qwen_tts.py``'s, imported here.

Layer equations, for one sequence ``x`` ``(T, H)`` at positions 0..T-1:

* block: ``h = x + op(rms(x))``, ``out = h + ffn(rms(h))``; ``rms(x) = x̂ · w``;
* attention: ``q, k, v`` from one projection, an RMSNorm over each q and each
  k head, RoPE (rotate-half), causal GQA, the output projection;
* short convolution: ``B, C, x̃ = split₃(x @ in_proj)``, ``u = B ⊙ x̃``,
  ``y = C ⊙ conv(u)`` with ``conv`` depthwise and causal over
  ``conv_L_cache`` taps (``conv_w`` ``(H, K)``, tap i on position
  ``t - (K - 1) + i``), then ``y @ out_proj``;
* experts: ``s = sigmoid(h @ router)``, ``idx = topk(s + bias, k)``,
  ``w = s[idx] / (Σ s[idx] + 1e-6) · routed_scaling_factor`` (with
  ``norm_topk_prob``), ``out = Σ_j w_j · SwiGLU_{idx_j}(h)``.

Written as straightforward PyTorch: one causal forward over the whole
sequence, no cache, no batching, no kernel; it imports nothing of the
program under test. Weights (the layout ``lfm2.py`` builds) are turned to
float32 one layer, or one expert, at a time, so that 8.5 G bf16 parameters
and the reference fit on one card beside nothing else.

Besides the teacher-forced gaps of a whole utterance, :func:`expert_readings`
holds each expert layer on the program's own input to that layer (data the
program prepared), where routing differences built up through the layers
cannot reach.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import qwen_tts as base

run_float32 = base.run_float32
Gaps = base.Gaps


def _layer(stack: Dict, i: int) -> Dict:
    return {name: w[i] for name, w in stack.items()}


def _attention(p: Dict, cfg: Dict, h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // hq
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    t = h.shape[0]
    qkv = h @ p["wqkv"].float()
    q = qkv[:, : hq * d].reshape(t, hq, d)
    k = qkv[:, hq * d: (hq + hkv) * d].reshape(t, hkv, d)
    v = qkv[:, (hq + hkv) * d:].reshape(t, hkv, d)
    q = base.rope(base.rms_norm(q, p["q_norm"], eps), pos, theta)
    k = base.rope(base.rms_norm(k, p["k_norm"], eps), pos, theta)
    k = k.repeat_interleave(hq // hkv, dim=1)  # query head h reads KV head h // group
    v = v.repeat_interleave(hq // hkv, dim=1)
    causal = torch.ones((t, t), dtype=torch.bool, device=h.device).tril()
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    attn = torch.einsum("hqk,khd->qhd", probs, v).reshape(t, hq * d)
    return attn @ p["wo"].float()


def _short_conv(p: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    hd, taps = cfg["hidden_size"], cfg["conv_L_cache"]
    bcx = h @ p["in_proj"].float()
    b, c, xt = bcx[:, :hd], bcx[:, hd: 2 * hd], bcx[:, 2 * hd:]
    u = (b * xt).T[None]  # (1, H, T)
    conv = F.conv1d(u, p["conv_w"].float()[:, None, :], padding=taps - 1,
                    groups=hd)[0, :, : h.shape[0]].T
    return (c * conv) @ p["out_proj"].float()


def _swiglu(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(h @ w_gate.float()) * (h @ w_up.float())) @ w_down.float()


def route(p: Dict, cfg: Dict, h: torch.Tensor):
    """The router of one expert layer on ``h`` ``(N, H)``: the chosen experts
    ``(N, k)`` and their weights ``(N, k)``."""
    scores = torch.sigmoid(h @ p["router"].float())
    choice = scores + p["expert_bias"].float() if cfg["use_expert_bias"] else scores
    _, idx = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1)
    w = scores.gather(1, idx)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    return idx, w * cfg["routed_scaling_factor"]


def mix(p: Dict, h: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Σ_j w_j · SwiGLU_{idx_j}(h)`` of each row of ``h`` ``(N, H)``."""
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, j = torch.nonzero(idx == e, as_tuple=True)
        y = _swiglu(h[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
        out.index_add_(0, tok, y * w[tok, j][:, None])
    return out


def _experts(p: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    idx, w = route(p, cfg, h)
    return mix(p, h, idx, w)


def expert_readings(params: Dict, cfg: Dict, records: List) -> Dict[str, float]:
    """Judge the program's expert layers on their own inputs.

    ``records`` is program-prepared data: for each call of an expert layer,
    in layer order and call after call, the layer's input ``h`` ``(N, H)``
    (after its norm), the experts the program chose ``(N, k)`` and its
    output ``(N, H)``. The reference routes each ``h`` itself (in f32, as
    the program states it routes, with the same shapes) and mixes the
    experts in f32. Routing differences that build up through the layers
    (which the teacher-forced gaps carry) cannot reach this number: each
    layer starts from the program's own input. Returns the largest, over the
    layers, relative Frobenius error of the outputs (``expert_rel_err``)
    and the share of rows whose set of experts differs
    (``expert_choice_mismatch``)."""
    moe = params["talker"]["moe"]
    n = int(moe["router"].shape[0])
    if not records or len(records) % n:
        raise ValueError(f"{len(records)} expert-layer records for {n} expert layers")
    errs, differ, rows = [], 0, 0
    for m in range(n):
        p = {k: v[m].float() for k, v in moe.items()}
        hs, idxs, ws, outs = [], [], [], []
        for h, got_idx, out in records[m::n]:
            h = h.float()
            idx, w = route(p, cfg, h)
            differ += int((idx.sort(-1).values != got_idx.sort(-1).values).any(-1).sum())
            rows += h.shape[0]
            hs.append(h)
            idxs.append(idx)
            ws.append(w)
            outs.append(out.float())
        want = mix(p, torch.cat(hs), torch.cat(idxs), torch.cat(ws))
        errs.append(float((torch.cat(outs) - want).norm() / want.norm()))
    worst = max(errs) if all(math.isfinite(e) for e in errs) else float("nan")
    return {"expert_rel_err": worst, "expert_choice_mismatch": differ / rows}


def talker_hidden(params: Dict, cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """Causal forward of the talker over one whole sequence ``x`` ``(T, hidden)``
    in f32; returns the final-normed hidden states ``(T, hidden)``."""
    talker, eps = params["talker"], cfg["norm_eps"]
    pos = torch.arange(x.shape[0], device=x.device)
    seen = {"attn": 0, "conv": 0, "ffn": 0, "moe": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        if kind == "conv":
            p = _layer(talker["conv"], seen["conv"])
            x = x + _short_conv(p, cfg, base.rms_norm(x, p["conv_norm"], eps))
            seen["conv"] += 1
        else:
            p = _layer(talker["attn"], seen["attn"])
            x = x + _attention(p, cfg, base.rms_norm(x, p["attn_norm"], eps), pos)
            seen["attn"] += 1
        if i < cfg["num_dense_layers"]:
            p = _layer(talker["ffn"], seen["ffn"])
            h = base.rms_norm(x, p["mlp_norm"], eps)
            x = x + _swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
            seen["ffn"] += 1
        else:
            p = _layer(talker["moe"], seen["moe"])
            x = x + _experts(p, cfg, base.rms_norm(x, p["mlp_norm"], eps))
            seen["moe"] += 1
    return base.rms_norm(x, talker["final_norm"], eps)


def served_gaps(params: Dict, cfg: Dict, text: str, speaker: str, codes: torch.Tensor,
                min_frames: int, judge_primary: bool) -> Dict:
    """Judge one served utterance, teacher-forced on its own codes, as
    ``qwen_tts.served_gaps`` does with this talker: the gap by which the
    reference's logit of each served code lies below its best (EOS
    excluded under ``min_frames``; primary codes where ``judge_primary``,
    residual codes of every audible frame). Returns the widest gaps, their
    sums and the counts."""
    codes = codes.long()
    n_frames = codes.shape[0]
    eos = base.audio_eos(cfg)
    prompt = base.prompt_embeds(params, cfg, text, speaker)
    seq = torch.cat([prompt, base.code_embeds(params, codes[:-1])], dim=0)
    h = talker_hidden(params, cfg, seq)
    # The state that chose frame f's primary code sits at position n - 1 + f.
    h_frames = h[prompt.shape[0] - 1:]
    logits = h_frames @ params["lm_head"].float()
    masked = torch.arange(n_frames, device=codes.device) < min_frames
    logits[masked, eos] = float("-inf")
    out = {"primary_gap": 0.0, "primary_gap_sum": 0.0, "primary_tokens": 0,
           "residual_gap": 0.0, "residual_gap_sum": 0.0, "residual_tokens": 0}
    if judge_primary:
        served = logits.gather(1, codes[:, :1])[:, 0]
        gap = logits.max(dim=1).values - served
        out.update(primary_gap=float(gap.max()), primary_gap_sum=float(gap.sum()),
                   primary_tokens=n_frames)
    audible = codes[1:, 0] != eos  # frame 0's residuals are zeros; an EOS frame is not heard
    if bool(audible.any()):
        rows = torch.nonzero(audible)[:, 0] + 1
        res = base.residual_logits(params, cfg, h_frames[rows], codes[rows, 0])  # (Q, R, V)
        served = res.gather(2, codes[rows, 1:].T[..., None])[..., 0]
        gap = res.max(dim=2).values - served
        out.update(residual_gap=float(gap.max()), residual_gap_sum=float(gap.sum()),
                   residual_tokens=int(served.numel()))
    return out
