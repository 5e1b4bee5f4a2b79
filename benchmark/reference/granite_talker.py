"""Plain reference of the codec-LM TTS model with granite-4.0-h-small's decoder
as its talker, in float32.

The talker is the public ``granitemoehybrid`` decoder the configuration file
names (``configs/granite-4.0-h-small-tts-bf16.json``): a schedule of Mamba-2
mixers and attention layers without rotary embeddings, each followed by
``num_local_experts`` routed SwiGLU experts plus one shared SwiGLU, then one
final RMSNorm. Everything around the talker (the prompt, the audio head, the
residual code predictor, the vocoder, the judges) is ``qwen_tts.py``'s,
imported here.

Layer equations, for one sequence ``x`` ``(T, H)`` at positions 0..T-1:

* input: the talker's input vectors times ``embedding_multiplier``;
* block: ``h = x + m · op(rms(x))``, ``out = h + m · (moe(rms(h)) +
  shared(rms(h)))`` with ``m = residual_multiplier``; ``rms(x) = x̂ · w``;
* attention: ``q, k, v`` projections (the program's one ``wqkv``, split),
  no bias, no QK-norm, no rotary; causal GQA with softmax scale
  ``attention_multiplier``; the output projection;
* Mamba-2: ``z, xBC, dt = split(h @ in_proj)``; ``xBC = silu(conv(xBC) +
  b)`` causal and depthwise over ``mamba_d_conv`` taps (tap i on position
  ``t - (K - 1) + i``); ``x, B, C = split(xBC)`` (one group: B, C shared by
  the heads); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; per head
  and position, ``S <- exp(dt A) S + dt x B^T``, ``y = S C + D x`` (the
  recurrence itself, a position at a time: not the program's chunked scan);
  ``rms(y · silu(z)) · w`` over all ``mamba_n_heads · mamba_d_head``
  channels; ``@ out_proj``;
* experts: ``logits = h @ router``, ``idx = topk(logits, k)``, ``w =
  softmax(logits[idx])``, ``Σ_j w_j · SwiGLU_{idx_j}(h)``; the shared
  expert ``SwiGLU(h)`` of ``shared_intermediate_size``.

Written as straightforward PyTorch: a causal forward over whole sequences,
no cache, no kernel; it imports nothing of the program under test. Several
sequences may go through a layer together (right-padded: a causal layer's
output at a position never sees a later one), so that each layer's weights,
turned to float32 one layer at a time (32 G bf16 parameters do not fit in
float32), are turned once for all of them.

Besides the teacher-forced gaps of whole utterances, :func:`expert_readings`
holds each expert layer, and :func:`ssm_readings` each Mamba layer, on the
program's own input to that layer over a whole call (data the program
prepared), where differences built up through the layers cannot reach.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import qwen_tts as base
from .lfm2_talker import mix

run_float32 = base.run_float32
Gaps = base.Gaps


def _layer(stack: Dict, i: int) -> Dict:
    """Layer ``i`` of a stack, in float32."""
    return {name: w[i].float() for name, w in stack.items()}


def _swiglu(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def _attention(p: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    """``h`` ``(U, T, H)``: causal NoPE GQA at ``attention_multiplier``."""
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    d = cfg["hidden_size"] // hq
    u, t, _ = h.shape
    q = (h @ p["wqkv"][:, : hq * d]).reshape(u, t, hq, d)
    k = (h @ p["wqkv"][:, hq * d: (hq + hkv) * d]).reshape(u, t, hkv, d)
    v = (h @ p["wqkv"][:, (hq + hkv) * d:]).reshape(u, t, hkv, d)
    k = k.repeat_interleave(hq // hkv, dim=2)  # query head h reads KV head h // group
    v = v.repeat_interleave(hq // hkv, dim=2)
    causal = torch.ones((t, t), dtype=torch.bool, device=h.device).tril()
    scores = torch.einsum("uqhd,ukhd->uhqk", q, k) * cfg["attention_multiplier"]
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("uhqk,ukhd->uqhd", probs, v).reshape(u, t, hq * d) @ p["wo"]


def mamba_scan(p: Dict, cfg: Dict, zxbcdt: torch.Tensor, valid: torch.Tensor = None,
               conv0: torch.Tensor = None, s0: torch.Tensor = None):
    """The Mamba-2 mixer between its two projections, on the ``in_proj``
    output ``zxbcdt`` ``(U, T, W)``: the recurrence a position at a time from
    the convolution's inputs ``conv0`` ``(U, K - 1, conv_dim)`` and the state
    ``s0`` ``(U, heads, P, N)`` (zero where None). Where ``valid`` ``(U, T)``
    is False (left padding) the position is no step: xBC zero before and
    after the convolution, dt zero. Returns ``y · silu(z)`` ``(U, T, di)``
    and the state after the last position."""
    nh, hp, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    taps = cfg["mamba_d_conv"]
    di = nh * hp
    u, t, _ = zxbcdt.shape
    z, xbc, dt = zxbcdt.float().split([di, di + 2 * n, nh], dim=-1)
    keep = torch.ones((u, t, 1), dtype=torch.bool, device=z.device) if valid is None \
        else valid.bool()[..., None]
    xbc = xbc.masked_fill(~keep, 0.0)
    hist = torch.zeros((u, taps - 1, di + 2 * n), device=z.device) if conv0 is None \
        else conv0.float()
    full = torch.cat([hist, xbc], dim=1)
    conv = sum(full[:, i: i + t] * p["conv_w"][:, i] for i in range(taps)) + p["conv_b"]
    xbc = F.silu(conv).masked_fill(~keep, 0.0)
    dt = F.softplus(dt + p["dt_bias"]).masked_fill(~keep, 0.0)
    x, bm, cm = xbc.split([di, n, n], dim=-1)
    x = x.reshape(u, t, nh, hp)
    a = -torch.exp(p["A_log"])
    s = torch.zeros((u, nh, hp, n), device=z.device) if s0 is None else s0.float().clone()
    ys = []
    for i in range(t):
        decay = torch.exp(dt[:, i] * a)  # (U, heads)
        s = s * decay[:, :, None, None] + (dt[:, i, :, None] * x[:, i])[..., None] \
            * bm[:, i, None, None, :]
        ys.append(torch.einsum("uhpn,un->uhp", s, cm[:, i]) + p["D"][:, None] * x[:, i])
    return torch.stack(ys, dim=1).reshape(u, t, di) * F.silu(z), s


def mamba_out(p: Dict, cfg: Dict, gated: torch.Tensor) -> torch.Tensor:
    """The gated norm over all ``di`` channels, then ``out_proj``."""
    return base.rms_norm(gated.float(), p["gate_norm"], cfg["rms_norm_eps"]) @ p["out_proj"]


def mamba_mixer(p: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 mixer on ``h`` ``(U, T, H)`` (after its norm), from zero
    states: ``in_proj``, :func:`mamba_scan`, :func:`mamba_out`."""
    return mamba_out(p, cfg, mamba_scan(p, cfg, h @ p["in_proj"])[0])


def route(p: Dict, cfg: Dict, h: torch.Tensor):
    """The router of one expert layer on ``h`` ``(N, H)``: the chosen experts
    ``(N, k)`` and their weights ``(N, k)``, the softmax of their logits."""
    top, idx = torch.topk(h @ p["router"], cfg["num_experts_per_tok"], dim=-1)
    return idx, torch.softmax(top, dim=-1)


def _ffn(p: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    """The routed experts plus the shared expert on ``h`` ``(U, T, H)``."""
    flat = h.reshape(-1, h.shape[-1])
    idx, w = route(p, cfg, flat)
    routed = mix(p, flat, idx, w).reshape(h.shape)
    return routed + _swiglu(h, p["shared_w_gate"], p["shared_w_up"], p["shared_w_down"])


def talker_hidden(params: Dict, cfg: Dict, seqs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Causal forward of the talker over whole sequences ``seqs`` (each
    ``(T_i, hidden)``, the talker's input vectors before the embedding
    multiplier) in f32, together; returns each one's final-normed hidden
    states ``(T_i, hidden)``."""
    talker, eps, m = params["talker"], cfg["rms_norm_eps"], cfg["residual_multiplier"]
    lens = [s.shape[0] for s in seqs]
    x = torch.zeros((len(seqs), max(lens), cfg["hidden_size"]), device=seqs[0].device)
    for i, s in enumerate(seqs):
        x[i, : lens[i]] = s.float() * cfg["embedding_multiplier"]
    seen = {"attention": 0, "mamba": 0}
    for layer, kind in enumerate(cfg["layer_types"]):
        if kind == "mamba":
            p = _layer(talker["mamba"], seen["mamba"])
            x = x + m * mamba_mixer(p, cfg, base.rms_norm(x, p["ssm_norm"], eps))
        else:
            p = _layer(talker["attn"], seen["attention"])
            x = x + m * _attention(p, cfg, base.rms_norm(x, p["attn_norm"], eps))
        seen[kind] += 1
        p = _layer(talker["moe"], layer)
        x = x + m * _ffn(p, cfg, base.rms_norm(x, p["mlp_norm"], eps))
        del p
    x = base.rms_norm(x, talker["final_norm"], eps)
    return [x[i, : n] for i, n in enumerate(lens)]


def served_gaps(params: Dict, cfg: Dict, utterances: Sequence[Dict],
                min_frames: int) -> List[Dict]:
    """Judge served utterances, teacher-forced on their own codes, as
    ``qwen_tts.served_gaps`` does with this talker, all through the talker
    together. Each utterance is a dict of ``text``, ``speaker``, ``codes``
    ``(T, nq)`` and ``judge_primary``: the gap by which the reference's logit
    of each served code lies below its best (EOS excluded under
    ``min_frames``; primary codes where ``judge_primary``, residual codes of
    every audible frame). Returns each one's widest gaps, sums and counts."""
    eos = base.audio_eos(cfg)
    prompts, seqs = [], []
    for utt in utterances:
        codes = utt["codes"].long()
        prompt = base.prompt_embeds(params, cfg, utt["text"], utt["speaker"])
        prompts.append(prompt.shape[0])
        seqs.append(torch.cat([prompt, base.code_embeds(params, codes[:-1])], dim=0))
    hidden = talker_hidden(params, cfg, seqs)
    out = []
    for utt, h, n_prompt in zip(utterances, hidden, prompts):
        codes = utt["codes"].long()
        n_frames = codes.shape[0]
        # The state that chose frame f's primary code sits at position n - 1 + f.
        h_frames = h[n_prompt - 1:]
        logits = h_frames @ params["lm_head"].float()
        logits[torch.arange(n_frames, device=codes.device) < min_frames, eos] = float("-inf")
        g = {"primary_gap": 0.0, "primary_gap_sum": 0.0, "primary_tokens": 0,
             "residual_gap": 0.0, "residual_gap_sum": 0.0, "residual_tokens": 0}
        if utt["judge_primary"]:
            gap = logits.max(dim=1).values - logits.gather(1, codes[:, :1])[:, 0]
            g.update(primary_gap=float(gap.max()), primary_gap_sum=float(gap.sum()),
                     primary_tokens=n_frames)
        audible = codes[1:, 0] != eos  # frame 0's residuals are zeros; an EOS frame is not heard
        if bool(audible.any()):
            rows = torch.nonzero(audible)[:, 0] + 1
            res = base.residual_logits(params, cfg, h_frames[rows], codes[rows, 0])
            served = res.gather(2, codes[rows, 1:].T[..., None])[..., 0]
            gap = res.max(dim=2).values - served
            g.update(residual_gap=float(gap.max()), residual_gap_sum=float(gap.sum()),
                     residual_tokens=int(served.numel()))
        out.append(g)
    return out


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def expert_readings(params: Dict, cfg: Dict, records: List) -> Dict[str, float]:
    """Judge the program's expert layers on their own inputs, as
    ``lfm2_talker.expert_readings`` does with this router: ``records`` holds,
    for each call of an expert layer's routed experts, in layer order and
    call after call, the layer's input ``h`` ``(N, H)`` (after its norm), the
    experts the program chose ``(N, k)`` and the routed output ``(N, H)``.
    The reference routes each ``h`` itself in f32 and mixes the experts in
    f32. Returns the worst layer's relative Frobenius error
    (``expert_rel_err``) and the share of rows whose set of experts differs
    (``expert_choice_mismatch``)."""
    moe = params["talker"]["moe"]
    n = int(moe["router"].shape[0])
    if not records or len(records) % n:
        raise ValueError(f"{len(records)} expert-layer records for {n} expert layers")
    errs, differ, rows = [], 0, 0
    dev = moe["router"].device
    for m in range(n):
        p = _layer(moe, m)
        hs, idxs, ws, outs = [], [], [], []
        for h, got_idx, out in records[m::n]:
            h = h.to(dev).float()
            idx, w = route(p, cfg, h)
            differ += int((idx.sort(-1).values != got_idx.to(dev).sort(-1).values).any(-1).sum())
            rows += h.shape[0]
            hs.append(h)
            idxs.append(idx)
            ws.append(w)
            outs.append(out.to(dev).float())
        want = mix(p, torch.cat(hs), torch.cat(idxs), torch.cat(ws))
        errs.append(_rel(torch.cat(outs), want))
        del p
    worst = max(errs) if all(math.isfinite(e) for e in errs) else float("nan")
    return {"expert_rel_err": worst, "expert_choice_mismatch": differ / rows}


def ssm_readings(params: Dict, cfg: Dict, records: List, finals: List) -> Dict[str, float]:
    """Judge the program's Mamba layers, part by part, on their own inputs over a whole call.

    ``records`` holds, for each call of a Mamba layer, in layer order and
    call after call, ``(h, valid, zxbcdt, conv0, s0, gated, out)``: the
    layer's input ``(B, T, H)`` (after its norm), its ``(B, T)`` validity
    (None: all valid), the program's ``in_proj`` output, the convolution's
    and the scan's state before the call (a call's first layer call only,
    None after), the program's ``y · silu(z)`` and its output; ``finals``
    each layer's scan state ``(B, heads, P, N)`` after the call. Each
    layer's calls are joined along T; at the valid positions, in f32, the
    reference computes each part from the program's input to that part:
    ``in_proj`` from ``h`` (``ssm_in_rel_err``), the convolution and the
    recurrence from the program's ``in_proj`` output, from the first call's
    states (the scan's output ``ssm_scan_rel_err``, and the state after the
    call ``ssm_state_rel_err``, at its worst head, which no bf16 rounding of
    the program's activations reaches), the gated norm and ``out_proj`` from the program's
    ``y · silu(z)`` (``ssm_out_rel_err``). Returns each part's relative L2
    error at the worst layer, and the worst of them as ``ssm_rel_err``."""
    mamba = params["talker"]["mamba"]
    n = int(mamba["in_proj"].shape[0])
    if not records or len(records) % n or len(finals) != n:
        raise ValueError(f"{len(records)} Mamba-layer records and {len(finals)} final states "
                         f"for {n} Mamba layers")
    dev = mamba["in_proj"].device
    parts = {"ssm_in_rel_err": [], "ssm_scan_rel_err": [], "ssm_state_rel_err": [],
             "ssm_out_rel_err": []}
    for m in range(n):
        calls = records[m::n]
        conv0, s0 = calls[0][3], calls[0][4]

        def joined(i):
            return torch.cat([c[i].to(dev).float() for c in calls], dim=1)

        h, zxbcdt, gated, out = joined(0), joined(2), joined(5), joined(6)
        keep = torch.cat([torch.ones(c[0].shape[:2], dtype=torch.bool, device=dev)
                          if c[1] is None else c[1].to(dev).bool() for c in calls], dim=1)
        p = _layer(mamba, m)
        want_gated, state = mamba_scan(p, cfg, zxbcdt, keep, conv0.to(dev), s0.to(dev))
        parts["ssm_in_rel_err"].append(_rel(zxbcdt[keep], (h @ p["in_proj"])[keep]))
        parts["ssm_scan_rel_err"].append(_rel(gated[keep], want_gated[keep]))
        # head by head: a head that keeps its past longest gathers most of a rounding's drift
        drift = (finals[m].to(dev).float() - state).square().sum(dim=(0, 2, 3))
        parts["ssm_state_rel_err"].append(
            float((drift / state.square().sum(dim=(0, 2, 3))).sqrt().max()))
        parts["ssm_out_rel_err"].append(_rel(out[keep], mamba_out(p, cfg, gated)[keep]))
        del p
    out = {name: max(e) if all(math.isfinite(v) for v in e) else float("nan")
           for name, e in parts.items()}
    out["ssm_rel_err"] = max(out.values())
    return out
