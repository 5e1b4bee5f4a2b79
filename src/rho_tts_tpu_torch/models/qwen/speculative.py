"""Speculative decoding for the codec-LM (draft-verify, single stream; PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen/speculative.py``. Standard
speculative sampling (Leviathan et al., arXiv:2211.17192): a small DRAFT
model proposes ``gamma`` primary-codebook tokens autoregressively, the
TARGET scores all of them in ONE forward, and tokens are accepted with
probability ``min(1, p(x)/q(x))``, so the emitted stream samples from the
target's distribution.

* JAX's ``lax.while_loop`` becomes a host loop of rounds. Every round's
  state (cache slots, rope position, last codes, the key chain, the output
  and its count) stays on the device; a round whose loop condition is
  already false changes none of it, so the host reads the condition only
  once every :data:`CHECK_EVERY` rounds and the codes, ``n_emitted`` and
  ``rounds`` equal JAX's.
* Rejected suffixes roll back by not marking their cache slots valid; the
  next round overwrites them (per-row cache slots on the device,
  ``models.transformer.stack_forward``).
* The draft's steps are T == 1 forwards through the decode attention
  kernel; the verification is a T = gamma+1 forward over the used cache,
  plain masked attention as in the JAX package.
* Draws follow JAX's key chain through ``utils.prng`` (``split``,
  ``gumbel``, ``uniform``), bit for bit.

Single stream (B=1) only; the batched variant is ``serving_spec``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...utils import prng
from .. import transformer as tfm
from .model import _predict_residuals

Params = Dict[str, Any]

#: rounds dispatched between two host reads of the loop condition
CHECK_EVERY = 4


def _topk_dist(logits: torch.Tensor, temperature: torch.Tensor, top_k: int) -> torch.Tensor:
    """Full-vocab probabilities of the top-k + temperature sampler, row-wise:
    logits ``(..., V)``, temperature a tensor broadcastable to
    ``logits[..., 0]`` (a tensor divisor: division by a Python scalar may
    run as a multiplication by its reciprocal). Ties in the top k go to the
    lower index, as ``lax.top_k``'s (a stable descending sort)."""
    scaled = logits.float() / temperature.float().clamp_min(float(np.float32(1e-5)))[..., None]
    vals, idxs = torch.sort(scaled, dim=-1, descending=True, stable=True)
    probs = torch.softmax(vals[..., :top_k], dim=-1)
    return torch.zeros_like(scaled).scatter(-1, idxs[..., :top_k], probs)


def _sample_from(dist: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Sample an index from a ``(V,)`` distribution (Gumbel over log p)."""
    logp = torch.log(dist.clamp_min(1e-30))
    g = prng.gumbel(key, dist.shape)
    return torch.argmax(torch.where(dist > 0, logp + g, -torch.inf))


def _suppress_eos(logits: torch.Tensor, eos: int, suppress: torch.Tensor) -> None:
    """EOS logit to -1e30 where ``suppress`` (``logits[..., 0]``'s shape), in place."""
    logits[..., eos] = torch.where(suppress, -1e30, logits[..., eos])


def _embed_codes(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """(..., nq) code vectors -> (..., H): sum over the codebook embeddings."""
    embs = params["audio_embed"]
    e = embs[0][codes[..., 0]]
    for q in range(1, codes.shape[-1]):
        e = e + embs[q][codes[..., q]]
    return e


def _spec_decode(tp: Params, dp: Params, cfg_t, cfg_d, t_ck, t_cv, t_kv, d_ck, d_cv, d_kv,
                 t_slot0: int, d_slot0: int, pos0: int, last_codes: torch.Tensor,
                 rng: torch.Tensor, temperature: float, min_frames: int, gamma: int,
                 max_rounds: int, top_k: int, cap: int, residual_mode: str = "strict",
                 t_axis=None, d_axis=None):
    """The speculation loop. Returns ``(codes (cap, nq), n_emitted, rounds)``
    on the device; entries past an EOS are pads, the caller slices.

    ``residual_mode`` "strict": emitted residual codebooks come from the
    target's predictor and acceptance truncates at the first position where
    the draft's residuals (the verification's inputs) disagree; "draft":
    accepted slots emit the draft's residual codebooks, no truncation. See
    the JAX package's ``_spec_decode``. The caches are written in place.
    ``t_axis`` / ``d_axis``: the mesh axis each model's weights are sharded
    over (tensor parallelism), or None.
    """
    dev = t_ck.device
    eos, pad = cfg_t.audio_eos, cfg_t.audio_pad
    nq = cfg_t.codec.n_codebooks
    g1 = gamma + 1
    lm_t = tp["lm_head"].float()
    lm_d = dp["lm_head"].float()
    ar_g1 = torch.arange(g1, device=dev)
    ar_t = torch.arange(t_kv.shape[-1], device=dev)
    ar_d = torch.arange(d_kv.shape[-1], device=dev)
    temp = torch.full((), float(np.float32(temperature)), dtype=torch.float32, device=dev)
    eos_vec = torch.where(torch.arange(nq, device=dev) == 0, eos, 0)

    def scalar(v):  # a 0-d int64 tensor made by a fill: no upload
        return torch.full((), int(v), dtype=torch.int64, device=dev)

    state = {
        "t_slot": scalar(t_slot0), "d_slot": scalar(d_slot0), "pos": scalar(pos0),
        "last": last_codes.to(torch.int64).reshape(nq), "rng": rng,
        "out": torch.full((cap, nq), pad, dtype=torch.int64, device=dev),
        "n_out": scalar(0),
        # done starts true when the first sampled token is already EOS
        "done": last_codes.reshape(nq)[0] == eos,
        "rounds": scalar(0),
    }
    t_kv, d_kv = t_kv.clone(), d_kv.clone()

    def round_body(st, t_kv, d_kv):
        t_slot, d_slot, pos, last, rng = (st[k] for k in ("t_slot", "d_slot", "pos", "last",
                                                          "rng"))
        n_out = st["n_out"]

        # ---- 1. Draft proposes gamma code vectors (gamma+1 steps: the last
        # writes x_gamma's K/V so an all-accepted round leaves no hole) ----
        codes_in, d_codes_all, qs_all = last, [], []
        for i in range(g1):
            x = _embed_codes(dp, codes_in)[None, None, :]
            slot = (d_slot + i)[None]
            h, _ = tfm.stack_forward(
                dp["talker"], cfg_d.talker, x, (pos + i)[None, None],
                kv_caches=(d_ck, d_cv), cache_len=slot, attn_mask=None, key_valid=d_kv,
                tp=d_axis,
            )
            tfm.scatter_rows(d_kv, slot[:, None], torch.ones((1, 1), dtype=torch.bool,
                                                              device=dev))
            logits = h[0, -1].float() @ lm_d
            _suppress_eos(logits, cfg_d.audio_eos, (n_out + 1 + i) < min_frames)
            q = _topk_dist(logits, temp, top_k)
            keys = prng.split(rng)
            rng = keys[0]
            prim = _sample_from(q, keys[1])
            res_d = _predict_residuals(dp, cfg_d, h[0, -1][None], prim[None], d_axis)[0]
            codes_in = torch.cat([prim[None], res_d.to(torch.int64)])
            d_codes_all.append(codes_in)
            qs_all.append(q)
        d_codes = torch.stack(d_codes_all[:gamma])  # (gamma, nq)
        qs = torch.stack(qs_all[:gamma])  # (gamma, V)
        d_prim = d_codes[:, 0]

        # ---- 2. Target verifies all gamma (+ bonus) in ONE forward ----------
        seq_codes = torch.cat([last[None], d_codes])  # (gamma+1, nq)
        x = _embed_codes(tp, seq_codes)[None]
        h, _ = tfm.stack_forward(
            tp["talker"], cfg_t.talker, x, (pos + ar_g1)[None],
            kv_caches=(t_ck, t_cv), cache_len=t_slot, attn_mask=None, key_valid=t_kv,
            tp=t_axis,
        )
        logits_all = h[0].float() @ lm_t  # (gamma+1, V)
        _suppress_eos(logits_all, eos, (n_out + 1 + ar_g1) < min_frames)
        ps = _topk_dist(logits_all, temp, top_k)

        # ---- 3. Accept / reject (primary) + residual consistency ------------
        ar_g = ar_g1[:gamma]
        p_of = ps[ar_g, d_prim]
        q_of = qs[ar_g, d_prim]
        keys = prng.split(rng)
        rng = keys[0]
        u = prng.uniform(keys[1], (gamma,))
        accept = u < torch.clamp_max(p_of / q_of.clamp_min(1e-30), 1.0)
        all_acc = accept.all()
        rej = torch.cat([accept, accept.new_zeros(1)]).to(torch.int32).argmin()
        n_p = torch.where(all_acc, gamma, rej).to(torch.int64)
        if residual_mode == "strict":
            res_t_draft = _predict_residuals(tp, cfg_t, h[0, :gamma], d_prim, t_axis)
            res_match = (res_t_draft.to(torch.int64) == d_codes[:, 1:]).all(dim=-1)
            m = torch.where(res_match.all(), gamma,
                            res_match.to(torch.int32).argmin()).to(torch.int64)
            truncated = n_p > m
            n_eff = torch.where(truncated, m + 1, n_p)
        else:
            truncated = torch.zeros((), dtype=torch.bool, device=dev)
            n_eff = n_p
        has_extra = ~truncated

        # Extra token: bonus (all accepted) from ps[gamma], else resample from
        # norm(max(p - q, 0)) at the rejection slot.
        p_rej = ps[torch.clamp_max(n_p, gamma)]
        q_rej = qs[torch.clamp_max(n_p, gamma - 1)]
        resid = torch.clamp_min(p_rej - q_rej, 0.0)
        total = resid.sum()
        resid = torch.where(total > 1e-12, resid / total.clamp_min(1e-30), p_rej)
        extra_dist = torch.where(all_acc, ps[gamma], resid)
        keys = prng.split(rng)
        rng = keys[0]
        extra = _sample_from(extra_dist, keys[1])

        # ---- 4. Emit tokens + residual codebooks ---------------------------
        d_prim_pad = torch.cat([d_prim, d_prim.new_zeros(1)])
        emit_prim = torch.where(
            ar_g1 < n_eff, d_prim_pad,
            torch.where((ar_g1 == n_eff) & has_extra, extra, pad))
        res_emit = _predict_residuals(tp, cfg_t, h[0], emit_prim, t_axis).to(torch.int64)
        if residual_mode == "draft" and nq > 1:
            d_res_pad = torch.cat([d_codes[:, 1:], d_codes.new_zeros((1, nq - 1))])
            res_emit = torch.where((ar_g1 < n_eff)[:, None], d_res_pad, res_emit)
        codes_vec = torch.cat([emit_prim[:, None], res_emit], dim=-1)
        n_new = n_eff + has_extra.to(torch.int64)

        # EOS: anything at or after an EOS is pad; stop emitting there
        is_eos = emit_prim == eos
        seen = torch.cumsum(is_eos.to(torch.int64), dim=0)
        valid = (ar_g1 < n_new) & (seen - is_eos.to(torch.int64) == 0)
        codes_vec = torch.where(valid[:, None], codes_vec, pad)
        eos_in = is_eos & (ar_g1 < n_new)
        hit_eos = eos_in.any()
        n_emit = torch.where(hit_eos, eos_in.to(torch.int32).argmax() + 1, n_new)

        # ---- 5. Commit cache validity & pointers ---------------------------
        cut = truncated.to(torch.int64)
        keep_t = t_slot + n_eff - cut
        new_t_kv = (t_kv & ~(ar_t > keep_t)[None, :]) | ((ar_t >= t_slot) & (ar_t <= keep_t))[None]
        keep_d = d_slot + n_eff - cut
        new_d_kv = d_kv & ~(ar_d > keep_d)[None, :]
        last_idx = torch.clamp_min(n_emit - 1, 0)
        new_last = torch.where(hit_eos, eos_vec, codes_vec[last_idx])
        new = {
            "t_slot": keep_t + 1, "d_slot": keep_d + 1, "pos": pos + n_emit,
            "last": new_last, "rng": rng,
            "n_out": torch.clamp_max(n_out + n_emit, cap - g1),
            "done": st["done"] | hit_eos, "rounds": st["rounds"] + 1,
        }
        rows = n_out + ar_g1  # in range: n_out <= cap - (gamma+1)
        return new, rows, codes_vec, new_t_kv, new_d_kv

    def cond(st):
        return (~st["done"]) & (st["rounds"] < max_rounds) & (st["n_out"] < cap - g1)

    for r in range(max(int(max_rounds), 0)):
        if r % CHECK_EVERY == 0 and r and not bool(cond(state)):
            break  # the only host read: once every CHECK_EVERY rounds
        live = cond(state)
        new, rows, codes_vec, new_t_kv, new_d_kv = round_body(state, t_kv, d_kv)
        # A round after the loop condition fails changes nothing.
        state["out"][rows] = torch.where(live, codes_vec, state["out"][rows])
        for k, v in new.items():
            state[k] = torch.where(live, v, state[k])
        t_kv = torch.where(live, new_t_kv, t_kv)
        d_kv = torch.where(live, new_d_kv, d_kv)
    return state["out"], state["n_out"], state["rounds"]


def speculative_generate_codes(target, draft, text: str, speaker: Optional[str] = None,
                               language: str = "English", ref_audio: Optional[str] = None,
                               ref_text: Optional[str] = None, max_frames: Optional[int] = None,
                               min_frames: int = 0, gamma: int = 4,
                               temperature: Optional[float] = None, top_k: Optional[int] = None,
                               rng: Optional[torch.Tensor] = None,
                               residual_mode: str = "draft") -> Tuple[np.ndarray, Dict[str, float]]:
    """Single-stream speculative decode: returns (codes (T, nq) int32, stats).

    ``target`` / ``draft`` are :class:`QwenTTSModel` instances sharing the
    codec vocabulary; ``rng`` a threefry key ``(2,)`` (``prng.PRNGKey(0)`` by
    default). Stats hold the rounds, the emitted count and the realized
    tokens per round against the gamma+1 upper bound.
    """
    if residual_mode not in ("strict", "draft"):
        raise ValueError(f"Unknown residual_mode: {residual_mode!r}")
    cfg_t, cfg_d = target.config, draft.config
    if cfg_t.audio_vocab != cfg_d.audio_vocab:
        raise ValueError("target and draft must share the codec vocabulary")
    tfm.require_dense(cfg_t.talker, "speculative decoding")
    tfm.require_dense(cfg_d.talker, "speculative decoding")
    temperature = cfg_t.temperature if temperature is None else temperature
    top_k = cfg_t.top_k if top_k is None else top_k
    dev = target.device
    rng = (prng.PRNGKey(0) if rng is None else rng).to(dev)

    if max_frames is None:
        max_frames = int(np.clip(len(text) * 1.0 + 50, 64, 1500))
    cap = int(max_frames + gamma + 1)
    max_rounds = max(int(max_frames), 1)  # at least one token emitted per round

    with torch.inference_mode():
        t_pre = _prefill_single(target, text, speaker, language, ref_audio, ref_text, cap, gamma)
        d_pre = _prefill_single(draft, text, speaker, language, ref_audio, ref_text, cap, gamma)

        keys = prng.split(rng)
        rng, k0 = keys[0], keys[1]
        logits0 = t_pre["logits"]
        if min_frames > 0:
            _suppress_eos(logits0, cfg_t.audio_eos, torch.ones((), dtype=torch.bool, device=dev))
        temp = torch.full((), float(np.float32(temperature)), dtype=torch.float32, device=dev)
        tok0 = _sample_from(_topk_dist(logits0, temp, top_k), k0)

        nq = cfg_t.codec.n_codebooks
        first_codes = torch.where(torch.arange(nq, device=dev) == 0, tok0, 0)
        codes, n_out, rounds = _spec_decode(
            target.params, draft.params, cfg_t, cfg_d,
            t_pre["ck"], t_pre["cv"], t_pre["kv"], d_pre["ck"], d_pre["cv"], d_pre["kv"],
            t_pre["slot0"], d_pre["slot0"], t_pre["pos0"], first_codes, rng,
            temperature, min_frames, gamma, max_rounds, int(top_k), cap, residual_mode,
            target.tp_axis, draft.tp_axis,
        )
        codes_np = codes.cpu().numpy().astype(np.int32)
        n, r = int(n_out), max(int(rounds), 1)
        tok0 = int(tok0)
    first = np.zeros((1, nq), np.int32)
    first[0, 0] = tok0
    out = np.concatenate([first, codes_np[:n]])
    # Strip any trailing pads / EOS rows
    keep = out[:, 0] < cfg_t.codec.codebook_size
    if not keep.all():
        end = int(np.argmin(keep))
        out = out[: max(end, 1)]
    stats = {"rounds": r, "emitted": n, "tokens_per_round": n / r,
             "acceptance_upper": gamma + 1}
    return out, stats


def _prefill_single(model, text, speaker, language, ref_audio, ref_text, decode_cap, gamma):
    """The model's standard prefill for one text, over new caches with room
    for the decode; returns the cache state."""
    arrays, lens, p = model._build_prompt_arrays([text], speaker, language, ref_audio, ref_text)
    a = {k: torch.from_numpy(v).to(model.device) for k, v in arrays.items()}
    with model._decoding(1, p + int(decode_cap) + gamma + 2) as dec:  # no top_k: no graph
        logits = dec.prefill(a)
    return {"logits": logits[0], "ck": dec.cache_k, "cv": dec.cache_v, "kv": dec.key_valid,
            "slot0": int(p), "pos0": int(lens[0])}
