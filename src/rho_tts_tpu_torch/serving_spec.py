"""Speculative decoding inside the continuous-batching ServingEngine (PyTorch port).

Counterpart of ``rho_tts_tpu/serving_spec.py``: the draft-propose /
target-verify round of ``models.qwen.speculative`` over the serving SLOT
BATCH. ``RHO_TTS_TPU_SPEC_ROUNDS`` rounds (default 4) make one dispatch,
whose only host transfer is the lagged ``(k, B, 2)`` harvest. One round:

* **Draft phase.** The draft decodes ``gamma+1`` single-token steps over
  the slot batch into its own ring (``key_valid`` masking, RoPE by logical
  position) at per-row write columns: T == 1 forwards through the decode
  attention kernel. Proposals sample per row from the schedule-reproducible
  ``fold_in(fold_in(fold_in(PRNGKey(0x5BEC), tag), seed), frame)`` keys.
* **Verify phase.** The target scores all proposals in ONE ``T=gamma+1``
  forward at each row's own columns; ``block_causal`` restores causality
  inside the block while history stays ``key_valid``-gated. JAX computes it
  with an einsum, and the port with plain masked attention.
* **Per-row acceptance + column rewind.** ``min(1, p/q)`` acceptance per
  row; after it each row rewinds its column to just past its last kept
  key, so a row's columns are its prompt, its emitted keys and one
  transient block. Per-row RoPE and frame counters advance by each row's
  own count; the code log scatters at per-row frame positions. With
  ``top_k=1`` and ``residual_mode="strict"`` the process is exact target
  greedy.

Rows that finish mid-dispatch ride along masked (``live = active & ~done``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict

import torch

from .models import transformer as tfm
from .models.qwen.model import _predict_residuals
from .models.qwen.speculative import _embed_codes, _suppress_eos, _topk_dist
from .utils import prng

Params = Dict[str, Any]

# Distinct fold tags: the draft-proposal, acceptance and resample draws at
# the same (seed, frame) are independent streams.
_TAG_DRAFT = 1
_TAG_ACCEPT = 2
_TAG_EXTRA = 3


@lru_cache(maxsize=16)
def _base_key(tag: int, device: torch.device) -> torch.Tensor:
    """``fold_in(PRNGKey(0x5BEC), tag)``, made once per device by fills."""
    return prng.fold_in(prng.PRNGKey(0x5BEC, device=device),
                        torch.full((), tag, dtype=torch.int64, device=device))


def _fold_keys(seeds: torch.Tensor, frames: torch.Tensor, tag: int):
    """Per-element keys ``fold_in(fold_in(base, seed), frame)``; any matching
    shapes. Returns ``(keys (N, 2), seeds.shape)``."""
    base = _base_key(tag, seeds.device)
    keys = prng.fold_in(prng.fold_in(base, seeds.reshape(-1)), frames.reshape(-1))
    return keys, seeds.shape


def _sample_rows(dist: torch.Tensor, seeds, frames, tag: int) -> torch.Tensor:
    """One index per row of ``dist`` ``(..., V)`` with (seed, frame, tag) keys;
    seeds / frames have ``dist[..., 0]``'s shape."""
    keys, shape = _fold_keys(seeds, frames, tag)
    flat = dist.reshape(-1, dist.shape[-1])
    logp = torch.log(flat.clamp_min(1e-30))
    g = prng.gumbel(keys, (flat.shape[-1],))
    pick = torch.argmax(torch.where(flat > 0, logp + g, -torch.inf), dim=-1)
    return pick.reshape(shape)


def _uniform_rows(seeds, frames, tag: int) -> torch.Tensor:
    keys, shape = _fold_keys(seeds, frames, tag)
    return prng.uniform(keys, ()).reshape(shape)


def _spec_round_body(tp: Params, dp: Params, t_ck, t_cv, t_kv, d_ck, d_cv, d_kv, codes_buf,
                     cfg_t, cfg_d, cols, rope_next, last_codes, done, active, seeds,
                     temperature, frames_done, min_frames, gamma: int, top_k: int,
                     residual_mode: str):
    """One batched draft-propose / target-verify / accept round.

    The caches, ``t_kv`` / ``d_kv`` and ``codes_buf`` are written in place.
    Returns ``(harvest, last_codes, done, cols, rope_next, frames_done)``,
    where ``harvest`` ``(B, 2)`` holds ``[n_real, hit_eos]`` per row:
    ``n_real`` real frames appended this round (EOS and pads excluded),
    ``hit_eos`` rows that finished. ``cols`` comes back rewound per row to
    just past its last kept key.
    """
    b = last_codes.shape[0]
    dev = last_codes.device
    nq = cfg_t.codec.n_codebooks
    eos = cfg_t.audio_eos
    g1 = gamma + 1
    hidden = cfg_t.talker.hidden
    live = active & ~done
    idx = torch.arange(g1, device=dev)[None, :]  # (1, gamma+1)

    # ---- 1. Draft proposes gamma tokens per row (gamma+1 steps: the last
    # writes x_gamma's K/V so an all-accepted round leaves no hole) -------
    lm_d = dp["lm_head"].float()
    codes_in, d_codes_all, qs_all = last_codes, [], []
    for i in range(g1):
        x = _embed_codes(dp, codes_in)[:, None, :]
        slot = cols + i  # per-row write columns
        h, _ = tfm.stack_forward(
            dp["talker"], cfg_d.talker, x, (rope_next + i)[:, None],
            kv_caches=(d_ck, d_cv), cache_len=slot, attn_mask=live[:, None], key_valid=d_kv,
            slot_causal=False,
        )
        tfm.scatter_rows(d_kv, slot[:, None], live[:, None])
        logits = h[:, -1].float() @ lm_d
        _suppress_eos(logits, cfg_d.audio_eos, (frames_done + i) < min_frames)
        q = _topk_dist(logits, temperature, top_k)  # (B, V)
        prim = _sample_rows(q, seeds, frames_done + i, _TAG_DRAFT)
        res_d = _predict_residuals(dp, cfg_d, h[:, -1],
                                   prim.clamp_max(cfg_d.codec.codebook_size - 1))
        codes_in = torch.cat([prim[:, None], res_d], dim=-1)  # (B, nq)
        d_codes_all.append(codes_in)
        qs_all.append(q)
    d_codes = torch.stack(d_codes_all[:gamma], dim=1)  # (B, gamma, nq)
    qs = torch.stack(qs_all[:gamma], dim=1)  # (B, gamma, V)
    d_prim = d_codes[..., 0]

    # ---- 2. Target verifies all proposals in ONE T=gamma+1 forward ------
    seq_codes = torch.cat([last_codes[:, None, :], d_codes], dim=1)
    x = _embed_codes(tp, seq_codes)  # (B, gamma+1, H)
    h, _ = tfm.stack_forward(
        tp["talker"], cfg_t.talker, x, rope_next[:, None] + idx,
        kv_caches=(t_ck, t_cv), cache_len=cols, attn_mask=live[:, None].expand(b, g1),
        key_valid=t_kv, slot_causal=False, block_causal=True,
    )
    h_flat = h.reshape(b * g1, hidden)
    logits_all = (h_flat.float() @ tp["lm_head"].float()).reshape(b, g1, -1)
    _suppress_eos(logits_all, eos, (frames_done[:, None] + idx) < min_frames[:, None])
    ps = _topk_dist(logits_all, temperature[:, None].expand(b, g1), top_k)  # (B, g1, V)
    v = ps.shape[-1]

    # ---- 3. Accept / reject per row --------------------------------------
    p_of = ps[:, :gamma].gather(-1, d_prim[..., None])[..., 0]
    q_of = qs.gather(-1, d_prim[..., None])[..., 0]
    fr = frames_done[:, None] + idx[:, :gamma]
    u = _uniform_rows(seeds[:, None].expand(b, gamma), fr, _TAG_ACCEPT)
    accept = u < torch.clamp_max(p_of / q_of.clamp_min(1e-30), 1.0)  # (B, gamma)
    all_acc = accept.all(dim=1)
    rej = torch.cat([accept, accept.new_zeros((b, 1))], dim=1).to(torch.int32).argmin(dim=1)
    n_p = torch.where(all_acc, gamma, rej).to(torch.int64)  # (B,)

    if residual_mode == "strict":
        res_t_draft = _predict_residuals(
            tp, cfg_t, h[:, :gamma].reshape(b * gamma, hidden),
            d_prim.reshape(-1).clamp_max(cfg_t.codec.codebook_size - 1),
        ).reshape(b, gamma, nq - 1)
        res_match = (res_t_draft == d_codes[..., 1:]).all(dim=-1)  # (B, gamma)
        m = torch.where(res_match.all(dim=1), gamma,
                        res_match.to(torch.int32).argmin(dim=1)).to(torch.int64)
        truncated = n_p > m
        n_eff = torch.where(truncated, m + 1, n_p)
    else:
        truncated = torch.zeros((b,), dtype=torch.bool, device=dev)
        n_eff = n_p
    has_extra = ~truncated

    # Extra token: bonus (all accepted) from ps[:, gamma], else resample from
    # norm(max(p - q, 0)) at the rejection slot.
    p_rej = ps.gather(1, n_p.clamp_max(gamma)[:, None, None].expand(b, 1, v))[:, 0]
    q_rej = qs.gather(1, n_p.clamp_max(gamma - 1)[:, None, None].expand(b, 1, v))[:, 0]
    resid = torch.clamp_min(p_rej - q_rej, 0.0)
    total = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(total > 1e-12, resid / total.clamp_min(1e-30), p_rej)
    extra_dist = torch.where(all_acc[:, None], ps[:, gamma], resid)
    extra = _sample_rows(extra_dist, seeds, frames_done + n_p, _TAG_EXTRA)  # (B,)

    # ---- 4. Emit tokens + residual codebooks ------------------------------
    d_prim_pad = torch.cat([d_prim, d_prim.new_zeros((b, 1))], dim=1)
    emit_prim = torch.where(
        idx < n_eff[:, None], d_prim_pad,
        torch.where((idx == n_eff[:, None]) & has_extra[:, None], extra[:, None],
                    cfg_t.audio_pad),
    )  # (B, gamma+1)
    res_emit = _predict_residuals(
        tp, cfg_t, h_flat, emit_prim.reshape(-1).clamp_max(cfg_t.codec.codebook_size - 1),
    ).reshape(b, g1, nq - 1)
    if residual_mode == "draft" and nq > 1:
        d_res_pad = torch.cat([d_codes[..., 1:], d_codes.new_zeros((b, 1, nq - 1))], dim=1)
        res_emit = torch.where((idx < n_eff[:, None])[..., None], d_res_pad, res_emit)
    codes_vec = torch.cat([emit_prim[..., None], res_emit], dim=-1)
    n_new_raw = n_eff + has_extra.to(torch.int64)  # tokens incl. the extra

    is_eos = emit_prim == eos
    eos_hit_mask = is_eos & (idx < n_new_raw[:, None])
    # Rows already done at round start (EOS sampled at admission) still
    # report an EOS so the host retires them.
    hit_eos = (eos_hit_mask.any(dim=1) & live) | (active & done)
    eos_at = eos_hit_mask.to(torch.int32).argmax(dim=1)
    n_total = torch.where(hit_eos, eos_at + 1, n_new_raw)  # emitted incl. EOS
    n_real = torch.where(live, n_total - hit_eos.to(torch.int64), 0)

    # Real frames into the device code log at per-row positions.
    write = (idx < n_real[:, None]) & live[:, None]
    codes_z = torch.where(write[..., None], codes_vec, 0)
    tfm.scatter_rows(codes_buf, frames_done[:, None] + idx, codes_z, keep=write)

    # ---- 5. Commit cache validity & per-row pointers ----------------------
    keep = n_eff - truncated.to(torch.int64)  # columns [col, col+keep] valid
    valid_block = (idx <= keep[:, None]) & live[:, None]
    cols_blk = cols[:, None] + idx
    tfm.scatter_rows(t_kv, cols_blk, valid_block)
    tfm.scatter_rows(d_kv, cols_blk, valid_block)
    # Rewind: the next block starts right after the last kept key.
    cols = torch.where(live, cols + keep + 1, cols)

    last_i = torch.clamp_min(n_total - 1, 0)
    new_last = codes_vec.gather(1, last_i[:, None, None].expand(b, 1, nq))[:, 0]
    eos_vec = torch.where(torch.arange(nq, device=dev) == 0, eos, 0)
    new_last = torch.where(hit_eos[:, None], eos_vec[None], new_last)
    last_codes = torch.where(live[:, None], new_last, last_codes)

    rope_next = rope_next + torch.where(live, n_total, 0)
    frames_done = frames_done + n_real
    done = done | hit_eos
    harvest = torch.stack([n_real, hit_eos.to(torch.int64)], dim=1)  # (B, 2)
    return harvest, last_codes, done, cols, rope_next, frames_done


def _spec_serve_rounds(tp: Params, dp: Params, t_ck, t_cv, t_kv, d_ck, d_cv, d_kv, codes_buf,
                       cfg_t, cfg_d, cols, rope_next, last_codes, done, active, seeds,
                       temperature, frames_done, min_frames, gamma: int, top_k: int,
                       residual_mode: str, k: int):
    """``k`` draft/verify rounds as one dispatch.

    A speculative round harvests about its accepted frames, against a
    decode chunk's ``steps``: running ``k`` rounds per dispatch spreads the
    per-dispatch host cost the same way. Returns ``(harvests (k, B, 2),
    codes_buf, last_codes, done, cols, rope_next, frames_done)``; the caches
    and ``key_valid`` tensors are written in place.
    """
    harvests = []
    for _ in range(k):
        harvest, last_codes, done, cols, rope_next, frames_done = _spec_round_body(
            tp, dp, t_ck, t_cv, t_kv, d_ck, d_cv, d_kv, codes_buf, cfg_t, cfg_d, cols,
            rope_next, last_codes, done, active, seeds, temperature, frames_done, min_frames,
            gamma, top_k, residual_mode,
        )
        harvests.append(harvest)
    return torch.stack(harvests), codes_buf, last_codes, done, cols, rope_next, frames_done
