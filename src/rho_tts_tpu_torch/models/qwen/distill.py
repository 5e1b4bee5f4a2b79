"""Draft-model distillation for speculative decoding (PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen/distill.py``. Speculative
decoding's speedup is gated by the acceptance rate, the overlap
``sum_x min(p(x), q(x))`` between the target's and the draft's next-token
distributions (Leviathan et al., arXiv:2211.17192). This trains a small
draft toward exactly that:

* on-policy data: code sequences SAMPLED from the target through the real
  prompt path (``_build_prompt_arrays`` + ``generate_codes``), so the draft
  sees the [spk][text][BOS] layout of decode time. The rollouts run under
  ``torch.inference_mode`` and cross to training as numpy arrays, uploaded
  as fresh tensors;
* distribution matching: cross-entropy of the draft's softmax against the
  target's top-k + temperature sampler distribution (``_topk_dist``), the
  teacher run under ``torch.no_grad()``;
* residual-head matching: CE of the draft's code predictor toward the
  target's argmax, which the speculation loop's residual check compares.

The optimizer is optax's ``adamw(warmup_cosine_decay_schedule(...),
weight_decay=0.0)`` on ``torch.optim.AdamW`` (``train.AdamW``): the
schedule is reproduced in float32 as optax computes it and is read at the
count before each update, so the first step runs at ``init_value = 0.0``
while Adam's moments update. :func:`distill_draft` updates ``draft``'s
registered parameters in place, so ``speculative_generate_codes`` and the
serving engines serve the distilled weights.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...utils import prng
from .. import transformer as tfm
from .config import QwenTTSConfig
from .model import prompt_embeds
from .speculative import _topk_dist
from .train import AdamW, _apply_updates, _ce, _code_predictor_logits, _value_and_grad, leaves

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

_WORDS = (
    "the quick brown fox jumps over a lazy dog while bright voices carry "
    "soft music through evening air and children listen near the open "
    "window as distant bells ring slowly across the quiet valley town"
).split()


def make_corpus(n: int, seed: int = 0, lo: int = 3, hi: int = 6) -> List[str]:
    """Deterministic synthetic sentences for rollouts (the JAX package's,
    word for word): short enough that every prompt lands in one 64-slot
    prompt bucket, which :func:`build_batches` requires."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(lo, hi + 1))
        out.append(" ".join(rng.choice(_WORDS, size=k)))
    return out


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1), in float32 with
    optax's order of operations: a linear ramp from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps``. Returns ``count -> lr``."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        count = int(count)
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        span = decay_steps - warmup_steps
        c = f32(min(count - warmup_steps, span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span)))
        return float(f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def _teacher_forced_hidden(params: Params, cfg: QwenTTSConfig, batch) -> torch.Tensor:
    """Hidden states ``(B, T, H)`` that predict frames 0..T-1, teacher-forced:
    the prompt (its BOS slot predicts frame 0), then the audio embeddings of
    frames 0..T-2 (the sum over the codebooks, as the decode loop conditions)."""
    codes = batch["codes"]  # (B, T, nq)
    b, t, nq = codes.shape
    p = batch["ids_slotted"].shape[1]

    emb_p = prompt_embeds(
        params, cfg, batch["ids_slotted"], batch["text_mask"], batch["codes_slotted"],
        batch["code_mask"], batch["spk_ids"], batch["spk_mask"], batch["attn_mask"],
    )
    audio_in = params["audio_embed"][0][codes[:, :-1, 0]]
    for q in range(1, nq):
        audio_in = audio_in + params["audio_embed"][q][codes[:, :-1, q]]
    x = torch.cat([emb_p, audio_in.to(emb_p.dtype)], dim=1)

    lens = batch["lens"]  # (B,) prompt lengths (the rope position of frame 0)
    pos_audio = lens[:, None] + torch.arange(t - 1, device=lens.device)[None, :]
    positions = torch.cat([batch["rope_pos"], pos_audio], dim=1)
    attn = torch.cat([batch["attn_mask"].bool(),
                      torch.ones((b, t - 1), dtype=torch.bool, device=x.device)], dim=1)
    h, _ = tfm.stack_forward(params["talker"], cfg.talker, x, positions, attn_mask=attn)
    return h[:, p - 1: p + t - 1]


def _residual_logits(params: Params, cfg: QwenTTSConfig, h: torch.Tensor, tok0: torch.Tensor):
    """Code-predictor logits ``(nq-1, B, T, C)`` given hidden + primary code."""
    if cfg.codec.n_codebooks == 1:
        return None
    return _code_predictor_logits(params, h, tok0)


def distill_loss(draft_params: Params, target_params: Params, cfg_d: QwenTTSConfig,
                 cfg_t: QwenTTSConfig, batch, temperature: torch.Tensor, top_k: int):
    """``(loss, overlap)``: CE(teacher sampler distribution || draft) plus the
    residual argmax CE, and the acceptance proxy ``sum min(p, q)`` under both
    top-k sampler distributions. ``temperature`` is a 0-d f32 tensor."""
    codes = batch["codes"]
    tok0 = codes[..., 0]

    with torch.no_grad():
        h_t = _teacher_forced_hidden(target_params, cfg_t, batch)
        logits_t = h_t.float() @ target_params["lm_head"].float()
        p_t = _topk_dist(logits_t, temperature, top_k)  # (B, T, V)
        res_t = _residual_logits(target_params, cfg_t, h_t, tok0)
        labels = None if res_t is None else torch.argmax(res_t, dim=-1)  # (nq-1, B, T)

    h_d = _teacher_forced_hidden(draft_params, cfg_d, batch)
    logits_d = h_d.float() @ draft_params["lm_head"].float()
    logq = torch.log_softmax(logits_d / temperature.float().clamp_min(float(np.float32(1e-5))),
                             dim=-1)
    loss = (-(p_t * logq).sum(dim=-1)).mean()
    if labels is not None:
        res_d = _residual_logits(draft_params, cfg_d, h_d, tok0)
        loss = loss + _ce(res_d, labels).mean()

    q_s = _topk_dist(logits_d.detach(), temperature, top_k)
    overlap = torch.minimum(p_t, q_s).sum(dim=-1).mean()
    return loss, overlap


def distill_step(draft_params: Params, opt_state: torch.optim.AdamW, target_params: Params,
                 batch, cfg_d: QwenTTSConfig, cfg_t: QwenTTSConfig, temperature: torch.Tensor,
                 top_k: int, optimizer: AdamW):
    """One optimizer step on the draft: ``(draft_params, opt_state, loss,
    overlap)``, the draft's leaves updated in place."""
    trained = leaves(draft_params)
    (loss, overlap), grads = _value_and_grad(
        lambda: distill_loss(draft_params, target_params, cfg_d, cfg_t, batch, temperature,
                             top_k),
        trained)
    _apply_updates(optimizer, opt_state, trained, grads)
    return draft_params, opt_state, loss, overlap


def build_batches(target, texts: Sequence[str], seq_frames: int, batch_size: int,
                  speaker: Optional[str] = "Vivian", language: str = "English",
                  rng: Optional[torch.Tensor] = None) -> List[Dict[str, torch.Tensor]]:
    """Roll the target out on ``texts`` and pack fixed-shape batches on its device.

    ``rng`` is a threefry key ``(2,)`` (``prng.PRNGKey(0)`` by default), split
    once per batch as in JAX, so the codes equal the JAX package's under the
    same key. Rollouts are exactly ``seq_frames`` long (EOS suppressed) and
    all prompts must share one prompt bucket.
    """
    if rng is None:
        rng = prng.PRNGKey(0, device=target.device)
    if len(texts) < batch_size:
        raise ValueError(f"corpus of {len(texts)} texts cannot fill a batch of {batch_size}")
    dev = target.device
    batches = []
    for start in range(0, len(texts) - batch_size + 1, batch_size):
        chunk = list(texts[start: start + batch_size])
        arrays, lens, p = target._build_prompt_arrays(chunk, speaker, language, None, None)
        rng, k = prng.split(rng)
        codes = target.generate_codes(
            chunk, speaker=speaker, language=language, min_frames=seq_frames,
            max_frames=seq_frames, rng=k, prebuilt_prompt=(arrays, lens, p),
        )
        codes = np.stack([c[:seq_frames] for c in codes]).astype(np.int64)  # (B, T, nq)
        batch = {name: torch.from_numpy(v).to(dev) for name, v in arrays.items()}
        batch["codes"] = torch.from_numpy(codes).to(dev)
        batch["lens"] = torch.as_tensor(lens, dtype=torch.int64).to(dev)
        batches.append(batch)
    ps = {int(b["ids_slotted"].shape[1]) for b in batches}
    if len(ps) != 1:
        raise ValueError(f"corpus spans multiple prompt buckets: {sorted(ps)}")
    return batches


def distill_draft(target, draft, n_texts: int = 64, seq_frames: int = 96, batch_size: int = 8,
                  steps: int = 300, learning_rate: float = 1e-3,
                  speaker: Optional[str] = "Vivian", seed: int = 0, log_every: int = 50,
                  temperature: Optional[float] = None, top_k: Optional[int] = None,
                  texts: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Distill ``draft`` toward ``target``'s sampler distribution, in place.

    Both models share the codec vocabulary and the device. ``temperature``
    and ``top_k`` override the target config's sampler; ``texts`` the
    synthetic corpus (all in one prompt bucket). Returns the final
    ``loss`` and ``overlap``, ``steps``, and every step's ``losses`` and
    ``overlaps`` (fetched once, at the end).
    """
    tfm.require_dense(target.config.talker, "distillation")
    tfm.require_dense(draft.config.talker, "distillation")
    cfg_t, cfg_d = target.config, draft.config
    if cfg_t.audio_vocab != cfg_d.audio_vocab:
        raise ValueError("target and draft must share the codec vocabulary")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")

    texts = list(texts) if texts is not None else make_corpus(n_texts, seed=seed)
    batches = build_batches(target, texts, seq_frames, batch_size, speaker=speaker,
                            rng=prng.PRNGKey(seed, device=target.device))
    logger.info("distill: %d batches of %dx%d frames", len(batches), batch_size, seq_frames)

    # Warm-up + cosine decay: under a flat LR the overlap plateaus at an LR
    # floor, not a capacity limit.
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=learning_rate,
        warmup_steps=min(20, max(steps // 10, 1)),
        decay_steps=max(steps, 2), end_value=learning_rate * 0.02,
    )
    optimizer = AdamW(schedule, weight_decay=0.0)
    params = draft.params
    opt_state = optimizer.init(params)
    temperature = torch.tensor(cfg_t.temperature if temperature is None else temperature,
                               dtype=torch.float32, device=draft.device)
    top_k = int(cfg_t.top_k if top_k is None else top_k)

    losses, overlaps = [], []
    for step in range(steps):
        batch = batches[step % len(batches)]
        params, opt_state, loss, overlap = distill_step(
            params, opt_state, target.params, batch, cfg_d, cfg_t, temperature, top_k, optimizer,
        )
        losses.append(loss)
        overlaps.append(overlap)
        if log_every and (step + 1) % log_every == 0:
            logger.info("distill step %d: loss %.4f, acceptance-overlap %.3f",
                        step + 1, float(loss), float(overlap))
    hist = torch.stack([torch.stack(losses), torch.stack(overlaps)]).cpu()
    return {"loss": float(hist[0, -1]), "overlap": float(hist[1, -1]), "steps": steps,
            "losses": hist[0].tolist(), "overlaps": hist[1].tolist()}
