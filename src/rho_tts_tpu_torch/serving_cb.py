"""Continuous-batching serving for the Chatterbox-class CFG model (PyTorch port).

Counterpart of ``rho_tts_tpu/serving_cb.py``. :class:`ChatterboxServingEngine`
keeps the :class:`~rho_tts_tpu_torch.serving.ServingEngine` slot scheduler
(admission, lagged harvest, streaming windows, retirement, QoS) and swaps
the model hooks for the CFG-pair decode:

* **CFG pairs as 2B transformer rows.** Request ``i`` owns rows ``i``
  (conditional) and ``i + n_slots`` (unconditional), the ``[cond...,
  uncond...]`` layout of the one-shot ``ChatterboxModel``. The KV ring,
  ``key_valid`` and the RoPE counters live in the 2B row space (the two
  prompts of a pair differ in length, hence in RoPE base); the sampling
  state (seed, temperature, CFG weight, frame counter, EOS floor) lives in
  the (B,) request space.
* **Single-codebook token log.** The device-resident log is a ``(B, F)``
  int64 matrix; retirement and streaming vocode from it on the device.
* **No host wait in admission or dispatch.** Uploads are pinned and
  asynchronous; the done flags come back lagged, as in the base engine.
* **Schedule-reproducible sampling.** Request noise is ``f(seed, frame)``,
  so greedy and sampled serving match ``ChatterboxModel.generate(...,
  seed=seed)`` token for token whatever the slot assignment.
* **Position-indexed watermark.** Retired waveforms and streamed pieces are
  marked on the device at their absolute sample offsets.

* **Mesh serving**, as the base engine's: request slots split over
  ``data`` (this rank's cond and uncond rows together, so the CFG mix stays
  local) and KV heads over ``model`` under tensor parallelism.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .models import transformer as tfm
from .models.chatterbox.model import (
    PROMPT_BUCKET as CB_PROMPT_BUCKET,
    ChatterboxModel,
    _cfg_mix,
    _cfg_sample,
    _prefill,
    _vocode,
)
from .models.qwen.model import _gumbel_noise, _round_up, _sample_with_noise
from .models.qwen.speculative import _suppress_eos
from .ops.watermark import _ENV_WINDOW, apply_watermark
from .parallel.collectives import all_gather
from .serving import ServeRequest, ServingEngine, _insert_rows, _Lagged, _upload
from .utils import profiling


# ---------------------------------------------------------------------------
# Device programs (eager; the JAX package's compiled programs)
# ---------------------------------------------------------------------------


def _cb_serve_decode_chunk(params, cache_k, cache_v, key_valid, toks_buf, cfg, col0: int,
                           rope_next, last_tok, done, active, seeds, temperature, cfg_w,
                           frames_done, min_frames, steps: int, top_k: int, tp=None):
    """``steps`` CFG decode steps over the slot batch with ring writes at
    global column ``col0 + t`` (mod S); caches, ``key_valid`` and
    ``toks_buf`` are written in place.

    The serving twin of ``chatterbox.model._decode_chunk``: ``slot_causal=
    False`` (RoPE carries the logical position), per-request EOS floors, and
    an ``active`` mask so empty slots mark no column valid. The sampled token
    feeds both rows of its request; the EOS column is suppressed on both
    rows before the CFG mix. The chunk's tokens append to ``toks_buf`` at
    each request's frame positions (the EOS frame and after it zeroed,
    positions past the log's end dropped). ``tp``: the mesh axis the
    weights are sharded over.

    Returns ``(done_chunk (B, steps), last_tok, done, rope_next,
    frames_done)``.
    """
    b = last_tok.shape[0]
    s = cache_k.shape[2]
    lm_head = params["lm_head"].float()
    embed = params["speech_embed"]
    ar = torch.arange(steps, device=seeds.device)
    frames = frames_done[None, :] + ar[:, None]  # (steps, B)
    noise = _gumbel_noise(seeds, frames, top_k)
    act2 = torch.cat([active, active])
    attn_mask = act2[:, None]
    toks_seq, done_seq = [], []
    for t in range(steps):
        slot = (col0 + t) % s
        h, _ = tfm.stack_forward(
            params["talker"], cfg.talker, embed[torch.cat([last_tok, last_tok])][:, None, :],
            (rope_next + t)[:, None], kv_caches=(cache_k, cache_v), cache_len=slot,
            attn_mask=attn_mask, key_valid=key_valid, slot_causal=False, tp=tp,
        )
        key_valid[:, slot] = act2
        logits = h[:, -1].float() @ lm_head
        suppress = frames[t] < min_frames
        _suppress_eos(logits, cfg.speech_eos, torch.cat([suppress, suppress]))
        tok = _sample_with_noise(_cfg_mix(logits, cfg_w), temperature, top_k, noise[t])
        newly_done = tok == cfg.speech_eos
        tok = torch.where(done | ~active, cfg.speech_pad, tok)
        done = done | newly_done
        toks_seq.append(tok)
        done_seq.append(done)
        last_tok = tok
    toks_chunk = torch.stack(toks_seq, dim=1)  # (B, steps)
    done_chunk = torch.stack(done_seq, dim=1)
    tfm.scatter_rows(toks_buf, frames_done[:, None] + ar[None, :],
                     torch.where(done_chunk, 0, toks_chunk),
                     keep=active[:, None].expand(b, steps))
    return done_chunk, last_tok, done, rope_next + steps, frames_done + steps


def _cb_vocode_windows(params, cfg, toks_buf, rows, los, ends, w: int):
    """Vocode per-request windows ``toks_buf[row, lo:lo+w]`` (frames >= end
    zeroed) for streaming."""
    idx = los[:, None] + torch.arange(w, device=los.device)[None, :]
    win = torch.where(idx < ends[:, None], toks_buf[rows[:, None], idx], 0)
    return _vocode(params, cfg, win)


def _cb_vocode_rows(params, cfg, toks_buf, rows, ends, t: int):
    """Vocode ``toks_buf[rows, :t]`` with frames >= ``ends`` zeroed. Returns
    (wav (G, t*hop), the masked tokens (G, t) behind the lazy
    ``ServeRequest.codes``)."""
    te = min(t, toks_buf.shape[1])
    toks = torch.zeros((rows.shape[0], t), dtype=toks_buf.dtype, device=toks_buf.device)
    toks[:, :te] = toks_buf[rows, :te]
    toks = torch.where(torch.arange(t, device=toks.device)[None, :] < ends[:, None], toks, 0)
    return _vocode(params, cfg, toks), toks


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ChatterboxServingEngine(ServingEngine):
    """Slot-batched continuous serving over one :class:`ChatterboxModel`.

    ``n_slots`` is the number of concurrent REQUESTS; the transformer batch
    is ``2 * n_slots`` rows (CFG pairs). Submit from any thread; drive with
    :meth:`step` / :meth:`run_until_idle` or :meth:`start`. A model on a
    mesh serves over it, ``n_slots`` a multiple of the ``data`` axis.
    """

    def __init__(self, model: ChatterboxModel, n_slots: int = 8, max_prompt: int = 128,
                 max_frames: int = 768, top_k: Optional[int] = None, seed: int = 0,
                 stream_context: int = 32, max_queue: Optional[int] = None, chunk: int = 64):
        self.model = model
        self.cfg = model.cfg
        self.device = torch.device(model.device)
        # Shorter chunks than the one-shot CHUNK (128) admit and retire at a
        # finer grain; parity does not depend on it (frames are absolute).
        self.chunk = int(chunk)
        self.n_slots = int(n_slots)
        self.max_prompt = _round_up(int(max_prompt), CB_PROMPT_BUCKET)
        self.max_frames = _round_up(int(max_frames), self.chunk)
        self.top_k = int(self.cfg.top_k if top_k is None else top_k)
        self.stream_context = int(stream_context)
        self.draft = None  # no speculative path for the CFG family
        self.gamma = 0
        self.residual_mode = "strict"
        cap = self.cfg.max_cache_len
        self.ring = self.max_prompt + self.max_frames + self.chunk
        if cap is not None and self.ring > _round_up(cap, self.chunk):
            # The "faster" preset: the ring honours the decode cache cap by
            # bounding max_frames.
            self.ring = _round_up(cap, self.chunk)
            self.max_frames = max(self.ring - self.max_prompt - self.chunk, self.chunk)
        # Speaker embeddings, encoded once per reference path.
        self._spk_cache: Dict[str, np.ndarray] = {}
        self._start(seed, max_queue)

    def _alloc_state(self) -> None:
        """The 2B-row ring and the (B,) request state, on the device (this
        rank's request slots: its cond rows, then its uncond rows)."""
        b, dev = self._n_local, self.device
        i64 = dict(dtype=torch.int64, device=dev)
        self._cache_k, self._cache_v = self.model._shard_kv(2 * b, self.ring)
        self._key_valid = torch.zeros((2 * b, self.ring), dtype=torch.bool, device=dev)
        self._rope_next = torch.zeros((2 * b,), **i64)
        self._last_codes = torch.zeros((b,), **i64)
        self._done = torch.ones((b,), dtype=torch.bool, device=dev)
        self._active_dev = torch.zeros((b,), dtype=torch.bool, device=dev)
        self._frames_done = torch.zeros((b,), **i64)
        self._min_frames = torch.zeros((b,), **i64)
        self._temp = torch.full((b,), float(self.cfg.temperature), dtype=torch.float32,
                                device=dev)
        self._cfg_w = torch.full((b,), 0.6, dtype=torch.float32, device=dev)
        self._seeds = torch.zeros((b,), **i64)
        self._codes_buf = torch.zeros((b, self.max_frames + self.chunk), **i64)

    # -- submission -------------------------------------------------------------

    def submit(self, text: str, ref_audio: Optional[str] = None,  # type: ignore[override]
               cfg_weight: float = 0.6, min_frames: int = 0, max_frames: Optional[int] = None,
               temperature: Optional[float] = None, stream: bool = False, priority: int = 0,
               expires_s: Optional[float] = None, seed: Optional[int] = None) -> ServeRequest:
        """Queue one utterance; returns a future-like :class:`ServeRequest`.

        ``ref_audio`` selects the voice (falling back to the model's primed
        ``conditionals``, then to the unconditioned default voice). ``seed``
        pins the sampling stream: the result matches
        ``ChatterboxModel.generate(..., seed=seed)`` token for token.
        """
        if seed is None:
            seed = self._default_seed()
        if max_frames is None:
            # The one-shot default budget: ~2 tokens a character + 50, clamped.
            max_frames = int(np.clip(len(text) * 2.0 + 50, self.chunk, self.max_frames))
        max_frames = min(_round_up(int(max_frames), self.chunk), self.max_frames)
        req = ServeRequest(
            text, None, "English", ref_audio, None,
            min_frames=min(int(min_frames), max_frames), max_frames=max_frames,
            temperature=self.cfg.temperature if temperature is None else temperature,
            stream=stream, priority=priority, expires_s=expires_s, seed=seed,
        )
        req.cfg_weight = float(cfg_weight)
        return self._enqueue(req)

    # -- admission --------------------------------------------------------------

    def _admit_build(self, picked: List[ServeRequest]):
        """Tokenize and resolve the speaker conditioning of an admission
        group; a bad input fails its own request only."""
        built = []
        for req in picked:
            try:
                spk = None
                if req.ref_audio is not None:
                    spk = self._spk_cache.get(req.ref_audio)
                    if spk is None:
                        spk = np.asarray(self.model.prepare_conditionals(req.ref_audio),
                                         np.float32)
                        self._spk_cache[req.ref_audio] = spk
                elif self.model.conditionals is not None:
                    spk = np.asarray(self.model.conditionals, np.float32)
                ids = np.asarray(self.model.tokenizer.encode(req.text), np.int64)
            except Exception as exc:  # noqa: BLE001 — bad input fails ONE request
                req.error = exc
                self._end_request(req)
                continue
            n_cond = int(ids.shape[0]) + 1 + (1 if spk is not None else 0)
            if n_cond > self.max_prompt:
                req.error = ValueError(
                    f"prompt is {n_cond} tokens; engine max_prompt={self.max_prompt}")
                self._end_request(req)
                continue
            built.append((req, (ids, spk), n_cond, _round_up(n_cond, CB_PROMPT_BUCKET)))
        return built

    def _admit_prefill(self, built) -> int:
        """Prefill the admission group's cond and uncond rows and scatter
        both row sets into the ring. Reads nothing back."""
        free = self._free_rows()
        p = max(pp for _, _, _, pp in built)
        a_real = len(built)
        a = 1 << (a_real - 1).bit_length()  # admit-batch bucket (1, 2, 4, 8, ...)
        rows_real = free[:a_real]
        dev = self.device
        spk_dim = self.model.params["spk_proj"].shape[0]

        ids_slotted = np.zeros((2 * a, p), np.int64)
        text_mask = np.zeros((2 * a, p), np.float32)
        bos_mask = np.zeros((2 * a, p), np.float32)
        spk_mask = np.zeros((2 * a, p), np.float32)
        spk_vecs = np.zeros((2 * a, spk_dim), np.float32)
        lens2 = np.zeros(2 * a, np.int64)  # [cond lens, uncond lens]
        # Bucket padding repeats the last admitted request (the same target
        # row): duplicate scatters carry identical values.
        group = built + [built[-1]] * (a - a_real)
        for j, (_req, (ids, spk), n_cond, _pp) in enumerate(group):
            nt = ids.shape[0]
            # cond row j: [pad..., spk?, text..., BOS]; uncond row a+j: [pad..., spk?, BOS]
            ids_slotted[j, p - 1 - nt: p - 1] = ids
            text_mask[j, p - 1 - nt: p - 1] = 1.0
            bos_mask[j, p - 1] = bos_mask[a + j, p - 1] = 1.0
            if spk is not None:
                spk_mask[j, p - 2 - nt] = spk_mask[a + j, p - 2] = 1.0
                spk_vecs[j] = spk_vecs[a + j] = spk
            lens2[j] = n_cond
            lens2[a + j] = 1 + int(spk is not None)
        rope_pos = np.maximum(np.arange(p, dtype=np.int64)[None, :] - (p - lens2)[:, None], 0)
        attn_mask = np.arange(p)[None, :] >= (p - lens2)[:, None]

        reqs = [r for r, _, _, _ in group]
        min_f = _upload(np.array([r.min_frames for r in reqs], np.int64), dev)
        temps = _upload(np.array([r.temperature for r in reqs], np.float32), dev)
        ws = _upload(np.array([r.cfg_weight for r in reqs], np.float32), dev)
        seed_vals = _upload(np.array([r.seed for r in reqs], np.int64), dev)

        pk, pv = self.model._shard_kv(2 * a, p)
        pkv = torch.zeros((2 * a, p), dtype=torch.bool, device=dev)
        logits, pk, pv, pkv = _prefill(
            self.model.params, self.cfg, _upload(ids_slotted, dev), _upload(text_mask, dev),
            _upload(bos_mask, dev), _upload(spk_mask, dev), _upload(spk_vecs, dev),
            _upload(rope_pos, dev), _upload(attn_mask, dev), pk, pv, pkv, tp=self._tp,
        )
        # Frame 0 from the prefill logits with the per-request (seed, 0) key;
        # EOS masked on both rows under a floor, as the one-shot start.
        sup = min_f > 0
        _suppress_eos(logits, self.cfg.speech_eos, torch.cat([sup, sup]))
        tok0 = _cfg_sample(logits, seed_vals, torch.zeros_like(seed_vals), temps, self.top_k, ws)

        # Every data rank prefilled the group; each keeps the requests it
        # holds, their cond rows and their uncond rows (the group's j, a + j).
        js, local = self._own(rows_real + [rows_real[-1]] * (a - a_real))
        if js:
            pick = self._picker(js, a)
            pick2 = self._picker(js + [a + j for j in js], 2 * a)
            rows_t = _upload(np.array(local, np.int64), dev)
            rows2 = torch.cat([rows_t, rows_t + self._n_local])
            _insert_rows(self._cache_k, self._cache_v, self._key_valid, rows2, pick2(pk, 1),
                         pick2(pv, 1), pick2(pkv), self._col)

            # Every per-request state tensor; frame 0 of the log is the
            # prefill-sampled token, the rest of the row zeroed.
            tok0 = pick(tok0)
            row0 = torch.zeros((len(js), self._codes_buf.shape[1]), dtype=torch.int64,
                               device=dev)
            row0[:, 0] = tok0
            self._last_codes[rows_t] = tok0
            self._done[rows_t] = tok0 == self.cfg.speech_eos
            self._active_dev.index_fill_(0, rows_t, True)
            self._rope_next[rows2] = pick2(_upload(lens2, dev))
            self._frames_done.index_fill_(0, rows_t, 1)
            self._min_frames[rows_t] = pick(min_f)
            self._temp[rows_t] = pick(temps)
            self._cfg_w[rows_t] = pick(ws)
            self._codes_buf[rows_t] = row0
            self._seeds[rows_t] = pick(seed_vals)
        self.admissions += 1

        now = time.time()
        for j, (req, _, _, _) in enumerate(built):
            row = rows_real[j]
            self._active[row] = True
            slot = self._slots[row]
            slot.req = req
            slot.pieces = []
            slot.emitted = 0
            slot.done_seen = None  # EOS at frame 0 surfaces via the done carry
            slot.frames = 1
            req.t_admit = now
        return a_real

    # -- model hooks ------------------------------------------------------------

    def _dispatch(self) -> _Lagged:
        self.dispatches += 1
        with profiling.stage("serve/cb_decode_chunk"):
            (done_chunk, self._last_codes, self._done, self._rope_next,
             self._frames_done) = _cb_serve_decode_chunk(
                self.model.params, self._cache_k, self._cache_v, self._key_valid,
                self._codes_buf, self.cfg, self._col, self._rope_next, self._last_codes,
                self._done, self._active_dev, self._seeds, self._temp, self._cfg_w,
                self._frames_done, self._min_frames, self.chunk, self.top_k, self._tp,
            )
        self._col = (self._col + self.chunk) % self.ring
        return _Lagged(all_gather(done_chunk, 0, self._data))

    def _widen_lo(self, lo: int, hi: int) -> int:
        """Streamed windows span at least one watermark-envelope window of
        samples (the one-shot ``stream_chunks`` widening)."""
        need = -(-_ENV_WINDOW // self.cfg.codec.hop) + 1
        return min(lo, max(hi - need, 0))

    def _stream_vocode(self, log, rows, los, ends, w: int):
        return _cb_vocode_windows(self.model.params, self.cfg, log, rows, los, ends, w)

    def _stream_piece(self, wav_row, lo: int, hi: int, emit_from: int, emit_to: int):
        hop = self.cfg.codec.hop
        marked = apply_watermark(wav_row[: (hi - lo) * hop], offset=lo * hop)
        return marked[(emit_from - lo) * hop: (emit_to - lo) * hop]

    def _retire_vocode(self, log, rows_arr, ends_arr, t: int):
        return _cb_vocode_rows(self.model.params, self.cfg, log, rows_arr, ends_arr, t)

    def _finish_wav(self, wav_row, end: int):
        """The watermarked waveform, as ``ChatterboxModel.generate`` returns it."""
        return apply_watermark(wav_row[: end * self.cfg.codec.hop])
