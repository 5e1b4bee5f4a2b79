"""Qwen-class codec-LM TTS model: AR talker + code predictor + codec (PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen/model.py``. The stages are plain
functions on tensors; :class:`QwenTTSModel` is an ``nn.Module`` whose
parameters carry the names of the JAX params tree (``talker.blocks.wqkv.q``,
``codec.decoder.ups.0``, ...).

* Prompts are LEFT-padded into a static-shape KV cache so every row's last
  prompt token lands on the same slot; prefill runs the talker over the
  whole prompt through the prefill attention kernel.
* Decode runs in chunks of ``_chunk()`` steps; JAX's ``lax.scan`` becomes a
  loop of one step function (:func:`_decode_step`), which runs the talker
  (decode attention kernel), seeded top-k Gumbel sampling and the residual
  code predictor on device-resident state alone. A call's decode is one
  :class:`_Decode` (:meth:`QwenTTSModel._decoding`), which owns its buffers
  and runs the prefill, frame 0 and the chunk loop for both
  ``generate_codes`` and ``stream_chunks``. On a CUDA device the step is
  captured once per key as a CUDA graph and replayed (:class:`_StepGraph`):
  one graph launch a step in place of some two thousand kernel launches.
  On the CPU and under tensor parallelism over several ranks it runs
  eagerly. The host checks cancellation and the lagged all-done flag
  between chunks only.
* The talker is the dense GQA stack of the Qwen presets, or a hybrid one
  (``lfm2-8b-a1b``: short convolutions, attention, routed experts;
  ``granite-4.0-h-small``: Mamba-2 mixers, attention without RoPE, routed
  experts beside a shared one), whose short-convolution or Mamba state lies
  in the step graph's arena beside the KV caches (the talker's input
  vectors scaled by its ``embedding_multiplier``) and whose step counts the
  distinct experts of each expert layer;
  each ``qwen/decode_chunk`` span carries them as ``experts_touched``,
  fetched once a call (with a chunk's codes in ``stream_chunks``). It runs
  in bf16 on one device, without serving, speculation or meshes.
* The codec vocoder turns the codes into a 24 kHz waveform per length
  bucket; :meth:`QwenTTSModel.stream_chunks` vocodes a sliding window per
  decode chunk instead, and voice cloning encodes the reference audio with
  the codec's encoder (:meth:`QwenTTSModel._reference_codes`).
* :meth:`QwenTTSModel.from_pretrained` serves a native checkpoint as
  exported (:meth:`QwenTTSModel.save_checkpoint`, ``models.checkpoint``),
  converts an HF safetensors directory (``models.qwen.weights``), or
  builds a preset with random weights.

Sampling reproduces the JAX package's bits: row i's noise at frame f comes
from ``fold_in(fold_in(PRNGKey(0x5EED), seeds[i]), f)`` through the port's
threefry (``utils.prng``), so the same seeds draw the same tokens;
:func:`_derive_row_seeds` turns a caller's threefry key into those seeds
as the JAX package does.

The JAX decode attends to a static window of the cache that grows per
chunk (``_kv_window``), a shortcut for its compiler; the port's decode
kernel skips masked slots exactly, so the port decodes over the whole cache.
On the CUDA kernel the split of the keys follows the cache length, so a
near-tie could round to another code than a windowed decode would; the
streamed and the one-shot decode of a text share the cache length and
decode the same codes.

Meshes (``parallel``; one process per GPU, every rank making the same call
and returning the whole result): under data parallelism a batch pads to a
multiple of the ``data`` axis with copies of row 0 (and its seed), each
rank prefills and decodes its rows, the lagged all-done flag is a max over
``data``, and the codes and done flags are all-gathered once at the end;
under tensor parallelism the stages run on this rank's weight shards and
KV heads (``tp``); under sequence parallelism the prefill splits the
prompt over ``model`` (``sp_mesh``) and writes the whole cache, which is
the decode layout. The vocoder runs the whole batch on every rank.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import math
import os
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel.collectives import all_gather, all_reduce_max, all_reduce_sum, vocab_embed
from ...utils import prng, profiling
from ...utils.tokenizer import load_tokenizer
from .. import transformer as tfm
from ..quantization import quantize_stack
from . import codec as codec_lib
from .config import PRESETS, QwenTTSConfig, resolve_config

Params = Dict[str, Any]

# Decode steps per chunk (the JAX package's compiled scan length).
CHUNK = int(os.environ.get("RHO_TTS_TPU_DECODE_CHUNK", "64"))


def _chunk() -> int:
    """Decode-chunk size, re-read from ``RHO_TTS_TPU_DECODE_CHUNK`` at call time."""
    return int(os.environ.get("RHO_TTS_TPU_DECODE_CHUNK", str(CHUNK)))


# Prompt bucket granularity (slots).
PROMPT_BUCKET = 64

# Named speakers for CustomVoice checkpoints (id -> speaker-table row).
SPEAKERS = ["Chelsie", "Aidan", "Vivian", "Ryan", "Aria", "Ethan", "Luna", "Harper", "James"]

_SAMPLER_BASE_SEED = 0x5EED


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: QwenTTSConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a seeded generator on ``device``.

    Shapes, scales and dtypes as the JAX ``init_params``; the values differ
    (a torch generator is not ``jax.random``), which throughput does not
    depend on.
    """
    device = torch.device(device or "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    t = cfg.talker
    n_res = cfg.codec.n_codebooks - 1
    cp_hidden = max(t.hidden // 2, 64)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(t.dtype)

    return {
        "text_embed": normal((cfg.text_vocab, t.hidden), 0.02),
        # Per-codebook audio embeddings, all sized audio_vocab for stacking.
        "audio_embed": normal((cfg.codec.n_codebooks, cfg.audio_vocab, t.hidden), 0.02),
        "speaker_embed": normal((cfg.n_speakers, t.hidden), 0.02),
        "talker": tfm.init_stack(gen, t, device),
        "lm_head": tfm._dense_init(gen, (t.hidden, cfg.audio_vocab), t.dtype, device),
        "code_predictor": {
            "w1": normal((n_res, 2 * t.hidden, cp_hidden), 0.02),
            "w2": normal((n_res, cp_hidden, cfg.codec.codebook_size), 0.02),
        },
        "codec": codec_lib.init_codec(gen, cfg.codec, device),
    }


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def prompt_embeds(params, cfg, ids_slotted, text_mask, codes_slotted, code_mask,
                  spk_ids, spk_mask, attn_mask, tp=None) -> torch.Tensor:
    """Assemble the prompt embeddings from the host-built index/mask arrays
    (the [spk?][ref text][text][ref codes][BOS] layout of
    ``_build_prompt_arrays``). Under ``tp`` the text table is this rank's
    vocab shard."""
    dt = params["text_embed"].dtype
    emb = vocab_embed(params["text_embed"], ids_slotted, tp) * text_mask[..., None].to(dt)
    for q in range(cfg.codec.n_codebooks):
        emb = emb + params["audio_embed"][q][codes_slotted[..., q]] * code_mask[..., None].to(dt)
    emb = emb + params["speaker_embed"][spk_ids][:, None, :] * spk_mask[..., None].to(dt)
    bos_mask = attn_mask.float() - text_mask - code_mask - spk_mask
    emb = emb + params["audio_embed"][0][cfg.audio_bos][None, None] * bos_mask[..., None].to(dt)
    return emb


def _talker_input(cfg, emb: torch.Tensor) -> torch.Tensor:
    """The talker's input vectors: ``emb`` times the talker's
    ``embedding_multiplier`` (itself where that is 1)."""
    m = cfg.talker.embedding_multiplier
    return emb if m == 1.0 else emb * m


def _prefill(params, cfg, ids_slotted, text_mask, codes_slotted, code_mask, spk_ids,
             spk_mask, rope_pos, attn_mask, cache_k, cache_v, key_valid, tp=None, sp_mesh=None,
             conv_state=None, ssm_state=None):
    """Prompt-embedding assembly + prefill. Writes the caches in place.

    ``tp``: the mesh axis the weights are sharded over; ``sp_mesh``: a
    sequence-parallel prefill (``transformer.stack_forward``);
    ``conv_state`` / ``ssm_state``: a hybrid talker's short-convolution or
    Mamba state, zeroed, which the prefill leaves holding the state after
    the prompt's last position. ``key_valid``,
    zeroed, is set in place to the prompt's slots. Returns ``(logits (B, V)
    f32, cache_k, cache_v, key_valid)``, the caller's tensors.
    """
    p = ids_slotted.shape[1]
    embeds = prompt_embeds(params, cfg, ids_slotted, text_mask, codes_slotted, code_mask,
                           spk_ids, spk_mask, attn_mask, tp)
    h, (ck, cv) = tfm.stack_forward(
        params["talker"], cfg.talker, _talker_input(cfg, embeds), rope_pos,
        kv_caches=(cache_k, cache_v), cache_len=0, attn_mask=attn_mask,
        key_valid=key_valid, fused_prefill=True, sp_mesh=sp_mesh, tp=tp, conv_state=conv_state,
        ssm_state=ssm_state,
    )
    key_valid[:, :p] = attn_mask
    logits = h[:, -1].float() @ params["lm_head"].float()
    return logits, ck, cv, key_valid


def _gumbel_noise(seeds: torch.Tensor, frames: torch.Tensor, top_k: int) -> torch.Tensor:
    """Sampler noise ``(..., B, top_k)`` for seeds ``(B,)`` at frames ``(..., B)``
    (or broadcastable): a pure function of ``(seed, frame)`` per row."""
    base = prng.PRNGKey(_SAMPLER_BASE_SEED, device=seeds.device)
    keys = prng.fold_in(prng.fold_in(base, seeds), frames)
    return prng.gumbel(keys, (top_k,))


def _sample_with_noise(logits, temperature, top_k: int, noise):
    """``temperature`` is a number, or a ``(B,)`` tensor of per-row values."""
    # A tensor divisor, not a Python scalar: division by a scalar may run as
    # a multiplication by its reciprocal, which rounds differently.
    if isinstance(temperature, torch.Tensor):
        t = temperature.float().clamp_min(float(np.float32(1e-5)))[:, None]
    else:
        t = torch.full((1, 1), max(float(np.float32(temperature)), float(np.float32(1e-5))),
                       dtype=torch.float32, device=logits.device)
    logits = logits.float() / t
    vals, idxs = torch.topk(logits, top_k, dim=-1)
    choice = torch.argmax(vals + noise, dim=-1)
    return torch.gather(idxs, 1, choice[:, None])[:, 0]


def _sample_token_seeded(logits, seeds, frames, temperature, top_k: int):
    """Schedule-reproducible top-k Gumbel sampling.

    Row ``i``'s noise is a pure function of ``(seeds[i], frames[i])``, bit
    for bit the JAX package's; ``top_k=1`` is exact greedy. ``temperature``
    is a number or a ``(B,)`` tensor.
    """
    return _sample_with_noise(logits, temperature, top_k, _gumbel_noise(seeds, frames, top_k))


def _derive_row_seeds(key: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row sampling seeds from a caller's threefry key ``(2,)``, one draw
    per row: ``jax.random.randint(key, (n,), 0, int32 max)`` bit for bit, on
    the key's device."""
    return prng.randint(key, (int(n),), 0, int(np.iinfo(np.int32).max))


def _predict_residuals(params, cfg, h_last, tok0, tp=None):
    """Predict residual codebooks from hidden state + primary-code embed.
    Under ``tp`` ``w1`` is column- and ``w2`` row-parallel."""
    n_res = cfg.codec.n_codebooks - 1
    if n_res == 0:
        return torch.zeros((h_last.shape[0], 0), dtype=torch.int64, device=h_last.device)
    w1, w2 = params["code_predictor"]["w1"], params["code_predictor"]["w2"]
    e0 = params["audio_embed"][0][tok0]  # (B, H)
    cp_in = torch.cat([h_last, e0], dim=-1).to(w1.dtype)
    hidden = F.silu(torch.einsum("bd,qdc->qbc", cp_in, w1).float())
    logits = all_reduce_sum(torch.einsum("qbc,qce->qbe", hidden.to(w2.dtype), w2), tp)
    return torch.argmax(logits, dim=-1).T  # (B, Q)


class _StepState:
    """The device state one decode step reads and advances, for a chunk of
    ``steps`` steps over ``b`` rows: every value that changes from step to
    step lives here, so the step depends on no host value.

    ``slot0`` (0-d) is the chunk's first cache slot and ``t`` (0-d) the
    step's index in the chunk, which the step advances; ``rope_base`` ``(B,)``
    the rows' RoPE positions at ``t = 0``; ``last_codes`` ``(B, nq)`` and
    ``done`` ``(B,)`` the last frame; ``noise`` ``(steps, B, top_k)`` the
    sampler noise and ``gate`` ``(steps,)`` the minimum-duration gate of each
    step; ``temperature`` ``(B,)`` the rows' sampling temperatures; ``codes``
    ``(B, steps, nq)`` and ``dones`` ``(B, steps)`` what each step emits. A
    talker with ``moe_layers`` expert layers adds ``touched`` ``(steps,
    moe_layers)`` int32, the distinct experts each expert layer ran at each
    step, summed from ``hits`` ``(moe_layers, experts)``, which the experts
    kernel writes at each step (1 for each expert chosen).
    """

    def __init__(self, b: int, nq: int, steps: int, top_k: int, device, moe_layers: int = 0,
                 experts: int = 0):
        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=device)

        self.slot0 = empty((), torch.int64)
        self.t = empty((), torch.int64)
        self.rope_base = empty((b,), torch.int64)
        self.last_codes = empty((b, nq), torch.int64)
        self.done = empty((b,), torch.bool)
        self.noise = empty((steps, b, top_k), torch.float32)
        self.gate = empty((steps,), torch.bool)
        self.temperature = empty((b,), torch.float32)
        self.codes = empty((b, steps, nq), torch.int64)
        self.dones = empty((b, steps), torch.bool)
        self.touched = empty((steps, moe_layers), torch.int32) if moe_layers else None
        self.hits = empty((moe_layers, experts), torch.int32) if moe_layers else None

    def load(self, slot0: int, rope_base, last_codes, done, noise, gate, temperature) -> None:
        """Write a chunk's inputs in place (fills and copies: no host wait)."""
        self.slot0.fill_(slot0)
        self.t.zero_()
        self.rope_base.copy_(rope_base)
        self.last_codes.copy_(last_codes)
        self.done.copy_(done)
        self.noise.copy_(noise)
        self.gate.copy_(gate)
        if isinstance(temperature, torch.Tensor):
            self.temperature.copy_(temperature)
        else:
            self.temperature.fill_(float(np.float32(temperature)))


def _decode_step(params, cfg, lm_head, cache_k, cache_v, key_valid, st: _StepState,
                 top_k: int, tp=None, conv_state=None, ssm_state=None) -> None:
    """One AR decode step on the chunk's device state ``st``: embed the last
    frame, run the talker with its K/V written at slot ``slot0 + t``, sample
    the primary code (EOS floored while the step's gate is set), predict the
    residual codes, write the frame at step ``t`` of ``st.codes`` / ``st.dones``
    and advance ``t``. Caches and ``key_valid`` are updated in place; ``tp``
    as :func:`_prefill`; ``conv_state`` / ``ssm_state`` (a hybrid talker's)
    advance in place, and the distinct experts of each expert layer go to
    ``st.touched`` at step ``t``. Capturable: it reads and writes only
    ``st``, the caches, ``key_valid``, the talker's states, ``lm_head`` and
    the weights."""
    nq = cfg.codec.n_codebooks
    embs = params["audio_embed"]
    t = st.t.view(1)
    with profiling.region("qwen/embed"):
        emb = embs[0][st.last_codes[:, 0]]
        for q in range(1, nq):
            emb = emb + embs[q][st.last_codes[:, q]]
    slot = st.slot0 + st.t
    h, _ = tfm.stack_forward(
        params["talker"], cfg.talker, _talker_input(cfg, emb[:, None, :]),
        (st.rope_base + st.t)[:, None],
        kv_caches=(cache_k, cache_v), cache_len=slot, attn_mask=None,
        key_valid=key_valid, tp=tp, uniform_slot=True, conv_state=conv_state,
        expert_hits=st.hits, ssm_state=ssm_state,
    )
    if st.touched is not None:
        st.touched.index_copy_(0, t, st.hits.sum(dim=1, dtype=torch.int32)[None])
    with profiling.region("qwen/sample"):
        key_valid.index_fill_(1, slot.view(1), True)
        h_last = h[:, -1]
        logits = h_last.float() @ lm_head
        # Enforce a minimum duration: -1e30 where the gate is set, untouched elsewhere.
        logits[:, cfg.audio_eos] = torch.where(st.gate.index_select(0, t), -1e30,
                                               logits[:, cfg.audio_eos])
        tok0 = _sample_with_noise(logits, st.temperature, top_k, st.noise.index_select(0, t)[0])
        newly_done = tok0 == cfg.audio_eos
        tok0 = torch.where(st.done, cfg.audio_pad, tok0)
    with profiling.region("qwen/residuals"):
        res = _predict_residuals(params, cfg, h_last,
                                 tok0.clamp_max(cfg.codec.codebook_size - 1), tp)
        res = torch.where(st.done[:, None], 0, res)
        codes = torch.cat([tok0[:, None], res], dim=-1)
        st.done.logical_or_(newly_done)
        st.codes.index_copy_(1, t, codes[:, None])
        st.dones.index_copy_(1, t, st.done[:, None])
        st.last_codes.copy_(codes)
        st.t.add_(1)


class _Chunk(NamedTuple):
    """A decode chunk's result, copies the next chunk does not overwrite:
    ``codes`` ``(B, steps, nq)`` and ``dones`` ``(B, steps)``, what each step
    emitted; ``last_codes`` ``(B, nq)`` and ``done`` ``(B,)``, the last frame;
    ``touched`` ``(steps, expert layers)`` int32, the distinct experts of each
    step's expert layers (None without experts); ``mode``, how the steps ran:
    ``"capture"``, ``"replay"`` or ``"eager"`` (:meth:`_Decode.run`)."""

    codes: torch.Tensor
    dones: torch.Tensor
    last_codes: torch.Tensor
    done: torch.Tensor
    touched: Optional[torch.Tensor]
    mode: str


def _decode_chunk(dec: "_Decode", key_valid, slot0: int, rope_base, last_codes, done, seeds,
                  temperature, step_base: int, min_frames: int, steps: int) -> _Chunk:
    """``steps`` AR decode steps of the call ``dec`` from cache slot ``slot0``.

    The JAX scan as a loop of :func:`_decode_step` (:meth:`_Decode.run`):
    the call's caches, ``key_valid`` and short-convolution state are updated
    in place. ``key_valid`` is ``dec.key_valid`` as it stands before the
    chunk, a parameter of its own because the benchmark's traced chunk binds
    it and ``steps`` by name (ROADMAP B8).
    """
    with profiling.region("qwen/chunk_prologue"):
        # Every step's sampler noise in one batched pass: it depends only on
        # (seed, frame), both known before the chunk runs.
        frames = step_base + torch.arange(steps, dtype=torch.int64, device=seeds.device)
        noise = _gumbel_noise(seeds, frames[:, None], dec.top_k)  # (steps, B, top_k)
        dec.state.load(slot0, rope_base, last_codes, done, noise, frames < min_frames,
                       temperature)
    mode = dec.run(steps)
    st = dec.state
    return _Chunk(*(None if x is None else x.clone()
                    for x in (st.codes, st.dones, st.last_codes, st.done, st.touched)), mode)


def _attach_touched(chunks) -> None:
    """Fetch the distinct-expert counters of ``chunks`` (``(span attrs,
    (steps, expert layers) tensor)``) in one copy and put each chunk's, a
    list a step of one count an expert layer, on its ``qwen/decode_chunk``
    span as ``experts_touched``."""
    values = torch.stack([t for _, t in chunks]).cpu().tolist()
    for (attrs, _), v in zip(chunks, values):
        attrs["experts_touched"] = v


#: decode steps captured as CUDA graphs, and graph replays, in this process
graph_captures = 0
graph_replays = 0

#: decode-step graphs a model keeps, one a key, the least recently used dropped first
GRAPH_KEYS = 4


def _step_leaves(params) -> List[torch.Tensor]:
    """The weights a decode step reads, in a fixed order."""
    out: List[torch.Tensor] = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            out.append(node)

    for key in ("audio_embed", "talker", "lm_head", "code_predictor"):
        walk(params[key])
    return out


def _arena_layout(cfg_local, b: int, s: int, kv_dtype) -> Tuple[Tuple[int, ...], List[int]]:
    """The shape of one KV cache of a key and the byte offsets of its two
    caches, its ``key_valid``, a hybrid talker's f32 short-convolution state
    or its f32 Mamba convolution and scan states, and the end in an arena
    (each 256-aligned)."""
    shape = (cfg_local.attn_layers, b, s, cfg_local.kv_heads, cfg_local.head_dim)
    sizes = [math.prod(shape) * torch.empty((), dtype=kv_dtype).element_size()] * 2 + [b * s]
    if cfg_local.conv_layers:
        sizes.append(math.prod(_conv_shape(cfg_local, b)) * 4)
    if cfg_local.mamba_layers:
        sizes += [math.prod(tfm.ssm_conv_shape(cfg_local, b)) * 4,
                  math.prod(tfm.ssm_scan_shape(cfg_local, b)) * 4]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + _round_up(n, 256))
    return shape, offsets


def _conv_shape(cfg_local, b: int) -> Tuple[int, ...]:
    return (cfg_local.conv_layers, b, tfm.CONV_TAPS - 1, cfg_local.hidden)


class _StepGraph:
    """One key's decode step as a CUDA graph, and every buffer it reads and writes.

    The key is (rows, cache length, top_k, KV dtype, chunk steps) on one
    model, so the weights and the quantization are fixed. The KV caches,
    ``key_valid`` and a hybrid talker's short-convolution or Mamba states are
    views at the start of the model's arena (:class:`_StepGraphs`), which the call
    holding them zeroes (:class:`_Decode`); the chunk's inputs go into
    ``state`` and the model's f32 ``lm_head`` before the replays. The graph
    is captured and replayed on its device's one decode stream
    (:func:`_decode_stream`, :meth:`_Decode.run`), so graphs never run at
    the same time and share the per-stream buffers of the kernels that keep
    one (``ssm_step``'s tickets).
    """

    def __init__(self, arena: torch.Tensor, cfg_local, b: int, s: int, kv_dtype, nq: int,
                 steps: int, top_k: int, lm_head: torch.Tensor):
        shape, at = _arena_layout(cfg_local, b, s, kv_dtype)
        # Ordinary tensors, not inference tensors: a caller may run outside
        # inference mode.
        with torch.inference_mode(False):
            self.cache_k, self.cache_v = (arena[at[i]:at[i + 1]].view(kv_dtype)
                                          [:math.prod(shape)].view(shape) for i in (0, 1))
            self.key_valid = arena[at[2]:at[2] + b * s].view(torch.bool).view(b, s)
            f32 = [arena[at[i]:at[i + 1]].view(torch.float32) for i in range(3, len(at) - 1)]
            self.conv_state = self.ssm_state = None
            if cfg_local.conv_layers:
                conv = _conv_shape(cfg_local, b)
                self.conv_state = f32[0][:math.prod(conv)].view(conv)
            if cfg_local.mamba_layers:
                shapes = tfm.ssm_conv_shape(cfg_local, b), tfm.ssm_scan_shape(cfg_local, b)
                self.ssm_state = tuple(buf[:math.prod(shp)].view(shp) for buf, shp in
                                       zip(f32[bool(cfg_local.conv_layers):], shapes))
            self.state = _StepState(b, nq, steps, top_k, arena.device, cfg_local.moe_layers,
                                    cfg_local.n_experts)
        self.lm_head = lm_head
        self.graph = None
        self.leaves: List[torch.Tensor] = []  # the weights the graph was captured on

    def capture(self, step, leaves, stream) -> None:
        """Run ``step`` once eagerly on ``stream``, so the kernels' per-stream
        buffers and cuBLAS's workspace exist before the capture records their
        addresses, then capture one step (which runs nothing)."""
        step()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            step()
        self.graph, self.leaves = graph, leaves


_decode_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _decode_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream every decode-step graph of ``device`` is captured and replayed on."""
    if device not in _decode_streams:
        _decode_streams[device] = torch.cuda.Stream(device)
    return _decode_streams[device]


class _StepGraphs:
    """A model's decode-step graphs, by key, and the buffers they share.

    One call holds the store at a time (:meth:`acquire` to :meth:`release`,
    :meth:`QwenTTSModel._decoding`); another call meanwhile gets no graph
    and decodes eagerly over new buffers. Every key's buffers lie at the
    start of one byte arena, as large as the largest key's need: the model
    keeps the buffers of one call, whatever mix of lengths came before. An
    arena outgrown is freed with the graphs, which hold its addresses. At
    most :data:`GRAPH_KEYS` graphs are kept; the f32 ``lm_head`` is one for
    all.
    """

    def __init__(self):
        self._graphs: "collections.OrderedDict[tuple, _StepGraph]" = collections.OrderedDict()
        self._arena: Optional[torch.Tensor] = None
        self._lm_head: Optional[torch.Tensor] = None
        self._held = False
        self._lock = threading.Lock()

    def acquire(self, cfg_local, b: int, s: int, kv_dtype, nq: int, steps: int, top_k: int,
                lm_head: torch.Tensor) -> Optional[_StepGraph]:
        """The key's graph, made if new, with the store held for the caller
        until :meth:`release`; None while another call holds it."""
        key, dev = (b, s, top_k, kv_dtype, steps), lm_head.device
        with self._lock:
            if self._held:
                return None
            graph = self._graphs.get(key)
            if graph is None:
                need = _arena_layout(cfg_local, b, s, kv_dtype)[1][-1]
                outgrown = self._arena is None or self._arena.numel() < need
                if self._graphs and (outgrown or len(self._graphs) >= GRAPH_KEYS):
                    if dev.type == "cuda":  # no replay of a graph dropped here still runs
                        _decode_stream(dev).synchronize()
                if outgrown:
                    self._graphs.clear()
                    self._arena = None  # freed before the larger one is made
                    with torch.inference_mode(False):
                        self._arena = torch.empty(need, dtype=torch.uint8, device=dev)
                while len(self._graphs) >= GRAPH_KEYS:
                    self._graphs.popitem(last=False)
                if self._lm_head is None:
                    with torch.inference_mode(False):
                        self._lm_head = torch.empty(lm_head.shape, dtype=torch.float32,
                                                    device=dev)
                graph = self._graphs[key] = _StepGraph(self._arena, cfg_local, b, s, kv_dtype,
                                                       nq, steps, top_k, self._lm_head)
            self._graphs.move_to_end(key)
            self._held = True
            return graph

    def release(self) -> None:
        self._held = False


class _Decode:
    """One call's decode: every buffer its steps read and write, and how they run.

    Made by :meth:`QwenTTSModel._decoding` for ``b`` local rows over ``s``
    cache slots. It holds the KV caches, ``key_valid`` and a hybrid talker's
    short-convolution or Mamba states, zeroed; the steps' :class:`_StepState`; the f32
    ``lm_head``, copied once a call (state and head only with a ``top_k``);
    and ``graph``, the model's :class:`_StepGraph` for the key, whose
    buffers these then are, or None: new buffers, and the steps run eagerly.
    :meth:`prefill` and :meth:`chunks` fill them; :meth:`run` runs a
    chunk's steps.
    """

    def __init__(self, model: "QwenTTSModel", b: int, s: int, top_k: Optional[int], steps: int,
                 graph: Optional[_StepGraph]):
        cfg, dev = model.config, model.device
        self.params, self.cfg, self.tp = model.params, cfg, model.tp_axis
        self.top_k, self.steps, self.graph = top_k, steps, graph
        if graph is None:
            self.cache_k, self.cache_v = model._shard_kv(b, s)
            self.key_valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
            self.conv_state = tfm.make_conv_state(cfg.talker, b, dev)
            self.ssm_state = tfm.make_ssm_state(cfg.talker, b, dev)
            self.state = None if top_k is None else _StepState(
                b, cfg.codec.n_codebooks, steps, top_k, dev, cfg.talker.moe_layers,
                cfg.talker.n_experts)
            # f32 logits over the bf16 head, as JAX's dot
            self.lm_head = None if top_k is None else self.params["lm_head"].float()
        else:
            self.cache_k, self.cache_v = graph.cache_k, graph.cache_v
            self.key_valid, self.conv_state = graph.key_valid, graph.conv_state
            self.ssm_state = graph.ssm_state
            for buf in (self.cache_k, self.cache_v, self.key_valid, self.conv_state,
                        *(self.ssm_state or ())):
                if buf is not None:
                    buf.zero_()
            self.state, self.lm_head = graph.state, graph.lm_head.copy_(self.params["lm_head"])

    def prefill(self, a: Dict[str, torch.Tensor], sp_mesh=None) -> torch.Tensor:
        """Prefill the uploaded prompt arrays ``a`` into the call's buffers
        (:func:`_prefill`); returns the last position's logits ``(B, V)`` f32.
        A talker with Mamba layers puts its scan's chunk count on the
        ``qwen/prefill`` span (``ssm_chunks``)."""
        talker, p = self.cfg.talker, a["attn_mask"].shape[1]
        attrs = {"ssm_chunks": -(-p // talker.ssm_chunk)} if talker.mamba_layers else {}
        with profiling.stage("qwen/prefill", **attrs):
            return _prefill(self.params, self.cfg, a["ids_slotted"], a["text_mask"],
                            a["codes_slotted"], a["code_mask"], a["spk_ids"], a["spk_mask"],
                            a["rope_pos"], a["attn_mask"], self.cache_k, self.cache_v,
                            self.key_valid, tp=self.tp, sp_mesh=sp_mesh,
                            conv_state=self.conv_state, ssm_state=self.ssm_state)[0]

    def chunks(self, a: Dict[str, torch.Tensor], seeds, temperature, min_frames: int,
               cancel_check=None, sp_mesh=None):
        """The prefill, frame 0 and the decode chunks of the call.

        Prefills ``a`` (:meth:`prefill`), samples frame 0 from its logits
        with each row's ``(seed, 0)`` noise (EOS floored under
        ``min_frames``) and yields it as ``(codes (B, nq), done (B,))``;
        then yields each chunk as ``(its qwen/decode_chunk span's attrs,
        _Chunk)`` until the cache is full, ``cancel_check`` run before each.
        The caller stops it where it has what it needs.
        """
        cfg, p = self.cfg, a["attn_mask"].shape[1]
        logits = self.prefill(a, sp_mesh)
        if min_frames > 0:
            logits[:, cfg.audio_eos] = -1e30
        b, dev = logits.shape[0], logits.device
        tok0 = _sample_token_seeded(logits, seeds, torch.zeros((b,), dtype=torch.int64, device=dev),
                                    temperature, self.top_k)
        # Frame 0's residual codes are zeros, as in the JAX package.
        last_codes = torch.cat(
            [tok0[:, None], torch.zeros((b, cfg.codec.n_codebooks - 1), dtype=torch.int64,
                                        device=dev)], dim=-1,
        )
        done = tok0 == cfg.audio_eos
        yield last_codes, done
        rope_base = a["attn_mask"].sum(dim=1)  # each row's prompt length
        for slot0 in range(p, self.key_valid.shape[1], self.steps):
            if cancel_check is not None:
                cancel_check()
            with profiling.stage("qwen/decode_chunk", steps=self.steps) as attrs:
                out = _decode_chunk(self, self.key_valid, slot0, rope_base + (slot0 - p),
                                    last_codes, done, seeds, temperature, slot0 - p + 1,
                                    min_frames, self.steps)
                attrs["graph"] = out.mode
            last_codes, done = out.last_codes, out.done
            yield attrs, out

    def run(self, steps: int) -> str:
        """Run ``steps`` decode steps over the call's buffers and ``state``
        and say how: ``"replay"`` the key's graph; ``"capture"`` it first
        where there is none for these weights (its warm-up runs the first
        step); or ``"eager"``, step by step, where the call has no graph or
        none may be captured now (a profiler records, which a capture's
        synchronisation and set-up would join, or a graph is being captured
        around the call)."""
        global graph_captures, graph_replays
        g = self.graph
        if g is not None:
            leaves = _step_leaves(self.params)
            if g.graph is not None and any(a is not b for a, b in zip(leaves, g.leaves)):
                g.graph = None  # the weights were replaced: their addresses are stale
            if g.graph is None and (profiling.profiler_active()
                                    or torch.cuda.is_current_stream_capturing()):
                g = None
        if g is None:
            for _ in range(steps):
                with profiling.region("qwen/step"):
                    self._step()
            return "eager"
        mode, todo = "replay", steps
        dev = self.cache_k.device
        stream = _decode_stream(dev)
        with torch.cuda.device(dev):
            caller = torch.cuda.current_stream()
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                if g.graph is None:
                    g.capture(self._step, leaves, stream)
                    graph_captures += 1
                    mode, todo = "capture", steps - 1  # the capture's warm-up ran the first step
                for _ in range(todo):
                    with profiling.region("qwen/step"):
                        g.graph.replay()
            caller.wait_stream(stream)
        graph_replays += todo
        return mode

    def _step(self) -> None:
        _decode_step(self.params, self.cfg, self.lm_head, self.cache_k, self.cache_v,
                     self.key_valid, self.state, self.top_k, self.tp, self.conv_state,
                     self.ssm_state)


def _decode_slots(max_chars: int, max_frames: Optional[int]) -> int:
    """The cache slots a call decodes into: ``max_frames`` (by default the
    longest text's characters + 50, within one chunk and 1500) in whole
    chunks."""
    if max_frames is None:
        max_frames = int(np.clip(max_chars * 1.0 + 50, _chunk(), 1500))
    return _round_up(max_frames, _chunk())


def _vocode(params, cfg, codes):
    """codes (B, T, nq) with specials clamped -> waveform (B, T*hop)."""
    clamped = codes.clamp_max(cfg.codec.codebook_size - 1)
    return codec_lib.decode_from_codes(params["codec"], cfg.codec, clamped)


def _vocode_rows(params, cfg, codes_buf, rows, ends, t: int):
    """Vocode ``codes_buf[rows, :t]`` with frames >= ``ends`` zeroed.

    Returns (wav (G, t*hop), the masked codes (G, t, nq)); the latter backs
    the serving engine's lazy code fetches.
    """
    f = codes_buf.shape[1]
    te = min(t, f)
    codes = codes_buf[rows, :te]
    if t > te:
        codes = F.pad(codes, (0, 0, 0, t - te))
    mask = torch.arange(t, device=codes.device)[None, :] < ends[:, None]
    codes = torch.where(mask[..., None], codes, 0)
    return _vocode(params, cfg, codes), codes


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


class _ParamTree(nn.Module):
    """A node of the params tree; its children are registered by key name."""


def _register(module: nn.Module, name: str, value):
    """Register ``value`` (a tensor, or a nested dict/list of them) under
    ``name``; return the same tree holding the registered parameters."""
    if isinstance(value, dict):
        node = _ParamTree()
        module.add_module(name, node)
        return {k: _register(node, str(k), v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        node = _ParamTree()
        module.add_module(name, node)
        return [_register(node, str(i), v) for i, v in enumerate(value)]
    param = nn.Parameter(value, requires_grad=False)
    module.register_parameter(name, param)
    return param


def _tree_quantization(params: Params) -> Optional[str]:
    """"int4" / "int8" when the talker holds such leaves, else None."""
    blocks = params.get("talker", {}).get("blocks", {})
    kinds = {k for w in blocks.values() if isinstance(w, dict) for k in ("q4", "q") if k in w}
    return "int4" if "q4" in kinds else ("int8" if "q" in kinds else None)


class QwenTTSModel(nn.Module):
    """Inference wrapper: tokenization, prompt building, chunked decode, vocoder.

    ``device=None`` means ``"cuda"``. ``params`` is a nested dict of tensors
    (``init_params``, ``from_jax.params_from_numpy`` or a loaded checkpoint);
    without it the weights are random from ``seed``. ``quantization`` "int8"
    or "int4" quantizes the talker's matmul weights (leaves already
    quantized stay as they are); without it, the model reports the
    quantization its params already carry. ``model_path``, a checkpoint
    directory, supplies its ``tokenizer.json`` when it has one.
    ``lora_path``, an adapter directory (``models.qwen.lora.save_lora``),
    is merged into the dense weights before any quantization; a quantized
    base raises ``ValueError``. ``parallel.inference.enable_*`` put the
    model on a mesh (``mesh``, ``tp_axis``, ``seq_parallel``).
    """

    def __init__(self, config: QwenTTSConfig, params: Optional[Params] = None, seed: int = 0,
                 quantization: Optional[str] = None, device=None,
                 model_path: Optional[str] = None, lora_path: Optional[str] = None):
        super().__init__()
        self.config = config
        self.device = torch.device(device or "cuda")
        self.model_path = model_path or config.name
        self.tokenizer = load_tokenizer(model_path, vocab_size=config.text_vocab)
        with profiling.stage("qwen/model_init"):  # the weights placed, merged and quantized
            if params is None:
                params = init_params(config, seed, self.device)
            if lora_path is not None:
                tfm.require_dense(config.talker, "lora_path")
                # Merge BEFORE quantization: adapters train in f32 against the
                # dense base; a quantized export cannot be merged into.
                from .lora import apply_lora, load_lora

                if _tree_quantization(params) is not None:
                    raise ValueError(
                        "lora_path requires a DENSE base (merge precedes "
                        "quantization); load the un-quantized export instead"
                    )
                lora, meta = load_lora(lora_path, device=self.device)
                # Ordinary tensors without autograd history, never inference tensors.
                with torch.inference_mode(False), torch.no_grad():
                    params = apply_lora(params, lora, scale=float(meta.get("scale", 1.0)))
            if quantization in ("int8", "int4"):
                tfm.require_dense(config.talker, f"quantization={quantization!r}")
                params = {**params, "talker": quantize_stack(params["talker"], quantization)}
            elif quantization not in (None, "none"):
                raise ValueError(f"Unsupported quantization: {quantization}")
            self.quantization = _tree_quantization(params)
            #: the registered parameters as a plain nested dict, for the stage functions
            self.params = {key: _register(self, key, value) for key, value in params.items()}
        self.sample_rate = config.codec.sample_rate
        self._ref_codes_cache: Dict[str, np.ndarray] = {}
        #: the device mesh (``parallel.inference``); None = one device
        self.mesh = None
        #: the mesh's ``model`` axis when the talker weights are sharded over it
        self.tp_axis = None
        #: prefill's prompt axis over the mesh's ``model`` axis
        self.seq_parallel = False
        #: the decode step's CUDA graphs and their buffers, by key
        self._step_graphs = _StepGraphs()

    # -- Loading --------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_path: str, seed: int = 0, quantization: Optional[str] = None,
                        device=None, lora_path: Optional[str] = None) -> "QwenTTSModel":
        """Build from a native checkpoint dir, an HF safetensors dir or a preset name.

        * A native checkpoint (:meth:`save_checkpoint`) restores the full
          tree onto ``device`` and is served as exported. An explicit
          ``quantization`` (``"none"`` meaning dense) that differs from a
          quantized export raises ``ValueError``; int8 or int4 on a dense
          export quantizes in the constructor.
        * A JAX-package (orbax) export raises ``ValueError`` naming the
          bridge, ``from_jax.params_from_numpy``.
        * A directory with ``*.safetensors`` goes through the HF loader
          (``models.qwen.weights``), quantizing on the host.
        * Anything else resolves a config (a preset name, or the size named
          in the path) and runs with random weights from ``seed``.

        ``lora_path`` merges an adapter into the dense weights before
        quantizing (see the constructor).
        """
        from .. import checkpoint as ckpt_lib
        from .weights import load_checkpoint

        path = str(model_path)
        if os.path.isdir(path) and (ckpt_lib.is_native_checkpoint(path)
                                    or ckpt_lib.is_jax_checkpoint(path)):
            params, manifest = ckpt_lib.load_params(path, family="qwen", device=device)
            preset = manifest.get("preset", "1.7B")
            cfg = PRESETS.get(preset) or resolve_config(preset)
            saved_quant = manifest.get("quantization")
            if saved_quant == "none":
                saved_quant = None
            requested = None if quantization == "none" else quantization
            if quantization is not None and saved_quant is not None and requested != saved_quant:
                raise ValueError(
                    f"Checkpoint at {path} was exported with quantization={saved_quant!r}; "
                    f"cannot serve as {quantization!r}"
                )
            model = cls(cfg, params=params, seed=seed, quantization=requested or saved_quant,
                        device=device, model_path=path, lora_path=lora_path)
            model.variant = manifest.get("variant")
            return model

        cfg = resolve_config(path)
        params = load_checkpoint(path, cfg, quantization=quantization, device=device)
        return cls(cfg, params=params, seed=seed, quantization=quantization, device=device,
                   model_path=path, lora_path=lora_path)

    def save_checkpoint(self, path: str) -> None:
        """Export the parameter tree as a native serving checkpoint.

        A quantized model writes its int8 / int4 leaves. The manifest records
        the CustomVoice/Base ``variant``, as the JAX package's does. On a mesh
        every rank calls it: a tensor-parallel model gathers its shards into
        the global tree (int4 row shards packed whole again), as JAX writes
        its global arrays, and the mesh's first rank writes it.
        """
        from .. import checkpoint as ckpt_lib

        from ...parallel.sharding import whole_params

        params = whole_params(self)  # a TP model's shards gathered (every rank calls)

        variant = getattr(self, "variant", None) or (
            "custom-voice" if "CustomVoice" in str(self.model_path or "") else "base"
        )
        def write():
            ckpt_lib.save_params(path, params, family="qwen", preset=self.config.name,
                                 quantization=self.quantization, extra={"variant": variant})

        if self.mesh is None:
            write()
        else:
            self.mesh.write_on_first_rank(write)

    # -- Mesh helpers ----------------------------------------------------------

    def _data_axis(self):
        return None if self.mesh is None else self.mesh.axis("data")

    def _shard(self, x, batch_axis: int = 0):
        """This rank's rows of one array (numpy or tensor): the batch axis
        split over the mesh's ``data`` axis."""
        data = self._data_axis()
        if data is None or data.size == 1:
            return x
        n = x.shape[batch_axis] // data.size
        idx = (slice(None),) * batch_axis + (slice(data.index * n, (data.index + 1) * n),)
        return x[idx]

    def _dp_pad(self, n: int) -> int:
        """Rows of padding needed so the batch divides the data axis."""
        data = self._data_axis()
        return 0 if data is None else (-n) % data.size

    def _shard_kv(self, b: int, s: int):
        """This rank's ``(L, b, s, Hkv, D)`` KV caches: ``b`` local rows and,
        under tensor parallelism, the local KV heads (JAX's ``_shard_kv``
        lays out a global cache; here the shard is allocated directly)."""
        return tfm.make_kv_cache(tfm.local_config(self.config.talker, self.tp_axis), b, s,
                                 device=self.device)

    def _graphable(self) -> bool:
        """Whether the decode step may be captured: on a CUDA device, unless
        tensor parallelism splits the talker over several ranks (its
        collectives are not captured)."""
        return self.device.type == "cuda" and (self.tp_axis is None or self.tp_axis.size == 1)

    @contextlib.contextmanager
    def _decoding(self, b: int, s: int, top_k: Optional[int] = None):
        """The call's :class:`_Decode` for ``b`` local rows over ``s`` cache
        slots, its buffers zeroed.

        Where the step may be captured (:meth:`_graphable`) they are the
        buffers of the model's :class:`_StepGraph` for the key (rows, cache
        length, ``top_k``, KV dtype, chunk steps), the model's graphs held
        until the block is left. Elsewhere, without ``top_k`` (a prefill
        alone), or while another call holds the graphs, they are new and the
        steps run eagerly.
        """
        steps, graph = _chunk(), None
        if top_k is not None and self._graphable():
            graph = self._step_graphs.acquire(
                tfm.local_config(self.config.talker, self.tp_axis), b, s,
                tfm.kv_cache_dtype(b, s), self.config.codec.n_codebooks, steps, top_k,
                self.params["lm_head"])
        try:
            yield _Decode(self, b, s, top_k, steps, graph)
        finally:
            if graph is not None:
                self._step_graphs.release()

    def _all_done(self, done: torch.Tensor) -> torch.Tensor:
        """The batch's all-done flag, over every data rank's rows."""
        data = self._data_axis()
        if data is None or data.size == 1:
            return done.all()
        busy = (~done).any().to(torch.int32).reshape(1)
        return all_reduce_max(busy, data)[0] == 0

    # -- Reference audio conditioning --------------------------------------

    @torch.inference_mode()
    def _reference_codes(self, ref_audio_path: str) -> np.ndarray:
        """Codec-encode reference audio to conditioning tokens (cached per path).

        The WAV is resampled to the codec's rate on the model's device,
        capped at 10 s, cut to a whole number of hops (at least one), and
        encoded by the codec's encoder; the codes ``(T, nq)`` come back to
        the host, where the prompt arrays are built.
        """
        if ref_audio_path in self._ref_codes_cache:
            return self._ref_codes_cache[ref_audio_path]
        from ...audio_io import load_wav
        from ...ops.resample import resample

        wav, sr = load_wav(ref_audio_path)
        wav = torch.from_numpy(wav).to(self.device)
        if sr != self.sample_rate:
            wav = resample(wav, sr, self.sample_rate)
        # Cap the reference at 10 s and align to the codec hop
        hop = self.config.codec.hop
        wav = wav[: 10 * self.sample_rate]
        n = max((wav.shape[0] // hop) * hop, hop)
        wav = F.pad(wav[:n], (0, max(0, n - wav.shape[0])))
        codes = codec_lib.encode_to_codes(self.params["codec"], self.config.codec, wav[None])
        codes_np = codes[0].cpu().numpy().astype(np.int32)
        self._ref_codes_cache[ref_audio_path] = codes_np
        return codes_np

    # -- Prompt building ----------------------------------------------------

    def _build_prompt_arrays(self, texts: Sequence[str], speaker: Optional[str], language: str,
                             ref_audio: Optional[str], ref_text: Optional[str]):
        """Host-built index/mask arrays describing each prompt row.

        Layout per row: [spk?][ref text][text][ref codes][BOS], left-padded
        to the prompt bucket. Returns (arrays dict of np arrays, lens list, p).
        """
        cfg = self.config
        nq = cfg.codec.n_codebooks
        ref_codes = None
        ref_ids: List[int] = []
        if ref_audio is not None:
            ref_codes = self._reference_codes(ref_audio)
            ref_ids = self.tokenizer.encode(ref_text or "")
        nr = int(ref_codes.shape[0]) if ref_codes is not None else 0
        has_spk = speaker is not None
        spk_id = 0
        if has_spk:
            if speaker in SPEAKERS:
                spk_id = SPEAKERS.index(speaker)
            else:
                # Stable digest: Python's str hash is salted per process.
                digest = hashlib.md5(speaker.encode("utf-8")).hexdigest()
                spk_id = int(digest, 16) % cfg.n_speakers

        rows_ids = [
            self.tokenizer.encode(f"{language}: {t}" if language else t) for t in texts
        ]
        lens = [int(has_spk) + len(ref_ids) + len(ids) + nr + 1 for ids in rows_ids]
        p = _round_up(max(lens), PROMPT_BUCKET)
        b = len(texts)

        ids_slotted = np.zeros((b, p), np.int64)
        text_mask = np.zeros((b, p), np.float32)
        codes_slotted = np.zeros((b, p, nq), np.int64)
        code_mask = np.zeros((b, p), np.float32)
        spk_mask = np.zeros((b, p), np.float32)
        for i, ids in enumerate(rows_ids):
            pos = p - lens[i]
            if has_spk:
                spk_mask[i, pos] = 1.0
                pos += 1
            toks = list(ref_ids) + list(ids)
            ids_slotted[i, pos : pos + len(toks)] = toks
            text_mask[i, pos : pos + len(toks)] = 1.0
            pos += len(toks)
            if nr:
                codes_slotted[i, pos : pos + nr] = ref_codes
                code_mask[i, pos : pos + nr] = 1.0
            # BOS occupies slot p-1: attn_mask minus the other masks.

        arrays = {
            "ids_slotted": ids_slotted,
            "text_mask": text_mask,
            "codes_slotted": codes_slotted,
            "code_mask": code_mask,
            "spk_ids": np.full((b,), spk_id, np.int64),
            "spk_mask": spk_mask,
            "rope_pos": np.stack(
                [np.maximum(np.arange(p) - (p - n), 0) for n in lens]
            ).astype(np.int64),
            "attn_mask": np.stack([np.arange(p) >= (p - n) for n in lens]),
        }
        return arrays, lens, p

    # -- Generation ----------------------------------------------------------

    @torch.inference_mode()
    def generate_codes(self, texts: Sequence[str], speaker: Optional[str] = None,
                       language: str = "English", ref_audio: Optional[str] = None,
                       ref_text: Optional[str] = None, max_frames: Optional[int] = None,
                       min_frames: int = 0, temperature: Optional[float] = None,
                       top_k: Optional[int] = None, rng: Optional[torch.Tensor] = None,
                       cancel_check=None, prebuilt_prompt=None,
                       seeds: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        """Prefill + chunked AR decode; returns per-text ``(T, nq)`` int32 code arrays.

        ``min_frames`` masks EOS for the first N frames. ``seeds`` (one int
        per text, or an integer tensor such as :func:`_derive_row_seeds`
        gives) makes sampling schedule-reproducible and equal to the JAX
        package's for the same seeds; without them they are
        ``_derive_row_seeds(rng, n)`` of a threefry key ``rng`` ``(2,)``
        (``prng.PRNGKey(0)`` by default), the JAX package's draw.
        """
        with profiling.stage("qwen/generate_codes", rows=len(texts)) as attrs:
            codes_dev, done_dev, n_real = self._generate_codes_arrays(
                texts, speaker=speaker, language=language, ref_audio=ref_audio,
                ref_text=ref_text, max_frames=max_frames, min_frames=min_frames,
                temperature=temperature, top_k=top_k, rng=rng, cancel_check=cancel_check,
                prebuilt_prompt=prebuilt_prompt, seeds=seeds,
            )
            attrs["frames"] = int(done_dev.shape[1])
            with profiling.stage("qwen/fetch_codes"):
                codes = codes_dev.cpu().numpy().astype(np.int32)
                done_seq = done_dev.cpu().numpy()
        outputs = []
        for i in range(n_real):
            d = np.nonzero(done_seq[i])[0]
            end = max(int(d[0]) if d.size else codes.shape[1], 1)
            outputs.append(codes[i, :end])
        return outputs

    def _generate_codes_arrays(self, texts, speaker=None, language="English", ref_audio=None,
                               ref_text=None, max_frames=None, min_frames=0, temperature=None,
                               top_k=None, rng=None, cancel_check=None, prebuilt_prompt=None,
                               seeds=None):
        """Device-tensor core of :meth:`generate_codes`.

        Returns ``(codes (B, T, nq), done (B, T), n_real)`` on the model's
        device: the whole (padded) batch, on every rank of a mesh.
        """
        cfg = self.config
        dev = self.device
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k

        with profiling.stage("qwen/prompt_build"):
            if prebuilt_prompt is not None:
                arrays, _, p = prebuilt_prompt
            else:
                arrays, _, p = self._build_prompt_arrays(
                    texts, speaker, language, ref_audio, ref_text
                )
        # Data parallelism: pad the batch to a multiple of the data axis
        # with copies of row 0; each rank takes its rows.
        n_real = len(texts)
        pad_rows = self._dp_pad(n_real)
        if pad_rows:
            arrays = {k: np.concatenate([v, np.repeat(v[:1], pad_rows, axis=0)])
                      for k, v in arrays.items()}
        a = {k: torch.from_numpy(np.ascontiguousarray(self._shard(v))).to(dev)
             for k, v in arrays.items()}
        b = a["attn_mask"].shape[0]

        if seeds is None:
            seeds_b = _derive_row_seeds(prng.PRNGKey(0) if rng is None else rng, n_real)
        else:
            if len(seeds) != n_real:
                raise ValueError(f"seeds has {len(seeds)} entries for {n_real} texts")
            seeds_b = seeds if isinstance(seeds, torch.Tensor) else \
                torch.as_tensor(np.asarray(seeds, np.int64))
        seeds_b = seeds_b.to(device=dev, dtype=torch.int64)
        if pad_rows:  # one seed per real row: padding never shifts a real row
            seeds_b = torch.cat([seeds_b, seeds_b[:1].expand(pad_rows)])
        seeds_b = self._shard(seeds_b)

        s = p + _decode_slots(max(len(t) for t in texts), max_frames)
        with self._decoding(b, s, top_k) as dec:
            chunks = dec.chunks(a, seeds_b, temperature, min_frames, cancel_check,
                                self.mesh if self.seq_parallel else None)
            first_codes, done = next(chunks)
            # Code/done chunks accumulate on the device; the early exit reads the
            # PREVIOUS chunk's all-done flag, so the host never waits on the chunk
            # it just enqueued (worst case one surplus chunk).
            all_codes = [first_codes[:, None, :]]
            all_done = [done[:, None]]
            prev_flag = None
            touched = []  # (span attrs, the chunk's distinct experts) of an expert talker
            for attrs, out in chunks:
                if out.touched is not None:
                    touched.append((attrs, out.touched))
                all_codes.append(out.codes)
                all_done.append(out.dones)
                if prev_flag is not None:
                    with profiling.stage("qwen/done_check"):  # the host waits for the flag
                        finished = bool(prev_flag)
                    if finished:
                        break
                prev_flag = self._all_done(out.done)

            if touched:  # fetched once, where the caller is about to wait for the codes
                _attach_touched(touched)
            data = self._data_axis()
            return (all_gather(torch.cat(all_codes, dim=1), 0, data),
                    all_gather(torch.cat(all_done, dim=1), 0, data), n_real)

    @torch.inference_mode()
    def synthesize(self, texts: Union[str, Sequence[str]], speaker: Optional[str] = None,
                   language: str = "English", ref_audio: Optional[str] = None,
                   ref_text: Optional[str] = None, max_frames: Optional[int] = None,
                   min_frames: int = 0, temperature: Optional[float] = None,
                   top_k: Optional[int] = None, rng: Optional[torch.Tensor] = None,
                   cancel_check=None,
                   seeds: Optional[Sequence[int]] = None) -> Tuple[List[torch.Tensor], int]:
        """Full text -> waveform path. Returns (list of 1-D f32 waveforms, sr).

        The codes stay on the device: the host fetches only the (B, T) done
        bitmap to learn each row's length, and the vocoder reads the code
        tensor in place (gather + end-mask per length bucket).
        """
        text_list = [texts] if isinstance(texts, str) else list(texts)
        with profiling.stage("qwen/synthesize", rows=len(text_list)) as attrs:
            codes_dev, done_dev, n_real = self._generate_codes_arrays(
                text_list, speaker=speaker, language=language, ref_audio=ref_audio,
                ref_text=ref_text, max_frames=max_frames, min_frames=min_frames,
                temperature=temperature, top_k=top_k, rng=rng, cancel_check=cancel_check,
                seeds=seeds,
            )
            attrs["frames"] = int(done_dev.shape[1])
            with profiling.stage("qwen/fetch_done"):
                done_np = done_dev.cpu().numpy()[:n_real]
            ends = []
            for i in range(n_real):
                d = np.nonzero(done_np[i])[0]
                ends.append(max(int(d[0]) if d.size else done_np.shape[1], 1))

            hop = self.config.codec.hop
            # Rows of equal (bucketed) frame count are vocoded as one batch.
            waves: List[Optional[torch.Tensor]] = [None] * n_real
            buckets: Dict[int, List[int]] = {}
            for i, end in enumerate(ends):
                buckets.setdefault(_round_up(end, _chunk()), []).append(i)
            for t, idxs in buckets.items():
                with profiling.stage("qwen/vocode"):
                    wav, _ = _vocode_rows(
                        self.params, self.config, codes_dev,
                        torch.as_tensor(idxs, dtype=torch.int64).to(self.device),
                        torch.as_tensor([ends[i] for i in idxs],
                                        dtype=torch.int64).to(self.device),
                        t,
                    )
                for row, i in enumerate(idxs):
                    waves[i] = wav[row, : ends[i] * hop]
        return waves, self.sample_rate

    @torch.inference_mode()
    def synthesize_speculative(self, text: str, draft: "QwenTTSModel",
                               speaker: Optional[str] = None, language: str = "English",
                               ref_audio: Optional[str] = None, ref_text: Optional[str] = None,
                               max_frames: Optional[int] = None, min_frames: int = 0,
                               gamma: int = 4, rng: Optional[torch.Tensor] = None,
                               residual_mode: str = "draft") -> Tuple[torch.Tensor, int]:
        """Single-stream synthesis with draft-verify speculative decoding.

        ``draft`` is a smaller model sharing the codec vocabulary; ``rng`` a
        threefry key ``(2,)``. Returns (waveform (T,) on the device, sr).
        See :mod:`rho_tts_tpu_torch.models.qwen.speculative` for the decode
        and the ``residual_mode`` acceptance semantics.
        """
        from .speculative import speculative_generate_codes

        codes, _stats = speculative_generate_codes(
            self, draft, text, speaker=speaker, language=language, ref_audio=ref_audio,
            ref_text=ref_text, max_frames=max_frames, min_frames=min_frames, gamma=gamma,
            rng=rng, residual_mode=residual_mode,
        )
        hop = self.config.codec.hop
        t = _round_up(max(codes.shape[0], 1), _chunk())
        batch = np.pad(codes, ((0, t - codes.shape[0]), (0, 0)))[None].astype(np.int64)
        with profiling.stage("qwen/vocode"):
            wav = _vocode(self.params, self.config, torch.from_numpy(batch).to(self.device))
        return wav[0, : codes.shape[0] * hop], self.sample_rate

    # -- Single-stream streaming --------------------------------------------

    @torch.inference_mode()
    def stream_chunks(self, text: str, speaker: Optional[str] = None, language: str = "English",
                      ref_audio: Optional[str] = None, ref_text: Optional[str] = None,
                      max_frames: Optional[int] = None, min_frames: int = 0,
                      temperature: Optional[float] = None, top_k: Optional[int] = None,
                      rng: Optional[torch.Tensor] = None, cancel_check=None,
                      context_frames: int = 32, seed: Optional[int] = None):
        """Incremental synthesis: yields waveform pieces per decode chunk.

        Audio appears after the first decode chunk instead of after the
        whole utterance. The codec vocoder is local (convolutions and
        pointwise nonlinearities), so vocoding a sliding window with
        ``context_frames`` of left/right context reproduces the
        full-utterance vocode for every emitted sample (window-boundary
        samples within the convolutions' rounding). Each chunk's codes come
        to the host (the one fetch a chunk costs), which decides what to
        emit. ``seed`` is the row's sampling seed (``_derive_row_seeds``);
        without it, ``_derive_row_seeds(rng, 1)`` of a threefry key ``rng``
        (``prng.PRNGKey(0)`` by default).

        Yields (waveform_piece (S,) on the device, sample_rate). Single
        stream (B=1).
        """
        cfg = self.config
        dev = self.device
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k
        if seed is None:
            seed = int(_derive_row_seeds(prng.PRNGKey(0) if rng is None else rng, 1)[0])
        seeds = torch.full((1,), int(seed), dtype=torch.int64, device=dev)
        arrays, _, p = self._build_prompt_arrays([text], speaker, language, ref_audio, ref_text)
        # one stream: the row stays on every rank
        a = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        with self._decoding(1, p + _decode_slots(len(text), max_frames), top_k) as dec:
            chunks = dec.chunks(a, seeds, temperature, min_frames, cancel_check)
            first_codes, _ = next(chunks)
            hop = cfg.codec.hop
            codes_np = first_codes.cpu().numpy()  # (1, nq), grows per chunk
            finished = bool(codes_np[0, 0] == cfg.audio_eos)
            emitted = 0  # frames already yielded

            def vocode_span(lo: int, hi: int, emit_from: int, emit_to: int):
                """Vocode codes[lo:hi]; return samples for frames [emit_from, emit_to)."""
                window = codes_np[lo:hi]
                t = _round_up(window.shape[0], _chunk())
                batch = np.pad(window, ((0, t - window.shape[0]), (0, 0)))[None]
                with profiling.stage("qwen/vocode"):
                    wav = _vocode(self.params, cfg, torch.from_numpy(batch).to(dev))
                return wav[0, (emit_from - lo) * hop: (emit_to - lo) * hop]

            for attrs, out in (() if finished else chunks):
                cc, dd = out.codes[0].cpu().numpy(), out.dones[0].cpu().numpy()
                if out.touched is not None:  # with the chunk's codes
                    _attach_touched([(attrs, out.touched)])
                hit = np.nonzero(dd)[0]
                if hit.size:
                    cc = cc[: int(hit[0]) + 1]
                    finished = True
                codes_np = np.concatenate([codes_np, cc])
                if (finished and codes_np.shape[0] > 1
                        and codes_np[-1, 0] >= cfg.codec.codebook_size):
                    codes_np = codes_np[:-1]  # drop the EOS frame itself
                total = codes_np.shape[0]

                safe = total if finished else max(total - context_frames, 0)
                if safe > emitted:
                    lo = max(emitted - context_frames, 0)
                    piece = vocode_span(lo, total, emitted, safe)
                    emitted = safe
                    yield piece, self.sample_rate
                if finished:
                    break

            if emitted < codes_np.shape[0]:  # final flush (max_frames reached)
                total = codes_np.shape[0]
                lo = max(emitted - context_frames, 0)
                yield vocode_span(lo, total, emitted, total), self.sample_rate
