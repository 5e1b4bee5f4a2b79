"""Chatterbox-class voice-cloning TTS: CFG-guided AR over speech tokens (PyTorch port).

Counterpart of ``rho_tts_tpu/models/chatterbox/model.py``. The stages are
plain functions on tensors; :class:`ChatterboxModel` is an ``nn.Module``
whose parameters carry the names of the JAX params tree.

* Conditional and unconditional streams are folded into ONE batch of 2B
  rows ``[cond..., uncond...]``, so classifier-free guidance costs a batch
  doubling; logits mix as ``cond + w * (cond - uncond)`` (w = 0 disables
  guidance).
* Voice conditioning: the GE2E speaker encoder's embedding, projected by
  ``spk_proj`` in f32, is a prefix token of the prompt (the reference audio
  is encoded once and cached by the caller).
* Prefill runs the talker over the left-padded prompt through the prefill
  attention kernel; decode runs chunks of :data:`CHUNK` steps, JAX's
  ``lax.scan`` as a Python loop of eager launches (the decode attention
  kernel in every layer of every step), seeded top-k Gumbel sampling on the
  CFG mix. The "faster" preset caps the cache length and new tokens.
* The tokens stay on the device. :meth:`ChatterboxModel.generate` exits
  early on a lagged all-done flag (a pinned copy behind an event, read one
  chunk late) and fetches only the done bitmap, once, to find the EOS cut;
  then a single-codebook conv vocoder at 25 Hz (hop 960 at 24 kHz) and the
  on-device watermark (``ops.watermark``) finish the waveform.

Sampling reproduces the JAX package's bits: the noise of request i at
frame f is ``f(seeds[i], f)`` through the port's threefry, and the CFG mix
is rounded once, as XLA's fused multiply-add rounds it, so the same seeds
draw the same tokens in both packages.

Meshes (``parallel``; one process per GPU, each returning the whole
result): the one-shot CFG batch keeps its rows on every rank (the mix needs
both rows of a pair, and the batch is one text's 2k rows), so ``data``
replicates it; under tensor parallelism each rank runs its weight shards
and KV heads (``tp``). The serving engine (``serving_cb``) is where the
slot rows split over ``data``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ...ops.watermark import _ENV_WINDOW, apply_watermark
from ...parallel.collectives import vocab_embed
from ...serving import _Lagged, _upload
from ...utils import prng, profiling
from ...utils.tokenizer import load_tokenizer
from .. import transformer as tfm
from ..qwen import codec as codec_lib
from ..qwen.config import CodecConfig
from ..qwen.model import (
    _derive_row_seeds,
    _gumbel_noise,
    _register,
    _round_up,
    _sample_with_noise,
    _tree_quantization,
)
from ..quantization import quantize_stack

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

# Decode steps per chunk (the JAX package's compiled scan length).
CHUNK = 128
PROMPT_BUCKET = 64


@dataclasses.dataclass(frozen=True)
class ChatterboxConfig:
    name: str = "standard"
    talker: tfm.TransformerConfig = dataclasses.field(
        default_factory=lambda: tfm.TransformerConfig(
            hidden=1024, layers=30, q_heads=16, kv_heads=16, head_dim=64, ffn=4096
        )
    )
    codec: CodecConfig = dataclasses.field(
        default_factory=lambda: CodecConfig(
            sample_rate=24000,
            upsample_rates=(8, 6, 5, 4),  # hop 960 -> 25 Hz
            n_codebooks=1,
            codebook_size=4096,
            codebook_dim=512,
            decoder_channels=(512, 256, 128, 64, 32),
            encoder_channels=(32, 64, 128, 256, 512),
        )
    )
    text_vocab: int = 2048
    max_position_embeddings: int = 4096
    temperature: float = 1.0
    top_k: int = 50
    max_cache_len: Optional[int] = None  # "faster" sets 1500
    max_new_tokens: Optional[int] = None  # "faster" sets 1000

    @property
    def speech_vocab(self) -> int:
        return self.codec.codebook_size + 3

    @property
    def speech_bos(self) -> int:
        return self.codec.codebook_size

    @property
    def speech_eos(self) -> int:
        return self.codec.codebook_size + 1

    @property
    def speech_pad(self) -> int:
        return self.codec.codebook_size + 2


PRESETS = {
    "standard": ChatterboxConfig(),
    "faster": ChatterboxConfig(name="faster", max_cache_len=1500, max_new_tokens=1000),
    "tiny": ChatterboxConfig(
        name="tiny",
        talker=tfm.TransformerConfig(
            hidden=64, layers=2, q_heads=4, kv_heads=2, head_dim=16, ffn=128
        ),
        codec=CodecConfig(
            sample_rate=24000,
            upsample_rates=(4, 2),
            n_codebooks=1,
            codebook_size=64,
            codebook_dim=32,
            decoder_channels=(32, 16, 8),
            encoder_channels=(8, 16, 32),
        ),
        text_vocab=512,
        max_position_embeddings=512,
    ),
}


def init_params(cfg: ChatterboxConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a seeded generator on ``device``: the JAX
    ``init_params``'s shapes, scales and dtypes (other values)."""
    device = torch.device(device or "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    t = cfg.talker

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(t.dtype)

    return {
        "text_embed": normal((cfg.text_vocab, t.hidden), 0.02),
        "speech_embed": normal((cfg.speech_vocab, t.hidden), 0.02),
        "spk_proj": normal((256, t.hidden), 0.05),
        "talker": tfm.init_stack(gen, t, device),
        "lm_head": tfm._dense_init(gen, (t.hidden, cfg.speech_vocab), t.dtype, device),
        "codec": codec_lib.init_codec(gen, cfg.codec, device),
    }


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def prompt_embeds(params, cfg: ChatterboxConfig, ids_slotted, text_mask, bos_mask, spk_mask,
                  spk, tp=None) -> torch.Tensor:
    """Prompt embeddings from the host-built masks: text slots, the BOS slot
    and the speaker-prefix slot. ``spk`` is one embedding ``(256,)`` shared by
    every row, or one per row ``(R, 256)``; its projection runs in f32.
    Under ``tp`` the text table is this rank's vocab shard."""
    dt = params["text_embed"].dtype
    emb = vocab_embed(params["text_embed"], ids_slotted, tp)  # (R, P, H)
    spk_e = (spk.float() @ params["spk_proj"].float()).to(dt)
    spk_e = spk_e[None, None] if spk_e.dim() == 1 else spk_e[:, None, :]
    bos_e = params["speech_embed"][cfg.speech_bos].to(dt)
    # The masks cast to the embedding dtype first, so a bf16 model's prefill
    # stays bf16, as in the JAX package.
    return (emb * text_mask[..., None].to(dt)
            + bos_e[None, None] * bos_mask[..., None].to(dt)
            + spk_e * spk_mask[..., None].to(dt))


def _prefill(params, cfg: ChatterboxConfig, ids_slotted, text_mask, bos_mask, spk_mask, spk,
             rope_pos, attn_mask, cache_k, cache_v, key_valid, tp=None):
    """Prompt embedding + prefill (the prefill attention kernel). Writes the
    caches in place; returns ``(logits (R, V) f32, cache_k, cache_v,
    key_valid)``. ``tp``: the mesh axis the weights are sharded over."""
    p = ids_slotted.shape[1]
    embeds = prompt_embeds(params, cfg, ids_slotted, text_mask, bos_mask, spk_mask, spk, tp)
    h, (ck, cv) = tfm.stack_forward(
        params["talker"], cfg.talker, embeds, rope_pos,
        kv_caches=(cache_k, cache_v), cache_len=0, attn_mask=attn_mask,
        key_valid=key_valid, fused_prefill=True, tp=tp,
    )
    key_valid = key_valid.clone()
    key_valid[:, :p] = attn_mask
    logits = h[:, -1].float() @ params["lm_head"].float()
    return logits, ck, cv, key_valid


def _cfg_mix(logits2b: torch.Tensor, cfg_weight) -> torch.Tensor:
    """``cond + w * (cond - uncond)`` over rows ``[cond..., uncond...]``.

    ``cfg_weight`` is a number or a ``(B,)`` tensor. XLA computes the mix as
    one fused multiply-add (one rounding); the f32 x f32 product is exact in
    float64, so rounding the float64 sum once to float32 gives its bits.
    """
    b = logits2b.shape[0] // 2
    cond, uncond = logits2b[:b].float(), logits2b[b:].float()
    if isinstance(cfg_weight, torch.Tensor):
        w = cfg_weight.float().double()[:, None]
    else:
        w = torch.full((1, 1), float(np.float32(cfg_weight)), dtype=torch.float64,
                        device=logits2b.device)
    return (cond.double() + w * (cond - uncond).double()).float()


def _cfg_sample(logits2b, seeds, frames, temperature, top_k: int, cfg_weight):
    """logits2b ``(2B, V)`` rows ``[cond..., uncond...]`` -> sampled ``(B,)``
    tokens. Request i's noise is a pure function of ``(seeds[i],
    frames[i])``, so a request decoded one-shot and inside the serving slot
    batch draws the same tokens. ``temperature`` and ``cfg_weight`` are
    numbers or ``(B,)`` tensors."""
    return _sample_with_noise(_cfg_mix(logits2b, cfg_weight), temperature, top_k,
                              _gumbel_noise(seeds, frames, top_k))


def _decode_chunk(params, cfg: ChatterboxConfig, cache_k, cache_v, key_valid, slot0: int,
                  rope_base, last_tok, done, seeds, temperature, cfg_weight, step_base: int,
                  min_new: int, steps: int, top_k: int, tp=None):
    """``steps`` CFG decode steps from cache slot ``slot0`` over the 2B rows.

    The JAX scan as a Python loop; caches and ``key_valid`` are updated in
    place; ``tp`` as :func:`_prefill`. The sampled token feeds both rows of
    its request. Returns ``(toks (B, steps), done (B, steps), cache_k,
    cache_v, key_valid, last_tok, done)``.
    """
    lm_head = params["lm_head"].float()  # f32 logits over the bf16 head, as JAX's dot
    embed = params["speech_embed"]
    # Every step's sampler noise in one batched pass: (seed, frame) is
    # known before the chunk runs.
    frames = step_base + torch.arange(steps, dtype=torch.int64, device=seeds.device)
    noise = _gumbel_noise(seeds, frames[:, None], top_k)  # (steps, B, top_k)
    toks_seq, done_seq = [], []
    for t in range(steps):
        tok2b = torch.cat([last_tok, last_tok])
        slot = slot0 + t
        h, _ = tfm.stack_forward(
            params["talker"], cfg.talker, embed[tok2b][:, None, :], (rope_base + t)[:, None],
            kv_caches=(cache_k, cache_v), cache_len=slot, attn_mask=None, key_valid=key_valid,
            tp=tp,
        )
        key_valid[:, slot] = True
        logits = h[:, -1].float() @ lm_head
        if step_base + t < min_new:  # minimum-duration floor
            logits[:, cfg.speech_eos] = -1e30
        tok = _sample_with_noise(_cfg_mix(logits, cfg_weight), temperature, top_k, noise[t])
        newly_done = tok == cfg.speech_eos
        tok = torch.where(done, cfg.speech_pad, tok)
        done = done | newly_done
        toks_seq.append(tok)
        done_seq.append(done)
        last_tok = tok
    return (torch.stack(toks_seq, dim=1), torch.stack(done_seq, dim=1),
            cache_k, cache_v, key_valid, last_tok, done)


def _vocode(params, cfg: ChatterboxConfig, tokens):
    """tokens ``(B, T)`` -> raw waveform ``(B, T*hop)``.

    The watermark is embedded after slicing to the true length (in
    :meth:`ChatterboxModel.generate` and ``stream_chunks``), so streamed
    windows align with the one-shot embed and the envelope near the end is
    computed from real samples.
    """
    clamped = tokens.clamp_max(cfg.codec.codebook_size - 1)
    return codec_lib.decode_from_codes(params["codec"], cfg.codec, clamped[..., None])


def _vocode_masked(params, cfg: ChatterboxConfig, toks_dev, end: int, t: int):
    """Vocode the device-resident history ``toks_dev[:t]`` (1-D) with tokens
    at ``end`` and after zeroed; the tokens never cross to the host."""
    te = min(t, toks_dev.shape[0])
    toks = torch.zeros((t,), dtype=toks_dev.dtype, device=toks_dev.device)
    toks[:min(te, end)] = toks_dev[:min(te, end)]
    return _vocode(params, cfg, toks[None])


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------


class ChatterboxModel(nn.Module):
    """Voice-cloning TTS with conditionals caching and CFG decoding.

    ``device=None`` means ``"cuda"``. ``params`` is a nested dict of tensors
    (``init_params``, ``from_jax.params_from_numpy`` or a loaded checkpoint);
    without it the weights are random from ``seed``. ``quantization`` "int8"
    or "int4" quantizes the talker's matmul weights.
    """

    def __init__(self, cfg: ChatterboxConfig, params: Optional[Params] = None, seed: int = 0,
                 quantization: Optional[str] = None, model_path: Optional[str] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device or "cuda")
        self.sr = self.sample_rate = cfg.codec.sample_rate
        # A checkpoint directory may bundle its tokenizer.json: text ids must
        # come from the vocabulary the weights were trained on.
        self.tokenizer = load_tokenizer(model_path, vocab_size=cfg.text_vocab)
        if params is None:
            params = init_params(cfg, seed, self.device)
        if quantization in ("int8", "int4"):
            params = {**params, "talker": quantize_stack(params["talker"], quantization)}
        elif quantization not in (None, "none"):
            raise ValueError(f"Unsupported quantization: {quantization}")
        self.quantization = _tree_quantization(params)
        #: the registered parameters as a plain nested dict, for the stage functions
        self.params = {key: _register(self, key, value) for key, value in params.items()}
        self._speaker_encoder = None
        self.conditionals: Optional[np.ndarray] = None  # active speaker embedding
        #: the device mesh (``parallel.inference``); None = one device
        self.mesh = None
        #: the mesh's ``model`` axis when the talker weights are sharded over it
        self.tp_axis = None

    @property
    def config(self) -> ChatterboxConfig:
        return self.cfg

    # -- Loading --------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, device=None, implementation: str = "standard", seed: int = 0,
                        quantization: Optional[str] = None,
                        model_path: Optional[str] = None) -> "ChatterboxModel":
        """Build the model on ``device`` (default ``"cuda"``).

        * A native checkpoint directory (:meth:`save_checkpoint`, family
          ``"chatterbox"``) is served as exported; an explicit
          ``quantization`` (``"none"`` meaning dense) that differs from a
          quantized export raises ``ValueError``.
        * Otherwise the ``implementation`` preset, with local T3 weights when
          ``model_path`` is a safetensors directory or a ``t3_cfg.pt`` file
          (``models.chatterbox.weights``), else random weights from ``seed``.
          As in the JAX package, a conversion that fails logs a warning and
          falls back to the random weights: that is the reference's
          checkpoint behaviour, not a device fallback.
        """
        from .. import checkpoint as ckpt_lib

        if model_path and os.path.isdir(str(model_path)) and (
                ckpt_lib.is_native_checkpoint(model_path)
                or ckpt_lib.is_jax_checkpoint(model_path)):
            params, manifest = ckpt_lib.load_params(model_path, family="chatterbox",
                                                    device=device)
            cfg = PRESETS.get(manifest.get("preset", implementation), PRESETS["standard"])
            saved_quant = manifest.get("quantization")
            if saved_quant == "none":
                saved_quant = None
            requested = None if quantization == "none" else quantization
            if quantization is not None and saved_quant is not None and requested != saved_quant:
                raise ValueError(
                    f"Checkpoint at {model_path} was exported with "
                    f"quantization={saved_quant!r}; cannot serve as {quantization!r}"
                )
            return cls(cfg, params=params, seed=seed, quantization=requested or saved_quant,
                       model_path=model_path, device=device)

        cfg = PRESETS.get(implementation, PRESETS["standard"])
        params = None
        if model_path:
            try:
                from .weights import load_checkpoint

                params = load_checkpoint(model_path, cfg, device=device)
            except Exception as exc:  # noqa: BLE001 — the reference's checkpoint behaviour
                logger.warning("Chatterbox checkpoint load failed (%s); random init", exc)
        return cls(cfg, params=params, seed=seed, quantization=quantization,
                   model_path=model_path, device=device)

    def save_checkpoint(self, path: str) -> None:
        """Export the parameter tree as a native serving checkpoint
        (pre-quantized when the model is quantized). On a mesh every rank
        calls it; a tensor-parallel model's shards are gathered into the
        global tree, which the mesh's first rank writes."""
        from .. import checkpoint as ckpt_lib

        from ...parallel.sharding import whole_params

        params = whole_params(self)  # a TP model's shards gathered (every rank calls)

        preset = next((k for k, v in PRESETS.items() if v is self.cfg), "standard")
        def write():
            ckpt_lib.save_params(path, params, family="chatterbox", preset=preset,
                                 quantization=self.quantization)

        if self.mesh is None:
            write()
        else:
            self.mesh.write_on_first_rank(write)

    def _shard_kv(self, rows: int, s: int):
        """This rank's ``(L, rows, s, Hkv, D)`` KV caches: every row (the CFG
        rows stay whole over ``data``), the local KV heads under tensor
        parallelism (JAX's ``_shard_kv`` lays out a global cache; here the
        shard is allocated directly)."""
        return tfm.make_kv_cache(tfm.local_config(self.cfg.talker, self.tp_axis), rows, s,
                                 device=self.device)

    # -- Voice conditioning ----------------------------------------------------

    @property
    def speaker_encoder(self):
        if self._speaker_encoder is None:
            from ..speaker import SpeakerEncoder

            self._speaker_encoder = SpeakerEncoder(device=self.device)
        return self._speaker_encoder

    def prepare_conditionals(self, ref_audio_path: str) -> np.ndarray:
        """Speaker conditioning (a 256-d embedding) from reference audio."""
        from ...audio_io import load_wav

        wav, sr = load_wav(ref_audio_path)
        return self.speaker_encoder.embed_utterance(wav, sr)

    # -- Decoding --------------------------------------------------------------

    def _start_decode(self, text: str, audio_prompt_path: Optional[str], temperature: float,
                      cfg_weight: float, max_new_tokens: Optional[int],
                      max_cache_len: Optional[int], min_new_tokens: int, rng,
                      candidates: int = 1, seeds=None) -> Dict[str, Any]:
        """Prompt assembly + prefill + first sampled token.

        Rows are ``[cond x k, uncond x k]``: ``candidates`` k > 1 decodes k
        independent samples of the same text in one CFG batch (per-row
        seeds differ). ``seeds`` (one per candidate) pins the sampling
        streams; by default ``_derive_row_seeds(rng, k)``. Every host array
        goes up by a pinned, asynchronous copy, so nothing here waits on the
        device. Returns the decode-loop carry.
        """
        cfg = self.cfg
        dev = self.device
        k = int(candidates)

        spk = None
        if audio_prompt_path is not None:
            spk = self.prepare_conditionals(audio_prompt_path)
        elif self.conditionals is not None:
            spk = np.asarray(self.conditionals)

        ids = np.asarray(self.tokenizer.encode(text), np.int64)
        nt = int(ids.shape[0])
        has_spk = spk is not None
        # Left-padded prompt rows described by masks:
        #   cond = [pad..., spk?, text..., BOS]   uncond = [pad..., spk?, BOS]
        lens = [nt + 1 + int(has_spk)] * k + [1 + int(has_spk)] * k
        p = _round_up(max(lens), PROMPT_BUCKET)
        ids_slotted = np.zeros((2 * k, p), np.int64)
        text_mask = np.zeros((2 * k, p), np.float32)
        bos_mask = np.zeros((2 * k, p), np.float32)
        spk_mask = np.zeros((2 * k, p), np.float32)
        ids_slotted[:k, p - 1 - nt: p - 1] = ids
        text_mask[:k, p - 1 - nt: p - 1] = 1.0
        bos_mask[:, p - 1] = 1.0
        if has_spk:
            spk_mask[:k, p - 2 - nt] = 1.0
            spk_mask[k:, p - 2] = 1.0
        spk_vec = (np.asarray(spk, np.float32) if has_spk
                   else np.zeros(self.params["spk_proj"].shape[0], np.float32))
        rope_pos = np.stack([np.maximum(np.arange(p) - (p - n), 0) for n in lens])
        attn_mask = np.stack([np.arange(p) >= (p - n) for n in lens])

        max_new = max_new_tokens or cfg.max_new_tokens
        if max_new is None:
            max_new = int(np.clip(len(text) * 2.0 + 50, CHUNK, 2000))
        n_chunks = _round_up(max_new, CHUNK) // CHUNK
        s = p + n_chunks * CHUNK
        cache_cap = max_cache_len or cfg.max_cache_len
        if cache_cap is not None:
            s = min(s, _round_up(max(cache_cap, p + CHUNK), CHUNK))
            n_chunks = max((s - p) // CHUNK, 1)

        cache_k, cache_v = self._shard_kv(2 * k, s)
        key_valid = torch.zeros((2 * k, s), dtype=torch.bool, device=dev)
        with profiling.stage("chatterbox/prefill"):
            logits, cache_k, cache_v, key_valid = _prefill(
                self.params, cfg, _upload(ids_slotted, dev), _upload(text_mask, dev),
                _upload(bos_mask, dev), _upload(spk_mask, dev), _upload(spk_vec, dev),
                _upload(rope_pos.astype(np.int64), dev), _upload(attn_mask, dev),
                cache_k, cache_v, key_valid, tp=self.tp_axis,
            )
        if seeds is None:
            seeds_np = _derive_row_seeds(prng.PRNGKey(0) if rng is None else rng, k)
            seeds_np = seeds_np.cpu().numpy()
        else:
            if len(seeds) != k:
                raise ValueError(f"seeds has {len(seeds)} entries for {k} candidates")
            seeds_np = np.asarray([int(x) for x in seeds], np.int64)
        seeds_t = _upload(seeds_np.astype(np.int64), dev)
        if min_new_tokens > 0:
            logits[:, cfg.speech_eos] = -1e30
        tok0 = _cfg_sample(logits, seeds_t, torch.zeros((k,), dtype=torch.int64, device=dev),
                           temperature, cfg.top_k, cfg_weight)
        return {
            "cache_k": cache_k, "cache_v": cache_v, "key_valid": key_valid,
            "tok0": tok0, "done": tok0 == cfg.speech_eos,
            "rope_base": _upload(np.asarray(lens, np.int64), dev),
            "p": p, "n_chunks": n_chunks, "seeds": seeds_t,
        }

    def _decode_all(self, st, temperature, cfg_weight, min_new_tokens: int, cancel_check):
        """Run the chunked decode loop to completion on the device.

        Early exit reads a LAGGED flag: chunk k's all-done bit is copied to
        pinned host memory behind an event and read after chunk k+1 is
        enqueued, so the device queue never drains (worst case one surplus
        chunk). Returns ``(toks (B, T), done (B, T))``, both on the device.
        """
        cfg = self.cfg
        cache_k, cache_v, key_valid = st["cache_k"], st["cache_v"], st["key_valid"]
        last_tok, done, seeds = st["tok0"], st["done"], st["seeds"]
        rope_base, p = st["rope_base"], st["p"]

        all_toks = [last_tok[:, None]]
        all_done = [done[:, None]]
        slot0 = p
        prev_flag = None
        for _ in range(st["n_chunks"]):
            if cancel_check is not None:
                cancel_check()
            with profiling.stage("chatterbox/decode_chunk"):
                (toks, dones, cache_k, cache_v, key_valid, last_tok, done) = _decode_chunk(
                    self.params, cfg, cache_k, cache_v, key_valid, slot0,
                    rope_base + (slot0 - p), last_tok, done, seeds, temperature, cfg_weight,
                    slot0 - p + 1, min_new_tokens, CHUNK, cfg.top_k, self.tp_axis,
                )
            all_toks.append(toks)
            all_done.append(dones)
            slot0 += CHUNK
            # The PREVIOUS chunk's flag: its copy overlaps the chunk just
            # enqueued.
            if prev_flag is not None and bool(prev_flag.numpy()):
                break
            prev_flag = _Lagged(done.all())
        return torch.cat(all_toks, dim=1), torch.cat(all_done, dim=1)

    @staticmethod
    def _ends(done_np: np.ndarray) -> List[int]:
        """Each row's frame count: up to its first EOS, at least 1."""
        ends = []
        for row in done_np:
            d = np.nonzero(row)[0]
            ends.append(max(int(d[0]) if d.size else row.shape[0], 1))
        return ends

    @torch.inference_mode()
    def generate(self, text: str, audio_prompt_path: Optional[str] = None,
                 temperature: float = 1.0, cfg_weight: float = 0.6,
                 max_new_tokens: Optional[int] = None, max_cache_len: Optional[int] = None,
                 min_new_tokens: int = 0, rng: Optional[torch.Tensor] = None,
                 cancel_check=None, seed: Optional[int] = None) -> torch.Tensor:
        """Synthesize one text; returns a 1-D f32 waveform on the device.

        ``min_new_tokens`` masks EOS for the first N tokens. ``seed`` pins the
        schedule-reproducible sampling stream (a serving request with the
        same seed draws the same tokens); by default
        ``_derive_row_seeds(rng, 1)`` of a threefry key ``rng``
        (``prng.PRNGKey(0)`` by default).
        """
        cfg = self.cfg
        st = self._start_decode(text, audio_prompt_path, temperature, cfg_weight,
                                max_new_tokens, max_cache_len, min_new_tokens, rng,
                                seeds=None if seed is None else [seed])
        toks_dev, done_dev = self._decode_all(st, temperature, cfg_weight, min_new_tokens,
                                              cancel_check)
        # The one fetch: the done bitmap, to find the EOS cut; the tokens are
        # vocoded where they lie.
        with profiling.stage("chatterbox/fetch_done"):
            end = self._ends(done_dev[:1].cpu().numpy())[0]
        with profiling.stage("chatterbox/vocode"):
            wav = _vocode_masked(self.params, cfg, toks_dev[0], end, _round_up(end, CHUNK))
            return apply_watermark(wav[0, : end * cfg.codec.hop])

    @torch.inference_mode()
    def generate_candidates(self, text: str, candidates: int,
                            audio_prompt_path: Optional[str] = None, temperature: float = 1.0,
                            cfg_weight: float = 0.6, max_new_tokens: Optional[int] = None,
                            max_cache_len: Optional[int] = None, min_new_tokens: int = 0,
                            rng: Optional[torch.Tensor] = None, cancel_check=None,
                            seeds=None) -> List[torch.Tensor]:
        """``candidates`` independent samples of one text in a single CFG
        batch (2k rows); returns a list of 1-D waveforms on the device.
        ``seeds`` (one per candidate) pins each candidate's stream: candidate
        i reproduces ``generate(..., seed=seeds[i])``."""
        cfg = self.cfg
        k = int(candidates)
        st = self._start_decode(text, audio_prompt_path, temperature, cfg_weight,
                                max_new_tokens, max_cache_len, min_new_tokens, rng,
                                candidates=k, seeds=seeds)
        toks_dev, done_dev = self._decode_all(st, temperature, cfg_weight, min_new_tokens,
                                              cancel_check)
        with profiling.stage("chatterbox/fetch_done"):
            ends = self._ends(done_dev.cpu().numpy())
        # One bucketed vocode for all candidates, rows masked past their end.
        t_pad = _round_up(max(ends), CHUNK)
        full = toks_dev.shape[1]
        toks = torch.zeros((k, t_pad), dtype=toks_dev.dtype, device=toks_dev.device)
        toks[:, :min(t_pad, full)] = toks_dev[:, :t_pad]
        ar = torch.arange(t_pad, device=toks.device)[None, :]
        toks = torch.where(ar < _upload(np.asarray(ends, np.int64), self.device)[:, None], toks, 0)
        hop = cfg.codec.hop
        with profiling.stage("chatterbox/vocode"):
            wavs = _vocode(self.params, cfg, toks)
            return [apply_watermark(wavs[b, : ends[b] * hop]) for b in range(k)]

    @torch.inference_mode()
    def stream_chunks(self, text: str, audio_prompt_path: Optional[str] = None,
                      temperature: float = 1.0, cfg_weight: float = 0.6,
                      max_new_tokens: Optional[int] = None, max_cache_len: Optional[int] = None,
                      min_new_tokens: int = 0, rng: Optional[torch.Tensor] = None,
                      cancel_check=None, context_frames: int = 32, seed: Optional[int] = None):
        """Incremental synthesis: yields waveform pieces per decode chunk.

        Sliding-window vocode as ``QwenTTSModel.stream_chunks`` (the conv
        vocoder is local, so a window with ``context_frames`` of context
        reproduces the full-utterance vocode for every emitted sample). The
        watermark's chips are position-indexed, so each window is marked at
        its absolute sample offset and the concatenated stream carries the
        one-shot watermark. Each chunk's tokens come to the host (the one
        fetch a chunk costs). Yields ``(piece (S,) on the device,
        sample_rate)``. Single stream.
        """
        cfg = self.cfg
        st = self._start_decode(text, audio_prompt_path, temperature, cfg_weight,
                                max_new_tokens, max_cache_len, min_new_tokens, rng,
                                seeds=None if seed is None else [seed])
        cache_k, cache_v, key_valid = st["cache_k"], st["cache_v"], st["key_valid"]
        last_tok, done, seeds = st["tok0"], st["done"], st["seeds"]
        rope_base, p = st["rope_base"], st["p"]

        hop = cfg.codec.hop
        toks_np = last_tok[:1].cpu().numpy()  # the cond row's token history, grows
        finished = bool(done[0].item())
        emitted = 0  # frames already yielded
        slot0 = p

        def vocode_span(lo: int, hi: int, emit_from: int, emit_to: int):
            """Vocode toks[lo:hi]; return the marked samples of frames
            [emit_from, emit_to). ``lo`` widens so the window holds at least
            one envelope window of samples."""
            need = -(-_ENV_WINDOW // hop) + 1
            lo = min(lo, max(hi - need, 0))
            window = toks_np[lo:hi]
            t = _round_up(window.shape[0], CHUNK)
            batch = _upload(np.pad(window, (0, t - window.shape[0]))[None], self.device)
            with profiling.stage("chatterbox/vocode"):
                wav = _vocode(self.params, cfg, batch)[0, : (hi - lo) * hop]
                marked = apply_watermark(wav, offset=lo * hop)
            return marked[(emit_from - lo) * hop: (emit_to - lo) * hop]

        for _ in range(st["n_chunks"]):
            if finished:
                break
            if cancel_check is not None:
                cancel_check()
            with profiling.stage("chatterbox/decode_chunk"):
                (toks, dones, cache_k, cache_v, key_valid, last_tok, done) = _decode_chunk(
                    self.params, cfg, cache_k, cache_v, key_valid, slot0,
                    rope_base + (slot0 - p), last_tok, done, seeds, temperature, cfg_weight,
                    slot0 - p + 1, min_new_tokens, CHUNK, cfg.top_k, self.tp_axis,
                )
            slot0 += CHUNK
            tt, dd = toks[0].cpu().numpy(), dones[0].cpu().numpy()
            hit = np.nonzero(dd)[0]
            if hit.size:
                tt = tt[: int(hit[0]) + 1]
                finished = True
            toks_np = np.concatenate([toks_np, tt])
            if finished and toks_np.shape[0] > 1 and toks_np[-1] >= cfg.codec.codebook_size:
                toks_np = toks_np[:-1]  # drop the EOS / pad frame itself
            total = toks_np.shape[0]

            safe = total if finished else max(total - context_frames, 0)
            if safe > emitted:
                lo = max(emitted - context_frames, 0)
                piece = vocode_span(lo, total, emitted, safe)
                emitted = safe
                yield piece, self.sr

        if emitted < toks_np.shape[0]:  # final flush (max_new reached)
            total = toks_np.shape[0]
            lo = max(emitted - context_frames, 0)
            yield vocode_span(lo, total, emitted, total), self.sr
