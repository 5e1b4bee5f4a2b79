"""Qwen-class codec-LM TTS model: AR talker + code predictor + codec (PyTorch port).

Counterpart of ``rho_tts_tpu/models/qwen/model.py``. The stages are plain
functions on tensors; :class:`QwenTTSModel` is an ``nn.Module`` whose
parameters carry the names of the JAX params tree (``talker.blocks.wqkv.q``,
``codec.decoder.ups.0``, ...).

* Prompts are LEFT-padded into a static-shape KV cache so every row's last
  prompt token lands on the same slot; prefill runs the talker over the
  whole prompt through the prefill attention kernel.
* Decode runs in chunks of ``_chunk()`` steps; JAX's ``lax.scan`` becomes a
  Python step loop of eager launches, each step running the talker (decode
  attention kernel), seeded top-k Gumbel sampling and the residual code
  predictor. The host checks cancellation and the lagged all-done flag
  between chunks only.
* The codec vocoder turns the codes into a 24 kHz waveform per length
  bucket.
* :meth:`QwenTTSModel.from_pretrained` serves a native checkpoint as
  exported (:meth:`QwenTTSModel.save_checkpoint`, ``models.checkpoint``),
  converts an HF safetensors directory (``models.qwen.weights``), or
  builds a preset with random weights.

Sampling reproduces the JAX package's bits: row i's noise at frame f comes
from ``fold_in(fold_in(PRNGKey(0x5EED), seeds[i]), f)`` through the port's
threefry (``utils.prng``), so the same seeds draw the same tokens.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

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
                  spk_ids, spk_mask, attn_mask) -> torch.Tensor:
    """Assemble the prompt embeddings from the host-built index/mask arrays
    (the [spk?][ref text][text][ref codes][BOS] layout of
    ``_build_prompt_arrays``)."""
    dt = params["text_embed"].dtype
    emb = params["text_embed"][ids_slotted] * text_mask[..., None].to(dt)
    for q in range(cfg.codec.n_codebooks):
        emb = emb + params["audio_embed"][q][codes_slotted[..., q]] * code_mask[..., None].to(dt)
    emb = emb + params["speaker_embed"][spk_ids][:, None, :] * spk_mask[..., None].to(dt)
    bos_mask = attn_mask.float() - text_mask - code_mask - spk_mask
    emb = emb + params["audio_embed"][0][cfg.audio_bos][None, None] * bos_mask[..., None].to(dt)
    return emb


def _prefill(params, cfg, ids_slotted, text_mask, codes_slotted, code_mask, spk_ids,
             spk_mask, rope_pos, attn_mask, cache_k, cache_v, key_valid):
    """Prompt-embedding assembly + prefill. Writes the caches in place.

    Returns ``(logits (B, V) f32, cache_k, cache_v, key_valid)``.
    """
    p = ids_slotted.shape[1]
    embeds = prompt_embeds(params, cfg, ids_slotted, text_mask, codes_slotted, code_mask,
                           spk_ids, spk_mask, attn_mask)
    h, (ck, cv) = tfm.stack_forward(
        params["talker"], cfg.talker, embeds, rope_pos,
        kv_caches=(cache_k, cache_v), cache_len=0, attn_mask=attn_mask,
        key_valid=key_valid, fused_prefill=True,
    )
    key_valid = key_valid.clone()
    key_valid[:, :p] = attn_mask
    logits = h[:, -1].float() @ params["lm_head"].float()
    return logits, ck, cv, key_valid


def _gumbel_noise(seeds: torch.Tensor, frames: torch.Tensor, top_k: int) -> torch.Tensor:
    """Sampler noise ``(..., B, top_k)`` for seeds ``(B,)`` at frames ``(..., B)``
    (or broadcastable): a pure function of ``(seed, frame)`` per row."""
    base = prng.PRNGKey(_SAMPLER_BASE_SEED, device=seeds.device)
    keys = prng.fold_in(prng.fold_in(base, seeds), frames)
    return prng.gumbel(keys, (top_k,))


def _sample_with_noise(logits, temperature: float, top_k: int, noise):
    # A tensor divisor, not a Python scalar: division by a scalar may run as
    # a multiplication by its reciprocal, which rounds differently.
    t = torch.full((1, 1), max(float(np.float32(temperature)), float(np.float32(1e-5))),
                   dtype=torch.float32, device=logits.device)
    logits = logits.float() / t
    vals, idxs = torch.topk(logits, top_k, dim=-1)
    choice = torch.argmax(vals + noise, dim=-1)
    return torch.gather(idxs, 1, choice[:, None])[:, 0]


def _sample_token_seeded(logits, seeds, frames, temperature, top_k: int):
    """Schedule-reproducible top-k Gumbel sampling.

    Row ``i``'s noise is a pure function of ``(seeds[i], frames[i])``, bit
    for bit the JAX package's; ``top_k=1`` is exact greedy.
    """
    return _sample_with_noise(logits, temperature, top_k, _gumbel_noise(seeds, frames, top_k))


def _predict_residuals(params, cfg, h_last, tok0):
    """Predict residual codebooks from hidden state + primary-code embed."""
    n_res = cfg.codec.n_codebooks - 1
    if n_res == 0:
        return torch.zeros((h_last.shape[0], 0), dtype=torch.int64, device=h_last.device)
    w1, w2 = params["code_predictor"]["w1"], params["code_predictor"]["w2"]
    e0 = params["audio_embed"][0][tok0]  # (B, H)
    cp_in = torch.cat([h_last, e0], dim=-1).to(w1.dtype)
    hidden = F.silu(torch.einsum("bd,qdc->qbc", cp_in, w1).float())
    logits = torch.einsum("qbc,qce->qbe", hidden.to(w2.dtype), w2)
    return torch.argmax(logits, dim=-1).T  # (B, Q)


def _decode_chunk(params, cfg, cache_k, cache_v, key_valid, slot0: int, rope_base,
                  last_codes, done, seeds, temperature, step_base: int, min_frames: int,
                  steps: int, top_k: int):
    """``steps`` AR decode steps from cache slot ``slot0``.

    The JAX scan as a Python loop: caches and ``key_valid`` are updated in
    place. Returns ``(codes (B, steps, nq), done (B, steps), cache_k,
    cache_v, key_valid, last_codes, done)``.
    """
    b = last_codes.shape[0]
    nq = cfg.codec.n_codebooks
    embs = params["audio_embed"]
    lm_head = params["lm_head"].float()  # f32 logits over the bf16 head, as JAX's dot
    # Every step's sampler noise in one batched pass: it depends only on
    # (seed, frame), both known before the chunk runs.
    frames = step_base + torch.arange(steps, dtype=torch.int64, device=seeds.device)
    noise = _gumbel_noise(seeds, frames[:, None], top_k)  # (steps, B, top_k)
    codes_seq, done_seq = [], []
    for t in range(steps):
        emb = embs[0][last_codes[:, 0]]
        for q in range(1, nq):
            emb = emb + embs[q][last_codes[:, q]]
        slot = slot0 + t
        h, _ = tfm.stack_forward(
            params["talker"], cfg.talker, emb[:, None, :], (rope_base + t)[:, None],
            kv_caches=(cache_k, cache_v), cache_len=slot, attn_mask=None,
            key_valid=key_valid,
        )
        key_valid[:, slot] = True
        h_last = h[:, -1]
        logits = h_last.float() @ lm_head
        if step_base + t < min_frames:  # enforce a minimum duration
            logits[:, cfg.audio_eos] = -1e30
        tok0 = _sample_with_noise(logits, temperature, top_k, noise[t])
        newly_done = tok0 == cfg.audio_eos
        tok0 = torch.where(done, cfg.audio_pad, tok0)
        res = _predict_residuals(params, cfg, h_last, tok0.clamp_max(cfg.codec.codebook_size - 1))
        res = torch.where(done[:, None], 0, res)
        codes = torch.cat([tok0[:, None], res], dim=-1)
        done = done | newly_done
        codes_seq.append(codes)
        done_seq.append(done)
        last_codes = codes
    return (
        torch.stack(codes_seq, dim=1),
        torch.stack(done_seq, dim=1),
        cache_k, cache_v, key_valid, last_codes, done,
    )


def _vocode(params, cfg, codes):
    """codes (B, T, nq) with specials clamped -> waveform (B, T*hop)."""
    clamped = codes.clamp_max(cfg.codec.codebook_size - 1)
    return codec_lib.decode_from_codes(params["codec"], cfg.codec, clamped)


def _vocode_rows(params, cfg, codes_buf, rows, ends, t: int):
    """Vocode ``codes_buf[rows, :t]`` with frames >= ``ends`` zeroed -> wav (G, t*hop)."""
    f = codes_buf.shape[1]
    te = min(t, f)
    codes = codes_buf[rows, :te]
    if t > te:
        codes = F.pad(codes, (0, 0, 0, t - te))
    mask = torch.arange(t, device=codes.device)[None, :] < ends[:, None]
    codes = torch.where(mask[..., None], codes, 0)
    return _vocode(params, cfg, codes)


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
    """

    def __init__(self, config: QwenTTSConfig, params: Optional[Params] = None, seed: int = 0,
                 quantization: Optional[str] = None, device=None,
                 model_path: Optional[str] = None):
        super().__init__()
        self.config = config
        self.device = torch.device(device or "cuda")
        self.model_path = model_path or config.name
        self.tokenizer = load_tokenizer(model_path, vocab_size=config.text_vocab)
        if params is None:
            params = init_params(config, seed, self.device)
        if quantization in ("int8", "int4"):
            params = {**params, "talker": quantize_stack(params["talker"], quantization)}
        elif quantization not in (None, "none"):
            raise ValueError(f"Unsupported quantization: {quantization}")
        self.quantization = _tree_quantization(params)
        #: the registered parameters as a plain nested dict, for the stage functions
        self.params = {key: _register(self, key, value) for key, value in params.items()}
        self.sample_rate = config.codec.sample_rate

    # -- Loading --------------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_path: str, seed: int = 0, quantization: Optional[str] = None,
                        device=None) -> "QwenTTSModel":
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
                        device=device, model_path=path)
            model.variant = manifest.get("variant")
            return model

        cfg = resolve_config(path)
        params = load_checkpoint(path, cfg, quantization=quantization, device=device)
        return cls(cfg, params=params, seed=seed, quantization=quantization, device=device,
                   model_path=path)

    def save_checkpoint(self, path: str) -> None:
        """Export the parameter tree as a native serving checkpoint.

        A quantized model writes its int8 / int4 leaves. The manifest records
        the CustomVoice/Base ``variant``, as the JAX package's does.
        """
        from .. import checkpoint as ckpt_lib

        variant = getattr(self, "variant", None) or (
            "custom-voice" if "CustomVoice" in str(self.model_path or "") else "base"
        )
        ckpt_lib.save_params(
            path, self.params, family="qwen", preset=self.config.name,
            quantization=self.quantization, extra={"variant": variant},
        )

    # -- Prompt building ----------------------------------------------------

    def _build_prompt_arrays(self, texts: Sequence[str], speaker: Optional[str], language: str,
                             ref_audio: Optional[str], ref_text: Optional[str]):
        """Host-built index/mask arrays describing each prompt row.

        Layout per row: [spk?][ref text][text][ref codes][BOS], left-padded
        to the prompt bucket. Returns (arrays dict of np arrays, lens list, p).
        """
        if ref_audio is not None:
            raise NotImplementedError(
                "ref_audio conditioning needs audio_io/resample, not ported yet"
            )
        cfg = self.config
        nq = cfg.codec.n_codebooks
        ref_ids: List[int] = []
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
        lens = [int(has_spk) + len(ref_ids) + len(ids) + 1 for ids in rows_ids]
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
                       top_k: Optional[int] = None, rng: Optional[torch.Generator] = None,
                       cancel_check=None, prebuilt_prompt=None,
                       seeds: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        """Prefill + chunked AR decode; returns per-text ``(T, nq)`` int32 code arrays.

        ``min_frames`` masks EOS for the first N frames. ``seeds`` (one int
        per text) makes sampling schedule-reproducible and equal to the JAX
        package's for the same seeds; without them the seeds are drawn from
        ``rng`` (a CPU ``torch.Generator``, seed 0 by default).
        """
        codes_dev, done_dev, n_real = self._generate_codes_arrays(
            texts, speaker=speaker, language=language, ref_audio=ref_audio,
            ref_text=ref_text, max_frames=max_frames, min_frames=min_frames,
            temperature=temperature, top_k=top_k, rng=rng, cancel_check=cancel_check,
            prebuilt_prompt=prebuilt_prompt, seeds=seeds,
        )
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
        device.
        """
        cfg = self.config
        dev = self.device
        temperature = cfg.temperature if temperature is None else temperature
        top_k = cfg.top_k if top_k is None else top_k

        with profiling.stage("qwen/prompt_build"):
            if prebuilt_prompt is not None:
                arrays, lens, p = prebuilt_prompt
            else:
                arrays, lens, p = self._build_prompt_arrays(
                    texts, speaker, language, ref_audio, ref_text
                )
        n_real = b = len(texts)
        a = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

        if max_frames is None:
            max_chars = max(len(t) for t in texts)
            max_frames = int(np.clip(max_chars * 1.0 + 50, _chunk(), 1500))
        n_chunks = _round_up(max_frames, _chunk()) // _chunk()
        s = p + n_chunks * _chunk()

        cache_k, cache_v = tfm.make_kv_cache(cfg.talker, b, s, device=dev)
        key_valid = torch.zeros((b, s), dtype=torch.bool, device=dev)

        with profiling.stage("qwen/prefill"):
            logits, cache_k, cache_v, key_valid = _prefill(
                self.params, cfg, a["ids_slotted"], a["text_mask"], a["codes_slotted"],
                a["code_mask"], a["spk_ids"], a["spk_mask"], a["rope_pos"], a["attn_mask"],
                cache_k, cache_v, key_valid,
            )

        if seeds is None:
            if rng is None:
                rng = torch.Generator().manual_seed(0)
            seeds_b = torch.randint(0, np.iinfo(np.int32).max, (n_real,), generator=rng)
        else:
            if len(seeds) != n_real:
                raise ValueError(f"seeds has {len(seeds)} entries for {n_real} texts")
            seeds_b = torch.as_tensor(np.asarray(seeds, np.int64))
        seeds_b = seeds_b.to(dev)
        if min_frames > 0:
            logits[:, cfg.audio_eos] = -1e30
        tok0 = _sample_token_seeded(
            logits, seeds_b, torch.zeros((b,), dtype=torch.int64, device=dev), temperature, top_k
        )
        # Frame 0's residual codes are zeros, as in the JAX package.
        first_codes = torch.cat(
            [tok0[:, None], torch.zeros((b, cfg.codec.n_codebooks - 1), dtype=torch.int64,
                                        device=dev)], dim=-1,
        )
        done = tok0 == cfg.audio_eos
        rope_base = torch.as_tensor(lens, dtype=torch.int64).to(dev)

        # Code/done chunks accumulate on the device; the early exit reads the
        # PREVIOUS chunk's all-done flag, so the host never waits on the chunk
        # it just enqueued (worst case one surplus chunk).
        all_codes = [first_codes[:, None, :]]
        all_done = [done[:, None]]
        last_codes = first_codes
        slot0 = p
        prev_flag = None
        for _ in range(n_chunks):
            if cancel_check is not None:
                cancel_check()
            with profiling.stage("qwen/decode_chunk"):
                (codes_chunk, done_chunk, cache_k, cache_v, key_valid, last_codes,
                 done) = _decode_chunk(
                    self.params, cfg, cache_k, cache_v, key_valid, slot0,
                    rope_base + (slot0 - p), last_codes, done, seeds_b, temperature,
                    slot0 - p + 1, min_frames, _chunk(), top_k,
                )
            all_codes.append(codes_chunk)
            all_done.append(done_chunk)
            slot0 += _chunk()
            if prev_flag is not None and bool(prev_flag):
                break
            prev_flag = done.all()

        return torch.cat(all_codes, dim=1), torch.cat(all_done, dim=1), n_real

    @torch.inference_mode()
    def synthesize(self, texts: Union[str, Sequence[str]], speaker: Optional[str] = None,
                   language: str = "English", ref_audio: Optional[str] = None,
                   ref_text: Optional[str] = None, max_frames: Optional[int] = None,
                   min_frames: int = 0, temperature: Optional[float] = None,
                   top_k: Optional[int] = None, rng: Optional[torch.Generator] = None,
                   cancel_check=None,
                   seeds: Optional[Sequence[int]] = None) -> Tuple[List[torch.Tensor], int]:
        """Full text -> waveform path. Returns (list of 1-D f32 waveforms, sr).

        The codes stay on the device: the host fetches only the (B, T) done
        bitmap to learn each row's length, and the vocoder reads the code
        tensor in place (gather + end-mask per length bucket).
        """
        text_list = [texts] if isinstance(texts, str) else list(texts)
        codes_dev, done_dev, n_real = self._generate_codes_arrays(
            text_list, speaker=speaker, language=language, ref_audio=ref_audio,
            ref_text=ref_text, max_frames=max_frames, min_frames=min_frames,
            temperature=temperature, top_k=top_k, rng=rng, cancel_check=cancel_check,
            seeds=seeds,
        )
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
                wav = _vocode_rows(
                    self.params, self.config, codes_dev,
                    torch.as_tensor(idxs, dtype=torch.int64).to(self.device),
                    torch.as_tensor([ends[i] for i in idxs], dtype=torch.int64).to(self.device),
                    t,
                )
            for row, i in enumerate(idxs):
                waves[i] = wav[row, : ends[i] * hop]
        return waves, self.sample_rate
