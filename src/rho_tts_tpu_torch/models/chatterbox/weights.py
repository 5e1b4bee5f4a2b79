"""Chatterbox checkpoint conversion to the port's parameter tree.

Counterpart of ``rho_tts_tpu/models/chatterbox/weights.py``. The upstream
chatterbox-tts package ships a T3 AR model (a llama-style backbone with
text and speech embeddings, a speech head and a speaker-conditioning
projection) beside separate voice-encoder and vocoder files. This converter
maps the T3 tensors into :mod:`rho_tts_tpu_torch.models.chatterbox.model`'s
layout from either a ``*.safetensors`` directory or a ``t3_cfg.pt`` torch
file, with the JAX package's tensor names and exclusions. Unmatched leaves
keep their random initialization.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Any, Dict, Optional

import torch

from ..hf_weights import find, map_llama_blocks, read_safetensors, read_torch_state, scope

logger = logging.getLogger(__name__)

# Chatterbox checkpoints bundle non-T3 components in separate namespaces /
# files; they are kept out of the AR backbone's matching.
_NON_T3 = ("s3gen", "ve.", "voice_encoder", "tokenizer", "watermark", "codec")


def _read(model_path: str) -> Optional[Dict[str, torch.Tensor]]:
    if os.path.isdir(model_path):
        tensors = read_safetensors(model_path)
        if tensors:
            return tensors
        merged: Dict[str, torch.Tensor] = {}
        for pt in sorted(glob.glob(os.path.join(model_path, "*.pt"))):
            base = os.path.basename(pt)
            if any(x in base for x in ("ve", "s3gen")):
                continue  # the voice encoder and the vocoder live in other modules
            state = read_torch_state(pt)
            if state:
                merged.update(state)
        return merged or None
    if model_path.endswith((".pt", ".safetensors")) and os.path.isfile(model_path):
        return read_torch_state(model_path)
    return None


def load_checkpoint(model_path: str, cfg, device=None) -> Optional[Dict[str, Any]]:
    """Convert a chatterbox T3 checkpoint onto ``device`` (default
    ``"cuda"``); None when absent or when nothing matched."""
    tensors = _read(model_path)
    if not tensors:
        return None

    from .model import init_params

    device = torch.device(device or "cuda")
    params = init_params(cfg, seed=0, device=device)
    matched = 0

    def count():
        nonlocal matched
        matched += 1

    def put(key, value, transpose=False):
        ref = params[key]
        v = value.T if transpose else value
        if tuple(v.shape) != tuple(ref.shape):
            logger.warning("Shape mismatch at %s: %s vs %s", key, tuple(v.shape),
                           tuple(ref.shape))
            return
        params[key] = v.to(dtype=ref.dtype, device=device)
        count()

    t3 = scope(tensors, exclude=_NON_T3)

    emb = find(t3, "text_emb.weight", "text_embed.weight")
    if emb is not None:
        put("text_embed", emb)
    spe = find(t3, "speech_emb.weight", "speech_embed.weight")
    if spe is not None:
        put("speech_embed", spe)
    head = find(t3, "speech_head.weight", "lm_head.weight")
    if head is not None:
        put("lm_head", head, transpose=True)
    spk = find(t3, "spkr_enc.weight", "spk_proj.weight", "cond_proj.weight")
    if spk is not None:
        put("spk_proj", spk, transpose=True)

    blocks = params["talker"]["blocks"]
    new_blocks = map_llama_blocks(t3, blocks, cfg.talker.layers, count)
    params["talker"]["blocks"] = {
        k: v.to(dtype=blocks[k].dtype, device=device) for k, v in new_blocks.items()
    }
    final_norm = find(t3, "tfmr.norm.weight", "model.norm.weight", "final_layernorm.weight")
    if final_norm is not None:
        ref = params["talker"]["final_norm"]
        if tuple(final_norm.shape) == tuple(ref.shape):
            params["talker"]["final_norm"] = final_norm.to(dtype=ref.dtype, device=device)
            count()

    if matched == 0:
        logger.warning("Chatterbox checkpoint at %s matched no tensors", model_path)
        return None
    logger.info("Converted %d chatterbox tensor groups from %s", matched, model_path)
    return params
