"""Checkpoint loading: HF safetensors to the port's Qwen parameter tree.

Counterpart of ``rho_tts_tpu/models/qwen/weights.py``. Maps Qwen-family
transformer weights (q/k/v/o projections, gate/up/down MLP, norms,
embeddings) into the fused-QKV layout of ``models.transformer``, and the
codec's convolutions and codebooks into ``models.qwen.codec``. Matching is
scoped per component: talker tensors are selected only after excluding the
codec / code-predictor / speaker namespaces. Anything unmatched keeps its
random initialization.

HF convolutions already come in torch's layouts, ``Conv1d`` (Cout, Cin, K)
and ``ConvTranspose1d`` (Cin, Cout, K), which are the port's, so they land
as they are; the JAX package's (K, Cin, Cout) is also accepted.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

import torch

from ..hf_weights import find, map_llama_blocks, read_safetensors, scope
from ..quantization import QUANT_KEYS, pack_int4, quantize_weight
from .config import QwenTTSConfig

logger = logging.getLogger(__name__)

# Namespaces that are NOT the AR talker stack.
_NON_TALKER = (
    "codec", "code2wav", "token2wav", "wav2vec", "speaker",
    "code_predictor", "sub_talker", "thinker", "vocoder", "s3gen",
)

# Namespace markers that select codec tensors inside a multi-component checkpoint.
_CODEC_NS = ("codec.", "token2wav.", "code2wav.", "vocoder.")


def _fit_conv(value: torch.Tensor, ref_shape) -> Optional[torch.Tensor]:
    """A conv kernel in the port's layout: as given when the shape matches,
    else a permutation of the JAX (K, Cin, Cout) layout; None when nothing fits."""
    if value.dim() != len(ref_shape):
        return None
    if tuple(value.shape) == tuple(ref_shape):
        return value
    for perm in ((2, 1, 0), (1, 2, 0)):
        if tuple(value.permute(perm).shape) == tuple(ref_shape):
            return value.permute(perm).contiguous()
    return None


def _codec_leaves(codec_params):
    """(tree path, canonical tensor suffix) for every codec conv."""
    leaves = []
    for branch, updown in (("decoder", "ups"), ("encoder", "downs")):
        b = codec_params[branch]
        leaves.append((("codec", branch, "conv_pre"), f"{branch}.conv_pre.weight"))
        leaves.append((("codec", branch, "conv_post"), f"{branch}.conv_post.weight"))
        for i in range(len(b[updown])):
            leaves.append((("codec", branch, updown, i), f"{branch}.{updown}.{i}.weight"))
            rb = b["resblocks"][i]
            for j in range(len(rb["convs_d"])):
                leaves.append((("codec", branch, "resblocks", i, "convs_d", j),
                               f"{branch}.resblocks.{i}.convs_d.{j}.weight"))
                leaves.append((("codec", branch, "resblocks", i, "convs_p", j),
                               f"{branch}.resblocks.{i}.convs_p.{j}.weight"))
    return leaves


def _node(tree, path):
    for p in path[:-1]:
        tree = tree[p]
    return tree


def _map_codec(tensors, params, put) -> None:
    """Map codec (encoder / RVQ / decoder) tensors from their own namespace."""
    cod = scope(tensors, include=_CODEC_NS)
    if not cod:
        return
    for path, suffix in _codec_leaves(params["codec"]):
        t = find(cod, suffix)
        if t is None:
            continue
        fitted = _fit_conv(t, tuple(_node(params, path)[path[-1]].shape))
        if fitted is None:
            logger.warning("Codec layout mismatch at %s: %s", suffix, tuple(t.shape))
            continue
        put(params, path, fitted)
    books = find(cod, "rvq.codebooks", "quantizer.codebooks")
    if books is not None:
        put(params, ("codec", "rvq", "codebooks"), books)
    else:  # per-layer codebooks (encodec/DAC-style export)
        nq = params["codec"]["rvq"]["codebooks"].shape[0]
        per = [
            find(cod, f"rvq.codebooks.{q}", f"quantizer.layers.{q}.codebook",
                 f"quantizer.layers.{q}._codebook.embed")
            for q in range(nq)
        ]
        if all(b is not None for b in per):
            put(params, ("codec", "rvq", "codebooks"), torch.stack(per))


def load_checkpoint(model_path: str, cfg: QwenTTSConfig, quantization: Optional[str] = None,
                    device=None) -> Optional[Dict[str, Any]]:
    """Load and convert a local HF checkpoint onto ``device`` (default
    ``"cuda"``); None when ``model_path`` holds no safetensors.

    The random fallback tree is made on the device; matched tensors are
    assembled on the host, and with ``quantization`` ("int8" or "int4") the
    talker's matched matmul weights are quantized there too
    (``quantize_weight`` / ``pack_int4`` on the CPU), so only the quantized
    bytes travel.
    """
    if not os.path.isdir(model_path):
        return None
    tensors = read_safetensors(model_path)
    if tensors is None:
        return None

    from .model import init_params

    device = torch.device(device or "cuda")
    t = cfg.talker
    params = init_params(cfg, seed=0, device=device)
    matched = 0

    def count():
        nonlocal matched
        matched += 1

    def put(tree, path, value):
        node = _node(tree, path)
        ref = node[path[-1]]
        if tuple(value.shape) != tuple(ref.shape):
            logger.warning("Shape mismatch at %s: %s vs %s", path, tuple(value.shape),
                           tuple(ref.shape))
            return
        node[path[-1]] = value.to(dtype=ref.dtype, device=ref.device)
        count()

    talker_ns = scope(tensors, exclude=_NON_TALKER)

    emb = find(talker_ns, "embed_tokens.weight", "tok_embeddings.weight")
    if emb is not None:
        put(params, ("text_embed",), emb)

    blocks = params["talker"]["blocks"]
    new_blocks = map_llama_blocks(talker_ns, blocks, t.layers, count)
    host = {}  # checkpoint leaves, cast to the tree's dtypes on the host
    for name, value in new_blocks.items():
        host[name] = value.to(blocks[name].dtype) if value is not blocks[name] else None

    final_norm = find(talker_ns, "model.norm.weight", "final_layernorm.weight")
    if final_norm is not None:
        put(params["talker"], ("final_norm",), final_norm)

    head = find(talker_ns, "lm_head.weight", "codec_head.weight")
    if head is not None and tuple(head.T.shape) == tuple(params["lm_head"].shape):
        put(params, ("lm_head",), head.T)

    aud = find(tensors, "audio_embed.weight", "codec_embedding.weight", "codec_embed.weight")
    if aud is not None:
        want = tuple(params["audio_embed"].shape)
        if tuple(aud.shape) == want:
            put(params, ("audio_embed",), aud)
        elif tuple(aud.shape) == (want[0] * want[1], want[2]):
            put(params, ("audio_embed",), aud.reshape(want))
    spk = find(tensors, "speaker_embed.weight", "speaker_embedding.weight")
    if spk is not None:
        put(params, ("speaker_embed",), spk)

    _map_codec(tensors, params, put)

    if matched == 0:
        logger.warning("Checkpoint at %s matched no tensors; using random init", model_path)
        return None

    out_blocks = dict(blocks)
    for name, value in host.items():
        if value is None:
            continue  # unmatched: the device leaf stays (the model quantizes it)
        if quantization in ("int8", "int4") and name in QUANT_KEYS:
            quant = pack_int4 if quantization == "int4" else quantize_weight
            out_blocks[name] = {k: v.to(device) for k, v in quant(value).items()}
        else:
            out_blocks[name] = value.to(device)
    params["talker"] = {**params["talker"], "blocks": out_blocks}
    logger.info("Converted %d tensor groups from %s", matched, model_path)
    return params
