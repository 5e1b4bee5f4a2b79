"""Configuration for the Qwen-class codec-LM TTS model (PyTorch port).

Same presets and numbers as ``rho_tts_tpu/models/qwen/config.py``; the
talker dtype is a torch dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import torch

from ..transformer import TransformerConfig


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Neural audio codec (encoder + RVQ + vocoder decoder)."""

    sample_rate: int = 24000
    # Upsample rates multiply to hop (1920 → 12.5 Hz frames at 24 kHz)
    upsample_rates: Tuple[int, ...] = (8, 6, 5, 4, 2)
    n_codebooks: int = 4
    codebook_size: int = 2048
    codebook_dim: int = 512
    decoder_channels: Tuple[int, ...] = (512, 256, 128, 64, 32, 16)
    encoder_channels: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    resblock_dilations: Tuple[int, ...] = (1, 3, 9)

    @property
    def hop(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop


@dataclasses.dataclass(frozen=True)
class QwenTTSConfig:
    """Full model config: AR talker + codec + heads."""

    name: str = "1.7B"
    talker: TransformerConfig = dataclasses.field(default_factory=TransformerConfig)
    codec: CodecConfig = dataclasses.field(default_factory=CodecConfig)
    text_vocab: int = 152064
    n_speakers: int = 16  # CustomVoice named-speaker table
    max_position_embeddings: int = 8192
    # Sampling defaults
    temperature: float = 0.9
    top_k: int = 50
    # Audio token specials (appended after codebook entries in codebook 0)
    audio_bos_offset: int = 0  # codebook_size + 0
    audio_eos_offset: int = 1  # codebook_size + 1
    audio_pad_offset: int = 2  # codebook_size + 2

    @property
    def audio_vocab(self) -> int:
        return self.codec.codebook_size + 3

    @property
    def audio_bos(self) -> int:
        return self.codec.codebook_size + self.audio_bos_offset

    @property
    def audio_eos(self) -> int:
        return self.codec.codebook_size + self.audio_eos_offset

    @property
    def audio_pad(self) -> int:
        return self.codec.codebook_size + self.audio_pad_offset


def _talker(hidden, layers, q_heads, kv_heads, ffn, head_dim=128):
    return TransformerConfig(
        hidden=hidden,
        layers=layers,
        q_heads=q_heads,
        kv_heads=kv_heads,
        head_dim=head_dim,
        ffn=ffn,
        dtype=torch.bfloat16,
    )


PRESETS = {
    "1.7B": QwenTTSConfig(
        name="1.7B",
        talker=_talker(2048, 28, 16, 8, 6144),
        text_vocab=152064,
    ),
    "0.6B": QwenTTSConfig(
        name="0.6B",
        talker=_talker(1024, 28, 16, 8, 3072, head_dim=128),
        text_vocab=152064,
    ),
    # Mid-size pair for the speculative-decoding demo: "small" is big
    # enough that a decode step has real compute/HBM cost, "draft" is
    # ~30× cheaper — distilled (models.qwen.distill) it yields a measured
    # end-to-end speculation speedup with realized acceptance
    # (BASELINE.md 5s).
    "small": QwenTTSConfig(
        name="small",
        talker=_talker(512, 8, 8, 4, 1536, head_dim=64),
        codec=CodecConfig(
            upsample_rates=(4, 2),
            n_codebooks=2,
            codebook_size=64,
            codebook_dim=32,
            decoder_channels=(32, 16, 8),
            encoder_channels=(8, 16, 32),
        ),
        text_vocab=512,
        max_position_embeddings=1024,
    ),
    "draft": QwenTTSConfig(
        name="draft",
        talker=_talker(128, 2, 4, 2, 384, head_dim=32),
        codec=CodecConfig(
            upsample_rates=(4, 2),
            n_codebooks=2,
            codebook_size=64,
            codebook_dim=32,
            decoder_channels=(32, 16, 8),
            encoder_channels=(8, 16, 32),
        ),
        text_vocab=512,
        max_position_embeddings=1024,
    ),
    # Flagship-ratio speculation draft: same vocabularies and codec as the
    # 1.7B target (a serving draft must share them) with a ~45× smaller
    # talker. BASELINE 5s-mech showed a 0.6B draft (only ~3× cheaper per
    # step) can't break even on the 1.7B; at this ratio a draft step is
    # dispatch-bound, so the round cost is ~one target forward.
    # Exact-name match only (not in _INFERRED_PRESETS: "1.7B" appears in
    # real checkpoint names and must keep resolving to the flagship).
    "draft-1.7B": QwenTTSConfig(
        name="draft-1.7B",
        talker=_talker(512, 8, 8, 4, 2048, head_dim=64),
        text_vocab=152064,
    ),
    # Small configs for tests / CPU dry-runs
    "tiny": QwenTTSConfig(
        name="tiny",
        talker=_talker(64, 2, 4, 2, 128, head_dim=16),
        codec=CodecConfig(
            upsample_rates=(4, 2),
            n_codebooks=2,
            codebook_size=64,
            codebook_dim=32,
            decoder_channels=(32, 16, 8),
            encoder_channels=(8, 16, 32),
        ),
        text_vocab=512,
        max_position_embeddings=512,
    ),
}


#: LFM2-8B-A1B's decoder (huggingface.co/LiquidAI/LFM2-8B-A1B, config.json,
#: model_type lfm2_moe): 18 gated short-convolution and 6 attention layers
LFM2_LAYER_TYPES = tuple(
    "full_attention" if i in (2, 6, 10, 14, 18, 21) else "conv" for i in range(24))


def _lfm2_talker(hidden, q_heads, kv_heads, ffn, layer_types, n_experts, experts_per_token,
                 expert_ffn, dense_layers):
    return TransformerConfig(
        hidden=hidden, layers=len(layer_types), q_heads=q_heads, kv_heads=kv_heads,
        head_dim=hidden // q_heads, ffn=ffn, rope_theta=1_000_000.0, rms_eps=1e-5,
        dtype=torch.bfloat16, layer_types=layer_types, n_experts=n_experts,
        experts_per_token=experts_per_token, expert_ffn=expert_ffn, dense_layers=dense_layers)


# The hybrid talker: LFM2-8B-A1B's decoder at its published sizes as the
# codec-LM's talker, in bf16 (the release's precision), with the 1.7B's
# codec and heads. Exact-name match only.
PRESETS["lfm2-8b-a1b"] = QwenTTSConfig(
    name="lfm2-8b-a1b",
    talker=_lfm2_talker(2048, 32, 8, 7168, LFM2_LAYER_TYPES, 32, 4, 1792, 2),
    text_vocab=65536,
)
# Its shape at test size: conv, conv, attention, conv, attention, conv; two
# dense layers, then 8 experts of 32, top 3. Exact-name match only.
PRESETS["lfm2-tiny"] = QwenTTSConfig(
    name="lfm2-tiny",
    talker=_lfm2_talker(64, 4, 2, 128, ("conv", "conv", "full_attention", "conv",
                                        "full_attention", "conv"), 8, 3, 32, 2),
    codec=PRESETS["tiny"].codec,
    text_vocab=512,
    max_position_embeddings=512,
)


#: granite-4.0-h-small's decoder (huggingface.co/ibm-granite/granite-4.0-h-small,
#: config.json, model_type granitemoehybrid): 36 Mamba-2 and 4 attention layers
GRANITE_LAYER_TYPES = tuple(
    "full_attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))


def _granite_talker(hidden, q_heads, kv_heads, layer_types, n_experts, experts_per_token,
                    expert_ffn, shared_ffn, ssm_heads, ssm_head_dim, ssm_state, ssm_chunk,
                    attn_scale, residual_multiplier, embedding_multiplier):
    return TransformerConfig(
        hidden=hidden, layers=len(layer_types), q_heads=q_heads, kv_heads=kv_heads,
        head_dim=hidden // q_heads, ffn=0, rope_theta=10_000.0, rms_eps=1e-5,
        dtype=torch.bfloat16, layer_types=layer_types, n_experts=n_experts,
        experts_per_token=experts_per_token,
        expert_ffn=expert_ffn, router="softmax", shared_ffn=shared_ffn, ssm_heads=ssm_heads,
        ssm_head_dim=ssm_head_dim, ssm_state=ssm_state, ssm_conv=4, ssm_chunk=ssm_chunk,
        rope=False, qk_norm=False, attn_scale=attn_scale, residual_multiplier=residual_multiplier,
        embedding_multiplier=embedding_multiplier)


# The state-space hybrid talker: granite-4.0-h-small's decoder at its
# published sizes as the codec-LM's talker, in bf16 (the release's
# precision), with the 1.7B's codec and heads: Mamba-2 mixers (128 heads of
# 64, state 128) beside NoPE attention (softmax scale 1/128), 72 experts of
# 768 (top 10, softmax router) and a shared SwiGLU of 1536 in every layer,
# muP multipliers (residual 0.22, inputs x 12). Exact-name match only.
PRESETS["granite-4.0-h-small"] = QwenTTSConfig(
    name="granite-4.0-h-small",
    talker=_granite_talker(4096, 32, 8, GRANITE_LAYER_TYPES, 72, 10, 768, 1536, 128, 64, 128,
                           256, 0.0078125, 0.22, 12.0),
    text_vocab=100352,
)
# Its shape at test size: mamba, mamba, attention, mamba, attention, mamba;
# 8 experts of 32 (top 3) and a shared one of 32 in every layer; 8 Mamba
# heads of 16, a state of 16, a scan chunk of 8. Exact-name match only.
PRESETS["granite-tiny"] = QwenTTSConfig(
    name="granite-tiny",
    talker=_granite_talker(64, 4, 2, ("mamba", "mamba", "full_attention", "mamba",
                                      "full_attention", "mamba"), 8, 3, 32, 32, 8, 16, 16, 8,
                           0.0625, 0.22, 12.0),
    codec=PRESETS["tiny"].codec,
    text_vocab=512,
    max_position_embeddings=512,
)


# Preset keys eligible for substring inference from checkpoint names.
# "small"/"draft" (the speculative-demo pair) are deliberately excluded:
# they are common words in real checkpoint paths (".../qwen-0.6b-draft")
# and would silently hijack the size inference — they resolve only on an
# exact name match.
_INFERRED_PRESETS = ("0.6B", "1.7B", "tiny")


def resolve_config(model_path: str) -> QwenTTSConfig:
    """Map a model path / HF id to a config.

    A local directory with a ``config.json`` may override the preset size;
    otherwise the preset is inferred from the name ("0.6B", "1.7B", "tiny")
    or matched exactly ("small", "draft", "lfm2-8b-a1b", "lfm2-tiny",
    "granite-4.0-h-small", "granite-tiny").
    """
    base = "1.7B"
    # Match against the basename only (a parent directory like
    # '/home/martiny/' must not trigger the 'tiny' preset), preferring the
    # longest matching preset name.
    name = os.path.basename(os.path.normpath(str(model_path))).lower()
    exact = [k for k in PRESETS if k.lower() == name]
    matches = exact or [k for k in _INFERRED_PRESETS if k.lower() in name]
    if matches:
        base = max(matches, key=len)
    cfg = PRESETS[base]

    if os.path.isdir(model_path):
        cfg_file = os.path.join(model_path, "config.json")
        if os.path.exists(cfg_file):
            try:
                with open(cfg_file) as f:
                    raw = json.load(f)
                mpe = raw.get("max_position_embeddings")
                if mpe:
                    cfg = dataclasses.replace(cfg, max_position_embeddings=int(mpe))
            except Exception:
                pass
    return cfg
