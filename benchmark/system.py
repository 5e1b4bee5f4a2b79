"""The system under test: the PyTorch port, built from a configuration file.

The program is imported here, inside functions, and nowhere else in the
harness: only after the run has found its card, so that a run without a
card, or without the program beside it, stops before it imports anything.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import weights


def program_config(cfg: Dict):
    """The program's ``QwenTTSConfig`` with the sizes of configuration ``cfg``."""
    import torch
    from rho_tts_tpu_torch.models.qwen.config import CodecConfig, QwenTTSConfig
    from rho_tts_tpu_torch.models.transformer import TransformerConfig

    t, c = cfg["talker"], cfg["codec"]
    talker = TransformerConfig(
        hidden=t["hidden"], layers=t["layers"], q_heads=t["q_heads"], kv_heads=t["kv_heads"],
        head_dim=t["head_dim"], ffn=t["ffn"], rope_theta=t["rope_theta"], rms_eps=t["rms_eps"],
        dtype=torch.bfloat16)
    codec = CodecConfig(
        sample_rate=c["sample_rate"], upsample_rates=tuple(c["upsample_rates"]),
        n_codebooks=c["n_codebooks"], codebook_size=c["codebook_size"],
        codebook_dim=c["codebook_dim"], decoder_channels=tuple(c["decoder_channels"]),
        encoder_channels=tuple(c["encoder_channels"]),
        resblock_dilations=tuple(c["resblock_dilations"]))
    return QwenTTSConfig(name=cfg["name"], talker=talker, codec=codec,
                         text_vocab=cfg["text_vocab"], n_speakers=cfg["n_speakers"])


def quantization(cfg: Dict, control: bool = False) -> Optional[str]:
    """The talker's quantization the configuration states, or with ``control``
    the lower one it names for the output check's control."""
    q = cfg["control"]["quantization"] if control else cfg["quantization"]
    return None if q == "none" else q


def build_model(cfg: Dict, seed: int, device, control: bool = False):
    """``QwenTTSModel`` over the benchmark's weights from ``seed``; the program
    quantizes them itself where the configuration says so (``control``: in
    the configuration's control precision)."""
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel

    params = weights.make_params(cfg, seed, device)
    return QwenTTSModel(program_config(cfg), params=params,
                        quantization=quantization(cfg, control), device=device)


def serving_engine(model, **kwargs):
    from rho_tts_tpu_torch.serving import ServingEngine

    return ServingEngine(model, **kwargs)


def model_module():
    from rho_tts_tpu_torch.models.qwen import model

    return model
