"""The state-space hybrid talker's configuration (``configs/granite-4.0-h-small-tts-bf16.json``):
the program's config, and the weights from the seed in the program's layout.

The configuration holds granite-4.0-h-small's ``config.json`` keys at the top
level (``hidden_size``, ``layer_types``, ``mamba_n_heads``,
``num_local_experts``, ...) beside the codec, the text vocabulary and the
code predictor of the Qwen cells. Weights are drawn as ``lfm2.py`` draws
them, on the device by one ``torch.Generator``: the talker's matmul weights
(experts, shared experts, routers, Mamba and attention projections) into
one buffer of their own, filled a slice of at most 2**30 values at a time,
so that the 64 GB of them live on the card once; the other bf16 leaves; the
Mamba layers' f32 parameters by Mamba-2's initialisation (``A_log = log
U[1, 16]``, ``dt_bias = softplus^-1(exp U[log 1e-3, log 1e-1])``, ``D =
1``); the codebooks. A dense weight is N(0, 1 / fan-in), the depthwise
convolution's taps N(0, 1 / taps), its bias zero, norms at one.

``control`` rounds the talker's matmul weights through float8 e4m3 with one
scale an output channel before the program gets them (``lfm2.round_fp8``):
the precision below the bf16 the configuration states.

The program is imported inside functions only, as ``system.py`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import weights
from .lfm2 import _draw_chunked, round_fp8

BF16 = torch.bfloat16


def sizes(cfg: Dict) -> Dict[str, int]:
    """The talker's widths and layer counts by kind, from the config's keys."""
    kinds = cfg["layer_types"]
    h, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    nh, hp, n = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    di = nh * hp
    return {"hidden": h, "layers": cfg["num_hidden_layers"], "q_heads": hq,
            "kv_heads": cfg["num_key_value_heads"], "head_dim": h // hq,
            "attn": kinds.count("attention"), "mamba": kinds.count("mamba"),
            "experts": cfg["num_local_experts"], "topk": cfg["num_experts_per_tok"],
            "expert_ffn": cfg["intermediate_size"], "shared_ffn": cfg["shared_intermediate_size"],
            "ssm_heads": nh, "ssm_head_dim": hp, "ssm_state": n, "ssm_inner": di,
            "conv_dim": di + 2 * n, "in_proj": 2 * di + 2 * n + nh, "taps": cfg["mamba_d_conv"]}


def program_config(cfg: Dict):
    """The program's ``QwenTTSConfig`` for configuration ``cfg``. A program
    without the state-space talker raises here, before any weight is drawn."""
    from rho_tts_tpu_torch.models.qwen.config import CodecConfig, QwenTTSConfig
    from rho_tts_tpu_torch.models.transformer import TransformerConfig

    z, c = sizes(cfg), cfg["codec"]
    if (cfg["mamba_n_groups"] != 1 or not cfg["mamba_conv_bias"] or cfg["mamba_proj_bias"]
            or cfg["attention_bias"] or cfg["position_embedding_type"] != "nope"
            or cfg["mamba_expand"] * z["hidden"] != z["ssm_inner"]
            or cfg["hidden_act"] != "silu"):
        raise ValueError("the program's state-space talker has one group of B and C, a "
                         "convolution bias, no projection bias, attention without bias or "
                         "rotary embeddings, SiLU, and heads x head_dim = expand x hidden")
    talker = TransformerConfig(
        hidden=z["hidden"], layers=z["layers"], q_heads=z["q_heads"], kv_heads=z["kv_heads"],
        head_dim=z["head_dim"], ffn=0, rope_theta=float(cfg["rope_theta"]),
        rms_eps=cfg["rms_norm_eps"], dtype=BF16,
        layer_types=tuple("full_attention" if k == "attention" else k
                          for k in cfg["layer_types"]),
        n_experts=z["experts"], experts_per_token=z["topk"], expert_ffn=z["expert_ffn"],
        router="softmax", shared_ffn=z["shared_ffn"], ssm_heads=z["ssm_heads"],
        ssm_head_dim=z["ssm_head_dim"], ssm_state=z["ssm_state"], ssm_conv=z["taps"],
        ssm_chunk=cfg["mamba_chunk_size"], rope=False, qk_norm=False,
        attn_scale=float(cfg["attention_multiplier"]),
        residual_multiplier=float(cfg["residual_multiplier"]),
        embedding_multiplier=float(cfg["embedding_multiplier"]))
    codec = CodecConfig(
        sample_rate=c["sample_rate"], upsample_rates=tuple(c["upsample_rates"]),
        n_codebooks=c["n_codebooks"], codebook_size=c["codebook_size"],
        codebook_dim=c["codebook_dim"], decoder_channels=tuple(c["decoder_channels"]),
        encoder_channels=tuple(c["encoder_channels"]),
        resblock_dilations=tuple(c["resblock_dilations"]))
    return QwenTTSConfig(name=cfg["name"], talker=talker, codec=codec,
                         text_vocab=cfg["text_vocab"], n_speakers=cfg["n_speakers"])


def talker_layout(cfg: Dict) -> List[Tuple]:
    """``(path, shape, scale)`` of the talker's matmul weights, experts first."""
    z = sizes(cfg)
    h, fe, fs, e, L = z["hidden"], z["expert_ffn"], z["shared_ffn"], z["experts"], z["layers"]
    qkv = (z["q_heads"] + 2 * z["kv_heads"]) * z["head_dim"]
    hqd, di = z["q_heads"] * z["head_dim"], z["ssm_inner"]
    out = [(("talker", "moe", "w_gate"), (L, e, h, fe), 1 / math.sqrt(h)),
           (("talker", "moe", "w_up"), (L, e, h, fe), 1 / math.sqrt(h)),
           (("talker", "moe", "w_down"), (L, e, fe, h), 1 / math.sqrt(fe)),
           (("talker", "moe", "router"), (L, h, e), 1 / math.sqrt(h)),
           (("talker", "moe", "shared_w_gate"), (L, h, fs), 1 / math.sqrt(h)),
           (("talker", "moe", "shared_w_up"), (L, h, fs), 1 / math.sqrt(h)),
           (("talker", "moe", "shared_w_down"), (L, fs, h), 1 / math.sqrt(fs))]
    if z["mamba"]:
        out += [(("talker", "mamba", "in_proj"), (z["mamba"], h, z["in_proj"]), 1 / math.sqrt(h)),
                (("talker", "mamba", "out_proj"), (z["mamba"], di, h), 1 / math.sqrt(di))]
    if z["attn"]:
        out += [(("talker", "attn", "wqkv"), (z["attn"], h, qkv), 1 / math.sqrt(h)),
                (("talker", "attn", "wo"), (z["attn"], hqd, h), 1 / math.sqrt(hqd))]
    return out


def _rest_layout(cfg: Dict) -> List[Tuple]:
    """The other bf16 leaves: ``weights.py``'s embeddings, heads and codec for
    this hidden size, and the Mamba convolutions' taps."""
    z = sizes(cfg)
    # weights.py's layout of a talker with no layers: its talker leaves are empty
    shim = dict(cfg, talker={"hidden": z["hidden"], "layers": 0, "q_heads": z["q_heads"],
                             "kv_heads": z["kv_heads"], "head_dim": z["head_dim"], "ffn": 1})
    rest = weights._layout(shim)[1]
    if z["mamba"]:
        rest.append((("talker", "mamba", "conv_w"), (z["mamba"], z["conv_dim"], z["taps"]),
                     1 / math.sqrt(z["taps"])))
    return rest


def make_params(cfg: Dict, seed: int, device, control: bool = False) -> Dict:
    """The whole params tree of configuration ``cfg`` from ``seed`` on
    ``device``; ``control`` rounds the talker's matmul weights to float8."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z, c = sizes(cfg), cfg["codec"]
    tree: Dict = {}
    talker = talker_layout(cfg)
    _draw_chunked(gen, talker, device, tree)
    weights._draw(gen, _rest_layout(cfg), device, tree)
    f32 = dict(dtype=torch.float32, device=device)
    t = tree["talker"]
    t["final_norm"] = torch.ones((z["hidden"],), **f32)
    t["moe"]["mlp_norm"] = torch.ones((z["layers"], z["hidden"]), **f32)
    if z["attn"]:
        t["attn"]["attn_norm"] = torch.ones((z["attn"], z["hidden"]), **f32)
    if z["mamba"]:
        lm, nh = z["mamba"], z["ssm_heads"]

        def uniform(lo, hi):
            return torch.rand((lm, nh), generator=gen, **f32) * (hi - lo) + lo

        dt0 = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        t["mamba"].update(
            ssm_norm=torch.ones((lm, z["hidden"]), **f32),
            conv_b=torch.zeros((lm, z["conv_dim"]), dtype=BF16, device=device),
            dt_bias=dt0 + torch.log(-torch.expm1(-dt0)),  # softplus(dt_bias) = dt0
            A_log=torch.log(uniform(1.0, 16.0)),
            D=torch.ones((lm, nh), **f32),
            gate_norm=torch.ones((lm, z["ssm_inner"]), **f32))
    books = torch.randn((c["n_codebooks"], c["codebook_size"], c["codebook_dim"]),
                        generator=gen, dtype=torch.float32, device=device)
    tree["codec"]["rvq"] = {"codebooks": books.mul_(0.05)}
    if control:
        for (_t, kind, name), _shape, _scale in talker:
            round_fp8(t[kind][name])
    return tree


def build_model(cfg: Dict, seed: int, device, control: bool = False):
    """``QwenTTSModel`` over the weights from ``seed`` (``control``: rounded
    to float8), served in bf16. The program's config is built first, so a
    program without the state-space talker stops before any weight is
    drawn."""
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel

    config = program_config(cfg)
    return QwenTTSModel(config, params=make_params(cfg, seed, device, control), device=device)
