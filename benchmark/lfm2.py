"""The hybrid talker's configuration (``configs/lfm2-8b-a1b-tts-bf16.json``):
the program's config, and the weights from the seed in the program's layout.

The configuration holds LFM2-8B-A1B's ``config.json`` keys at the top level
(``hidden_size``, ``layer_types``, ``num_experts``, ...) beside the codec,
the text vocabulary and the code predictor of the Qwen cells. Weights are
drawn as ``weights.py`` draws them, on the device by one ``torch.Generator``:
the talker's matmul weights into a buffer of their own (filled a slice of at
most 2**30 values at a time), the other bf16 leaves, the expert bias
N(0, 0.05) in f32, the codebooks. A dense weight is N(0, 1 / fan-in), the
depthwise convolution's taps N(0, 1 / taps), norms at one.

``control`` rounds the talker's matmul weights through float8 e4m3 with one
scale an output channel (``absmax / 448`` over the input axis) before the
program gets them: the precision below the bf16 the configuration states.

The program is imported inside functions only, as ``system.py`` does.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import weights

BF16 = torch.bfloat16
_CHUNK = 1 << 30  # values a normal_ call fills at most
_FP8_MAX = 448.0


def sizes(cfg: Dict) -> Dict[str, int]:
    """The talker's widths and layer counts by kind, from the config's keys."""
    kinds = cfg["layer_types"]
    h, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    dense = cfg["num_dense_layers"] if cfg["num_experts"] else layers
    return {"hidden": h, "layers": layers, "q_heads": hq, "kv_heads": cfg["num_key_value_heads"],
            "head_dim": h // hq, "ffn": cfg["intermediate_size"], "attn": kinds.count("full_attention"),
            "conv": kinds.count("conv"), "dense": dense, "moe": layers - dense,
            "experts": cfg["num_experts"], "topk": cfg["num_experts_per_tok"],
            "expert_ffn": cfg["moe_intermediate_size"], "taps": cfg["conv_L_cache"]}


def program_config(cfg: Dict):
    """The program's ``QwenTTSConfig`` for configuration ``cfg``."""
    from rho_tts_tpu_torch.models.qwen.config import CodecConfig, QwenTTSConfig
    from rho_tts_tpu_torch.models.transformer import TransformerConfig

    from rho_tts_tpu_torch.models.transformer import CONV_TAPS

    z, c = sizes(cfg), cfg["codec"]
    if (cfg["conv_bias"] or z["taps"] != CONV_TAPS or not cfg["norm_topk_prob"]
            or cfg["routed_scaling_factor"] != 1):
        raise ValueError("the program's hybrid talker has short convolutions of "
                         f"{CONV_TAPS} taps without a bias, and normalises the experts' "
                         "weights to one")
    talker = TransformerConfig(
        hidden=z["hidden"], layers=z["layers"], q_heads=z["q_heads"], kv_heads=z["kv_heads"],
        head_dim=z["head_dim"], ffn=z["ffn"], rope_theta=float(cfg["rope_theta"]),
        rms_eps=cfg["norm_eps"], dtype=BF16, layer_types=tuple(cfg["layer_types"]),
        n_experts=z["experts"], experts_per_token=z["topk"], expert_ffn=z["expert_ffn"],
        dense_layers=z["dense"])
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
    h, f, fe, e = z["hidden"], z["ffn"], z["expert_ffn"], z["experts"]
    qkv = (z["q_heads"] + 2 * z["kv_heads"]) * z["head_dim"]
    out = []
    if z["moe"]:
        lm = z["moe"]
        out += [(("talker", "moe", "w_gate"), (lm, e, h, fe), 1 / math.sqrt(h)),
                (("talker", "moe", "w_up"), (lm, e, h, fe), 1 / math.sqrt(h)),
                (("talker", "moe", "w_down"), (lm, e, fe, h), 1 / math.sqrt(fe)),
                (("talker", "moe", "router"), (lm, h, e), 1 / math.sqrt(h))]
    if z["conv"]:
        out += [(("talker", "conv", "in_proj"), (z["conv"], h, 3 * h), 1 / math.sqrt(h)),
                (("talker", "conv", "out_proj"), (z["conv"], h, h), 1 / math.sqrt(h))]
    if z["attn"]:
        hqd = z["q_heads"] * z["head_dim"]
        out += [(("talker", "attn", "wqkv"), (z["attn"], h, qkv), 1 / math.sqrt(h)),
                (("talker", "attn", "wo"), (z["attn"], hqd, h), 1 / math.sqrt(hqd))]
    if z["dense"]:
        ld = z["dense"]
        out += [(("talker", "ffn", "w_gate"), (ld, h, f), 1 / math.sqrt(h)),
                (("talker", "ffn", "w_up"), (ld, h, f), 1 / math.sqrt(h)),
                (("talker", "ffn", "w_down"), (ld, f, h), 1 / math.sqrt(f))]
    return out


def _rest_layout(cfg: Dict) -> List[Tuple]:
    """The other bf16 leaves: ``weights.py``'s embeddings, heads and codec for
    this hidden size, and the convolutions' taps."""
    z = sizes(cfg)
    # weights.py's layout of a talker with no layers: its talker leaves are empty
    shim = dict(cfg, talker={"hidden": z["hidden"], "layers": 0, "q_heads": z["q_heads"],
                             "kv_heads": z["kv_heads"], "head_dim": z["head_dim"], "ffn": 1})
    rest = weights._layout(shim)[1]
    if z["conv"]:
        rest.append((("talker", "conv", "conv_w"), (z["conv"], z["hidden"], z["taps"]),
                     1 / math.sqrt(z["taps"])))
    return rest


def _draw_chunked(gen: torch.Generator, leaves: List, device, tree: Dict) -> None:
    """``weights._draw`` for a buffer of any size: one buffer, filled by
    ``normal_`` a slice of at most ``_CHUNK`` values at a time."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    buf = torch.empty(total, dtype=BF16, device=device)
    for at in range(0, total, _CHUNK):
        buf[at: at + _CHUNK].normal_(generator=gen)
    at = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        weights._put(tree, path, buf[at: at + n].view(shape).mul_(scale))
        at += n


def round_fp8(w: torch.Tensor) -> None:
    """Round a stacked ``(L, ..., in, out)`` weight through float8 e4m3 with
    one scale an output channel, in place, a layer at a time."""
    for layer in w:
        wf = layer.float()
        scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / _FP8_MAX
        layer.copy_((wf / scale).to(torch.float8_e4m3fn).float() * scale)


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
    ones = dict(dtype=torch.float32, device=device)
    t = tree["talker"]
    t["final_norm"] = torch.ones((z["hidden"],), **ones)
    if z["attn"]:
        t["attn"]["attn_norm"] = torch.ones((z["attn"], z["hidden"]), **ones)
        t["attn"]["q_norm"] = torch.ones((z["attn"], z["head_dim"]), **ones)
        t["attn"]["k_norm"] = torch.ones((z["attn"], z["head_dim"]), **ones)
    if z["conv"]:
        t["conv"]["conv_norm"] = torch.ones((z["conv"], z["hidden"]), **ones)
    if z["dense"]:
        t["ffn"]["mlp_norm"] = torch.ones((z["dense"], z["hidden"]), **ones)
    if z["moe"]:
        t["moe"]["mlp_norm"] = torch.ones((z["moe"], z["hidden"]), **ones)
        bias = torch.randn((z["moe"], z["experts"]), generator=gen, **ones).mul_(0.05)
        t["moe"]["expert_bias"] = bias if cfg["use_expert_bias"] else torch.zeros_like(bias)
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
    program without the hybrid talker stops before any weight is drawn."""
    from rho_tts_tpu_torch.models.qwen.model import QwenTTSModel

    config = program_config(cfg)
    return QwenTTSModel(config, params=make_params(cfg, seed, device, control), device=device)
