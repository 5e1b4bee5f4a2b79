"""Neural audio codec: conv encoder -> residual VQ -> transposed-conv vocoder.

Counterpart of ``rho_tts_tpu/models/qwen/codec.py`` in PyTorch idiom: the
convolutions run in torch's ``(B, C, T)`` layout through ``F.conv1d`` and
``F.conv_transpose1d`` (XLA computes them outside any Pallas kernel), and
the conv weights are stored in torch's layout, ``(Cout, Cin, K)`` for a
convolution and ``(Cin, Cout, K)`` for a transposed one (the JAX package
keeps ``(K, Cin, Cout)``; ``from_jax`` converts). The public entry points
keep the JAX layouts: waveforms ``(B, samples)``, codes ``(B, T, nq)``.
Compute dtype follows the parameters (bf16 by default, f32 in the parity
tests).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .config import CodecConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Conv primitives (B, C, T layout)
# ---------------------------------------------------------------------------


def conv1d(x, w, b=None, stride=1, dilation=1):
    """x: (B, Cin, T), w: (Cout, Cin, K); torch "same"-style symmetric pad
    ``dilation * (k - 1) // 2``, as the JAX ``conv1d(padding=None)``."""
    k = w.shape[-1]
    out = F.conv1d(x, w, b, stride=stride, dilation=dilation, padding=dilation * (k - 1) // 2)
    return out


def conv_transpose1d(x, w, b=None, stride=1):
    """x: (B, Cin, T), w: (Cin, Cout, K); output length exactly T*stride.

    ``ConvTranspose1d(stride=r, padding=(k - r) // 2)`` (the HiFiGAN
    convention); when ``k - stride`` is odd the extra right-edge sample is
    cropped, as in the JAX package.
    """
    k = w.shape[-1]
    out = F.conv_transpose1d(x, w, b, stride=stride, padding=(k - stride) // 2)
    return out[..., : x.shape[-1] * stride]


def _winit(gen, k, cin, cout, dtype, device, transpose=False):
    scale = 1.0 / np.sqrt(k * cin)
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def leaky_relu(x, slope=0.1):
    return torch.where(x >= 0, x, slope * x)


# ---------------------------------------------------------------------------
# Residual blocks
# ---------------------------------------------------------------------------


def init_resblock(gen, channels: int, dilations, dtype, device) -> Params:
    n = len(dilations)
    return {
        "convs_d": [_winit(gen, 3, channels, channels, dtype, device) for _ in range(n)],
        "convs_p": [_winit(gen, 1, channels, channels, dtype, device) for _ in range(n)],
    }


def resblock(params: Params, x, dilations):
    for wd, wp, d in zip(params["convs_d"], params["convs_p"], dilations):
        h = conv1d(leaky_relu(x), wd, dilation=d)
        h = conv1d(leaky_relu(h), wp)
        x = x + h
    return x


# ---------------------------------------------------------------------------
# Encoder (waveform -> frame embeddings)
# ---------------------------------------------------------------------------


def init_encoder(gen, cfg: CodecConfig, dtype, device) -> Params:
    chans = cfg.encoder_channels
    rates = tuple(reversed(cfg.upsample_rates))
    p: Params = {
        "conv_pre": _winit(gen, 7, 1, chans[0], dtype, device),
        "downs": [],
        "resblocks": [],
        "conv_post": _winit(gen, 3, chans[-1], cfg.codebook_dim, dtype, device),
    }
    for i, r in enumerate(rates):
        cin, cout = chans[i], chans[i + 1]
        p["downs"].append(_winit(gen, 2 * r, cin, cout, dtype, device))
        p["resblocks"].append(init_resblock(gen, cout, cfg.resblock_dilations, dtype, device))
    return p


def encode_frames(params: Params, cfg: CodecConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav: (B, T_samples) -> (B, T_frames, codebook_dim)."""
    rates = tuple(reversed(cfg.upsample_rates))
    x = wav[:, None, :].to(params["conv_pre"].dtype)  # (B, 1, T)
    x = conv1d(x, params["conv_pre"])
    for w, rb, r in zip(params["downs"], params["resblocks"], rates):
        x = conv1d(leaky_relu(x), w, stride=r)
        x = resblock(rb, x, cfg.resblock_dilations)
    return conv1d(leaky_relu(x), params["conv_post"]).transpose(1, 2)


# ---------------------------------------------------------------------------
# Residual vector quantizer
# ---------------------------------------------------------------------------


def init_rvq(gen, cfg: CodecConfig, device) -> Params:
    books = torch.randn(
        (cfg.n_codebooks, cfg.codebook_size, cfg.codebook_dim),
        generator=gen, dtype=torch.float32, device=device,
    )
    return {"codebooks": books * 0.05}  # (nq, size, dim)


def rvq_quantize(params: Params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, dim) -> codes (B, T, nq) by greedy residual NN search."""
    books = params["codebooks"]  # (nq, size, dim)
    residual = frames.float()
    codes = []
    for q in range(books.shape[0]):
        book = books[q]
        dots = torch.einsum("btd,sd->bts", residual, book)
        norms = (book * book).sum(dim=-1)
        idx = torch.argmax(2.0 * dots - norms[None, None, :], dim=-1)
        codes.append(idx)
        residual = residual - book[idx]
    return torch.stack(codes, dim=-1)


def rvq_dequantize(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """codes: (B, T, nq) -> frame embeddings (B, T, dim)."""
    books = params["codebooks"]
    out = 0.0
    for q in range(books.shape[0]):
        out = out + books[q][codes[..., q]]
    return out


# ---------------------------------------------------------------------------
# Decoder / vocoder (frame embeddings -> waveform)
# ---------------------------------------------------------------------------


def init_decoder(gen, cfg: CodecConfig, dtype, device) -> Params:
    chans = cfg.decoder_channels
    n_up = len(cfg.upsample_rates)
    p: Params = {
        "conv_pre": _winit(gen, 7, cfg.codebook_dim, chans[0], dtype, device),
        "ups": [],
        "resblocks": [],
        "conv_post": _winit(gen, 7, chans[n_up], 1, dtype, device),
    }
    for i, r in enumerate(cfg.upsample_rates):
        cin, cout = chans[i], chans[i + 1]
        p["ups"].append(_winit(gen, 2 * r, cin, cout, dtype, device, transpose=True))
        p["resblocks"].append(init_resblock(gen, cout, cfg.resblock_dilations, dtype, device))
    return p


def decode_frames(params: Params, cfg: CodecConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, dim) -> waveform (B, T * hop) in [-1, 1]."""
    x = frames.to(params["conv_pre"].dtype).transpose(1, 2)  # (B, dim, T)
    x = conv1d(x, params["conv_pre"])
    for w, rb, r in zip(params["ups"], params["resblocks"], cfg.upsample_rates):
        x = conv_transpose1d(leaky_relu(x), w, stride=r)
        x = resblock(rb, x, cfg.resblock_dilations)
    x = conv1d(leaky_relu(x), params["conv_post"])
    return torch.tanh(x.float())[:, 0, :]


def init_codec(gen, cfg: CodecConfig, device, dtype=torch.bfloat16) -> Params:
    return {
        "encoder": init_encoder(gen, cfg, dtype, device),
        "rvq": init_rvq(gen, cfg, device),
        "decoder": init_decoder(gen, cfg, dtype, device),
    }


def encode_to_codes(params: Params, cfg: CodecConfig, wav: torch.Tensor) -> torch.Tensor:
    """Waveform (B, S) -> RVQ codes (B, T, nq)."""
    frames = encode_frames(params["encoder"], cfg, wav)
    return rvq_quantize(params["rvq"], frames)


def decode_from_codes(params: Params, cfg: CodecConfig, codes: torch.Tensor) -> torch.Tensor:
    """RVQ codes (B, T, nq) -> waveform (B, T*hop)."""
    frames = rvq_dequantize(params["rvq"], codes)
    return decode_frames(params["decoder"], cfg, frames)
