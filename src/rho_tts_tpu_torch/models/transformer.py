"""Decoder-only transformer core (PyTorch port).

Counterpart of ``rho_tts_tpu/models/transformer.py``: grouped-query
attention over a preallocated stacked KV cache, rotary position embeddings,
RMSNorm and a SwiGLU MLP, f32 softmax over bf16 weights. Parameters are
nested dicts of tensors with the reference's names; the per-layer weights
are stacked ``(L, ...)`` as in ``init_stack``.

The cached path is ported with the modes serving uses: a batch-uniform
or per-row (``(B,)``) write slot, ``slot_causal=False`` for ring caches and
``block_causal`` for speculative verify. A batch-uniform slot may also stay
on the device (``uniform_slot``), the mode of a decode step captured as a
CUDA graph: no host value changes from step to step. Attention goes through
the port's kernels: a prefill into an empty cache (T > 1) runs
``ops.cuda.attention.fused_gqa_attention`` over the fresh q/k/v, and every
T == 1 step runs ``ops.cuda.decode_attention.decode_gqa_attention`` over
the cache with the complete ``(B, S)`` mask, built once per forward. On
CUDA tensors those are the hand-written kernels; on CPU tensors, their
plain versions. A T > 1 forward over a used cache (speculative verify) is
plain masked attention, as in the JAX package, whose einsum branch computes
it outside any Pallas kernel.

The block's f32 glue between its matmuls runs, on bf16 card tensors with
grad mode off, in three more kernels: each norm with the
residual add before it (``ops.cuda.add_rms_norm``), RoPE on q and k
(``ops.cuda.rope_qk``) and SwiGLU's SiLU.mul (``ops.cuda.silu_mul``); the
layers hand their output to the next norm as a pending ``delta``. On the
CPU, in f32 and with grad mode on the same steps run as plain PyTorch chains.

A hybrid talker (``TransformerConfig.layer_types`` / ``n_experts``: LFM2-MoE,
granite-4.0-h) keeps a weight stack per kind of layer and runs them in the
schedule's order (:func:`_hybrid_forward`): gated short convolutions over an
f32 state ``(Lc, B, K - 1, H)`` rolled in place, Mamba-2 mixers over an f32
conv state and SSM state (:func:`make_ssm_state`; a prefill runs the chunked
scan in plain PyTorch, a decode step ``ops.cuda.ssm_step``), GQA attention
(with QK-norm, or without RoPE at a configured softmax scale) over a KV cache
of the attention layers alone, a dense SwiGLU in the first ``dense_layers``
and routed experts after (an f32 sigmoid router with a bias on the choice,
or a softmax over the top-k logits; a decode step runs
``ops.cuda.moe_experts``, a prefill groups its tokens by expert), with a
shared SwiGLU expert beside them where configured. Each sublayer's output
may be scaled before the residual add (``residual_multiplier``). It has the
cached forward only.

The cache-less forward (``kv_caches=None``: training and distillation) is
plain masked causal attention too, as JAX's is, and differentiable; the
kernels have no backward and raise when reached under autograd.

Unlike the JAX package, the stacked caches are updated IN PLACE: the
caller's ``(L, B, S, Hkv, D)`` tensors are written and returned.

Meshes (``parallel``): under tensor parallelism (``tp``, the mesh's
``model`` axis) the weights are this rank's shards, the block computes its
local heads (:func:`local_config`) and sums the row-parallel ``wo`` and
``w_down`` over the axis: in place on the cached path, through the
differentiable ``copy_to_model`` / ``reduce_from_model`` pair on the
cache-less one (sharded training). A sequence-parallel prefill
(``sp_mesh``) runs each rank's slice of the prompt and all-gathers K/V for
the attention.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda import add_rms_norm as _arn
from ..ops.cuda import rope_qk as _rq
from ..ops.cuda import silu_mul as _sm
from ..ops.cuda.attention import fused_gqa_attention, sp_fused_gqa_attention
from ..ops.cuda.decode_attention import decode_gqa_attention
from ..ops.cuda.moe_experts import grouped_experts, moe_experts
from ..ops.cuda.ssm_step import ssm_step
from ..parallel.collectives import all_gather, copy_to_model, reduce_from_model
from ..utils import profiling
from .quantization import matmul as qmm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    hidden: int = 2048
    layers: int = 28
    q_heads: int = 16
    kv_heads: int = 8
    head_dim: int = 128
    ffn: int = 6144
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    # The hybrid talker (LFM2-MoE): a schedule of layer kinds, "conv" (gated
    # short convolution of CONV_TAPS taps) or "full_attention" (with QK-norm);
    # empty means every layer attends, as in the dense stack.
    layer_types: Tuple[str, ...] = ()
    # Routed experts: 0 means a dense SwiGLU of ``ffn`` in every layer. With
    # them, layers from ``dense_layers`` on hold ``n_experts`` SwiGLU experts
    # of ``expert_ffn``, ``experts_per_token`` chosen a token by a sigmoid
    # router with a bias on the choice, their weights normalised to one.
    n_experts: int = 0
    experts_per_token: int = 0
    expert_ffn: int = 0
    dense_layers: int = 0
    # How the experts are chosen: "sigmoid" (above) or "softmax" (the top-k
    # logits, their softmax the weights; no bias). ``shared_ffn`` > 0 adds a
    # shared SwiGLU expert of that width to every expert layer's output.
    router: str = "sigmoid"
    shared_ffn: int = 0
    # Mamba-2 mixers (layer kind "mamba"): ``ssm_heads`` heads of
    # ``ssm_head_dim`` channels, a state of ``ssm_state`` per channel, one
    # group of B and C, a causal depthwise convolution of ``ssm_conv`` taps
    # with a bias; a prefill scans in chunks of ``ssm_chunk`` positions.
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # Attention without rotary embeddings (``rope`` False), without a hybrid
    # talker's QK-norm (``qk_norm`` False: its init draws no q_norm / k_norm,
    # and the block normalises where its weights hold them), a softmax scale
    # (0: 1 / sqrt(head_dim)), each sublayer's output times
    # ``residual_multiplier`` before its residual add, and the talker's input
    # vectors times ``embedding_multiplier`` (the defaults change nothing).
    rope: bool = True
    qk_norm: bool = True
    attn_scale: float = 0.0
    residual_multiplier: float = 1.0
    embedding_multiplier: float = 1.0

    def __post_init__(self):
        if self.layer_types and (len(self.layer_types) != self.layers or not set(
                self.layer_types) <= {"conv", "full_attention", "mamba"}):
            raise ValueError(f"layer_types must give each of the {self.layers} layers "
                             f"'conv', 'mamba' or 'full_attention', got {self.layer_types}")
        if self.router not in ("sigmoid", "softmax"):
            raise ValueError(f"router must be 'sigmoid' or 'softmax', got {self.router!r}")
        if self.mamba_layers and min(self.ssm_heads, self.ssm_head_dim, self.ssm_state,
                                     self.ssm_conv - 1, self.ssm_chunk) < 1:
            raise ValueError("a talker with mamba layers needs ssm_heads, ssm_head_dim, "
                             "ssm_state, ssm_chunk and ssm_conv > 1")

    @property
    def schedule(self) -> Tuple[str, ...]:
        """Each layer's kind: ``"conv"`` or ``"full_attention"``."""
        return tuple(self.layer_types) or ("full_attention",) * self.layers

    @property
    def attn_layers(self) -> int:
        """Layers that attend, and so hold a slice of the KV cache."""
        return self.schedule.count("full_attention")

    @property
    def conv_layers(self) -> int:
        return self.schedule.count("conv")

    @property
    def mamba_layers(self) -> int:
        return self.schedule.count("mamba")

    @property
    def ssm_inner(self) -> int:
        """The Mamba mixer's channels: heads x head_dim."""
        return self.ssm_heads * self.ssm_head_dim

    @property
    def ssm_conv_dim(self) -> int:
        """Channels of the Mamba convolution: x, then B and C (one group)."""
        return self.ssm_inner + 2 * self.ssm_state

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers if self.n_experts else 0

    @property
    def hybrid(self) -> bool:
        """Whether the stack has layers other than the dense GQA block."""
        return bool(self.layer_types) or self.n_experts > 0

    @property
    def kind(self) -> str:
        """The talker's kind, as errors name it."""
        if not self.hybrid:
            return "dense GQA"
        mixers = (f"{self.mamba_layers} state-space (Mamba-2)" if self.mamba_layers
                  else f"{self.conv_layers} short-convolution")
        shared = ", a shared expert" if self.shared_ffn else ""
        return (f"hybrid ({mixers} + {self.attn_layers} attention layers, {self.n_experts} "
                f"routed experts in {self.moe_layers}{shared})")


#: taps of the hybrid talker's causal depthwise convolution (LFM2's ``conv_L_cache``)
CONV_TAPS = 3


def require_dense(cfg: TransformerConfig, what: str) -> None:
    """Raise ``NotImplementedError`` where ``what`` meets a hybrid talker."""
    if cfg.hybrid:
        raise NotImplementedError(
            f"{what} is not supported for a talker with short-convolution, state-space or "
            f"expert layers: this one is {cfg.kind}. It runs in bf16 through synthesize(), "
            f"generate_codes() and stream_chunks() on one device")


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


#: values above which a stacked weight is drawn a leading slice at a time
_DRAW_WHOLE = 1 << 32


def _dense_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape (..., in, out), drawn in f32 (a
    stack of more than ``_DRAW_WHOLE`` values a leading slice at a time, so
    that its f32 draw never lies beside it whole)."""
    scale = 1.0 / np.sqrt(shape[-2])
    if int(np.prod(shape)) <= _DRAW_WHOLE:
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for part in out:
        part.copy_(torch.randn(part.shape, generator=gen, dtype=torch.float32,
                               device=device) * scale)
    return out


def init_stack(gen: torch.Generator, cfg: TransformerConfig, device) -> Params:
    """Random stacked ``(layers, ...)`` block weights, shapes and scales as JAX
    (a hybrid talker's per-kind stacks: :func:`init_hybrid`)."""
    if cfg.hybrid:
        return init_hybrid(gen, cfg, device)
    L = cfg.layers
    qkv_out = (cfg.q_heads + 2 * cfg.kv_heads) * cfg.head_dim
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731
    blocks = {
        "attn_norm": ones(L, cfg.hidden),
        "wqkv": _dense_init(gen, (L, cfg.hidden, qkv_out), cfg.dtype, device),
        "wo": _dense_init(gen, (L, cfg.q_heads * cfg.head_dim, cfg.hidden), cfg.dtype, device),
        "mlp_norm": ones(L, cfg.hidden),
        "w_gate": _dense_init(gen, (L, cfg.hidden, cfg.ffn), cfg.dtype, device),
        "w_up": _dense_init(gen, (L, cfg.hidden, cfg.ffn), cfg.dtype, device),
        "w_down": _dense_init(gen, (L, cfg.ffn, cfg.hidden), cfg.dtype, device),
    }
    return {"blocks": blocks, "final_norm": ones(cfg.hidden)}


def init_hybrid(gen: torch.Generator, cfg: TransformerConfig, device) -> Params:
    """Random weights of a hybrid talker, one stack per kind of layer.

    ``attn`` ``(La, ...)``: ``attn_norm``, ``wqkv``, ``q_norm`` / ``k_norm``
    (``(La, head_dim)``; where ``qk_norm``), ``wo``. ``conv`` ``(Lc, ...)``:
    ``conv_norm``, ``in_proj`` ``(H, 3H)`` (the B, C and x~ projections),
    ``conv_w`` ``(H, CONV_TAPS)`` depthwise taps, ``out_proj``. ``ffn``
    (the dense layers) ``mlp_norm``, ``w_gate`` / ``w_up`` / ``w_down`` of
    ``ffn``; ``moe`` (the expert layers) ``mlp_norm``, ``router`` ``(H, E)``,
    ``expert_bias`` ``(E,)`` f32 (zero, as a release starts it), and
    ``w_gate`` / ``w_up`` ``(E, H, expert_ffn)``, ``w_down``
    ``(E, expert_ffn, H)``; a softmax router has no ``expert_bias``, and a
    shared expert adds ``shared_w_gate`` / ``shared_w_up`` ``(H, shared_ffn)``
    and ``shared_w_down``. ``mamba`` ``(Lm, ...)``: ``ssm_norm``, ``in_proj``
    ``(H, 2 di + 2 N + heads)`` (z, x, B, C, dt), ``conv_w`` ``(conv_dim,
    ssm_conv)`` N(0, 1 / taps) and ``conv_b`` (zero), ``dt_bias`` (the
    softplus inverse of exp U[log 1e-3, log 1e-1]), ``A_log`` (log U[1, 16]),
    ``D`` (one), ``gate_norm`` ``(di,)``, ``out_proj`` ``(di, H)``: Mamba-2's
    initialisation. Norms at one; the i-th layer of a kind is the i-th of the
    schedule's layers of that kind.
    """
    h, dt = cfg.hidden, cfg.dtype
    la, lc = cfg.attn_layers, cfg.conv_layers
    ld = cfg.layers - cfg.moe_layers
    lm, e, fe = cfg.moe_layers, cfg.n_experts, cfg.expert_ffn
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=device)  # noqa: E731

    def dense(*shape):
        return _dense_init(gen, shape, dt, device)

    out: Params = {"final_norm": ones(h)}
    if la:
        qkv_out = (cfg.q_heads + 2 * cfg.kv_heads) * cfg.head_dim
        out["attn"] = {"attn_norm": ones(la, h), "wqkv": dense(la, h, qkv_out)}
        if cfg.qk_norm:
            out["attn"].update(q_norm=ones(la, cfg.head_dim), k_norm=ones(la, cfg.head_dim))
        out["attn"]["wo"] = dense(la, cfg.q_heads * cfg.head_dim, h)
    if lc:
        out["conv"] = {"conv_norm": ones(lc, h), "in_proj": dense(lc, h, 3 * h),
                       # N(0, 1 / taps): drawn (Lc, K, H), stored (Lc, H, K)
                       "conv_w": dense(lc, CONV_TAPS, h).transpose(1, 2).contiguous(),
                       "out_proj": dense(lc, h, h)}
    if cfg.mamba_layers:
        out["mamba"] = init_mamba(gen, cfg, device)
    if ld:
        out["ffn"] = {"mlp_norm": ones(ld, h), "w_gate": dense(ld, h, cfg.ffn),
                      "w_up": dense(ld, h, cfg.ffn), "w_down": dense(ld, cfg.ffn, h)}
    if lm:
        out["moe"] = {"mlp_norm": ones(lm, h), "router": dense(lm, h, e)}
        if cfg.router == "sigmoid":
            out["moe"]["expert_bias"] = torch.zeros((lm, e), dtype=torch.float32, device=device)
        out["moe"].update(w_gate=dense(lm, e, h, fe), w_up=dense(lm, e, h, fe),
                          w_down=dense(lm, e, fe, h))
        if cfg.shared_ffn:
            fs = cfg.shared_ffn
            out["moe"].update(shared_w_gate=dense(lm, h, fs), shared_w_up=dense(lm, h, fs),
                              shared_w_down=dense(lm, fs, h))
    return out


def init_mamba(gen: torch.Generator, cfg: TransformerConfig, device) -> Params:
    """Random weights of the Mamba-2 layers (:func:`init_hybrid`'s ``mamba``)."""
    lm, h, nh = cfg.mamba_layers, cfg.hidden, cfg.ssm_heads
    di, cd = cfg.ssm_inner, cfg.ssm_conv_dim
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(lo, hi):
        return torch.rand((lm, nh), generator=gen, **f32) * (hi - lo) + lo

    dt0 = torch.exp(uniform(np.log(1e-3), np.log(1e-1)))
    return {
        "ssm_norm": torch.ones((lm, h), **f32),
        "in_proj": _dense_init(gen, (lm, h, 2 * di + 2 * cfg.ssm_state + nh), cfg.dtype, device),
        # N(0, 1 / taps): drawn (Lm, K, C), stored (Lm, C, K)
        "conv_w": _dense_init(gen, (lm, cfg.ssm_conv, cd), cfg.dtype,
                              device).transpose(1, 2).contiguous(),
        "conv_b": torch.zeros((lm, cd), dtype=cfg.dtype, device=device),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),  # softplus(dt_bias) = dt0
        "A_log": torch.log(uniform(1.0, 16.0)),
        "D": torch.ones((lm, nh), **f32),
        "gate_norm": torch.ones((lm, di), **f32),
        "out_proj": _dense_init(gen, (lm, di, h), cfg.dtype, device),
    }


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


rms_norm = _arn.reference_rms_norm
_rotate = _rq.reference_rotate


def _kernels_take(x: torch.Tensor) -> bool:
    """Whether the block's f32 glue (residual add + norm, RoPE, SiLU.mul)
    runs in the hand-written kernels: bf16 on a card with grad mode off
    (``no_grad`` / ``inference_mode``, as every inference path runs). With
    grad mode on the plain chains run, in the whole of every differentiable
    forward (training, LoRA, distillation), also where an op's own inputs
    require no grad: a forward's bits then do not depend on which of its
    tensors require grad (a pipeline stage's input does, the unmeshed
    forward's embeddings do not). The CPU and f32 take the plain chains."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def _add_norm(x: torch.Tensor, delta: Optional[torch.Tensor], weight: torch.Tensor,
              eps: float, scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual stream ``x + scale * delta`` (x where ``delta`` is None)
    and its RMSNorm: ``(x, normed)``. One ``add_rms_norm`` launch where
    :func:`_kernels_take`, else the add and :func:`rms_norm`."""
    if _kernels_take(x):
        return _arn.add_rms_norm(x, delta, weight, eps, scale)
    return _arn.reference_add_rms_norm(x, delta, weight, eps, scale)


def _rope(q: torch.Tensor, k: torch.Tensor, rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k rotated by the tables ``rope`` = ``(cos, sin)``: one
    ``rope_qk`` launch where :func:`_kernels_take`, else :func:`_rotate`
    of each."""
    if _kernels_take(q):
        return _rq.rope_qk(q, k, *rope)
    return _rq.reference_rope_qk(q, k, *rope)


def _swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in f32, cast to gate's dtype: one ``silu_mul``
    launch where :func:`_kernels_take`, else the plain chain."""
    if _kernels_take(gate):
        return _sm.silu_mul(gate, up)
    return _sm.reference_silu_mul(gate, up)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


@functools.lru_cache(maxsize=32)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # Cached per device: a host->device copy inside the decode loop would
    # synchronise the stream.
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)).to(device)


def _rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    inv = _inv_freq(head_dim, float(theta), positions.device)
    angles = positions[..., None].float() * inv  # (B, T, D/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]), Llama/Qwen convention.

    x: (B, T, H, D); positions: (B, T).
    """
    cos, sin = _rope_tables(positions, x.shape[-1], theta)
    return _rotate(x, cos, sin)


def _split_qkv(qkv: torch.Tensor, cfg: TransformerConfig):
    b, t, _ = qkv.shape
    q_sz = cfg.q_heads * cfg.head_dim
    kv_sz = cfg.kv_heads * cfg.head_dim
    q = qkv[..., :q_sz].reshape(b, t, cfg.q_heads, cfg.head_dim)
    k = qkv[..., q_sz : q_sz + kv_sz].reshape(b, t, cfg.kv_heads, cfg.head_dim)
    v = qkv[..., q_sz + kv_sz :].reshape(b, t, cfg.kv_heads, cfg.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# The block's shared math (the cached and the cache-less forward)
# ---------------------------------------------------------------------------
#
# A layer's functions take the residual stream as ``(x, delta)``: ``delta``
# is the previous sublayer's output, not yet added (None before the first),
# which the next norm adds (:func:`_add_norm`: one launch on a card). They
# return their own output as the next ``delta``.


def _qkv(params: Params, cfg: TransformerConfig, x: torch.Tensor, delta, rope, tp_grad=None):
    """The residual add, attention norm, fused QKV matmul, QK-norm and RoPE:
    ``(x, q, k, v)``, x with ``delta`` added. ``tp_grad``: the
    differentiable TP forward's axis (``copy_to_model`` before the
    column-parallel ``wqkv``)."""
    x, h = _add_norm(x, delta, params["attn_norm"], cfg.rms_eps, cfg.residual_multiplier)
    qkv = qmm(copy_to_model(h, tp_grad), params["wqkv"])
    q, k, v = _split_qkv(qkv, cfg)
    if "q_norm" in params:  # QK-norm (the hybrid talker): each head, before RoPE
        _, q = _add_norm(q, None, params["q_norm"], cfg.rms_eps)
        _, k = _add_norm(k, None, params["k_norm"], cfg.rms_eps)
    if cfg.rope:
        q, k = _rope(q, k, rope)
    return x, q, k, v


def _softmax_scale(cfg: TransformerConfig) -> Optional[float]:
    """The attention's softmax scale where the config sets one, else None
    (the kernels' and the plain versions' own 1 / sqrt(head_dim))."""
    return cfg.attn_scale or None


def _attn_out(params: Params, cfg: TransformerConfig, x: torch.Tensor,
              attn: torch.Tensor, tp=None, tp_grad=None) -> torch.Tensor:
    """The output projection: the attention sublayer's ``delta`` for the
    stream ``x``. Under ``tp`` the row-parallel ``wo`` sums over the axis in
    place; under ``tp_grad`` through Megatron's differentiable
    ``reduce_from_model``."""
    b, t, _ = x.shape
    attn = attn.reshape(b, t, cfg.q_heads * cfg.head_dim).to(x.dtype)
    return reduce_from_model(qmm(attn, params["wo"], reduce=tp), tp_grad)


def _mlp(params: Params, cfg: TransformerConfig, x: torch.Tensor, delta, tp=None,
         tp_grad=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The residual add, MLP norm and SwiGLU MLP: ``(x, its delta)``. Under
    ``tp`` the row-parallel ``w_down`` sums over the axis in place; under
    ``tp_grad`` through the differentiable pair (``copy_to_model`` before
    ``w_gate`` / ``w_up``, ``reduce_from_model`` after ``w_down``)."""
    x, h = _add_norm(x, delta, params["mlp_norm"], cfg.rms_eps, cfg.residual_multiplier)
    h = copy_to_model(h, tp_grad)
    act = _swiglu(qmm(h, params["w_gate"]), qmm(h, params["w_up"]))
    return x, reduce_from_model(qmm(act, params["w_down"], reduce=tp), tp_grad)


def _masked_attention(q, k, v, mask: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Plain GQA attention under a boolean key mask, JAX's einsum branch:
    f32 scores and mix, masked scores filled with -1e30 (finite: a row with
    every key masked averages all of them instead of turning NaN)."""
    scores = _gqa_scores(q, k) * (cfg.attn_scale or (1.0 / np.sqrt(cfg.head_dim)))
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    return _gqa_mix(probs, v)


# ---------------------------------------------------------------------------
# Cache-less block forward (training, distillation)
# ---------------------------------------------------------------------------


def _causal_mask(t: int, attn_mask: Optional[torch.Tensor], device) -> torch.Tensor:
    """``(1 or B, 1, T, T)`` causal mask, gated by ``attn_mask`` ``(B, T)``."""
    mask = torch.ones((t, t), dtype=torch.bool, device=device).tril()[None, None]
    if attn_mask is not None:
        mask = mask & attn_mask.bool()[:, None, None, :]
    return mask


def block_forward(
    params: Params,
    cfg: TransformerConfig,
    x: torch.Tensor,  # (B, T, hidden)
    positions: torch.Tensor,  # (B, T) RoPE positions
    kv_cache=None,
    cache_len=None,
    attn_mask: Optional[torch.Tensor] = None,  # (B, T) validity of the tokens
    key_valid=None,
    fused_prefill: bool = False,
    rope=None,
    mask: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One cache-less transformer block: plain causal attention over T.

    Returns ``(output, (k, v))``, k after RoPE. Differentiable: the
    attention is plain PyTorch, as JAX's is the einsum ``_gqa_scores`` /
    softmax / ``_gqa_mix`` and never a Pallas kernel. ``rope`` (the cos/sin
    tables of ``positions``) and ``mask`` (:func:`_causal_mask`) let
    :func:`stack_forward` build them once for every layer. A ``kv_cache``
    raises, as in JAX: cached attention is :func:`stack_forward`'s. Under
    ``tp`` the weights are this rank's shards and ``cfg`` its
    :func:`local_config`; the partial sums go through the differentiable
    collectives.
    """
    if kv_cache is not None:
        raise ValueError(
            "Cached attention moved to the stacked-cache path inside "
            "stack_forward (_block_forward_cached); pass caches there."
        )
    if rope is None:
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if mask is None:
        mask = _causal_mask(x.shape[1], attn_mask, x.device)
    x, delta, kv = _block_cacheless(params, cfg, x, None, rope, mask, tp)
    return x + delta, kv


def _block_cacheless(params, cfg, x, delta, rope, mask, tp=None):
    """:func:`block_forward` on the stream ``(x, delta)``: ``(x, delta, (k, v))``."""
    x, q, k, v = _qkv(params, cfg, x, delta, rope, tp_grad=tp)
    attn = _masked_attention(q, k, v, mask, cfg)
    x, delta = _mlp(params, cfg, x, _attn_out(params, cfg, x, attn, tp_grad=tp), tp_grad=tp)
    return x, delta, (k, v)


# ---------------------------------------------------------------------------
# Cached block forward (prefill, decode, ring and speculative writes)
# ---------------------------------------------------------------------------


def scatter_rows(buf: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 keep: Optional[torch.Tensor] = None) -> None:
    """``buf[b, cols[b, j]] = vals[b, j]`` in place, dropping the rest.

    ``buf`` ``(B, S, ...)``, ``cols`` ``(B, T)``, ``vals`` ``(B, T, ...)``.
    Entries outside ``[0, S)`` or not in ``keep`` are dropped, as JAX's
    ``.at[...].set(..., mode="drop")`` drops them, without a host wait: a
    dropped entry writes the row's first kept entry again (the same index
    and the same value), or, in a row with none, the row's last column its
    own value back. Clamping instead would overwrite a live column.
    """
    b, t = cols.shape
    s = buf.shape[1]
    ok = (cols >= 0) & (cols < s)
    if keep is not None:
        ok = ok & keep
    if buf.dtype == torch.float8_e4m3fn:  # moved as bytes
        buf, vals = buf.view(torch.uint8), vals.view(torch.uint8)
    rows = torch.arange(b, device=cols.device)
    any_ok = ok.any(dim=1)
    first = ok.to(torch.int32).argmax(dim=1)  # the first kept entry
    tail = (1,) * (vals.dim() - 2)
    first_col = torch.where(any_ok, cols[rows, first], s - 1)
    first_val = torch.where(any_ok.view(b, *tail), vals[rows, first], buf[:, s - 1])
    tgt = torch.where(ok, cols, first_col[:, None])
    src = torch.where(ok.view(b, t, *tail), vals, first_val[:, None])
    buf[rows[:, None].expand(b, t), tgt] = src


def _kv_compute_dtype(kv: torch.Tensor):
    """JAX's ``_kv_compute_dtype``: f8 caches compute in bf16, others in f32."""
    return torch.bfloat16 if kv.dtype == torch.float8_e4m3fn else torch.float32


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B,Tq,Hq,D) x (B,Tk,Hkv,D) -> (B,Hq,Tq,Tk) f32, as JAX's ``_gqa_scores``:
    both operands rounded to the compute dtype, products summed in f32."""
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    ct = _kv_compute_dtype(k)
    qg = q.reshape(b, tq, hkv, hq // hkv, d).to(ct).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(ct).float())
    return scores.reshape(b, hq, tq, k.shape[1])


def _gqa_mix(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,Hq,Tq,Tk) x (B,Tk,Hkv,D) -> (B,Tq,Hq,D) f32, as JAX's ``_gqa_mix``
    (an f8 cache rounds the probabilities to bf16)."""
    b, hq, tq, tk = probs.shape
    hkv = v.shape[2]
    ct = _kv_compute_dtype(v)
    pg = probs.reshape(b, hkv, hq // hkv, tq, tk).to(ct).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v.to(ct).float())
    return out.reshape(b, tq, hq, v.shape[3])


def _block_forward_cached(
    params: Params,
    cfg: TransformerConfig,
    x: torch.Tensor,  # (B, T, hidden)
    delta: Optional[torch.Tensor],  # the previous layer's output, not yet added to x
    rope: Tuple[torch.Tensor, torch.Tensor],  # cos/sin tables of the positions
    ck_all: torch.Tensor,  # (L, B, S, Hkv, D), written in place
    cv_all: torch.Tensor,
    layer: int,
    slot,  # int or 0-d tensor (batch-uniform), or (B,) tensor of per-row write columns
    attn_mask: Optional[torch.Tensor],  # (B, T) validity of the new tokens
    mask: Optional[torch.Tensor],  # (B, S) when T == 1, (B, 1, T, S) when T > 1
    tp=None,
    sp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cached transformer block writing its K/V at ``[slot, slot+T)``:
    ``(x, delta)``, the stream and the block's output, not yet added.

    ``mask`` is the complete key mask built once by :func:`stack_forward`;
    ``None`` means the chunk is a prefill into an empty cache, which the
    prefill kernel runs over the fresh q/k/v. Under ``sp`` (a sequence-
    parallel prefill) ``x`` is this rank's slice of the prompt and
    ``attn_mask`` the whole prompt's: K/V are all-gathered, written whole
    and attended by the local queries at their global offset.
    """
    with profiling.region("talker/attention"):
        x, delta = _attention_cached(params, cfg, x, delta, rope, ck_all, cv_all, layer, slot,
                                     attn_mask, mask, tp, sp)
    with profiling.region("talker/mlp"):
        return _mlp(params, cfg, x, delta, tp)


def _attention_cached(params, cfg, x, delta, rope, ck_all, cv_all, layer, slot, attn_mask, mask,
                      tp=None, sp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention half of :func:`_block_forward_cached`: the residual add
    and norm, K/V written at ``[slot, slot+T)`` of cache layer ``layer``,
    attention and the output projection: ``(x, delta)``."""
    x, q, k, v = _qkv(params, cfg, x, delta, rope)
    if sp is not None:
        k, v = all_gather(k, 1, sp), all_gather(v, 1, sp)
    b, t = k.shape[:2]

    if isinstance(slot, int):
        ck_all[layer, :, slot : slot + t] = k.to(ck_all.dtype)
        cv_all[layer, :, slot : slot + t] = v.to(cv_all.dtype)
    elif slot.dim() == 0:  # one device slot for the batch, inside the cache
        cols = _slot_columns(slot, t)
        _write_columns(ck_all[layer], cols, k)
        _write_columns(cv_all[layer], cols, v)
    else:  # per-row columns; out-of-range columns drop
        cols = slot[:, None] + torch.arange(t, device=slot.device)[None, :]
        scatter_rows(ck_all[layer], cols, k.to(ck_all.dtype))
        scatter_rows(cv_all[layer], cols, v.to(cv_all.dtype))

    if mask is None:
        # The chunk IS the whole attention context (empty cache): the
        # prefill kernel runs over the fresh q/k/v directly.
        pmask = attn_mask if attn_mask is not None else torch.ones(
            (b, t), dtype=torch.bool, device=x.device
        )
        if sp is not None:
            attn = sp_fused_gqa_attention(q, k, v, pmask, sp, causal=True)
        else:
            attn = fused_gqa_attention(q, k, v, pmask, causal=True, scale=_softmax_scale(cfg))
    elif t == 1:
        attn = decode_gqa_attention(q, ck_all[layer], cv_all[layer], mask,
                                    scale=_softmax_scale(cfg))
    else:
        # T > 1 over a used cache (speculative verify): JAX computes it as
        # plain masked attention (its einsum branch), and so does the port.
        attn = _masked_attention(q, ck_all[layer], cv_all[layer], mask, cfg)
    return x, _attn_out(params, cfg, x, attn, tp)


def _slot_columns(slot: torch.Tensor, t: int) -> torch.Tensor:
    """The ``(T,)`` columns ``[slot, slot + T)`` of a 0-d device slot."""
    return slot.view(1) if t == 1 else slot + torch.arange(t, device=slot.device)


def _write_columns(buf: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor) -> None:
    """``buf[:, cols] = vals`` in place by one ``index_copy_``; ``buf`` ``(B, S, ...)``,
    ``vals`` ``(B, T, ...)`` in any dtype (converted to ``buf``'s)."""
    vals = vals.to(buf.dtype)
    if buf.dtype == torch.float8_e4m3fn:  # moved as bytes
        buf, vals = buf.view(torch.uint8), vals.view(torch.uint8)
    buf.index_copy_(1, cols, vals)


def _attention_mask(b, t, s, slot, device, attn_mask, key_valid, slot_causal, block_causal):
    """The complete key mask of every layer: ``(B, S)`` for T == 1, else
    ``(B, 1, T, S)``. The new columns count as valid by ``attn_mask``."""
    key_pos = torch.arange(s, device=device)
    per_row = not isinstance(slot, int) and slot.dim() == 1
    slot_b = slot[:, None] if per_row else slot  # broadcastable against (B, S)
    valid = None
    if key_valid is not None:
        new_valid = (torch.ones((b, t), dtype=torch.bool, device=device)
                     if attn_mask is None else attn_mask.bool())
        valid = key_valid.clone()
        if per_row:
            scatter_rows(valid, slot[:, None] + torch.arange(t, device=device)[None, :],
                         new_valid)
        elif isinstance(slot, int):
            valid[:, slot : slot + t] = new_valid
        else:
            _write_columns(valid, _slot_columns(slot, t), new_valid)
    if t == 1:
        if slot_causal:
            causal = (key_pos[None, :] <= slot_b)
            mask = causal if valid is None else causal & valid
        else:
            mask = valid
        return mask.expand(b, s).contiguous()
    q_idx = torch.arange(t, device=device)[:, None]  # (T, 1)
    if per_row:
        rel = key_pos[None, None, :] - slot[:, None, None]  # (B, 1, S)
    else:
        rel = (key_pos - slot)[None, None, :]
    if slot_causal:
        mask = rel <= q_idx  # (B or 1, T, S)
        if valid is not None:
            mask = mask & valid[:, None, :]
    else:
        mask = valid[:, None, :].expand(b, t, s)
        if block_causal:
            future = (rel >= 0) & (rel < t) & (rel > q_idx)
            mask = mask & ~future
    return mask.expand(b, t, s)[:, None]


def stack_forward(
    params: Params,
    cfg: TransformerConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    kv_caches: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len=None,
    attn_mask: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    fused_prefill: bool = False,
    kv_window: Optional[int] = None,
    slot_causal: bool = True,
    block_causal: bool = False,
    sp_mesh=None,
    tp=None,
    uniform_slot: bool = False,
    conv_state: Optional[torch.Tensor] = None,
    expert_hits: Optional[torch.Tensor] = None,
    ssm_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Run the block stack, over the stacked caches or without them.

    Without ``kv_caches`` (training, distillation): plain causal attention
    over the T tokens, gated by ``attn_mask``, through :func:`block_forward`;
    returns ``(hidden_states, (ks, vs))`` with every layer's K/V stacked
    ``(L, B, T, Hkv, D)``, as JAX's scan emits them. Differentiable.

    With them, returns ``(hidden_states, (ck_all, cv_all))``; the caches are the
    caller's tensors, updated in place. ``key_valid`` is not modified: the
    new slots count as valid for this forward only, as in JAX.

    ``cache_len`` is a Python int (a slot shared by the batch), or a tensor:
    0-d (a shared slot on the device) or ``(B,)`` per-row write columns,
    whose out-of-range columns drop. ``uniform_slot=True`` keeps a 0-d
    ``cache_len`` one slot for the batch, whose columns the caller keeps
    inside the cache: each cache write is one ``index_copy_`` at it and the
    mask compares with it, with no per-row expansion (a decode step
    captured as a CUDA graph reads its slot from the device). A prefill
    chunk (T > 1) into an empty cache with ``fused_prefill=True`` runs the
    prefill kernel; T == 1 runs the decode kernel under the complete
    ``(B, S)`` mask; other T > 1 forwards (speculative verify) run plain
    masked attention, as the JAX package's einsum branch does. ``slot_causal=False`` leaves
    ``key_valid`` as the only gate (ring caches); ``block_causal`` restores
    causality inside the newly written block.

    ``tp`` (the mesh's ``model`` axis, weights sharded over it) runs the
    local heads and sums the row-parallel matmuls; the caches hold the
    local KV heads. Without caches (sharded training) the sums are
    differentiable (``copy_to_model`` / ``reduce_from_model``) and the K/V
    returned are the local heads'. ``sp_mesh`` makes a fused prefill into an empty cache
    sequence-parallel: every rank passes the WHOLE prompt (``x``,
    ``positions``, ``attn_mask``), computes its ``1/mp`` slice over the
    mesh's ``model`` axis, writes every layer's whole K/V (all-gathered)
    and returns the whole hidden states (all-gathered), as JAX's sharded
    arrays read; other forwards ignore it, as JAX's do.

    ``kv_window`` (not ported: the decode kernel skips masked slots) raises
    ``NotImplementedError``.

    A hybrid talker (``cfg.hybrid``) runs :func:`_hybrid_forward`: its KV
    caches hold the attention layers only, ``conv_state`` ``(Lc, B,
    CONV_TAPS - 1, H)`` f32 is the short convolutions' state (updated in
    place), ``ssm_state`` the Mamba layers' ``(conv, ssm)`` state
    (:func:`make_ssm_state`, updated in place), and ``expert_hits`` ``(Lm, E)``
    int32, if given, receives 1 for each expert that some token chose in each
    expert layer, else 0. It has no cache-less, TP or SP forward
    (``NotImplementedError``).
    """
    if kv_window is not None:
        raise NotImplementedError(
            "kv_window is not ported: the port decodes over the whole cache, whose masked "
            "slots the decode kernel skips")
    if cfg.hybrid:
        if kv_caches is None or sp_mesh is not None or tp is not None:
            require_dense(cfg, "the cache-less forward (training)" if kv_caches is None
                          else "a tensor- or sequence-parallel forward")
        return _hybrid_forward(params, cfg, x, positions, kv_caches, cache_len, attn_mask,
                               key_valid, fused_prefill, slot_causal, block_causal, uniform_slot,
                               conv_state, expert_hits, ssm_state)
    blocks = params["blocks"]
    cfg = local_config(cfg, tp)
    sp = None
    empty = cache_len is None or (isinstance(cache_len, int) and cache_len == 0)
    if sp_mesh is not None and kv_caches is not None and fused_prefill and x.shape[1] > 1 \
            and empty:
        sp = sp_mesh.axis("model")
        t_all = x.shape[1]
        if t_all % sp.size:
            raise ValueError(f"sp_mesh: a prompt of {t_all} does not divide over {sp.size}")
        tl = t_all // sp.size
        x = x[:, sp.index * tl: (sp.index + 1) * tl]
        positions = positions[:, sp.index * tl: (sp.index + 1) * tl]
        if attn_mask is None:
            attn_mask = torch.ones((x.shape[0], t_all), dtype=torch.bool, device=x.device)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    # Per-layer views by unbind: its backward stacks the L layers' gradients
    # once, where indexing (L, ...) per layer would zero-fill and add a whole
    # (L, ...) gradient for every layer.
    per_layer = {name: _unbind(w) for name, w in blocks.items()}
    delta = None
    if kv_caches is None:
        mask = _causal_mask(x.shape[1], attn_mask, x.device)
        ks, vs = [], []
        for layer in range(int(blocks["attn_norm"].shape[0])):
            lp = {name: w[layer] for name, w in per_layer.items()}
            x, delta, (k, v) = _block_cacheless(lp, cfg, x, delta, rope, mask, tp)
            ks.append(k)
            vs.append(v)
        _, x = _add_norm(x, delta, params["final_norm"], cfg.rms_eps, cfg.residual_multiplier)
        return x, (torch.stack(ks), torch.stack(vs))

    ck_all, cv_all = kv_caches
    slot, mask = _slot_and_mask(x, ck_all.shape[2], cache_len, attn_mask, key_valid,
                                fused_prefill, slot_causal, block_causal, uniform_slot)
    for layer in range(int(ck_all.shape[0])):
        lp = {name: w[layer] for name, w in per_layer.items()}
        x, delta = _block_forward_cached(lp, cfg, x, delta, rope, ck_all, cv_all, layer, slot,
                                         attn_mask, mask, tp, sp)
    _, x = _add_norm(x, delta, params["final_norm"], cfg.rms_eps, cfg.residual_multiplier)
    if sp is not None:
        x = all_gather(x, 1, sp)
    return x, (ck_all, cv_all)


def _slot_and_mask(x, s, cache_len, attn_mask, key_valid, fused_prefill, slot_causal,
                   block_causal, uniform_slot):
    """The write slot of a cached forward over ``s`` cache columns and the
    complete key mask of its attention layers (None for a prefill into an
    empty cache, which the prefill kernel runs)."""
    b, t, _ = x.shape
    if isinstance(cache_len, torch.Tensor):
        slot = cache_len.to(torch.int64)
        if uniform_slot and slot.dim() != 0:
            raise ValueError(f"uniform_slot: cache_len {tuple(cache_len.shape)} is not 0-d")
        if slot.dim() == 0 and not uniform_slot:
            slot = slot.expand(b)
        if slot.dim() and slot.shape != (b,):
            raise ValueError(f"cache_len {tuple(cache_len.shape)}: expected () or ({b},)")
    else:
        slot = int(cache_len or 0)
    if not slot_causal and key_valid is None:
        raise ValueError("slot_causal=False needs key_valid, the only gate left")

    if fused_prefill and t > 1 and isinstance(slot, int) and slot == 0:
        return slot, None
    return slot, _attention_mask(b, t, s, slot, x.device, attn_mask, key_valid, slot_causal,
                                 block_causal)


# ---------------------------------------------------------------------------
# The hybrid talker: short convolutions beside attention, routed experts
# ---------------------------------------------------------------------------


def _hybrid_forward(params, cfg, x, positions, kv_caches, cache_len, attn_mask, key_valid,
                    fused_prefill, slot_causal, block_causal, uniform_slot, conv_state,
                    expert_hits, ssm_state=None):
    """The cached forward of a hybrid talker, layer by layer as ``cfg.schedule``
    orders them: ``x + m * op(norm(x))`` with ``op`` the attention (its own KV
    cache layer), the short convolution (its own ``conv_state`` layer) or the
    Mamba-2 mixer (its own ``ssm_state`` layers), then ``+ m * ffn(norm(x))``
    with ``ffn`` the dense SwiGLU (layers under ``dense_layers``) or the
    routed experts (and the shared one); then the final norm. ``m`` is
    ``cfg.residual_multiplier``."""
    if cfg.conv_layers and conv_state is None:
        raise ValueError(f"a {cfg.kind} talker needs conv_state")
    if cfg.mamba_layers and ssm_state is None:
        raise ValueError(f"a {cfg.kind} talker needs ssm_state")
    ck_all, cv_all = kv_caches
    slot, mask = _slot_and_mask(x, ck_all.shape[2], cache_len, attn_mask, key_valid,
                                fused_prefill, slot_causal, block_causal, uniform_slot)
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta) if cfg.rope else None
    stacks = {kind: {name: _unbind(w) for name, w in params[kind].items()}
              for kind in ("attn", "conv", "mamba", "ffn", "moe") if kind in params}
    seen = collections.Counter()

    def take(kind):
        """The next layer of stack ``kind``: its weights and its index there."""
        i = seen[kind]
        seen[kind] += 1
        return {name: w[i] for name, w in stacks[kind].items()}, i

    delta = None
    for layer, kind in enumerate(cfg.schedule):
        if kind == "conv":
            lp, c = take("conv")
            with profiling.region("talker/conv"):
                x, delta = _conv_block(lp, cfg, x, delta, conv_state[c], attn_mask)
        elif kind == "mamba":
            lp, c = take("mamba")
            with profiling.region("talker/mamba"):
                x, h = _add_norm(x, delta, lp["ssm_norm"], cfg.rms_eps, cfg.residual_multiplier)
                delta = _mamba_mixer(lp, cfg, h, ssm_state[0][c], ssm_state[1][c], attn_mask)
        else:
            lp, a = take("attn")
            with profiling.region("talker/attention"):
                x, delta = _attention_cached(lp, cfg, x, delta, rope, ck_all, cv_all, a, slot,
                                             attn_mask, mask)
        if cfg.n_experts and layer >= cfg.dense_layers:
            lp, m = take("moe")
            with profiling.region("talker/moe"):
                x, delta = _moe_block(lp, cfg, x, delta,
                                      None if expert_hits is None else expert_hits[m])
        else:
            lp, _ = take("ffn")
            with profiling.region("talker/mlp"):
                x, delta = _mlp(lp, cfg, x, delta)
    normed = _add_norm(x, delta, params["final_norm"], cfg.rms_eps, cfg.residual_multiplier)[1]
    return normed, (ck_all, cv_all)


def _causal_conv(state: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The causal depthwise convolution of ``u`` ``(B, T, C)`` f32 with taps
    ``w`` ``(C, K)`` (tap i on position ``t - (K - 1) + i``) and an optional
    ``bias``, over ``state`` ``(B, K - 1, C)`` f32, the inputs of the K - 1
    positions before ``u``, which is replaced by the last K - 1 of this call
    (in place). Returns ``(B, T, C)`` f32."""
    taps = w.shape[-1]
    full = torch.cat([state, u], dim=1)  # (B, K - 1 + T, C)
    out = (full.unfold(1, taps, 1) * w).sum(dim=-1)  # f32: bf16 taps promote in the product
    if bias is not None:
        out = out + bias
    state.copy_(full[:, -(taps - 1):])
    return out


def _conv_block(params, cfg, x, delta, state, attn_mask):
    """The residual add, then the gated short convolution: ``B, C, x~ =
    in_proj(norm(x))``, ``u = B * x~``, ``y = C * conv(u)`` with ``conv``
    causal and depthwise over ``CONV_TAPS`` taps (:func:`_causal_conv`),
    ``(x, out_proj(y))`` (the stream and the sublayer's delta). ``state``
    ``(B, K - 1, H)`` f32 holds the ``u`` of the K - 1 positions before ``x``
    and is replaced by the last K - 1 of this call (in place). ``u`` is 0
    where ``attn_mask`` is False, so left padding never reaches a real token.
    f32 from ``u`` to ``y``."""
    hd = cfg.hidden
    x, h = _add_norm(x, delta, params["conv_norm"], cfg.rms_eps, cfg.residual_multiplier)
    bcx = qmm(h, params["in_proj"])
    u = bcx[..., :hd].float() * bcx[..., 2 * hd:]
    if attn_mask is not None:
        u = u.masked_fill(~attn_mask.bool()[..., None], 0.0)
    conv = _causal_conv(state, u, params["conv_w"])
    y = (bcx[..., hd:2 * hd].float() * conv).to(x.dtype)
    return x, qmm(y, params["out_proj"])


# ---------------------------------------------------------------------------
# The Mamba-2 mixer
# ---------------------------------------------------------------------------


def _mamba_mixer(params, cfg: TransformerConfig, h: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The Mamba-2 mixer of the normed stream ``h`` ``(B, T, H)``: its output
    ``(B, T, H)``, the sublayer's delta. ``z, xBC, dt = split(in_proj(h))``;
    ``xBC = silu(conv(xBC) + b)``; ``x, B, C = split(xBC)``; per head
    ``S <- exp(dt A) S + dt x B^T``, ``y = S C + D x``; ``out_proj(rms(y *
    silu(z)) * w)``. ``conv_state`` ``(B, K - 1, conv_dim)`` and
    ``ssm_state`` ``(B, heads, head_dim, N)``, f32, are advanced in place. A
    decode step (T == 1) runs ``ops.cuda.ssm_step`` (one launch); a prefill
    :func:`ssm_prefill`, the chunked scan in plain PyTorch. Where
    ``attn_mask`` is False (left padding) the step is no step: xBC is zero
    before and after the convolution and dt is zero, so the states stay as
    they were."""
    b, t, _ = h.shape
    zxbcdt = qmm(h, params["in_proj"])
    if t == 1 and attn_mask is None:
        y = ssm_step(zxbcdt[:, 0], conv_state, ssm_state, params["conv_w"], params["conv_b"],
                     params["dt_bias"], params["A_log"], params["D"])[:, None]
    else:
        y = ssm_prefill(zxbcdt, conv_state, ssm_state, params, cfg, attn_mask)
    _, y = _add_norm(y, None, params["gate_norm"], cfg.rms_eps)
    return qmm(y, params["out_proj"])


def ssm_prefill(zxbcdt: torch.Tensor, conv_state: torch.Tensor, ssm_state: torch.Tensor,
                params, cfg: TransformerConfig,
                attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The Mamba-2 mixer's convolution and scan over ``zxbcdt`` ``(B, T, W)``
    (the ``in_proj`` output), in f32: returns ``y * silu(z)`` ``(B, T, di)``
    in ``zxbcdt``'s dtype, ``conv_state`` and ``ssm_state`` advanced past the
    T positions in place. The scan is :func:`ssd_scan` in chunks of
    ``cfg.ssm_chunk``."""
    b, t, _ = zxbcdt.shape
    di, n, nh, p = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, nh], dim=-1)
    xbc = xbc.float()
    keep = None if attn_mask is None else attn_mask.bool()[..., None]
    if keep is not None:
        xbc = xbc.masked_fill(~keep, 0.0)
    xbc = torch.nn.functional.silu(_causal_conv(conv_state, xbc, params["conv_w"],
                                                params["conv_b"]))
    dt = torch.nn.functional.softplus(dt.float() + params["dt_bias"])
    if keep is not None:
        xbc = xbc.masked_fill(~keep, 0.0)
        dt = dt.masked_fill(~keep, 0.0)
    x, bm, cm = xbc.split([di, n, n], dim=-1)
    x = x.reshape(b, t, nh, p)
    y = ssd_scan(x, dt, -torch.exp(params["A_log"].float()), bm, cm, cfg.ssm_chunk, ssm_state)
    y = y + params["D"].float()[:, None] * x
    gated = y.reshape(b, t, di) * torch.nn.functional.silu(z.float())
    return gated.to(zxbcdt.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """``(..., L)`` -> ``(..., L, L)``: entry ``[i, j]`` the sum of ``a[j+1..i]``
    for ``j <= i`` (0 on the diagonal), -inf above it; summed a row at a
    time (no difference of two long sums)."""
    n = a.shape[-1]
    x = a[..., None].expand(*a.shape, n)  # x[..., i, j] = a[i]
    ones = torch.ones((n, n), dtype=torch.bool, device=a.device)
    x = x.masked_fill(~ones.tril(-1), 0.0).cumsum(dim=-2)
    return x.masked_fill(~ones.tril(), float("-inf"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, chunk: int, state: torch.Tensor) -> torch.Tensor:
    """Mamba-2's chunked scan (the state-space dual form), in f32.

    ``x`` ``(B, T, heads, P)``, ``dt`` ``(B, T, heads)``, ``a`` ``(heads,)``
    (negative), ``bm`` / ``cm`` ``(B, T, N)`` (one group), ``state``
    ``(B, heads, P, N)`` the state before position 0, replaced by the state
    after position T - 1 (in place). Returns ``y`` ``(B, T, heads, P)``
    without the ``D x`` term: ``S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T``,
    ``y_t = S_t C_t``. Within a chunk of ``chunk`` positions the quadratic
    form; across chunks the states, passed on chunk by chunk. T is padded to
    whole chunks with positions of ``dt = 0`` and zero inputs, which change
    nothing."""
    b, t, nh, p = x.shape
    pad = (-t) % chunk
    if pad:
        x, dt = (torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, pad)) for v in (x, dt))
        bm, cm = (torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in (bm, cm))
    c = (t + pad) // chunk
    xs = (x * dt[..., None]).view(b, c, chunk, nh, p)
    da = (dt * a).view(b, c, chunk, nh).permute(0, 3, 1, 2)  # (B, heads, c, l)
    bc, cc = bm.view(b, c, chunk, -1), cm.view(b, c, chunk, -1)
    cum = da.cumsum(dim=-1)
    # within each chunk: y_l = sum_{s <= l} C_l . B_s exp(sum_{s < k <= l} da_k) dt_s x_s
    decay = torch.exp(_segsum(da))  # (B, heads, c, l, s)
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)
    y = torch.einsum("bhcls,bcshp->bclhp", decay * cb[:, None], xs)
    # each chunk's own contribution to the state at its end
    to_end = torch.exp(cum[..., -1:] - cum)  # (B, heads, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bc, to_end, xs)
    # the states at each chunk's start, from the state before position 0
    states = torch.cat([state[:, None].float(), states], dim=1)  # (B, c + 1, heads, P, N)
    carry = torch.exp(_segsum(torch.nn.functional.pad(cum[..., -1], (1, 0))))  # (B, h, c+1, c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)
    state.copy_(states[:, -1])
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", cc, states[:, :-1], torch.exp(cum))
    return y.reshape(b, c * chunk, nh, p)[:, :t]


# ---------------------------------------------------------------------------
# Routed experts
# ---------------------------------------------------------------------------


def route_experts(h, router, bias, cfg: TransformerConfig):
    """The router, in f32, on ``h`` ``(N, H)``: ``(idx (N, k) int64, weight
    (N, k) f32)``, ``k = experts_per_token``.

    ``sigmoid`` (LFM2): ``s = sigmoid(h @ router)``, the k largest of ``s +
    bias`` chosen, their ``s`` normalised to sum to one (+ 1e-6; LFM2's
    ``norm_topk_prob``, with ``routed_scaling_factor`` 1). ``softmax``
    (granite): the k largest logits ``h @ router`` chosen, weighted by their
    softmax; ``bias`` is not read."""
    logits = h.float() @ router.float()
    if cfg.router == "softmax":
        top, idx = torch.topk(logits, cfg.experts_per_token, dim=-1)
        return idx, torch.softmax(top, dim=-1)
    scores = torch.sigmoid(logits)
    _, idx = torch.topk(scores + bias, cfg.experts_per_token, dim=-1)
    weight = scores.gather(1, idx)
    return idx, weight / (weight.sum(dim=-1, keepdim=True) + 1e-6)


def _moe_block(params, cfg, x, delta, hits):
    """The residual add, then the routed experts (plus the shared expert
    where the config has one, on the same normed input): ``(x, their
    delta)``. A decode step (T == 1) runs the experts kernel, which reads
    only the experts its rows chose; a prefill groups the tokens by expert
    after a host read of the counts. ``hits`` ``(E,)`` int32, if given,
    becomes 1 for each expert chosen, else 0 (on the device)."""
    b, t, hd = x.shape
    x, h = _add_norm(x, delta, params["mlp_norm"], cfg.rms_eps, cfg.residual_multiplier)
    flat = h.reshape(b * t, hd)
    idx, weight = route_experts(flat, params["router"], params.get("expert_bias"), cfg)
    run = moe_experts if t == 1 else grouped_experts
    out = run(flat, idx, weight, params["w_gate"], params["w_up"], params["w_down"], hits)
    out = out.view(b, t, hd)
    if cfg.shared_ffn:
        with profiling.region("talker/shared_expert"):
            act = _swiglu(qmm(h, params["shared_w_gate"]), qmm(h, params["shared_w_up"]))
            out = out + qmm(act, params["shared_w_down"]).float()
    return x, out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _heads_over(cfg: TransformerConfig, n: int) -> TransformerConfig:
    return dataclasses.replace(cfg, q_heads=cfg.q_heads // n, kv_heads=cfg.kv_heads // n)


def local_config(cfg: TransformerConfig, tp=None) -> TransformerConfig:
    """``cfg`` with this rank's head counts when the heads split over ``tp``."""
    if tp is None or tp.size == 1:
        return cfg
    return _heads_over(cfg, tp.size)


def _unbind(w):
    """A stacked (L, ...) weight (or a quantized leaf's dict) -> its L layers."""
    if isinstance(w, dict):
        parts = {k: v.unbind(0) for k, v in w.items()}
        return [dict(zip(parts, layer)) for layer in zip(*parts.values())]
    return w.unbind(0)


def kv_cache_dtype(batch=None, max_len=None):
    """KV-cache storage dtype, env-selectable (``RHO_TTS_TPU_KV_DTYPE``).

    ``bf16`` (default), ``f8`` (float8_e4m3fn), or ``auto`` (f8 when
    ``batch * max_len >= RHO_TTS_TPU_KV_AUTO_THRESHOLD``, default 2048), the
    same selection as the JAX package.
    """
    name = os.environ.get("RHO_TTS_TPU_KV_DTYPE", "bf16")
    if name == "auto":
        if batch is None or max_len is None:
            return torch.bfloat16
        threshold = int(os.environ.get("RHO_TTS_TPU_KV_AUTO_THRESHOLD", "2048"))
        return torch.float8_e4m3fn if batch * max_len >= threshold else torch.bfloat16
    table = {"bf16": torch.bfloat16, "f8": torch.float8_e4m3fn, "fp8": torch.float8_e4m3fn}
    if name not in table:
        raise ValueError(f"RHO_TTS_TPU_KV_DTYPE={name!r}; expected bf16|f8|auto")
    return table[name]


def make_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, device=None):
    if dtype is None:
        dtype = kv_cache_dtype(batch, max_len)
    shape = (cfg.attn_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return (
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def make_ssm_state(cfg: TransformerConfig, batch: int,
                   device=None) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The Mamba layers' state, zeroed (a new sequence), or None for a talker
    without them: the convolution's ``(Lm, B, ssm_conv - 1, conv_dim)`` and
    the scan's ``(Lm, B, heads, head_dim, ssm_state)``, both f32."""
    if not cfg.mamba_layers:
        return None
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(ssm_conv_shape(cfg, batch), **f32),
            torch.zeros(ssm_scan_shape(cfg, batch), **f32))


def ssm_conv_shape(cfg: TransformerConfig, batch: int) -> Tuple[int, ...]:
    return (cfg.mamba_layers, batch, cfg.ssm_conv - 1, cfg.ssm_conv_dim)


def ssm_scan_shape(cfg: TransformerConfig, batch: int) -> Tuple[int, ...]:
    return (cfg.mamba_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)


def make_conv_state(cfg: TransformerConfig, batch: int, device=None) -> Optional[torch.Tensor]:
    """The short convolutions' state ``(Lc, B, CONV_TAPS - 1, H)`` f32,
    zeroed (a new sequence), or None for a talker without them."""
    if not cfg.conv_layers:
        return None
    return torch.zeros((cfg.conv_layers, batch, CONV_TAPS - 1, cfg.hidden),
                       dtype=torch.float32, device=device)
