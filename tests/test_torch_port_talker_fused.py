"""The talker block's fused glue: ``ops.cuda.add_rms_norm``, ``ops.cuda.rope_qk``
and ``ops.cuda.silu_mul`` (``csrc/{add_rms_norm,rope_qk,silu_mul}.cu``), and
where ``models.transformer`` sends the block's f32 glue.

On the CPU: each plain version bit-equal to the chain the block ran before
the kernels (written out below) on random bf16 inputs at the three
benchmark cells' widths; the dispatch with the wrappers stood in (CPU
tensors, f32 and any forward with grad mode on take the plain chains; bf16
card tensors under ``no_grad`` take the kernels, with the shapes and strides
the kernels are given, and the forward's result unchanged); the launch
arguments the wrappers compute, read back through ``as_strided`` as the
kernels read memory; the wrappers' refusals.

On the card (``-m chip``; skipped without one): each kernel against its
plain version at 8 and 2,048 rows and the cells' widths, ``rope_qk`` and
``silu_mul`` bit-equal, ``add_rms_norm``'s residual bit-equal and its norm
within one bf16 unit in the last place (the share of values that differ is
printed), two launches on the same inputs bit-equal, launches counted. Run
there with ``python -m pytest tests/test_torch_port_talker_fused.py -m chip -s``.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rho_tts_tpu_torch.models import transformer as tfm
from rho_tts_tpu_torch.ops.cuda import add_rms_norm as arn
from rho_tts_tpu_torch.ops.cuda import rope_qk as rq
from rho_tts_tpu_torch.ops.cuda import silu_mul as sm

torch.set_num_threads(1)  # several test workers share the cores

# (hidden, q heads, kv heads, head dim, ffn) of the three cells' talkers
CELLS = {
    "1.7b": (2048, 16, 8, 128, 6144),
    "0.6b": (1024, 16, 8, 128, 3072),
    "lfm2": (2048, 32, 8, 64, 7168),
}


def _bf16(shape, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a * scale).to(torch.bfloat16)


def _norm_weight(d, seed):
    return torch.from_numpy(
        1.0 + 0.1 * np.random.default_rng(seed).standard_normal(d).astype(np.float32))


# The chains the block ran before the kernels, as they were written.


def _old_rms_norm(x, weight, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight).to(x.dtype)


def _old_rotate(x, cos, sin):
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def _old_swiglu(gate, up, dtype):
    return (F.silu(gate.float()) * up.float()).to(dtype)


def _qkv_views(b, t, hq, hk, d, seed):
    """q, k, v as ``_split_qkv`` cuts them from one QKV projection output."""
    qkv = _bf16((b, t, (hq + 2 * hk) * d), seed)
    q = qkv[..., : hq * d].reshape(b, t, hq, d)
    k = qkv[..., hq * d: (hq + hk) * d].reshape(b, t, hk, d)
    return qkv, q, k


def _tables(b, t, d, seed):
    pos = torch.from_numpy(np.random.default_rng(seed).integers(0, 4096, (b, t)))
    return tfm._rope_tables(pos, d, 1_000_000.0)


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("rows", [(8, 1), (2, 37)], ids=["decode", "prefill"])
def test_plain_add_rms_norm_is_the_add_then_the_old_norm(cell, rows):
    hidden, hq, _, d, _ = CELLS[cell]
    x = _bf16((*rows, hidden), 1)
    delta = _bf16((*rows, hidden), 2, 0.5)
    w = _norm_weight(hidden, 3)
    res, out = arn.reference_add_rms_norm(x, delta, w, 1e-6)
    assert torch.equal(res, x + delta)
    assert torch.equal(out, _old_rms_norm(x + delta, w, 1e-6))
    same, normed = arn.reference_add_rms_norm(x, None, w, 1e-5)
    assert same is x and torch.equal(normed, _old_rms_norm(x, w, 1e-5))
    _, q, _ = _qkv_views(*rows, hq, 8, d, 4)  # QK-norm over the heads of a view
    wq = _norm_weight(d, 5)
    assert torch.equal(arn.reference_add_rms_norm(q, None, wq, 1e-5)[1],
                       _old_rms_norm(q, wq, 1e-5))
    assert tfm.rms_norm is arn.reference_rms_norm


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("rows", [(8, 1), (2, 37)], ids=["decode", "prefill"])
def test_plain_rope_qk_is_the_old_rotation_of_q_and_k(cell, rows):
    _, hq, hk, d, _ = CELLS[cell]
    _, q, k = _qkv_views(*rows, hq, hk, d, 6)
    cos, sin = _tables(*rows, d, 7)
    qo, ko = rq.reference_rope_qk(q, k, cos, sin)
    assert torch.equal(qo, _old_rotate(q, cos, sin))
    assert torch.equal(ko, _old_rotate(k, cos, sin))
    assert qo.dtype == ko.dtype == torch.bfloat16


@pytest.mark.parametrize("cell", list(CELLS))
@pytest.mark.parametrize("rows", [(8, 1), (2, 37)], ids=["decode", "prefill"])
def test_plain_silu_mul_is_the_old_swiglu_chain(cell, rows):
    ffn = CELLS[cell][4]
    gate = _bf16((*rows, ffn), 8, 2.0)
    up = _bf16((*rows, ffn), 9)
    assert torch.equal(sm.reference_silu_mul(gate, up), _old_swiglu(gate, up, torch.bfloat16))


# ---------------------------------------------------------------------------
# The dispatch, with the wrappers stood in
# ---------------------------------------------------------------------------


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on a card, to reach the dispatch."""

    @property
    def is_cuda(self):
        return True


def _layout(shape, stride):
    """Shape and strides, a dim of one at stride 0 (never stepped)."""
    return tuple(shape), tuple(s if n > 1 else 0 for n, s in zip(shape, stride))


def _stand_ins(monkeypatch):
    """Each wrapper replaced by its plain version, recording what it was given."""
    calls = {"add_rms_norm": [], "rope_qk": [], "silu_mul": []}

    def layout(t):
        return None if t is None else _layout(t.shape, t.stride())

    def norm(x, delta, weight, eps, scale=1.0):
        calls["add_rms_norm"].append((layout(x), layout(delta), tuple(weight.shape)))
        return arn.reference_add_rms_norm(x, delta, weight, eps, scale)

    def rope(q, k, cos, sin):
        calls["rope_qk"].append((layout(q), layout(k)))
        return rq.reference_rope_qk(q, k, cos, sin)

    def swiglu(gate, up):
        calls["silu_mul"].append((layout(gate), layout(up)))
        return sm.reference_silu_mul(gate, up)

    monkeypatch.setattr(arn, "add_rms_norm", norm)
    monkeypatch.setattr(rq, "rope_qk", rope)
    monkeypatch.setattr(sm, "silu_mul", swiglu)
    return calls


DENSE = dict(hidden=64, layers=3, q_heads=4, kv_heads=2, head_dim=16, ffn=128)


def _dense(dtype=torch.bfloat16):
    cfg = tfm.TransformerConfig(**DENSE, dtype=dtype)
    params = tfm.init_stack(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, params


def _cached_forward(cfg, params, x, b, t):
    ck, cv = tfm.make_kv_cache(cfg, b, t + 4, dtype=cfg.dtype)
    pos = torch.arange(t)[None].expand(b, t)
    if cfg.hybrid:
        state = tfm.make_conv_state(cfg, b)
        return tfm.stack_forward(params, cfg, x, pos, kv_caches=(ck, cv), fused_prefill=True,
                                 conv_state=state)[0]
    return tfm.stack_forward(params, cfg, x, pos, kv_caches=(ck, cv), fused_prefill=True)[0]


@pytest.mark.parametrize("t", [1, 5], ids=["one-token", "prefill"])
def test_bf16_card_tensors_without_autograd_take_the_kernels(monkeypatch, t):
    """Per forward of L layers: 2L + 1 norms (the first without a residual
    add, the final norm with the last layer's), L RoPEs over the QKV views,
    L SiLU.muls; the result is the plain forward's, bit for bit."""
    cfg, params = _dense()
    b, hidden = 2, DENSE["hidden"]
    x = _bf16((b, t, hidden), 10)
    plain = _cached_forward(cfg, params, x, b, t)
    calls = _stand_ins(monkeypatch)
    with torch.no_grad():
        fused = _cached_forward(cfg, params, x.as_subclass(_CudaLike), b, t)
    assert torch.equal(fused.as_subclass(torch.Tensor), plain)
    n = DENSE["layers"]
    stream = _layout((b, t, hidden), (t * hidden, hidden, 1))
    assert calls["add_rms_norm"] == [(stream, None, (hidden,))] + [(stream, stream, (hidden,))] * (
        2 * n)
    w = (DENSE["q_heads"] + 2 * DENSE["kv_heads"]) * DENSE["head_dim"]
    hd = DENSE["head_dim"]
    q = _layout((b, t, DENSE["q_heads"], hd), (t * w, w, hd, 1))
    k = _layout((b, t, DENSE["kv_heads"], hd), (t * w, w, hd, 1))
    assert calls["rope_qk"] == [(q, k)] * n
    act = _layout((b, t, DENSE["ffn"]), (t * DENSE["ffn"], DENSE["ffn"], 1))
    assert calls["silu_mul"] == [(act, act)] * n


def test_the_hybrid_talker_takes_the_kernels_for_its_norms_qk_norm_rope_and_dense_mlp(
        monkeypatch):
    from rho_tts_tpu_torch.models.qwen.config import PRESETS

    cfg = PRESETS["lfm2-tiny"].talker
    params = tfm.init_stack(torch.Generator().manual_seed(1), cfg, "cpu")
    b, t = 2, 3
    x = _bf16((b, t, cfg.hidden), 11)
    plain = _cached_forward(cfg, params, x, b, t)
    calls = _stand_ins(monkeypatch)
    with torch.no_grad():
        fused = _cached_forward(cfg, params, x.as_subclass(_CudaLike), b, t)
    assert torch.equal(fused.as_subclass(torch.Tensor), plain)
    norms = calls["add_rms_norm"]
    # two a layer and the final one, and QK-norm's two in each attention layer
    assert len(norms) == 2 * cfg.layers + 1 + 2 * cfg.attn_layers
    assert sum(delta is None for _, delta, _ in norms) == 1 + 2 * cfg.attn_layers
    assert sum(w == (cfg.head_dim,) for _, _, w in norms) == 2 * cfg.attn_layers
    assert len(calls["rope_qk"]) == cfg.attn_layers
    assert len(calls["silu_mul"]) == cfg.dense_layers


@pytest.mark.parametrize("case", ["cpu", "autograd", "grad-mode", "f32"])
def test_cpu_f32_and_grad_mode_forwards_keep_the_plain_chains(monkeypatch, case):
    """Grad mode on takes the plain chains in the whole forward, also where
    nothing requires grad (``grad-mode``), so a forward's bits never depend
    on which of its inputs require grad."""
    cfg, params = _dense(torch.float32 if case == "f32" else torch.bfloat16)
    b, t = 2, 4
    x = _bf16((b, t, DENSE["hidden"]), 12).to(cfg.dtype)
    if case != "cpu":
        x = x.as_subclass(_CudaLike)
    if case == "autograd":
        for w in params["blocks"].values():
            w.requires_grad_(True)
    calls = _stand_ins(monkeypatch)
    with torch.set_grad_enabled(case in ("autograd", "grad-mode")):
        out, _ = tfm.stack_forward(params, cfg, x, torch.arange(t)[None].expand(b, t))
        if case == "autograd":
            out.float().sum().backward()
            assert params["blocks"]["attn_norm"].grad is not None
        tfm.block_forward({name: w[0] for name, w in params["blocks"].items()}, cfg, x,
                          torch.arange(t)[None].expand(b, t))
        if case != "autograd":  # the cached forward's kernels raise under autograd
            _cached_forward(cfg, params, x, b, t)
    assert calls == {"add_rms_norm": [], "rope_qk": [], "silu_mul": []}


# ---------------------------------------------------------------------------
# The launch arguments, read back as the kernels read memory
# ---------------------------------------------------------------------------


def _on_card(t):
    return None if t is None else t.as_subclass(_CudaLike)


LAYOUTS = {
    "stream": lambda: _bf16((8, 1, 2048), 13),
    "prefill": lambda: _bf16((2, 37, 1024), 13),
    "q-heads": lambda: _qkv_views(8, 1, 32, 8, 64, 14)[1],
    "k-heads-prefill": lambda: _qkv_views(2, 5, 32, 8, 64, 14)[2],
    "sequence-slice": lambda: _bf16((2, 8, 128), 15)[:, 4:],
    "one-row": lambda: _bf16((1, 1, 64), 16),
}


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_the_norms_rows_read_through_two_strides_are_xs_rows(case):
    x = LAYOUTS[case]()
    d = x.shape[-1]
    rows, groups, sr, sg = arn._check(_on_card(x), None, _norm_weight(d, 0))
    seen = x.as_strided((rows, groups, d), (sr, sg, 1))
    assert torch.equal(seen.reshape(-1, d), x.reshape(-1, d))


def test_a_layout_of_three_strided_dims_is_refused():
    q = _qkv_views(2, 3, 4, 2, 16, 17)[1].transpose(1, 2)  # (B, H, T, D) of a (B, T, W)
    with pytest.raises(ValueError, match="two strides"):
        arn.row_view(q, "add_rms_norm")


@pytest.mark.parametrize("b,t", [(8, 1), (2, 5), (1, 1)])
@pytest.mark.parametrize("cell", ["1.7b", "lfm2"])
def test_rope_arguments_address_q_k_and_the_tables(b, t, cell):
    _, hq, hk, d, _ = CELLS[cell]
    _, q, k = _qkv_views(b, t, hq, hk, d, 18)
    cos, sin = _tables(b, t, d, 19)
    args = rq._check(_on_card(q), _on_card(k), cos, sin)
    assert args[:5] == (b, t, hq, hk, d)
    sq, sk, sc = args[5:8], args[8:11], args[11:13]
    assert torch.equal(q.as_strided((b, t, hq, d), (*sq, 1)), q)
    assert torch.equal(k.as_strided((b, t, hk, d), (*sk, 1)), k)
    for tab in (cos, sin):
        assert torch.equal(tab.as_strided((b, t, d // 2), (*sc, 1)), tab[:, :, 0])
    one = _tables(1, t, d, 20)  # one row of tables for the batch: broadcast
    assert rq._check(_on_card(q), _on_card(k), *one)[11] == 0


# ---------------------------------------------------------------------------
# The wrappers' refusals
# ---------------------------------------------------------------------------


def _good_norm():
    return dict(x=_bf16((4, 64), 21), delta=_bf16((4, 64), 22), weight=_norm_weight(64, 23))


NORM_REFUSALS = {
    "x-f32": (dict(x=lambda: torch.zeros(4, 64)), TypeError),
    "delta-f16": (dict(delta=lambda: torch.zeros(4, 64, dtype=torch.float16)), TypeError),
    "weight-bf16": (dict(weight=lambda: torch.ones(64, dtype=torch.bfloat16)), TypeError),
    "d-ragged": (dict(x=lambda: _bf16((4, 60), 21), delta=lambda: None,
                      weight=lambda: torch.ones(60)), ValueError),
    "d-too-long": (dict(x=lambda: _bf16((1, arn.MAX_D + 8), 21), delta=lambda: None,
                        weight=lambda: torch.ones(arn.MAX_D + 8)), ValueError),
    "no-rows": (dict(x=lambda: _bf16((0, 64), 21), delta=lambda: None), ValueError),
    "weight-shape": (dict(weight=lambda: torch.ones(32)), ValueError),
    "delta-shape": (dict(delta=lambda: _bf16((2, 64), 22)), ValueError),
    "delta-strided": (dict(delta=lambda: _bf16((64, 4), 22).t()), ValueError),
    "x-stride": (dict(x=lambda: _bf16((4, 68), 21)[:, :64], delta=lambda: None), ValueError),
    "x-column-major": (dict(x=lambda: _bf16((64, 4), 21).t(), delta=lambda: None), ValueError),
    "x-misaligned": (dict(x=lambda: _bf16((4 * 64 + 1,), 21)[1:].view(4, 64),
                          delta=lambda: None), ValueError),
    "cpu": ({}, ValueError),  # every check passes but the device's
}


@pytest.mark.parametrize("case", list(NORM_REFUSALS))
def test_add_rms_norm_refuses_what_the_kernel_does_not_take(case):
    over, err = NORM_REFUSALS[case]
    t = {name: over[name]() if name in over else v for name, v in _good_norm().items()}
    on_card = case != "cpu"
    with pytest.raises(err, match="add_rms_norm"):
        arn._check(_on_card(t["x"]) if on_card else t["x"], t["delta"], t["weight"])


def _good_rope():
    _, q, k = _qkv_views(2, 3, 4, 2, 32, 24)
    cos, sin = _tables(2, 3, 32, 25)
    return dict(q=q, k=k, cos=cos, sin=sin)


ROPE_REFUSALS = {
    "q-f32": (dict(q=lambda g: g["q"].float()), TypeError),
    "cos-bf16": (dict(cos=lambda g: g["cos"].to(torch.bfloat16)), TypeError),
    "k-3d": (dict(k=lambda g: g["k"][:, :, 0]), ValueError),
    "k-other-t": (dict(k=lambda g: g["k"][:, :2]), ValueError),
    "d-ragged": (dict(q=lambda g: g["q"][..., :24], k=lambda g: g["k"][..., :24]), ValueError),
    "sin-shape": (dict(sin=lambda g: g["sin"][:, :2]), ValueError),
    "tables-other-t": (dict(cos=lambda g: g["cos"][:, :2], sin=lambda g: g["sin"][:, :2]),
                       ValueError),
    "q-last-dim-strided": (dict(q=lambda g: _bf16((2, 3, 4, 64), 26)[..., ::2]), ValueError),
    "q-misaligned": (dict(q=lambda g: _bf16((2 * 3 * 4 * 32 + 1,), 26)[1:].view(2, 3, 4, 32)),
                     ValueError),
    "cpu": ({}, ValueError),
}


@pytest.mark.parametrize("case", list(ROPE_REFUSALS))
def test_rope_qk_refuses_what_the_kernel_does_not_take(case):
    over, err = ROPE_REFUSALS[case]
    good = _good_rope()
    t = {name: over[name](good) if name in over else v for name, v in good.items()}
    if case != "cpu":
        t["q"], t["k"] = _on_card(t["q"]), _on_card(t["k"])
    with pytest.raises(err, match="rope_qk"):
        rq._check(t["q"], t["k"], t["cos"], t["sin"])


SILU_REFUSALS = {
    "gate-f32": (lambda: (torch.zeros(8, 64), _bf16((8, 64), 27)), TypeError),
    "shapes": (lambda: (_bf16((8, 64), 27), _bf16((8, 32), 28)), ValueError),
    "ragged": (lambda: (_bf16((3, 5), 27), _bf16((3, 5), 28)), ValueError),
    "empty": (lambda: (_bf16((0, 64), 27), _bf16((0, 64), 28)), ValueError),
    "strided": (lambda: (_bf16((64, 8), 27).t(), _bf16((8, 64), 28)), ValueError),
    "misaligned": (lambda: (_bf16((8 * 64 + 1,), 27)[1:].view(8, 64), _bf16((8, 64), 28)),
                   ValueError),
    "cpu": (None, ValueError),
}


@pytest.mark.parametrize("case", list(SILU_REFUSALS))
def test_silu_mul_refuses_what_the_kernel_does_not_take(case):
    make, err = SILU_REFUSALS[case]
    if make is None:
        gate, up = _bf16((8, 64), 27), _bf16((8, 64), 28)
    else:
        gate, up = make()
        gate = _on_card(gate)
    with pytest.raises(err, match="silu_mul"):
        sm._check(gate, up)


def test_the_wrappers_run_the_plain_versions_on_the_cpu_without_counting():
    x, delta, w = _bf16((2, 3, 64), 29), _bf16((2, 3, 64), 30), _norm_weight(64, 31)
    _, q, k = _qkv_views(2, 3, 4, 2, 32, 32)
    cos, sin = _tables(2, 3, 32, 33)
    counts = (arn.launches, rq.launches, sm.launches)
    res, out = arn.add_rms_norm(x, delta, w, 1e-6)
    assert torch.equal(res, x + delta) and torch.equal(out, _old_rms_norm(x + delta, w, 1e-6))
    qo, ko = rq.rope_qk(q, k, cos, sin)
    assert torch.equal(qo, _old_rotate(q, cos, sin)) and torch.equal(ko, _old_rotate(k, cos, sin))
    assert torch.equal(sm.silu_mul(x, delta), _old_swiglu(x, delta, torch.bfloat16))
    assert (arn.launches, rq.launches, sm.launches) == counts
    with pytest.raises(RuntimeError, match="no backward"):
        arn.add_rms_norm(x, None, w.clone().requires_grad_(), 1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        rq.rope_qk(q.float().requires_grad_(), k, cos, sin)
    with pytest.raises(RuntimeError, match="no backward"):
        sm.silu_mul(x.float().requires_grad_(), delta)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


def _card_bf16(shape, gen, scale=1.0):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(torch.bfloat16)


def _ulps(a, b):
    """|a - b| in units of the last place of bf16 at the larger of the two."""
    a, b = a.float(), b.float()
    exp = torch.frexp(torch.maximum(a.abs(), b.abs())).exponent
    return (a - b).abs() / torch.ldexp(torch.ones_like(a), exp - 8)


NORM_CARD = [(rows, d, view) for rows in (8, 2048) for d, view in
             ((1024, "stream"), (2048, "stream"), (3072, "stream"), (64, "q-heads"),
              (128, "q-heads"))]


@pytest.mark.chip
@pytest.mark.parametrize("rows,d,view", NORM_CARD, ids=lambda v: str(v))
def test_add_rms_norm_matches_its_plain_version_on_the_card(cuda_card, rows, d, view):
    gen = torch.Generator(device=cuda_card).manual_seed(rows * 31 + d)
    w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=cuda_card)
    if view == "stream":
        x = _card_bf16((rows, 1, d), gen)
        delta = _card_bf16((rows, 1, d), gen, 0.5)
    else:  # QK-norm: the q heads of a QKV output, read through its strides
        hq = 2048 // d
        qkv = _card_bf16((rows, 1, (hq + 16) * d), gen)
        x, delta = qkv[..., : hq * d].reshape(rows, 1, hq, d), None
    launches = arn.launches
    with torch.no_grad():
        res, out = arn.add_rms_norm(x, delta, w, 1e-6)
        res2, out2 = arn.add_rms_norm(x, delta, w, 1e-6)
    ref_res, ref = arn.reference_add_rms_norm(x, delta, w, 1e-6)
    torch.cuda.synchronize()
    assert arn.launches - launches == 2
    assert torch.equal(out, out2) and torch.equal(res, res2)
    assert torch.equal(res, ref_res) and out.is_contiguous() and out.shape == x.shape
    ulps = _ulps(out, ref)
    share = (ulps > 0).float().mean().item()
    print(json.dumps({"kernel": "add_rms_norm", "rows": rows, "d": d, "view": view,
                      "max_ulps": ulps.max().item(), "share_differing": share}))
    assert ulps.max().item() <= 1.0, f"{share:.2e} of the values differ, by up to " \
                                     f"{ulps.max().item()} ulps"


@pytest.mark.chip
@pytest.mark.parametrize("rows", [8, 2048])
@pytest.mark.parametrize("cell", ["1.7b", "lfm2"])
def test_rope_qk_is_its_plain_version_bit_for_bit_on_the_card(cuda_card, rows, cell):
    _, hq, hk, d, _ = CELLS[cell]
    gen = torch.Generator(device=cuda_card).manual_seed(rows + d)
    b, t = (8, 1) if rows == 8 else (1, rows)
    qkv = _card_bf16((b, t, (hq + 2 * hk) * d), gen)
    q = qkv[..., : hq * d].reshape(b, t, hq, d)
    k = qkv[..., hq * d: (hq + hk) * d].reshape(b, t, hk, d)
    pos = torch.randint(0, 4096, (b, t), generator=gen, device=cuda_card)
    cos, sin = tfm._rope_tables(pos, d, 1_000_000.0)
    launches = rq.launches
    with torch.no_grad():
        qo, ko = rq.rope_qk(q, k, cos, sin)
        qo2, ko2 = rq.rope_qk(q, k, cos, sin)
    rq_ref, rk_ref = rq.reference_rope_qk(q, k, cos, sin)
    torch.cuda.synchronize()
    assert rq.launches - launches == 2
    assert torch.equal(qo, qo2) and torch.equal(ko, ko2)
    assert torch.equal(qo, rq_ref) and torch.equal(ko, rk_ref)
    assert qo.is_contiguous() and ko.is_contiguous()


@pytest.mark.chip
@pytest.mark.parametrize("rows", [8, 2048])
@pytest.mark.parametrize("width", [1024, 2048, 3072, 6144, 7168])
def test_silu_mul_is_its_plain_version_bit_for_bit_on_the_card(cuda_card, rows, width):
    gen = torch.Generator(device=cuda_card).manual_seed(rows + width)
    gate = _card_bf16((rows, 1, width), gen, 3.0)
    up = _card_bf16((rows, 1, width), gen)
    launches = sm.launches
    with torch.no_grad():
        out = sm.silu_mul(gate, up)
        out2 = sm.silu_mul(gate, up)
    ref = sm.reference_silu_mul(gate, up)
    torch.cuda.synchronize()
    assert sm.launches - launches == 2
    assert torch.equal(out, out2) and torch.equal(out, ref)
