"""Port parity: talker stack and int8 quantization vs the JAX package.

Same weights (JAX init, carried over through ``from_jax``) and the same
numpy inputs go through ``stack_forward`` of both packages: a left-padded
prefill into an empty cache, then decode steps. The JAX side runs its
Pallas attention kernels in interpret mode (``RHO_TTS_TPU_FUSED_ATTENTION=1``,
``RHO_TTS_TPU_DECODE_KERNEL=1``), the attention the port's kernels
reproduce; the port runs the kernels' plain versions on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models import quantization as jq
from rho_tts_tpu.models import transformer as jtfm
from rho_tts_tpu_torch import from_jax
from rho_tts_tpu_torch.models import quantization as tq
from rho_tts_tpu_torch.models import transformer as ttfm

torch.set_num_threads(1)  # several test workers share the cores

CFG = dict(hidden=64, layers=2, q_heads=4, kv_heads=2, head_dim=16, ffn=128)


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_FUSED_ATTENTION", "1")
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_KERNEL", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _params(quant):
    """fp32 stack weights; ``quant`` is None / False (dense), True or "int8", or "int4",
    quantized by the JAX package and carried over through the bridge."""
    jcfg = jtfm.TransformerConfig(**CFG, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jtfm.init_stack(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(5)

    def init(leaf):  # fan-in scaled weights; norms around 1
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 3:
            return jnp.asarray(a / np.sqrt(leaf.shape[1]))
        return jnp.asarray(1.0 + 0.1 * a)

    params = jax.tree.map(init, shapes)
    if quant:
        params = jq.quantize_stack(params, "int8" if quant is True else quant)
    tparams = from_jax.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, ttfm.TransformerConfig(**CFG, dtype=torch.float32), tparams


@pytest.mark.parametrize("quant", [False, True, "int4", "int8-w8a8"],
                         ids=["dense", "int8", "int4", "int8-w8a8"])
def test_stack_forward_prefill_then_decode(quant, jax_kernels, monkeypatch):
    """fp32 with an f32 cache: 1e-4, the port's fp32 parity tolerance
    (tests/test_torch_oracle.py); the attention order of sums differs. int4
    runs both halves in one f32 dot (JAX: two dots, added); w8a8 quantizes
    the prefill's activations to int8 in both packages, decode stays
    weight-only."""
    if quant == "int8-w8a8":
        monkeypatch.setenv("RHO_TTS_TPU_W8A8_PREFILL", "1")
        jax.clear_caches()  # read at trace time
        quant = "int8"
    jcfg, jparams, tcfg, tparams = _params(quant)
    rng = np.random.default_rng(0)
    b, p, steps = 3, 12, 8
    s = p + steps
    lens = [12, 9, 4]
    attn_mask = np.stack([np.arange(p) >= p - n for n in lens])
    pos = np.stack([np.maximum(np.arange(p) - (p - n), 0) for n in lens])
    x = (rng.standard_normal((b, p + steps, CFG["hidden"])) * 0.5).astype(np.float32)

    jck, jcv = jtfm.make_kv_cache(jcfg, b, s, dtype=jnp.float32)
    jkv = jnp.zeros((b, s), bool)
    prefill = jax.jit(functools.partial(jtfm.stack_forward, cfg=jcfg, fused_prefill=True))
    decode = jax.jit(functools.partial(jtfm.stack_forward, cfg=jcfg))
    jh, (jck, jcv) = prefill(
        jparams, x=jnp.asarray(x[:, :p]), positions=jnp.asarray(pos), kv_caches=(jck, jcv),
        cache_len=jnp.int32(0), attn_mask=jnp.asarray(attn_mask), key_valid=jkv,
    )
    jkv = jkv.at[:, :p].set(jnp.asarray(attn_mask))

    tck, tcv = ttfm.make_kv_cache(tcfg, b, s, dtype=torch.float32, device="cpu")
    tkv = torch.zeros((b, s), dtype=torch.bool)
    th, _ = ttfm.stack_forward(
        tparams, tcfg, torch.from_numpy(x[:, :p]), torch.from_numpy(pos), kv_caches=(tck, tcv),
        cache_len=0, attn_mask=torch.from_numpy(attn_mask), key_valid=tkv, fused_prefill=True,
    )
    tkv[:, :p] = torch.from_numpy(attn_mask)
    real = attn_mask  # pad rows attend to nothing; only real rows carry meaning
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], atol=1e-4, rtol=1e-4)

    for t in range(steps):
        slot = p + t
        step_pos = np.asarray(lens)[:, None] + t
        jh, (jck, jcv) = decode(
            jparams, x=jnp.asarray(x[:, slot : slot + 1]), positions=jnp.asarray(step_pos),
            kv_caches=(jck, jcv), cache_len=jnp.int32(slot), key_valid=jkv,
        )
        jkv = jkv.at[:, slot].set(True)
        th, _ = ttfm.stack_forward(
            tparams, tcfg, torch.from_numpy(x[:, slot : slot + 1]), torch.from_numpy(step_pos),
            kv_caches=(tck, tcv), cache_len=slot, key_valid=tkv,
        )
        tkv[:, slot] = True
        np.testing.assert_allclose(
            th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4, err_msg=f"decode step {t}"
        )
    np.testing.assert_allclose(tck.numpy()[:, :, p:], np.asarray(jck)[:, :, p:], atol=1e-4, rtol=1e-4)


def test_quantize_weight_matches_jax():
    """int8 codes identical (both round half to even); scales to f32 ulp."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((2, 48, 40)).astype(np.float32)
    w[0, :4, 0] = [0.5, -0.5, 1.5, 2.5]  # exact .5 ratios after scaling by 127/absmax
    w[0, 4:, 0] = 0.0
    w[0, 4, 0] = 127.0
    ref = jax.jit(jq.quantize_weight)(jnp.asarray(w))
    ours = tq.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(ours["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_allclose(ours["s"].numpy(), np.asarray(ref["s"]), rtol=1e-7)
    host = tq.quantize_host(w)
    ref_host = jq.quantize_host(w)
    np.testing.assert_array_equal(host["q"], ref_host["q"])
    np.testing.assert_array_equal(host["s"], ref_host["s"])


def test_int8_matmul_matches_jax():
    """Same arithmetic as JAX (convert, dot, f32 scale, cast): 1e-5 at f32."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    jw = jq.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jq.matmul(jnp.asarray(x), jw))
    ours = tq.matmul(torch.from_numpy(x), {k: torch.tensor(np.asarray(v)) for k, v in jw.items()})
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-5)
    # {"q4", "s"} leaves now dispatch to the int4 matmul, as in JAX.
    jw4 = jq.quantize_host(w, "int4")
    ref4 = np.asarray(jq.matmul(jnp.asarray(x), {k: jnp.asarray(v) for k, v in jw4.items()}))
    ours4 = tq.matmul(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in jw4.items()})
    np.testing.assert_allclose(ours4.numpy(), ref4, atol=1e-5, rtol=1e-5)


SERVING_MODES = {
    # (T, cache_len, attn_mask, slot_causal, block_causal)
    "ring decode: per-row columns, one past the cache": (
        1, [5, 23, 24], [True, True, False], False, False),
    "ring decode: shared column": (1, 11, [True, False, True], False, False),
    "draft step: per-row columns, slot-causal": (1, [3, 17, 9], None, True, False),
    "speculative verify: per-row block, one row past the end": (
        4, [2, 21, 9], [True, True, False], False, True),
    "speculative verify: no block causality": (3, [4, 0, 12], None, False, False),
    "single-stream verify: shared slot, slot-causal": (4, 7, None, True, False),
}


@pytest.mark.parametrize("mode", list(SERVING_MODES))
def test_stack_forward_serving_modes(mode):
    """Per-row slots (out-of-range columns dropped), ``slot_causal=False``
    and ``block_causal`` against JAX's ``stack_forward`` (its einsum branch,
    which serving runs) at 1e-5 over an f32 cache, the same columns
    written. The caches hold random keys under a random ``key_valid``, so
    valid keys are not a prefix. (A float8 cache is held at the attention's
    primitives below: a key written across layers may round to the other
    e4m3 neighbour where the packages' f32 sums differ by an ulp.)"""
    t, cache_len, attn_mask, slot_causal, block_causal = SERVING_MODES[mode]
    jcfg, jparams, tcfg, tparams = _params(False)
    rng = np.random.default_rng(3)
    b, s = 3, 24
    shape = (CFG["layers"], b, s, CFG["kv_heads"], CFG["head_dim"])
    ck0 = rng.standard_normal(shape).astype(np.float32)
    cv0 = rng.standard_normal(shape).astype(np.float32)
    kv = rng.random((b, s)) < 0.6
    x = (rng.standard_normal((b, t, CFG["hidden"])) * 0.5).astype(np.float32)
    pos = rng.integers(0, 40, (b, 1)) + np.arange(t)[None, :]
    am = None if attn_mask is None else np.repeat(np.asarray(attn_mask)[:, None], t, axis=1)
    kw = dict(slot_causal=slot_causal, block_causal=block_causal)

    jh, (jck, jcv) = jtfm.stack_forward(
        jparams, jcfg, jnp.asarray(x), jnp.asarray(pos),
        kv_caches=(jnp.asarray(ck0), jnp.asarray(cv0)),
        cache_len=jnp.asarray(cache_len, jnp.int32),
        attn_mask=None if am is None else jnp.asarray(am), key_valid=jnp.asarray(kv), **kw)
    tck, tcv = from_jax._to_tensor(ck0), from_jax._to_tensor(cv0)
    th, _ = ttfm.stack_forward(
        tparams, tcfg, torch.from_numpy(x), torch.from_numpy(pos), kv_caches=(tck, tcv),
        cache_len=(torch.tensor(cache_len) if isinstance(cache_len, list) else cache_len),
        attn_mask=None if am is None else torch.from_numpy(am),
        key_valid=torch.from_numpy(kv), **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    # The same columns written (the rest bit-identical to before), the
    # written keys within f32 rounding, or one e4m3 step for an f8 cache.
    for ours, ref, before in ((tck, jck, ck0), (tcv, jcv, cv0)):
        ours, ref = ours.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(ours != before, ref != before)
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_verify_attention_primitives_match_jax(kv_dtype):
    """``_gqa_scores`` / ``_gqa_mix`` of the T > 1 path against JAX's: an f8
    cache computes in bf16 (q rounded, probabilities rounded before the
    mix), others in f32; products summed in f32 in both."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    jdt = getattr(jnp, kv_dtype)
    k, v = (np.asarray(jnp.asarray(rng.standard_normal((2, 24, 2, 16)), jnp.float32).astype(jdt))
            for _ in range(2))
    ref = np.asarray(jtfm._gqa_scores(jnp.asarray(q), jnp.asarray(k)))
    ours = ttfm._gqa_scores(torch.from_numpy(q), from_jax._to_tensor(k)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(ref), axis=-1))
    ref = np.asarray(jtfm._gqa_mix(jnp.asarray(probs), jnp.asarray(v)))
    ours = ttfm._gqa_mix(torch.from_numpy(probs.copy()), from_jax._to_tensor(v)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "float8_e4m3fn"])
def test_a_device_slot_is_the_int_slot(kv_dtype, t):
    """A 0-d device slot under ``uniform_slot`` (the captured decode step's
    mode) writes the same cache bytes, builds the same key mask and returns
    the same hidden states as the same slot given as a Python int."""
    _, _, tcfg, tparams = _params(False)
    rng = np.random.default_rng(6)
    b, s, slot = 3, 24, 9
    dt = getattr(torch, kv_dtype)
    shape = (CFG["layers"], b, s, CFG["kv_heads"], CFG["head_dim"])
    ck0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    cv0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dt)
    kv = torch.from_numpy(rng.random((b, s)) < 0.6)
    x = torch.from_numpy((rng.standard_normal((b, t, CFG["hidden"])) * 0.5).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 40, (b, 1)) + np.arange(t)[None, :])
    out = {}
    for name, cache_len, kw in (("int", slot, {}),
                                ("device", torch.tensor(slot), {"uniform_slot": True})):
        ck, cv = ck0.clone(), cv0.clone()
        h, _ = ttfm.stack_forward(tparams, tcfg, x, pos, kv_caches=(ck, cv), cache_len=cache_len,
                                  key_valid=kv, **kw)
        mask = ttfm._attention_mask(b, t, s, cache_len, "cpu", None, kv, True, False)
        out[name] = (h, ck.view(torch.uint8), cv.view(torch.uint8), mask)
    for ours, ref in zip(out["device"], out["int"]):
        assert ours.shape == ref.shape and torch.equal(ours, ref)
    assert not torch.equal(out["int"][1], ck0.view(torch.uint8))  # the slot was written
    with pytest.raises(ValueError, match="not 0-d"):
        ttfm.stack_forward(tparams, tcfg, x, pos, kv_caches=(ck0.clone(), cv0.clone()),
                           cache_len=torch.tensor([slot] * b), key_valid=kv, uniform_slot=True)


@pytest.mark.parametrize("cache_len", [[5, 24, 30], 24], ids=["per-row", "0-d"])
def test_slots_without_uniform_slot_still_drop_out_of_range_columns(cache_len):
    """Without ``uniform_slot`` a 0-d tensor slot is expanded per row as before,
    and a per-row slot past the cache writes nothing: its row's caches keep
    every byte, the in-range row's slot alone changes."""
    _, _, tcfg, tparams = _params(False)
    rng = np.random.default_rng(7)
    b, s = 3, 24
    shape = (CFG["layers"], b, s, CFG["kv_heads"], CFG["head_dim"])
    ck0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cv0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    ck, cv = ck0.clone(), cv0.clone()
    x = torch.from_numpy((rng.standard_normal((b, 1, CFG["hidden"])) * 0.5).astype(np.float32))
    pos = torch.zeros((b, 1), dtype=torch.int64)
    kv = torch.ones((b, s), dtype=torch.bool)
    ttfm.stack_forward(tparams, tcfg, x, pos, kv_caches=(ck, cv),
                       cache_len=torch.tensor(cache_len), key_valid=kv, slot_causal=False)
    changed = (ck != ck0).flatten(3).any(-1).any(0)  # (B, S): columns written
    want = torch.zeros((b, s), dtype=torch.bool)
    if isinstance(cache_len, list):
        want[0, 5] = True
    assert torch.equal(changed, want) and torch.equal((cv != cv0).flatten(3).any(-1).any(0), want)


def test_scatter_rows_drops_out_of_range_columns():
    """Dropped entries leave every other column as it was; a row whose
    columns all fall outside keeps its contents."""
    buf = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    cols = torch.tensor([[2, 3, 4, 5], [4, 5, 6, 7], [-1, 0, 1, 2]])
    vals = -torch.arange(1, 13, dtype=torch.float32).reshape(3, 4)
    keep = torch.tensor([[True] * 4, [True] * 4, [True, True, False, True]])
    ttfm.scatter_rows(buf, cols, vals, keep)
    assert buf.tolist() == [[0, 1, -1, -2], [4, 5, 6, 7], [-10, 9, -12, 11]]


def test_unported_modes_raise():
    """``kv_window`` raises. ``sp_mesh`` is ported (spawned worlds in
    ``test_torch_port_parallel_ranks.py``); a forward other than a fused
    prefill into an empty cache ignores it, as JAX's does, so a decode step
    with it computes what one without it does."""
    tcfg = ttfm.TransformerConfig(**CFG, dtype=torch.float32)
    tparams = _params(False)[3]
    x = torch.zeros((2, 1, CFG["hidden"]))
    pos = torch.zeros((2, 1), dtype=torch.int64)
    kv = torch.ones((2, 8), dtype=torch.bool)

    def caches():
        return ttfm.make_kv_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")

    with pytest.raises(NotImplementedError, match="whole cache"):
        ttfm.stack_forward(tparams, tcfg, x, pos, kv_caches=caches(), cache_len=1,
                           key_valid=kv, kv_window=4)
    ref, _ = ttfm.stack_forward(tparams, tcfg, x, pos, kv_caches=caches(), cache_len=1,
                                key_valid=kv)
    out, _ = ttfm.stack_forward(tparams, tcfg, x, pos, kv_caches=caches(), cache_len=1,
                                key_valid=kv, sp_mesh=object())
    assert torch.equal(out, ref)


def _cache_less_inputs(masked):
    rng = np.random.default_rng(3)
    b, t = 3, 10
    x = (rng.standard_normal((b, t, CFG["hidden"])) * 0.5).astype(np.float32)
    if not masked:
        return x, np.tile(np.arange(t), (b, 1)), None
    # Left-padded rows: their pad queries see no valid key at all.
    lens = [10, 6, 1]
    attn_mask = np.stack([np.arange(t) >= t - n for n in lens])
    pos = np.stack([np.maximum(np.arange(t) - (t - n), 0) for n in lens])
    return x, pos, attn_mask


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "left-padded"])
def test_cache_less_forward_matches_jax(masked):
    """``stack_forward(kv_caches=None)`` against JAX's scan over
    ``block_forward``: hidden states and the stacked (L, B, T, Hkv, D) K/V
    within 1e-5 at fp32. Pad queries whose keys are all masked average
    every key (the finite -1e30 fill), as in JAX: finite, never NaN."""
    jcfg, jparams, tcfg, tparams = _params(False)
    x, pos, attn_mask = _cache_less_inputs(masked)
    jh, (jk, jv) = jtfm.stack_forward(
        jparams, jcfg, jnp.asarray(x), jnp.asarray(pos),
        attn_mask=None if attn_mask is None else jnp.asarray(attn_mask))
    th, (tk, tv) = ttfm.stack_forward(
        tparams, tcfg, torch.from_numpy(x), torch.from_numpy(pos),
        attn_mask=None if attn_mask is None else torch.from_numpy(attn_mask))
    assert tuple(tk.shape) == (CFG["layers"], 3, 10, CFG["kv_heads"], CFG["head_dim"])
    assert bool(torch.isfinite(th).all())
    for ours, ref in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_cache_less_forward_gradients_match_jax():
    """The cache-less forward is differentiable: the gradient of a fixed
    projection of its output, with respect to the input and every block
    weight, matches ``jax.grad`` (atol 1e-5 + rtol 1e-4 at fp32; all-masked
    pad rows included)."""
    jcfg, jparams, tcfg, tparams = _params(False)
    x, pos, attn_mask = _cache_less_inputs(True)
    r = np.random.default_rng(4).standard_normal((3, 10, CFG["hidden"])).astype(np.float32)

    def jloss(params, x_):
        h, _ = jtfm.stack_forward(params, jcfg, x_, jnp.asarray(pos),
                                  attn_mask=jnp.asarray(attn_mask))
        return jnp.sum(h * r)

    jg_params, jg_x = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    blocks = tparams["blocks"]
    for w in blocks.values():
        w.requires_grad_(True)
    h, _ = ttfm.stack_forward(tparams, tcfg, tx, torch.from_numpy(pos),
                              attn_mask=torch.from_numpy(attn_mask))
    (h * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), atol=1e-5, rtol=1e-4)
    for name, w in blocks.items():
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg_params["blocks"][name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def test_block_forward_with_a_cache_raises():
    """As in JAX, cached attention belongs to ``stack_forward``."""
    tcfg = ttfm.TransformerConfig(**CFG, dtype=torch.float32)
    lp = {k: v[0] for k, v in _params(False)[3]["blocks"].items()}
    x = torch.zeros((1, 2, CFG["hidden"]))
    with pytest.raises(ValueError, match="stacked-cache path"):
        ttfm.block_forward(lp, tcfg, x, torch.zeros((1, 2), dtype=torch.int64),
                           kv_cache=(x, x))
