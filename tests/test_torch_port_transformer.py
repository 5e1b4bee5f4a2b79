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

CFG = dict(hidden=64, layers=2, q_heads=4, kv_heads=2, head_dim=16, ffn=128)


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("RHO_TTS_TPU_FUSED_ATTENTION", "1")
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_KERNEL", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _params(quant):
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
        params = jq.quantize_stack(params, "int8")
    tparams = from_jax.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, ttfm.TransformerConfig(**CFG, dtype=torch.float32), tparams


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_stack_forward_prefill_then_decode(quant, jax_kernels):
    """fp32 with an f32 cache: 1e-4, the port's fp32 parity tolerance
    (tests/test_torch_oracle.py); the attention order of sums differs."""
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
    with pytest.raises(NotImplementedError):
        tq.matmul(torch.from_numpy(x), {"q4": None, "s": None})


def test_unported_modes_raise():
    tcfg = ttfm.TransformerConfig(**CFG, dtype=torch.float32)
    tparams = _params(False)[3]
    x = torch.zeros((2, 1, CFG["hidden"]))
    pos = torch.zeros((2, 1), dtype=torch.int64)
    caches = ttfm.make_kv_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    kv = torch.ones((2, 8), dtype=torch.bool)
    for kwargs in (
        dict(kv_caches=None),
        dict(kv_caches=caches, cache_len=torch.tensor([1, 2]), key_valid=kv),
        dict(kv_caches=caches, cache_len=1, key_valid=kv, slot_causal=False),
        dict(kv_caches=caches, cache_len=1, key_valid=kv, kv_window=4),
        dict(kv_caches=caches, cache_len=1, key_valid=kv, block_causal=True),
    ):
        with pytest.raises(NotImplementedError):
            ttfm.stack_forward(tparams, tcfg, x, pos, **kwargs)
    with pytest.raises(NotImplementedError):  # multi-token forward into a used cache
        ttfm.stack_forward(tparams, tcfg, torch.zeros((2, 3, CFG["hidden"])),
                           torch.zeros((2, 3), dtype=torch.int64), kv_caches=caches,
                           cache_len=2, key_valid=kv, fused_prefill=True)
