"""Port parity: int4 packing, the int4 and w8a8 matmuls' plain versions, and ``matmul``'s dispatch.

The CUDA kernels cannot run on the CPU; ``chip_smoke.py`` holds them against
these plain versions on the card (w8a8 bit for bit). Here the plain versions
and the port's ``models.quantization`` are held against the JAX package on
the same numpy inputs: ``pack_int4`` / ``quantize_host`` and the unpack bit
for bit, the w8a8 path bit for bit (also against the Pallas kernel in
interpret mode), the int4 path at 1e-5 in f32 and within two bf16 roundings
in bf16 (JAX rounds each half-dot to bf16 before adding them; the port keeps
one f32 accumulator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.models import quantization as jq
from rho_tts_tpu.ops.pallas import int4_matmul as ji4
from rho_tts_tpu.ops.pallas import w8a8_matmul as jw8
from rho_tts_tpu_torch.models import quantization as tq
from rho_tts_tpu_torch.ops.cuda import int4_matmul as ti4
from rho_tts_tpu_torch.ops.cuda import w8a8_matmul as tw8

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _weights(shape, seed):
    """Gaussian weights with exact-tie rows: .5 ratios after scaling by 7/absmax."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    col = w[..., :, 0]
    col[..., :] = 0.0
    col[..., 0] = 7.0  # absmax 7: scale exactly 1
    col[..., 1:5] = [0.5, -0.5, 2.5, -3.5]  # halves round to even
    return w


def _x(shape, seed, dt):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(JDT[dt]).astype(jnp.float32))  # representable in dt


@pytest.mark.parametrize("shape", [(64, 48), (2, 128, 40), (3, 2, 32, 8)])
def test_pack_int4_bit_identical_to_jax(shape):
    w = _weights(shape, 0)
    ref = ji4.pack_int4(jnp.asarray(w))
    ours = tq.pack_int4(torch.from_numpy(w))
    host = tq.quantize_host(w, "int4")
    ref_host = jq.quantize_host(w, "int4")
    for got in (ours["q4"].numpy(), host["q4"], ref_host["q4"]):
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, np.asarray(ref["q4"]))
    for got in (ours["s"].numpy(), host["s"], ref_host["s"]):
        np.testing.assert_array_equal(got, np.asarray(ref["s"]))
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros((3, 4)))
    with pytest.raises(ValueError):
        tq.quantize_host(np.zeros((3, 4)), "int4")


def test_unpack_identical_to_jax():
    q4 = np.arange(-128, 128, dtype=np.int8).reshape(64, 4)  # every byte value
    ours = ti4.unpack_int4(torch.from_numpy(q4)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(ji4._unpack_nibbles(jnp.asarray(q4))))
    assert ours.min() == -8 and ours.max() == 7 and ours.shape == (128, 4)


def _int8_weight(k, n, seed):
    jw = jq.quantize_weight(jnp.asarray(np.random.default_rng(seed).standard_normal((k, n)),
                                        jnp.float32))
    return jw, {key: torch.from_numpy(np.array(v)) for key, v in jw.items()}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_w8a8_identical_to_jax(dt, monkeypatch):
    """reference_w8a8_matmul and matmul with the flag set equal JAX's
    _w8a8_matmul exactly: same quantize, exact integer dot, same rescale order."""
    x = _x((3, 7, 64), 1, dt)
    x[0, 0, :4] = [127.0, 63.5, -0.5, 1.5]  # absmax 127: ties at .5
    jw, tw = _int8_weight(64, 40, 2)
    ref = np.asarray(jq._w8a8_matmul(jnp.asarray(x, JDT[dt]), jw["q"], jw["s"]), np.float32)
    xt = torch.from_numpy(x).to(TDT[dt])
    monkeypatch.setenv("RHO_TTS_TPU_W8A8_PREFILL", "1")
    ours = tq.matmul(xt, tw)
    assert ours.dtype == TDT[dt]
    np.testing.assert_array_equal(ours.float().numpy(), ref)
    # The plain version on the same int8 activations.
    xf = torch.from_numpy(x).to(TDT[dt]).float()
    sx = tq._div(xf.abs().amax(-1, keepdim=True).clamp_min(1e-8), 127.0)
    xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
    plain = tw8.reference_w8a8_matmul(xq.reshape(-1, 64), sx.reshape(-1, 1), tw["q"], tw["s"],
                                      TDT[dt])
    np.testing.assert_array_equal(plain.float().numpy().reshape(ref.shape), ref)


def test_w8a8_plain_identical_to_pallas_kernel():
    """The Pallas kernel in interpret mode, as tests/test_quantization.py runs it."""
    m, k, n = 256, 256, 512
    x = _x((m, k), 3, "bf16")
    jw, tw = _int8_weight(k, n, 4)
    xf = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), -1, keepdims=True), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    pallas = jw8.w8a8_matmul_kernel(xq, sx.astype(jnp.float32), jw["q"], jw["s"],
                                    jnp.bfloat16, interpret=True)
    ours = tw8.w8a8_matmul(torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(sx)),
                           tw["q"], tw["s"], torch.bfloat16)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(pallas, np.float32))


def test_w8a8_flag_gates_prefill_only(monkeypatch):
    """Flag on: T > 1 goes through w8a8; T == 1 (decode) stays weight-only."""
    x = torch.from_numpy(_x((2, 16, 64), 5, "f32"))
    _, tw = _int8_weight(64, 32, 6)
    off = tq.matmul(x, tw)
    monkeypatch.setenv("RHO_TTS_TPU_W8A8_PREFILL", "1")
    on = tq.matmul(x, tw)
    np.testing.assert_array_equal(on.numpy(), tq._w8a8_matmul(x, tw["q"], tw["s"]).numpy())
    assert not torch.equal(on, off)
    on1 = tq.matmul(x[:, :1], tw)
    monkeypatch.delenv("RHO_TTS_TPU_W8A8_PREFILL")
    np.testing.assert_array_equal(on1.numpy(), tq.matmul(x[:, :1], tw).numpy())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(5, 128, 64), (40, 256, 48)])
def test_int4_plain_matches_jax(dt, m, k, n):
    """Against JAX int4_matmul (dequant_matmul_reference on the CPU): 1e-5 in
    f32 (order of sums); in bf16 within two bf16 roundings of the half-dots
    plus the output's, bounded by u * (2 * sum|x||w| * s + 2 |ref|), u = 2**-8."""
    w = _weights((k, n), 7)
    x = _x((m, k), 8, dt)
    jp = ji4.pack_int4(jnp.asarray(w))
    ref = np.asarray(ji4.int4_matmul(jnp.asarray(x, JDT[dt]), jp["q4"], jp["s"]), np.float32)
    tp = tq.pack_int4(torch.from_numpy(w))
    ours = ti4.int4_matmul(torch.from_numpy(x).to(TDT[dt]), tp["q4"], tp["s"])
    assert ours.dtype == TDT[dt] and ours.shape == (m, n)
    ours = ours.float().numpy()
    if dt == "f32":
        np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    else:
        mag = (np.abs(x) @ np.abs(ti4.unpack_int4(tp["q4"]).numpy())) * tp["s"].numpy()
        bound = 2.0 ** -8 * (2 * mag + 2 * np.abs(ref))
        assert (np.abs(ours - ref) <= bound).all(), np.abs(ours - ref).max()


def test_quantize_stack_int4_and_bytes():
    blocks = {name: torch.randn((2, 64, 96)) for name in tq.QUANT_KEYS}
    blocks["attn_norm"] = torch.ones((2, 64))
    stack = {"blocks": blocks, "final_norm": torch.ones(64)}
    q4 = tq.quantize_stack(stack, "int4")
    q8 = tq.quantize_stack(stack, "int8")
    for name in tq.QUANT_KEYS:
        assert q4["blocks"][name]["q4"].shape == (2, 32, 96)
        assert q8["blocks"][name]["q"].dtype == torch.int8
    assert tq.quantize_stack(q4, "int8")["blocks"]["wo"] is q4["blocks"]["wo"]  # kept as is
    dense = tq.quantized_bytes(stack)
    assert tq.quantized_bytes(q4) < 0.55 * tq.quantized_bytes(q8) < 0.55 * dense * 0.55 * 2
    with pytest.raises(ValueError):
        tq.quantize_stack(stack, "int2")


def test_cpu_wrappers_take_the_plain_version_without_counting():
    before = (ti4.launches, tw8.launches)
    x = torch.randn((3, 64))
    tp = tq.pack_int4(torch.randn((64, 16)))
    out = ti4.int4_matmul(x[None], tp["q4"], tp["s"])  # leading dims kept
    assert out.shape == (1, 3, 16)
    np.testing.assert_array_equal(out[0].numpy(), ti4.reference_int4_matmul(x, tp["q4"],
                                                                           tp["s"]).numpy())
    xq = torch.randint(-127, 128, (3, 64), dtype=torch.int8)
    q = torch.randint(-127, 128, (64, 16), dtype=torch.int8)
    tw8.w8a8_matmul(xq, torch.rand((3, 1)), q, torch.rand(16), torch.float32)
    assert (ti4.launches, tw8.launches) == before
    with pytest.raises(ValueError):  # the kernels' checks want CUDA tensors
        ti4._check(x, tp["q4"], tp["s"])
    with pytest.raises(ValueError):
        tw8._check(xq, torch.rand((3, 1)), q, torch.rand(16), torch.float32)
