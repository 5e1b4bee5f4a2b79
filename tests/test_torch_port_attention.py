"""Port parity: the attention kernels' plain PyTorch versions vs the JAX package.

The CUDA kernels cannot run on the CPU; ``chip_smoke.py`` holds them against
these plain versions on the card. Here the plain versions are held against
the JAX Pallas kernels in interpret mode and their einsum references, on the
same numpy inputs. The wrappers are also checked to take the plain version
for CPU tensors without counting a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.ops.pallas import attention as jattn
from rho_tts_tpu.ops.pallas import decode_attention as jdec
from rho_tts_tpu_torch.ops.cuda import attention as tattn
from rho_tts_tpu_torch.ops.cuda import decode_attention as tdec


def _left_padded_mask(b, s, pads):
    return np.stack([np.arange(s) >= pads[i % len(pads)] for i in range(b)])


def _prefill_inputs(b=3, t=40, s=40, hq=4, hkv=2, d=32, pads=(0, 7, 40), seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v, _left_padded_mask(b, s, pads)


def _t(a, dtype=None):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x if dtype is None else x.to(dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,s", [(40, 40), (130, 130)])
def test_prefill_plain_matches_jax_f32(causal, t, s):
    """f32: 2e-5, the tolerance of tests/test_pallas_attention.py (same math,
    different summation order). Covers left-padded rows, a fully masked row
    (pad 40 of 40 / 130 keys) and S not a multiple of 128."""
    q, k, v, mask = _prefill_inputs(t=t, s=s)
    ours = tattn.fused_gqa_attention(_t(q), _t(k), _t(v), _t(mask), causal=causal).numpy()
    ref = np.asarray(jattn.reference_gqa_attention(q, k, v, jnp.asarray(mask), causal=causal))
    pallas = np.asarray(
        jattn.fused_gqa_attention(q, k, v, jnp.asarray(mask), causal=causal, interpret=True)
    )
    # Rows whose every key is masked average V; the Pallas kernel averages
    # over its 128-padded key axis instead, so compare those rows to the
    # einsum reference only.
    real = mask[:, None, :] & (np.tril(np.ones((t, s), bool)) if causal else np.ones((t, s), bool))
    has_key = real.any(-1)  # (B, T)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours[has_key], pallas[has_key], atol=2e-5, rtol=2e-5)
    assert np.isfinite(ours).all()


def test_prefill_plain_q_offset_matches_jax():
    """q_offset shifts the causal diagonal (sequence-parallel shards)."""
    q, k, v, mask = _prefill_inputs(t=24, s=72, pads=(0, 5))
    ours = tattn.fused_gqa_attention(_t(q), _t(k), _t(v), _t(mask), q_offset=48).numpy()
    pallas = np.asarray(
        jattn.fused_gqa_attention(q, k, v, jnp.asarray(mask), interpret=True, q_offset=48)
    )
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=2e-5)


def test_prefill_plain_matches_jax_bf16():
    """bf16 inputs and output: 2e-2, a few bf16 ulps at unit scale."""
    q, k, v, mask = _prefill_inputs(pads=(0, 3, 11))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jattn.reference_gqa_attention(jq, jk, jv, jnp.asarray(mask)), np.float32)
    tq, tk, tv = (_t(np.asarray(a, np.float32), torch.bfloat16) for a in (jq, jk, jv))
    ours = tattn.fused_gqa_attention(tq, tk, tv, _t(mask)).float().numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-2, rtol=2e-2)


def test_prefill_fully_masked_rows_finite():
    """A row with no valid key (a left-padded prompt row) averages V, no NaN."""
    q, k, v, mask = _prefill_inputs(pads=(40,))
    ours = tattn.fused_gqa_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(
        ours[0, 0, 0], v[0, :, 0].mean(0), atol=2e-5, rtol=2e-5
    )


def _decode_inputs(b=3, s=192, hq=4, hkv=2, d=64, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    valid_to = np.asarray([s, s // 2, 40])[:b]
    mask = np.arange(s)[None, :] < valid_to[:, None]  # ragged, serving-style
    mask[0, :3] = False  # and left padding
    return q, k, v, mask


@pytest.mark.parametrize("s", [192, 100])
def test_decode_plain_matches_jax_f32(s):
    """f32: 2e-5, the tolerance of tests/test_decode_attention.py."""
    q, k, v, mask = _decode_inputs(s=s)
    ours = tdec.decode_gqa_attention(_t(q), _t(k), _t(v), _t(mask)).numpy()
    pallas = np.asarray(jdec.decode_gqa_attention(q, k, v, jnp.asarray(mask), interpret=True))
    ref = np.asarray(jdec.reference_decode_attention(q, k, v, jnp.asarray(mask)))
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)


def test_decode_plain_f8_storage_matches_jax():
    """float8 e4m3 storage against the f32-upcast oracle: 2e-5, as in
    tests/test_decode_attention.py (the conversion itself is exact)."""
    q, k, v, mask = _decode_inputs()
    k8 = np.asarray(jnp.asarray(k, jnp.float8_e4m3fn).astype(jnp.float32))
    v8 = np.asarray(jnp.asarray(v, jnp.float8_e4m3fn).astype(jnp.float32))
    tk = _t(k).to(torch.float8_e4m3fn)
    tv = _t(v).to(torch.float8_e4m3fn)
    np.testing.assert_array_equal(tk.float().numpy(), k8)  # same e4m3 rounding
    ours = tdec.decode_gqa_attention(_t(q), tk, tv, _t(mask)).numpy()
    pallas = np.asarray(
        jdec.decode_gqa_attention(
            q, jnp.asarray(k, jnp.float8_e4m3fn), jnp.asarray(v, jnp.float8_e4m3fn),
            jnp.asarray(mask), interpret=True,
        )
    )
    ref = np.asarray(jdec.reference_decode_attention(q, k8, v8, jnp.asarray(mask)))
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=2e-5)


def test_decode_plain_matches_jax_bf16():
    """bf16 query and cache: 2e-2, a few bf16 ulps at unit scale."""
    q, k, v, mask = _decode_inputs()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jdec.reference_decode_attention(jq, jk, jv, jnp.asarray(mask)), np.float32)
    tq, tk, tv = (_t(np.asarray(a, np.float32), torch.bfloat16) for a in (jq, jk, jv))
    ours = tdec.decode_gqa_attention(tq, tk, tv, _t(mask)).float().numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-2, rtol=2e-2)


def test_cpu_tensors_take_plain_version_without_counting():
    q, k, v, mask = _prefill_inputs()
    p0, d0 = tattn.launches, tdec.launches
    out = tattn.fused_gqa_attention(_t(q), _t(k), _t(v), _t(mask))
    torch.testing.assert_close(
        out, tattn.reference_gqa_attention(_t(q), _t(k), _t(v), _t(mask)), rtol=0, atol=0
    )
    dq, dk, dv, dmask = _decode_inputs()
    out = tdec.decode_gqa_attention(_t(dq), _t(dk), _t(dv), _t(dmask))
    torch.testing.assert_close(
        out, tdec.reference_decode_attention(_t(dq), _t(dk), _t(dv), _t(dmask)), rtol=0, atol=0
    )
    assert (tattn.launches, tdec.launches) == (p0, d0)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    from rho_tts_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_kernel_library_name_tracks_source(tmp_path):
    """An edited source gets a new library name, so a stale build is never loaded."""
    from rho_tts_tpu_torch.ops.cuda import _build

    src = tmp_path / "k.cu"
    src.write_text("// one")
    first = _build._library_path(src)
    src.write_text("// two")
    assert _build._library_path(src) != first
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == {
        "attention", "decode_attention", "w8a8_matmul", "int4_matmul"}
