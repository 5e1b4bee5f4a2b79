"""The int4 and w8a8 kernels' blocking, emulated in plain PyTorch, vs the JAX package.

``csrc/int4_matmul.cu`` runs decode as a GEMV whose K-splits of one column
tile form a thread block cluster: each split sums its packed rows in f32,
and the splits are merged in split order, then scaled and rounded once.
Prefill (bf16, M > 16) swaps the operands (out^T = W^T x^T): 64 packed rows
a stage, the low-nibble and high-nibble half-products of a stage going into
one f32 accumulator. Both unpack the nibbles with bit operations: bf16 from
``0x4300 | nibble`` minus 136 (tensor-core paths), f32 from the 2^23 magic
number (the f32 GEMV), and both feed the tensor cores an A fragment whose
rows are chosen so that one 32-bit shared load per packed row serves two
m16 tiles. ``csrc/w8a8_matmul.cu`` swaps the operands the same way with
128-byte K stages, gathering each A register's four k-consecutive bytes by
a 4x4 byte transpose.

The CUDA kernels cannot run on the CPU, so these tests emulate that
blocking and those bit operations (test code only: nothing in the port
calls it) and hold them against the JAX package on the same numpy inputs:
its ``dequant_matmul_reference`` and ``int4_matmul``, and the Pallas w8a8
kernel in interpret mode. They also check the wrappers' planners and that
the build names a library after the shared headers too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.ops.pallas import int4_matmul as ji4
from rho_tts_tpu.ops.pallas import w8a8_matmul as jw8
from rho_tts_tpu_torch.models import quantization as tq
from rho_tts_tpu_torch.ops.cuda import _build
from rho_tts_tpu_torch.ops.cuda import int4_matmul as ti4
from rho_tts_tpu_torch.ops.cuda import w8a8_matmul as tw8

SMS = 132  # the H100's streaming multiprocessors
SMEM = 232_448  # bytes of shared memory a block may use on the H100
DECODE_SHAPES = [(2048, 6144), (6144, 2048), (2048, 4096), (2048, 2048)]  # (K, N) at 1.7B
TINY_SHAPES = [(64, 128), (64, 64), (128, 64)]  # the tiny preset's (K, N)


def _x(shape, seed, dt=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dt)


def _packed(k, n, seed):
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32)
    return tq.pack_int4(torch.from_numpy(w))


# ---------------------------------------------------------------------------
# Bit operations of the kernels, emulated on Python integers
# ---------------------------------------------------------------------------


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    ``(s >> 4i) & 7`` of the eight bytes of (x, y), x's first."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(s >> (4 * i)) & 7] << (8 * i) for i in range(4))


def pair_bytes(p, q, c):
    return byte_perm(p, q, c | (c << 4) | ((4 + c) << 8) | ((4 + c) << 12))


def bf16x2_of_nibbles(h):
    """``nibbles_bf16x2`` before its subtract, as two bf16 values: the bits
    ``(h & 0x000F000F) ^ 0x43084308`` viewed as a bf16 pair, minus 136."""
    bits = torch.tensor([(h & 0x000F000F) ^ 0x43084308], dtype=torch.int64).to(torch.int32)
    pair = bits.view(torch.int16).view(torch.bfloat16).float()
    return pair - 136.0


def signed_nibble(b, hi):
    v = (b >> 4) & 0xF if hi else b & 0xF
    return v - 16 if v >= 8 else v


@pytest.mark.parametrize("hi", [False, True])
def test_nibble_to_bf16_bits_exact(hi):
    """All 16 nibble values in both halves of a packed byte, in both 16-bit
    lanes: 0x4300 | (v ^ 8) is bf16(136 + v), and the subtract gives v."""
    for lo_byte in range(256):
        for hi_byte in (0, 0x5A, 0xFF, lo_byte ^ 0x3C):
            p = lo_byte | (hi_byte << 16)
            h = p >> 4 if hi else p
            got = bf16x2_of_nibbles(h).tolist()
            assert got == [signed_nibble(lo_byte, hi), signed_nibble(hi_byte, hi)]


def test_nibble_to_f32_magic_exact():
    """The f32 GEMV: (v ^ 8) in the mantissa of 2^23, minus 2^23 + 8."""
    for b in range(256):
        for hi in (False, True):
            u = (((b >> 4) if hi else b) & 0xF) ^ 0x8
            bits = torch.tensor([0x4B000000 | u], dtype=torch.int64).to(torch.int32)
            val = bits.view(torch.float32).item() - 8388616.0
            assert val == signed_nibble(b, hi)


def _word(tile, r, c0):
    """The little-endian 32-bit word of bytes tile[r, c0:c0+4]."""
    return sum(int(tile[r, c0 + i]) << (8 * i) for i in range(4))


def test_int4_a_fragments_layout():
    """One 16-row step of a warp's 32 packed columns: each thread's lo and hi
    A fragments of tiles tau = 0, 1 hold exactly the nibbles of wgmma row
    rho (rows g, g+8 of warp 0) = column col + 2 tau + h, k pairs (2t, 2t+1)
    and (2t+8, 2t+9), as mma.sync / wgmma's A layout wants them."""
    rng = np.random.default_rng(0)
    tile = rng.integers(0, 256, size=(16, 32), dtype=np.int64)  # packed bytes [row][col]
    for g in range(8):
        for t in range(4):
            col = 4 * g
            w0, w1, w8, w9 = (_word(tile, 2 * t + d, col) for d in (0, 1, 8, 9))
            for tau in range(2):
                for h in range(2):
                    c = 2 * tau + h
                    p01, p89 = pair_bytes(w0, w1, c), pair_bytes(w8, w9, c)
                    n = col + c  # column of rows g (h = 0) / g + 8 (h = 1)
                    for half, shift in ((False, 0), (True, 4)):
                        a_k01 = bf16x2_of_nibbles(p01 >> shift).tolist()  # register h
                        a_k89 = bf16x2_of_nibbles(p89 >> shift).tolist()  # register 2 + h
                        assert a_k01 == [signed_nibble(int(tile[2 * t + d, n]), half) for d in (0, 1)]
                        assert a_k89 == [signed_nibble(int(tile[2 * t + d, n]), half) for d in (8, 9)]


def transpose4(r):
    lo01, hi01 = byte_perm(r[0], r[1], 0x5140), byte_perm(r[0], r[1], 0x7362)
    lo23, hi23 = byte_perm(r[2], r[3], 0x5140), byte_perm(r[2], r[3], 0x7362)
    return [byte_perm(lo01, lo23, 0x5410), byte_perm(lo01, lo23, 0x7632),
            byte_perm(hi01, hi23, 0x5410), byte_perm(hi01, hi23, 0x7632)]


def test_w8a8_a_fragments_layout():
    """One 32-byte k step of the w8a8 kernel: the 4x4 byte transpose gives
    each A register four k-consecutive bytes of one column; register h of
    tile tau is column col + 2 tau + h at k = 4t..4t+3, register 2 + h the
    same column at k = 16 + 4t..16 + 4t + 3."""
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 256, size=(32, 32), dtype=np.int64)  # q bytes [k][n]
    for g in range(8):
        for t in range(4):
            col = 4 * g
            c0 = transpose4([_word(tile, 4 * t + i, col) for i in range(4)])
            c1 = transpose4([_word(tile, 16 + 4 * t + i, col) for i in range(4)])
            for tau in range(2):
                regs = [c0[2 * tau], c0[2 * tau + 1], c1[2 * tau], c1[2 * tau + 1]]
                for j, reg in enumerate(regs):
                    n = col + 2 * tau + j % 2
                    k0 = 4 * t + 16 * (j // 2)
                    assert [(reg >> (8 * i)) & 0xFF for i in range(4)] == \
                        [int(tile[k0 + i, n]) for i in range(4)]


def swz128(row, col):
    return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15)


@pytest.mark.parametrize("rows", [(0, 1, 8, 9), (0, 1, 2, 3)])
def test_swizzled_weight_loads_conflict_free(rows):
    """The 32-bit shared loads of the prefill kernels' weight tiles (int4:
    packed rows 2t + {0, 1, 8, 9}; w8a8: k = 4t + {0..3}) at columns 4g:
    with the 128-byte swizzle the 32 lanes of each load hit 32 banks (int4)
    or at most 2 lanes a bank (w8a8), and every swizzled offset is distinct."""
    step = 2 if rows == (0, 1, 8, 9) else 4
    worst = 1 if step == 2 else 2
    for d in rows:
        banks = [(swz128(step * t + d, 4 * g) // 4) % 32 for g in range(8) for t in range(4)]
        assert max(banks.count(b) for b in set(banks)) <= worst
    offsets = {swz128(r, c) for r in range(64) for c in range(0, 128, 4)}
    assert len(offsets) == 64 * 32


# ---------------------------------------------------------------------------
# The int4 GEMV: planner and order of sums
# ---------------------------------------------------------------------------


def gemv_smem(m, ct, slice_, x_dtype=torch.bfloat16):
    """Dynamic shared memory of a GEMV block, as ``launch_gemv`` sizes it."""
    if x_dtype == torch.float32:
        cap = min(slice_, 512)
        return 8 * ct * 4 + max(cap * (ct + 64), 8192 * 8)
    tok = 16 if m > 8 else 8
    cap = min(-(-slice_ // 16) * 16, 512)
    row_groups = 8 // (ct // 32)
    return (tok * ct * 4 + cap * (ct + 16) + 2 * tok * (cap + 8) * 2
            + (row_groups * tok * ct * 4 if row_groups > 1 else 0))


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_gemv_plan_fills_the_card(k, n):
    kh = k // 2
    ct, cluster, slice_ = ti4.plan_gemv(5, kh, n, SMS)
    assert ct in (64, 128) and 1 <= cluster <= ti4.MAX_CLUSTER
    assert -(-n // ct) * cluster >= SMS  # every SM gets a block
    assert slice_ % 16 == 0 and (cluster - 1) * slice_ < kh <= cluster * slice_
    assert gemv_smem(5, ct, slice_) <= SMEM
    assert ti4.plan(torch.bfloat16, 5, kh, n, SMS) == ("gemv", ct, cluster, slice_)


@pytest.mark.parametrize("m", [1, 5, 16, 70])
@pytest.mark.parametrize("k,n", TINY_SHAPES + [(2000, 100), (30, 8)])
def test_gemv_plan_valid_at_small_widths(m, k, n):
    kh = k // 2
    for x_dtype in (torch.bfloat16, torch.float32):
        ct, cluster, slice_ = ti4.plan_gemv(m, kh, n, SMS)
        assert ct in (64, 128) and 1 <= cluster <= ti4.MAX_CLUSTER
        assert (cluster - 1) * slice_ < kh <= cluster * slice_  # every split non-empty
        rows = sorted(r for i in range(cluster) for r in range(i * slice_, min(kh, (i + 1) * slice_)))
        assert rows == list(range(kh))  # every packed row exactly once
        assert gemv_smem(m, ct, slice_, x_dtype) <= SMEM


def emulate_gemv(x, q4, s, cluster, slice_):
    """The GEMV's order of sums: per split an f32 sum over its packed rows,
    both halves into one accumulator; the splits added in split order; then
    ``* s`` and one cast."""
    kh = q4.shape[0]
    w = ti4.unpack_int4(q4)  # (K, N): rows [0, kh) low nibbles, [kh, K) high
    xf = x.float()
    total = torch.zeros((x.shape[0], q4.shape[1]))
    for sp in range(cluster):
        i0, i1 = sp * slice_, min(kh, (sp + 1) * slice_)
        part = xf[:, i0:i1] @ w[i0:i1] + xf[:, kh + i0:kh + i1] @ w[kh + i0:kh + i1]
        total = total + part
    return (total * s).to(x.dtype)


@pytest.mark.parametrize("m,k,n", [(5, 2048, 256), (5, 6144, 128), (16, 256, 64), (3, 64, 128),
                                   (70, 128, 64)])
def test_gemv_order_of_sums_f32(m, k, n):
    """f32: the emulated GEMV against JAX's dequant_matmul_reference (rel
    1e-5: the order of the f32 sums differs) and the port's plain version."""
    tp = _packed(k, n, 7)
    x = _x((m, k), 8)
    _, cluster, slice_ = ti4.plan_gemv(m, k // 2, n, SMS)
    ours = emulate_gemv(x, tp["q4"], tp["s"], cluster, slice_)
    ref = np.asarray(ji4.dequant_matmul_reference(jnp.asarray(x.numpy()),
                                                  jnp.asarray(tp["q4"].numpy()),
                                                  jnp.asarray(tp["s"].numpy())))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5 * scale)
    plain = ti4.reference_int4_matmul(x, tp["q4"], tp["s"])
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5 * scale)


def _bf16_bound(x, q4, s, ref):
    """test_torch_port_quant.py's bf16 tolerance: two bf16 roundings of the
    half-dots plus the output's, u * (2 * sum|x||w| * s + 2 |ref|), u = 2**-8."""
    mag = (x.float().abs() @ ti4.unpack_int4(q4).abs()) * s
    return 2.0 ** -8 * (2 * mag.numpy() + 2 * np.abs(ref))


@pytest.mark.parametrize("m,k,n", [(5, 2048, 128), (16, 512, 64)])
def test_gemv_order_of_sums_bf16(m, k, n):
    tp = _packed(k, n, 9)
    x = _x((m, k), 10, torch.bfloat16)
    _, cluster, slice_ = ti4.plan_gemv(m, k // 2, n, SMS)
    ours = emulate_gemv(x, tp["q4"], tp["s"], cluster, slice_).float().numpy()
    ref = np.asarray(ji4.int4_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(tp["q4"].numpy()), jnp.asarray(tp["s"].numpy())),
                     np.float32)
    assert (np.abs(ours - ref) <= _bf16_bound(x, tp["q4"], tp["s"], ref)).all()


# ---------------------------------------------------------------------------
# int4 prefill: swap-AB stages
# ---------------------------------------------------------------------------


def emulate_int4_prefill(x, q4, s, bt, cols=128):
    """out^T = W^T x^T in blocks of ``cols`` columns by ``bt`` tokens, 64
    packed rows a stage (the last zero-filled past K/2, rows past M zero):
    each stage adds its lo and hi half-products into one f32 accumulator;
    then ``* s`` and one rounding to bf16."""
    m, k = x.shape
    kh, n = q4.shape
    w = ti4.unpack_int4(q4)
    wlo, whi = w[:kh], w[kh:]
    xf = x.float()
    out = torch.empty((m, n), dtype=torch.bfloat16)
    stages = -(-kh // 64)
    pad = stages * 64 - kh
    for n0 in range(0, n, cols):
        for m0 in range(0, m, bt):
            xb = torch.zeros((bt, k))
            xb[: min(bt, m - m0)] = xf[m0:m0 + bt]
            xlo = torch.nn.functional.pad(xb[:, :kh], (0, pad))
            xhi = torch.nn.functional.pad(xb[:, kh:], (0, pad))
            wl = torch.nn.functional.pad(wlo[:, n0:n0 + cols], (0, 0, 0, pad))
            wh = torch.nn.functional.pad(whi[:, n0:n0 + cols], (0, 0, 0, pad))
            acc = torch.zeros((wl.shape[1], bt))  # (columns, tokens)
            for st in range(stages):
                i = slice(64 * st, 64 * st + 64)
                acc = acc + (wl[i].T @ xlo[:, i].T + wh[i].T @ xhi[:, i].T)
            tile = (acc.T * s[n0:n0 + cols]).to(torch.bfloat16)
            out[m0:m0 + bt, n0:n0 + cols] = tile[: min(bt, m - m0)]
    return out


@pytest.mark.parametrize("m,k,n", [(40, 256, 128), (70, 2000, 96), (130, 512, 384)])
def test_int4_prefill_tiling_bf16(m, k, n):
    """The emulated swap-AB stages against JAX's int4_matmul at bf16, within
    test_torch_port_quant.py's tolerance, for the block the planner picks."""
    tp = _packed(k, n, 11)
    x = _x((m, k), 12, torch.bfloat16)
    kind, bt = ti4.plan(torch.bfloat16, m, k // 2, n, SMS)
    assert kind == "wgmma"
    ours = emulate_int4_prefill(x, tp["q4"], tp["s"], bt).float().numpy()
    ref = np.asarray(ji4.int4_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(tp["q4"].numpy()), jnp.asarray(tp["s"].numpy())),
                     np.float32)
    assert (np.abs(ours - ref) <= _bf16_bound(x, tp["q4"], tp["s"], ref)).all()
    plain = ti4.reference_int4_matmul(x, tp["q4"], tp["s"]).float().numpy()
    np.testing.assert_allclose(ours, plain, rtol=2 ** -7, atol=1e-6)  # one bf16 rounding apart


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_int4_prefill_plan_at_1p7b(k, n):
    assert ti4.plan(torch.bfloat16, 640, k // 2, n, SMS) == ("wgmma", 128)
    assert ti4.plan(torch.bfloat16, 40, k // 2, n, SMS) == ("wgmma", 64)
    assert (k // 2) % 8 == 0 and n % 16 == 0  # TMA's 16-byte strides
    # f32 x, N % 16 != 0 and kh % 8 != 0 stay on the GEMV, at any M
    assert ti4.plan(torch.float32, 640, k // 2, n, SMS)[0] == "gemv"
    assert ti4.plan(torch.bfloat16, 640, k // 2, n - 4, SMS)[0] == "gemv"
    assert ti4.plan(torch.bfloat16, 640, k // 2 - 2, n, SMS)[0] == "gemv"


# ---------------------------------------------------------------------------
# w8a8: swap-AB stages, bit for bit
# ---------------------------------------------------------------------------


def emulate_w8a8(xq, sx, q, ws, out_dtype, bt):
    """out^T = q^T xq^T, 128 bytes of K a stage, exact integer sums in
    blocks of 128 columns by ``bt`` tokens; then (float(acc) * sx) * ws and
    one rounding."""
    m, k = xq.shape
    n = q.shape[1]
    acc = torch.zeros((n, m), dtype=torch.int64)
    for n0 in range(0, n, 128):
        for m0 in range(0, m, bt):
            for k0 in range(0, k, 128):
                acc[n0:n0 + 128, m0:m0 + bt] += (q[k0:k0 + 128, n0:n0 + 128].T.long()
                                                 @ xq[m0:m0 + bt, k0:k0 + 128].T.long())
    assert acc.abs().max() < 2 ** 31  # the kernel's s32 accumulators
    return ((acc.T.to(torch.int32).float() * sx) * ws).to(out_dtype)


@pytest.mark.parametrize("m,k,n", [(256, 256, 512), (256, 384, 256)])
def test_w8a8_tiling_identical_to_pallas_kernel(m, k, n):
    """The emulated w8a8 kernel, bit for bit against the Pallas kernel in
    interpret mode, as test_w8a8_plain_identical_to_pallas_kernel runs it."""
    rng = np.random.default_rng(m + k + n)
    x = np.array(jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(jnp.bfloat16)
                 .astype(jnp.float32))
    w = rng.standard_normal((k, n)).astype(np.float32)
    qw = tq.quantize_weight(torch.from_numpy(w))
    xf = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), -1, keepdims=True), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    pallas = jw8.w8a8_matmul_kernel(xq, sx.astype(jnp.float32), jnp.asarray(qw["q"].numpy()),
                                    jnp.asarray(qw["s"].numpy()), jnp.bfloat16, interpret=True)
    bt = tw8.plan(m, k, n, SMS)
    assert bt in (64, 128)
    ours = emulate_w8a8(torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(sx)), qw["q"],
                        qw["s"], torch.bfloat16, bt)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(pallas, np.float32))


@pytest.mark.parametrize("m,k,n,out_dtype", [(637, 256, 128, torch.bfloat16),
                                             (70, 96, 64, torch.float32)])
def test_w8a8_tiling_identical_to_plain_ragged(m, k, n, out_dtype):
    """Ragged M and K not a multiple of the 128-byte stage (zero-filled),
    f32 output: bit for bit against the plain version."""
    g = torch.Generator().manual_seed(m)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, generator=g)
    q = torch.randint(-127, 128, (k, n), dtype=torch.int8, generator=g)
    sx = torch.rand((m, 1), generator=g) / 100
    ws = torch.rand(n, generator=g) / 100
    bt = tw8.plan(m, k, n, SMS)
    ours = emulate_w8a8(xq, sx, q, ws, out_dtype, bt)
    assert torch.equal(ours, tw8.reference_w8a8_matmul(xq, sx, q, ws, out_dtype))


@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_w8a8_plan(k, n):
    bt = tw8.plan(640, k, n, SMS)
    assert bt in (64, 128) and k % 16 == 0 and n % 16 == 0
    assert tw8.plan(640, k, n - 4, SMS) == 0  # TMA cannot take N % 16 != 0: mma.sync


# ---------------------------------------------------------------------------
# The build
# ---------------------------------------------------------------------------


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh renames every library, so no stale one loads."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._library_path(tmp_path / "a.cu")
    assert first == _build._library_path(tmp_path / "a.cu")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._library_path(tmp_path / "a.cu") != first
