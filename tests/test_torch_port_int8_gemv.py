"""The int8 GEMV (``ops.cuda.int8_gemv``, ``csrc/int8_gemv.cu``) and its dispatch.

On the CPU: the plain version against an f64 computation; which int8
matmuls ``models.quantization.matmul`` sends to the kernel (a CUDA bf16
``x`` of at most 64 rows, no sum over several ranks) with the wrapper
stood in for; the CPU path bit-equal to the dequant route; the wrapper's
refusals; and the kernel's blocking emulated in plain Python and numpy
(test code only): the int8 -> bf16 bit trick for every byte, the planner,
the warps' weight loads reading whole sectors, and the whole launch (rows
of each step, A fragments of adjacent columns, warps, step groups, cluster
merge) against the f64 result.

On the card (``-m chip``; skipped without one): the kernel against the
plain version at the 1.7B's four decode shapes for 1, 5, 8 and 64 rows and
a ragged N, and two launches on the same inputs bit-equal. Run there with
``python -m pytest tests/test_torch_port_int8_gemv.py -m chip``.
"""

import struct
import types

import numpy as np
import pytest
import torch

from rho_tts_tpu_torch.models import quantization as tq
from rho_tts_tpu_torch.ops.cuda import int8_gemv as g8

torch.set_num_threads(1)  # several test workers share the cores

SMS = 132  # the H100's streaming multiprocessors
DECODE_SHAPES = [(2048, 6144), (6144, 2048), (2048, 4096), (2048, 2048)]  # (K, N) at 1.7B


def _weight(k, n, seed):
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32))
    return tq.quantize_weight(w / k ** 0.5)


def _x(shape, seed, dtype=torch.bfloat16):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# The plain version, the dispatch, the CPU path, the wrapper's checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", [(8, 256, 96), (1, 64, 16), (64, 128, 48)])
def test_plain_version_is_one_f32_sum_then_the_scale(dtype, m, k, n):
    """Against x @ (q * s) in f64: within the f32 sum's error, then one
    rounding to x's dtype."""
    qw = _weight(k, n, 1)
    x = _x((m, k), 2, dtype)
    out = g8.reference_int8_gemv(x, qw["q"], qw["s"])
    assert out.dtype == dtype and out.shape == (m, n)
    exact = x.double() @ (qw["q"].double() * qw["s"].double())
    mag = x.double().abs() @ (qw["q"].double().abs() * qw["s"].double())
    unit = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    bound = unit * exact.abs() + 2.0 ** -22 * k * mag
    assert ((out.double() - exact).abs() <= bound).all()


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on a card, to reach the dispatch."""

    @property
    def is_cuda(self):
        return True


def _routed(monkeypatch):
    calls = []

    def fake(x, q, s):
        calls.append(tuple(x.shape))
        return g8.reference_int8_gemv(x.as_subclass(torch.Tensor), q, s)

    monkeypatch.setattr(g8, "int8_gemv", fake)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return calls


ROUTES = {
    "decode-1": ((1, 1, 64), torch.bfloat16, True, None, True),
    "decode-8": ((8, 1, 64), torch.bfloat16, True, None, True),
    "rows-64": ((8, 8, 64), torch.bfloat16, True, None, True),
    "rows-65": ((65, 64), torch.bfloat16, True, None, False),
    "prefill": ((8, 256, 64), torch.bfloat16, True, None, False),
    "f32": ((8, 1, 64), torch.float32, True, None, False),
    "cpu": ((8, 1, 64), torch.bfloat16, False, None, False),
    "reduce-over-2": ((8, 1, 64), torch.bfloat16, True, 2, False),
    "reduce-over-1": ((8, 1, 64), torch.bfloat16, True, 1, True),
}


@pytest.mark.parametrize("case", list(ROUTES), ids=list(ROUTES))
def test_matmul_sends_few_bf16_rows_on_a_card_to_the_kernel(monkeypatch, case):
    shape, dtype, cuda, ranks, taken = ROUTES[case]
    calls = _routed(monkeypatch)
    qw = _weight(64, 32, 3)
    x = _x(shape, 4, dtype)
    if cuda:
        x = x.as_subclass(_CudaLike)
    reduce = None if ranks is None else types.SimpleNamespace(size=ranks, group=None)
    if ranks is not None and ranks > 1:  # a stand-in sum: this rank's part only
        monkeypatch.setattr(tq, "all_reduce_sum", lambda y, axis: y)
    before = tq.dequant_calls
    out = tq.matmul(x, qw, reduce=reduce)
    assert calls == ([shape] if taken else [])
    assert tq.dequant_calls - before == (0 if taken else 1)
    assert out.shape == (*shape[:-1], 32) and out.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(8, 1, 64), (2, 70, 64)])
def test_the_cpu_path_is_the_dequant_route_bit_for_bit(dtype, shape):
    qw = _weight(64, 40, 5)
    x = _x(shape, 6, dtype)
    launches = g8.launches
    ours = tq.matmul(x, qw)
    before = ((x @ qw["q"].to(dtype)).float() * qw["s"]).to(dtype)
    assert torch.equal(ours, before)
    assert g8.launches == launches


def test_the_wrapper_runs_the_plain_version_on_the_cpu_without_counting():
    qw = _weight(64, 32, 7)
    x = _x((2, 3, 64), 8)
    launches = g8.launches
    out = g8.int8_gemv(x, qw["q"], qw["s"])
    assert out.shape == (2, 3, 32) and g8.launches == launches
    assert torch.equal(out, g8.reference_int8_gemv(x, qw["q"], qw["s"]))
    with pytest.raises(RuntimeError, match="no backward"):
        g8.int8_gemv(x.float().requires_grad_(), qw["q"], qw["s"])


_GOOD = dict(x=lambda: _x((8, 64), 9), q=lambda: torch.zeros((64, 32), dtype=torch.int8),
             s=lambda: torch.ones(32))
REFUSALS = {
    "x-f32": (dict(x=lambda: _x((8, 64), 9, torch.float32)), TypeError),
    "x-f16": (dict(x=lambda: _x((8, 64), 9, torch.float16)), TypeError),
    "q-int32": (dict(q=lambda: torch.zeros((64, 32), dtype=torch.int32)), TypeError),
    "s-f64": (dict(s=lambda: torch.ones(32, dtype=torch.float64)), TypeError),
    "k-mismatch": (dict(q=lambda: torch.zeros((48, 32), dtype=torch.int8)), ValueError),
    "q-3d": (dict(q=lambda: torch.zeros((1, 64, 32), dtype=torch.int8)), ValueError),
    "rows-65": (dict(x=lambda: _x((65, 64), 9)), ValueError),
    "rows-0": (dict(x=lambda: _x((0, 64), 9)), ValueError),
    "n-ragged": (dict(q=lambda: torch.zeros((64, 24), dtype=torch.int8),
                      s=lambda: torch.ones(24)), ValueError),
    "k-ragged": (dict(x=lambda: _x((8, 60), 9), q=lambda: torch.zeros((60, 32),
                                                                        dtype=torch.int8)),
                 ValueError),
    "s-shape": (dict(s=lambda: torch.ones(31)), ValueError),
    "q-strided": (dict(q=lambda: torch.zeros((32, 64), dtype=torch.int8).t()), ValueError),
    "cpu": ({}, ValueError),  # every check passes but the device's
}


@pytest.mark.parametrize("case", list(REFUSALS), ids=list(REFUSALS))
def test_the_kernel_checks_refuse_what_it_does_not_take(case):
    over, err = REFUSALS[case]
    t = {name: over.get(name, make)() for name, make in _GOOD.items()}
    with pytest.raises(err, match="int8_gemv"):
        g8._check(t["x"], t["q"], t["s"])


# ---------------------------------------------------------------------------
# The kernel's blocking, emulated
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on Python ints (no sign modes)."""
    src = (x & 0xFFFFFFFF) | ((y & 0xFFFFFFFF) << 32)
    return sum(((src >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF) << (8 * i) for i in range(4))


def _bf16(bits):
    return struct.unpack("<f", struct.pack("<I", (bits & 0xFFFF) << 16))[0]


def _pair_bf16x2(lo, hi, b):
    """The kernel's ``pair_bf16x2``: (value of the low half, of the high half)."""
    p = _byte_perm(lo, hi, b | ((b + 4) << 8))
    big = (p & 0x007F007F) | 0x43004300
    sign = (p & 0x00800080) | 0x43004300
    # fma.rn.bf16x2(sign, -1, big): both halves exact, checked below
    return tuple(_bf16(big >> s) - _bf16(sign >> s) for s in (0, 16))


def test_the_bit_trick_gives_every_int8_value_exactly():
    values = list(range(-128, 128))
    for b in range(4):
        for i, v in enumerate(values):
            w = values[(7 * i + 3) % 256]
            lo = sum(((v if k == b else 0x5A) & 0xFF) << (8 * k) for k in range(4))
            hi = sum(((w if k == b else 0xA5) & 0xFF) << (8 * k) for k in range(4))
            assert _pair_bf16x2(lo, hi, b) == (v, w)
    # the two terms are bf16 values in [128, 256): their difference is exact
    for v in values:
        big, sign = 128 + (v & 0x7F), 128 + (v & 0x80)
        assert big == _bf16(0x4300 | (v & 0x7F)) and sign == _bf16(0x4300 | (v & 0x80))


def _fits(splits):
    """A model of the card's answer: how many clusters of ``splits`` blocks
    fit at once, two blocks an SM and clusters packed within 8 GPCs of 16."""
    return 8 * (32 // splits)


@pytest.mark.parametrize("k,n", DECODE_SHAPES + [(1024, 3072), (4096, 1024), (2000, 1936),
                                                  (64, 96), (32, 16), (6144, 16), (8, 16)])
@pytest.mark.parametrize("fits", [None, _fits], ids=["unasked", "asked"])
def test_the_plan_covers_every_row_once_in_one_wave(k, n, fits):
    splits, slice_ = g8.plan(k, n, SMS, fits)
    assert 1 <= splits <= g8.MAX_SPLITS and slice_ % g8.STEP_ROWS == 0
    assert (splits - 1) * slice_ < k <= splits * slice_  # every split non-empty
    tiles = -(-n // g8.COLS)
    assert splits == 1 or tiles * splits <= SMS
    assert fits is None or splits == 1 or fits(splits) >= tiles


def test_the_plan_at_the_decode_shapes():
    """One block an SM at most: w_gate / w_up in 2 splits, w_down and wo in 6,
    wqkv in 4."""
    got = [g8.plan(k, n, SMS, _fits) for k, n in DECODE_SHAPES]
    assert got == [(2, 1024), (6, 1024), (4, 512), (6, 352)]


def _tiling(nt):
    tj = 8 if nt <= 2 else 4 if nt <= 4 else 2
    p = 8 // tj
    return tj, p, 8 // p


@pytest.mark.parametrize("nt", [1, 2, 3, 4, 5, 8])
def test_a_warps_weight_load_reads_whole_sectors(nt):
    """A warp's load of one of the four rows of a step: the 32 lanes read
    4 rows x 8 lanes x 2 TJ bytes, each row's share one aligned, contiguous
    run of whole 32-byte sectors (whole 128-byte lines at TJ = 8)."""
    tj, p, _ = _tiling(nt)
    n = 6144
    for pc in range(p):
        for d in (0, 1, 8, 9):
            runs = {}
            for lane in range(32):
                g, t = lane // 4, lane % 4
                addr = (2 * t + d) * n + pc * 16 * tj + 2 * tj * g
                runs.setdefault(2 * t + d, []).append(addr)
            assert len(runs) == 4
            for addrs in runs.values():
                lo, hi = min(addrs), max(addrs) + 2 * tj
                assert sorted(addrs) == list(range(lo, hi, 2 * tj))
                assert lo % 32 == 0 and (hi - lo) % 32 == 0 and hi - lo == 16 * tj


def _emulate(x, q, s, splits, slice_):
    """The kernel's launch in plain Python: (M, N) f32 before the bf16 rounding."""
    m, k = x.shape
    n = q.shape[1]
    nt_n = -(-m // 8)
    tj, p, sg_n = _tiling(nt_n)
    tok = 8 * nt_n
    x16 = (x.view(np.uint32) >> 16).astype(np.int64)  # x holds bf16 values
    qb = q.astype(np.int64) & 0xFF
    out = np.zeros((m, n), np.float32)

    def word(row, col, row_end):  # the 4 bytes at (row, col..col+3), 0 past the split
        if row >= row_end or col >= n:
            return 0
        return sum(int(qb[row, col + i]) << (8 * i) for i in range(4))

    def xpair(mr, kc, row_end):  # x[mr, kc], x[mr, kc + 1] as bf16x2 bits, 0 outside
        if mr >= m or kc >= row_end:
            return 0
        return int(x16[mr, kc]) | (int(x16[mr, kc + 1]) << 16)

    for bx in range(-(-n // 128)):
        n0 = bx * 128
        parts = []
        for split in range(splits):
            i0 = split * slice_
            row_end = min(k, i0 + slice_)
            steps = -(-max(0, row_end - i0) // 16)
            regs = 4 * nt_n * tj
            red = np.zeros((8, 32, regs + 1), np.float32)  # each warp's lanes' accumulators
            for warp in range(8):
                pc, sg = warp % p, warp // p
                acc = np.zeros((nt_n, tj, 16, 8), np.float32)
                for st in range(sg, steps, sg_n):
                    r0 = i0 + 16 * st
                    a = np.zeros((tj, 16, 16), np.float32)
                    b = np.zeros((nt_n, 16, 8), np.float32)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        cb = n0 + pc * 16 * tj + 2 * tj * g
                        rows = [r0 + 2 * t + d for d in (0, 1, 8, 9)]
                        w = [[word(r, cb + 4 * i, row_end) for i in range(max(1, tj // 2))]
                             for r in rows]
                        for j in range(tj):
                            qd, byte = j // 2, 2 * (j % 2)
                            for h in range(2):  # mma rows g (h = 0) and g + 8
                                lo = _pair_bf16x2(w[0][qd], w[1][qd], byte + h)
                                hi = _pair_bf16x2(w[2][qd], w[3][qd], byte + h)
                                a[j, g + 8 * h, 2 * t:2 * t + 2] = lo
                                a[j, g + 8 * h, 2 * t + 8:2 * t + 10] = hi
                        for nt in range(nt_n):
                            for k0 in (2 * t, 2 * t + 8):
                                bits = xpair(8 * nt + g, r0 + k0, row_end)
                                pair = [(bits & 0xFFFF) << 16, (bits >> 16) << 16]
                                b[nt, k0:k0 + 2, g] = np.array(pair, np.uint32).view(np.float32)
                    for nt in range(nt_n):
                        for j in range(tj):
                            acc[nt, j] += a[j] @ b[nt]
                for nt in range(nt_n):  # mma (row i, column c): lane (i % 8, c // 2)
                    for j in range(tj):
                        for i in range(16):
                            for c in range(8):
                                reg = (nt * tj + j) * 4 + 2 * (i // 8) + c % 2
                                red[warp, 4 * (i % 8) + c // 2, reg] = acc[nt, j, i, c]
            part = np.zeros((tok, 128), np.float32)
            for tk in range(tok):  # the kernel's index arithmetic, step groups in order
                for col in range(128):
                    cc = col % (16 * tj)
                    lane = 4 * (cc // (2 * tj)) + (tk % 8) // 2
                    reg = ((tk // 8) * tj + (cc % (2 * tj)) // 2) * 4 + 2 * (cc % 2) + tk % 2
                    for r in range(sg_n):
                        part[tk, col] += red[r * p + col // (16 * tj), lane, reg]
            parts.append(part)
        total = np.zeros((tok, 128), np.float32)
        for part in parts:  # split order
            total += part
        cols = min(128, n - n0)
        out[:, n0:n0 + cols] = total[:m, :cols] * s[n0:n0 + cols]
    return out


@pytest.mark.parametrize("m,k,n", [(5, 96, 256), (13, 72, 144), (33, 64, 128), (64, 40, 16)],
                         ids=["tj8", "tj8-two-tiles-ragged", "tj2", "tj2-partial-step"])
def test_the_emulated_launch_gives_the_product(m, k, n):
    """Every weight byte lands in the A fragment of its column and row, x in
    the B fragment of its row, each product once: the launch's sum equals
    x @ q in f64 to f32 accuracy, then times s."""
    qw = _weight(k, n, 10 + m)
    x = _x((m, k), 11 + m).float().numpy()
    q = qw["q"].numpy()
    s = qw["s"].numpy()
    splits, slice_ = g8.plan(k, n, SMS)
    if k > 32:
        splits, slice_ = 2, -(-k // 32) * 16  # two K-splits, whatever the planner says
    got = _emulate(x, q, s, splits, slice_)
    exact = (x.astype(np.float64) @ q.astype(np.float64)) * s
    mag = (np.abs(x).astype(np.float64) @ np.abs(q).astype(np.float64)) * s
    assert (np.abs(got - exact) <= (k + 2) * 2.0 ** -23 * mag + 1e-30).all()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("m", [1, 5, 8, 64])
@pytest.mark.parametrize("k,n", DECODE_SHAPES + [(2048, 2000)], ids=lambda v: str(v))
def test_the_kernel_matches_the_plain_version_and_repeats(cuda_card, m, k, n):
    """Within one bf16 ulp of the largest output (both round an f32 sum of
    the same products, in other orders); two launches bit-equal (the
    K-splits merge in a fixed order); launches counted."""
    gen = torch.Generator(device=cuda_card).manual_seed(m * 7919 + k + n)
    w = torch.randn((k, n), generator=gen, device=cuda_card) / k ** 0.5
    qw = tq.quantize_weight(w)
    x = torch.randn((m, k), generator=gen, device=cuda_card).to(torch.bfloat16)
    launches = g8.launches
    out = g8.int8_gemv(x, qw["q"], qw["s"])
    again = g8.int8_gemv(x, qw["q"], qw["s"])
    ref = g8.reference_int8_gemv(x, qw["q"], qw["s"])
    torch.cuda.synchronize()
    assert g8.launches - launches == 2
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert torch.equal(out, again)
    scale = ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * scale
