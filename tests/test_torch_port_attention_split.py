"""The attention kernels' blocking, emulated in plain PyTorch, vs the JAX package.

``csrc/decode_attention.cu`` cuts the key axis of each (row, KV head)
over the C blocks of one thread block cluster: each block walks its keys in
tiles of 32 with an online softmax, reading only the valid keys (its
mask read first), skips tiles with no valid key, and the blocks' states are
merged in rank order; a row with no valid key at all averages V over every
key once the cluster knows no block saw one.
``csrc/attention.cu`` (bf16) walks 64-key tiles with an online softmax,
skips the tiles past the causal diagonal of a 64-query block when the
batch row has a valid key at or before the block's first query, and feeds
P to the tensor cores as a hi + lo pair of bf16.

The CUDA kernels cannot run on the CPU, so these tests emulate that
blocking step by step (test code only: nothing in the port calls it) and
hold it against the JAX Pallas kernels in interpret mode and the einsum
references, on the same numpy inputs. They also check the decode
wrapper's cluster plan and the kernel's cut of the keys.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_tts_tpu.ops.pallas import attention as jattn
from rho_tts_tpu.ops.pallas import decode_attention as jdec
from rho_tts_tpu_torch.ops.cuda import attention as tattn
from rho_tts_tpu_torch.ops.cuda import decode_attention as tdec

torch.set_num_threads(1)  # several test workers share the cores

_FILL = -1e30


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Decode: a cluster of blocks a (row, KV head)
# ---------------------------------------------------------------------------

_TILE = 32  # keys a tile of the decode kernel


def _block_state(qg, kf, vf, valid, lo, hi, scale):
    """One block's walk over keys ``[lo, hi)``: tiles of 32 keys, a tile
    with no valid key skipped, an online softmax (running max, sum and
    acc). A tile holds only the valid keys (the others are zeros, their
    scores selected away). Returns ``(m (G,), l (G,), acc (G, D), saw a
    valid key)``."""
    group, d = qg.shape
    m = torch.full((group,), -math.inf)
    l = torch.zeros(group)
    acc = torch.zeros(group, d)
    for t0 in range(lo, hi, _TILE):
        keys = slice(t0, min(hi, t0 + _TILE))
        ok = valid[keys]
        if not bool(ok.any()):
            continue  # not copied, not computed
        kk = torch.where(ok[:, None], kf[keys], 0.0)
        vv = torch.where(ok[:, None], vf[keys], 0.0)
        sc = torch.where(ok, (qg @ kk.T) * scale, -math.inf)  # (G, n)
        m_new = torch.maximum(m, sc.max(dim=-1).values)
        p = torch.where(ok, torch.exp(sc - m_new[:, None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[:, None] + p @ vv
        m = m_new
    return m, l, acc, bool(valid[lo:hi].any())


def emulate_cluster_decode(q, k, v, mask, clusters):
    """The decode kernel's arithmetic, block by block, in f32.

    q ``(B,1,Hq,D)``, k/v ``(B,S,Hkv,D)``, mask ``(B,S)`` bool; block r of
    the cluster owns keys :func:`block_keys` ``(S, clusters, r)``. Returns
    ``(B,1,Hq,D)`` f32.
    """
    b, _, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, d).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((b, hkv, group, d))
    for bi in range(b):
        for h in range(hkv):
            ranges = [tdec.block_keys(s, clusters, r) for r in range(clusters)]
            states = [_block_state(qg[bi, h], kf[bi, :, h], vf[bi, :, h], mask[bi], lo, hi, scale)
                      for lo, hi in ranges]
            if not any(st[3] for st in states):
                # No block saw a valid key: the -1e30 fill weighs every key 1.
                states = [(torch.full((group,), -1e30), torch.full((group,), float(hi - lo)),
                           vf[bi, lo:hi, h].sum(dim=0).expand(group, d), False)
                          for lo, hi in ranges]
            mx = torch.stack([st[0] for st in states]).max(dim=0).values
            den = torch.zeros(group)
            num = torch.zeros(group, d)
            for m, l, acc, _ in states:  # rank order
                c = torch.where(m == -math.inf, 0.0, torch.exp(m - mx))
                den = den + l * c
                num = num + acc * c[:, None]
            out[bi, h] = num / torch.clamp(den, min=1e-30)[:, None]
    return out.reshape(b, 1, hq, d)


def _decode_inputs(s, kind, b=3, hq=4, hkv=2, d=32, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.arange(s)[None, :]
    slot = np.asarray([s - 1, (2 * s) // 3, s // 3])[:, None]
    pads = np.asarray([0, s // 5, 2])[:, None]
    if kind == "serving":  # left pads, keys past the slot masked
        mask = (pos >= pads) & (pos <= slot)
    elif kind == "no_key":  # row 1 has no valid key: it averages V over all S
        mask = (pos >= pads) & (pos <= slot)
        mask[1] = False
    else:  # "newest": only the newest slot of each row is valid
        mask = np.broadcast_to(pos == slot, (b, s)).copy()
    return q, k, v, mask


def _jax_decode(q, k, v, mask):
    pallas = np.asarray(jdec.decode_gqa_attention(q, k, v, jnp.asarray(mask), interpret=True))
    ref = np.asarray(jdec.reference_decode_attention(q, k, v, jnp.asarray(mask)))
    return pallas, ref


@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["serving", "no_key", "newest"])
@pytest.mark.parametrize("s", [100, 192])
def test_split_decode_emulation_matches_jax_f32(clusters, kind, s):
    """f32: 1e-5 (the same math, the sums in another order). S = 100 leaves
    blocks of 12-13 keys and a ragged last tile; S = 192 at C = 1 walks six
    tiles; the serving masks skip whole tiles and blocks; "no_key" takes the
    no-valid-key path."""
    q, k, v, mask = _decode_inputs(s, kind)
    ours = emulate_cluster_decode(_t(q), _t(k), _t(v), _t(mask), clusters).numpy()
    pallas, ref = _jax_decode(q, k, v, mask)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    # A row with no valid key averages V; the Pallas kernel averages over its
    # 128-padded key axis instead, so that row is held to the references only.
    has_key = mask.any(-1)
    np.testing.assert_allclose(ours[has_key], pallas[has_key], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        _t(ours), tdec.reference_decode_attention(_t(q), _t(k), _t(v), _t(mask)),
        atol=1e-5, rtol=1e-5,
    )
    if kind == "no_key":
        np.testing.assert_allclose(ours[1, 0, 0], v[1, :, 0].mean(0), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
def test_split_decode_emulation_f8_storage(clusters):
    """float8 e4m3 storage, converted to f32 as it is used: 1e-5 against the
    Pallas kernel on the same f8 cache and the reference on its f32 upcast."""
    q, k, v, mask = _decode_inputs(100, "serving")
    k8, v8 = _t(k).to(torch.float8_e4m3fn), _t(v).to(torch.float8_e4m3fn)
    ours = emulate_cluster_decode(_t(q), k8, v8, _t(mask), clusters).numpy()
    pallas = np.asarray(jdec.decode_gqa_attention(
        q, jnp.asarray(k, jnp.float8_e4m3fn), jnp.asarray(v, jnp.float8_e4m3fn),
        jnp.asarray(mask), interpret=True))
    ref = np.asarray(jdec.reference_decode_attention(
        q, k8.float().numpy(), v8.float().numpy(), jnp.asarray(mask)))
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, pallas, atol=1e-5, rtol=1e-5)


def test_cluster_decode_masked_keys_never_reach_the_output():
    """A masked key is never read: whatever it holds (here NaN and inf)
    never reaches the output."""
    q, k, v, mask = _decode_inputs(192, "serving")
    k, v = k.copy(), v.copy()
    k[~mask] = np.nan
    v[~mask] = np.inf
    ours = emulate_cluster_decode(_t(q), _t(k), _t(v), _t(mask), 4).numpy()
    ref = tdec.reference_decode_attention(_t(q), _t(np.where(mask[..., None, None], k, 0)),
                                          _t(np.where(mask[..., None, None], v, 0)), _t(mask))
    np.testing.assert_allclose(ours, ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("units", [1, 2, 5, 40, 300])
def test_plan_splits_covers_every_key_once(sms, units):
    """For S = 1..400: C is 1, 2, 4 or 8; every key in exactly one block, no
    empty block; the grid holds two blocks for every SM unless C is already
    8 or the blocks would hold fewer than 16 keys."""
    for s in range(1, 401):
        c = tdec.plan_clusters(s, units, sms)
        assert c in (1, 2, 4, 8) and c <= s
        owner = np.zeros(s, np.int64)
        for r in range(c):
            lo, hi = tdec.block_keys(s, c, r)
            assert hi > lo, (s, units, sms, c)
            owner[lo:hi] += 1
        assert (owner == 1).all(), (s, units, sms)
        assert c * units >= 2 * sms or c == 8 or 2 * c * tdec.MIN_KEYS > s, (s, units, sms, c)
        assert c == 1 or (c // 2) * units < 2 * sms, (s, units, sms, c)  # no larger than needed


def test_plan_splits_main_path():
    """The Qwen cells: B 8 x Hkv 8, a 448-slot cache (a 256-slot prompt
    bucket and 192 frames), 132 SMs: clusters of 8 blocks of 56 keys, 512
    blocks."""
    assert tdec.plan_clusters(448, 64, 132) == 8
    assert [tdec.block_keys(448, 8, r) for r in (0, 7)] == [(0, 56), (392, 448)]


@pytest.mark.parametrize("s,fit8,fit4,want", [
    (448, 64, 64, 8), (448, 63, 64, 4), (448, 60, 50, 2), (448, -1, -1, 2),
    (2112, 45, 92, 8), (2112, -1, 92, 4), (1000, 45, 92, 4)])
def test_plan_clusters_takes_no_more_blocks_than_fit_at_once(s, fit8, fit4, want):
    """Where the card holds fewer clusters of a size at once than there are
    (row, KV head) pairs, a launch runs in waves: short blocks (S = 448 at
    C = 8: 56 keys) then wait on one another, so the plan takes the next
    size down; blocks of at least ``LONG_BLOCK`` keys (S = 2,112 at C = 8:
    264) still gain more from the size than the waves cost. A size that
    cannot launch at all (-1) is never taken. Clusters of 2 here always
    fit."""
    fits = {2: 1000, 4: fit4, 8: fit8}.__getitem__
    assert tdec.plan_clusters(s, 64, 132, fits) == want


def test_plan_clusters_long_caches_stay_within_a_block():
    """A cache past what one block's shared memory holds a mask of takes
    more blocks, whatever fills the card; beyond eight the wrapper refuses."""
    assert tdec.plan_clusters(tdec.MAX_BLOCK_KEYS, 10_000, 132) == 1
    assert tdec.plan_clusters(tdec.MAX_BLOCK_KEYS + 1, 10_000, 132) == 2
    assert tdec.plan_clusters(tdec.MAX_S, 10_000, 132) == 8


# ---------------------------------------------------------------------------
# Prefill: 64 x 64 tiles, causal tile skip, P as hi + lo bf16
# ---------------------------------------------------------------------------


def _bf16_pair(p):
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


def emulate_tc_prefill(q, k, v, mask, causal=True, q_offset=None, hi_lo=True,
                       block_q=64, block_k=64):
    """The bf16 prefill kernel's arithmetic, block by block, in f32.

    Per (row, head, 64-query block): the key tiles up to the causal
    diagonal of the block's last query when the row has a valid key at or
    before its first query, else all of them; an online softmax over the
    tiles; P enters P.V as hi + lo bf16 (``hi_lo``) and the denominator sums
    the f32 P. Returns ``(B,T,Hq,D)`` f32 and the number of key tiles run.
    """
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    off = 0 if q_offset is None else int(q_offset)
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((b, t, hq, d))
    tiles_run = 0
    for bi in range(b):
        for h in range(hq):
            hk = h // group
            for t0 in range(0, t, block_q):
                rows = torch.arange(t0, min(t, t0 + block_q))
                skip = causal and bool(mask[bi, : max(0, off + t0 + 1)].any())
                key_end = min(s, off + int(rows[-1]) + 1) if skip else s
                m = torch.full((len(rows),), -math.inf)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), d)
                for k0 in range(0, key_end, block_k):
                    tiles_run += 1
                    keys = torch.arange(k0, min(s, k0 + block_k))
                    sc = (qf[bi, rows, h] @ kf[bi, keys, hk].T) * scale
                    valid = mask[bi, keys][None, :].expand(len(rows), -1)
                    if causal:
                        valid = valid & (keys[None, :] <= off + rows[:, None])
                    sc = torch.where(valid, sc, _FILL)
                    mn = torch.maximum(m, sc.max(dim=-1).values)
                    alpha = torch.exp(m - mn)
                    p = torch.exp(sc - mn[:, None])
                    l = l * alpha + p.sum(dim=-1)
                    pv = _bf16_pair(p) if hi_lo else p
                    acc = acc * alpha[:, None] + pv @ vf[bi, keys, hk]
                    m = mn
                out[bi, rows, h] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out, tiles_run


def _prefill_inputs(b, t, s, pads, hq=4, hkv=2, d=32, seed=7, bf16=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d))]
    if bf16:  # bf16-representable values: the kernel's inputs, upcast
        arrs = [_t(a).to(torch.bfloat16).float().numpy() for a in arrs]
    mask = np.stack([np.arange(s) >= pads[i % len(pads)] for i in range(b)])
    return (*arrs, mask)


_PREFILL_CASES = [
    # t, s, pads, causal, q_offset
    (130, 130, (0, 9, 130), True, None),   # a fully masked row; a ragged 3rd tile
    (130, 130, (0, 9, 70), False, None),
    (64, 128, (0, 17, 40, 127, 128), True, 64),  # the main path's pads, a shard's queries
    (24, 72, (0, 5), True, 48),
    (40, 40, (0, 3, 11), True, None),
]


@pytest.mark.parametrize("t,s,pads,causal,q_offset", _PREFILL_CASES)
def test_tc_prefill_tile_skip_matches_jax_f32(t, s, pads, causal, q_offset):
    """The tile walk and causal skip with f32 probabilities: 2e-5 against
    the Pallas kernel in interpret mode (rows with a valid key) and the
    port's plain version (all rows; it is held to JAX's einsum reference in
    test_torch_port_attention.py), the tolerance of
    tests/test_pallas_attention.py."""
    q, k, v, mask = _prefill_inputs(len(pads), t, s, pads)
    ours, _ = emulate_tc_prefill(_t(q), _t(k), _t(v), _t(mask), causal, q_offset, hi_lo=False)
    ours = ours.numpy()
    pallas = np.asarray(jattn.fused_gqa_attention(
        q, k, v, jnp.asarray(mask), causal=causal, interpret=True, q_offset=q_offset))
    ref = tattn.reference_gqa_attention(
        _t(q), _t(k), _t(v), _t(mask), causal=causal, q_offset=q_offset).numpy()
    # Rows whose every key is masked average V; the Pallas kernel averages
    # over its 128-padded key axis instead, so those rows are held to the
    # plain version only.
    off = 0 if q_offset is None else q_offset
    real = mask[:, None, :] & (
        (np.arange(s)[None, :] <= off + np.arange(t)[:, None]) if causal else np.ones((t, s), bool))
    has_key = real.any(-1)
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(ours[has_key], pallas[has_key], atol=2e-5, rtol=2e-5)
    assert np.isfinite(ours).all()


@pytest.mark.parametrize("t,s,pads,causal,q_offset", _PREFILL_CASES[:3])
def test_tc_prefill_hi_lo_probabilities(t, s, pads, causal, q_offset):
    """P as hi + lo bf16 on bf16-representable inputs: each probability
    keeps ~16 bits (relative error <= 2^-16), so the output is within
    2^-16 * max|v| ~ 7e-5 of the f32-P result; 1e-4 against the Pallas
    kernel. Rounding P once to bf16 (2^-8) would miss it by far."""
    q, k, v, mask = _prefill_inputs(len(pads), t, s, pads, bf16=True)
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    ours, _ = emulate_tc_prefill(tq, tk, tv, tm, causal, q_offset)
    pallas = np.asarray(jattn.fused_gqa_attention(
        q, k, v, jnp.asarray(mask), causal=causal, interpret=True, q_offset=q_offset))
    ref = tattn.reference_gqa_attention(
        tq, tk, tv, tm, causal=causal, q_offset=q_offset).numpy()
    off = 0 if q_offset is None else q_offset
    real = mask[:, None, :] & (
        (np.arange(s)[None, :] <= off + np.arange(t)[:, None]) if causal else np.ones((t, s), bool))
    has_key = real.any(-1)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ours.numpy()[has_key], pallas[has_key], atol=1e-4, rtol=1e-4)
    p = torch.rand(4096)
    assert ((_bf16_pair(p) - p).abs() <= p * 2.0 ** -16).all()
    assert ((p.to(torch.bfloat16).float() - p).abs() > p * 2.0 ** -16).any()


def test_tc_prefill_causal_skip_counts():
    """The skip runs only where exact: with every row valid from key 0 the
    first 64-query block of T = S = 128 runs one key tile and the second
    two; a row whose first valid key lies past the first block's queries
    runs both tiles in both blocks."""
    q, k, v, mask = _prefill_inputs(1, 128, 128, (0,), hq=2, hkv=1)
    _, tiles = emulate_tc_prefill(_t(q), _t(k), _t(v), _t(mask))
    assert tiles == 2 * (1 + 2)  # two heads
    q, k, v, mask = _prefill_inputs(1, 128, 128, (100,), hq=2, hkv=1)
    _, tiles = emulate_tc_prefill(_t(q), _t(k), _t(v), _t(mask))
    assert tiles == 2 * (2 + 2)
    # With q_offset = 64 the queries sit at 64..127: no tile is past them.
    q, k, v, mask = _prefill_inputs(1, 64, 128, (0,), hq=2, hkv=1)
    _, tiles = emulate_tc_prefill(_t(q), _t(k), _t(v), _t(mask), q_offset=64)
    assert tiles == 2 * 2
