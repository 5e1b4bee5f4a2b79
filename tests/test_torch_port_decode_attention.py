"""The decode attention kernel on the card (``-m chip``; skipped without one).

``csrc/decode_attention.cu`` against :func:`reference_decode_attention` at
each benchmark cell's shape (Qwen: 8 rows, 8 KV heads, G = 2, D = 128;
LFM2: G = 4, D = 64; granite: G = 4, D = 128, scale 1/128), at
Chatterbox's (2 rows, 16 KV heads, G = 1, D = 64), over serving's rings
(S = 640, 1,600, 2,112) with per-row masks, on f8 and f32 caches, with a
row that has no valid key and with unaligned K/V rows (scalar loads). Each
case runs twice and must give the same bits; the launches are counted, and
``cluster_launches`` counts those whose plan has more than one block a
(row, KV head). A 0.6B decode, run eagerly, counts one cluster launch for
every attention layer of every step. Run on the card with
``python -m pytest tests/test_torch_port_decode_attention.py -m chip``.
"""

import pytest
import torch

from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel
from rho_tts_tpu_torch.models.qwen import model as qmodel
from rho_tts_tpu_torch.ops.cuda import decode_attention as dec

torch.set_num_threads(1)  # several test workers share the cores

BF, F8, F32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


def _cell_mask(b, s, frame, device):
    """Prompts left-padded in a 256-slot bucket, then ``frame`` + 1 frames."""
    key_pos = torch.arange(s, device=device)[None, :]
    pads = torch.tensor([36, 126, 80, 60, 100, 26, 50, 90], device=device)[:b, None]
    return (key_pos >= pads) & (key_pos <= min(s - 1, 256 + frame))


def _ring_mask(b, s, col, device):
    """Serving's ring: rows of different ages up to write column ``col``,
    row 0 wrapped, row 5 an empty slot, row 6 one key past ``col``, row 7
    a wrapped prompt with holes."""
    key_pos = torch.arange(s, device=device)
    age = (col - key_pos) % s
    mask = torch.zeros((b, s), dtype=torch.bool, device=device)
    mask[0] = age < s - 7
    for row, n in zip(range(1, 5), (1, 65, s // 3, s - 64)):
        mask[row] = age < n
    mask[6] = key_pos == (col + 37) % s
    mask[7] = (age < s // 2) & ~((age >= s // 2 - 20) & (key_pos % 3 == 0))
    return mask[:b]


# id: rows, S, q heads, KV heads, head dim, q dtype, KV dtype, mask, scale
CASES = {
    "qwen": (8, 448, 16, 8, 128, BF, BF, ("cell", 95), None),
    "qwen-first-frame": (8, 448, 16, 8, 128, BF, BF, ("cell", 0), None),
    "qwen-last-frame": (8, 448, 16, 8, 128, BF, BF, ("cell", 191), None),
    "qwen-f8": (8, 448, 16, 8, 128, BF, F8, ("cell", 95), None),
    "qwen-f32": (8, 448, 16, 8, 128, F32, F32, ("cell", 95), None),
    "lfm2": (8, 448, 32, 8, 64, BF, BF, ("cell", 95), None),
    "granite": (8, 448, 32, 8, 128, BF, BF, ("cell", 95), 1 / 128),
    "chatterbox": (2, 320, 16, 16, 64, BF, BF, ("cell", 40), None),
    "ring-640": (8, 640, 16, 8, 128, BF, BF, ("ring", 200), None),
    "ring-1600": (8, 1600, 16, 8, 128, BF, BF, ("ring", 901), None),
    "ring-1600-f8": (8, 1600, 16, 8, 128, BF, F8, ("ring", 5), None),
    "ring-2112": (8, 2112, 16, 8, 128, BF, BF, ("ring", 1500), None),
    "ring-2112-f32": (8, 2112, 16, 8, 128, F32, F32, ("ring", 2111), None),
    "no-key-f32": (8, 448, 16, 8, 128, F32, F32, ("no_key", 95), None),
    "no-key": (8, 448, 16, 8, 128, BF, BF, ("no_key", 95), None),
    "one-block": (64, 448, 16, 8, 128, BF, BF, ("cell", 95), None),
    "tiny": (2, 72, 4, 2, 16, F32, F32, ("cell", 0), None),
}


def _mask(kind, b, s, device):
    what, at = kind
    if what == "ring":
        return _ring_mask(b, s, at, device)
    mask = _cell_mask(b, s, at, device) if b <= 8 else _cell_mask(8, s, at, device).repeat(
        b // 8, 1)
    if what == "no_key":
        mask[3] = False
    return mask


def _run_case(device, case, kv_pad=0):
    b, s, hq, hkv, d, q_dtype, kv_dtype, kind, scale = case
    gen = torch.Generator(device=device).manual_seed(b * 7919 + s + hq + d)
    q = torch.randn((b, 1, hq, d), generator=gen, device=device).to(q_dtype)
    k, v = (torch.randn((b, s, hkv, d + kv_pad), generator=gen, device=device)
            .to(kv_dtype)[..., :d] for _ in range(2))
    mask = _mask(kind, b, s, device)
    launches, clustered = dec.launches, dec.cluster_launches
    out = dec.decode_gqa_attention(q, k, v, mask, scale)
    again = dec.decode_gqa_attention(q, k, v, mask, scale)
    ref = dec.reference_decode_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    c = dec.planned_clusters(q, k, v, mask)
    assert dec.launches - launches == 2
    assert dec.cluster_launches - clustered == (2 if c > 1 else 0)
    assert out.dtype == q_dtype and out.shape == q.shape
    assert torch.equal(out, again)  # the merge's fixed order
    tol = 2e-5 if q_dtype == F32 else 2e-2  # f32: the sums' order; bf16: 1 ulp at |o| < 4
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if kind[0] == "no_key":  # that row averages V over every key
        want = v[3].float().mean(dim=0).repeat_interleave(hq // hkv, dim=0)
        assert (out[3, 0].float() - want).abs().max().item() <= tol
    return c


@pytest.mark.chip
@pytest.mark.parametrize("name", list(CASES))
def test_the_kernel_matches_the_plain_version_and_repeats(cuda_card, name):
    c = _run_case(cuda_card, CASES[name])
    if name == "one-block":
        assert c == 1  # 512 (row, KV head) pairs fill the card alone
    elif name.startswith("qwen"):
        assert c > 1


@pytest.mark.chip
@pytest.mark.parametrize("name", ["qwen", "lfm2", "chatterbox"])
def test_unaligned_rows_take_scalar_loads(cuda_card, name):
    _run_case(cuda_card, CASES[name], kv_pad=1)


@pytest.mark.chip
def test_a_decode_step_launches_one_cluster_per_attention_layer(cuda_card):
    """0.6B, 8 rows, every decode step run eagerly: each attention layer of
    each step is one launch, and a cluster launch (64 pairs of row and KV
    head take more than one block each)."""
    model = QwenTTSModel(PRESETS["0.6B"], seed=3, device=cuda_card)
    model._step_graphs.acquire = lambda *args: None
    texts = [f"line {i}: a quiet river carries the morning light" for i in range(8)]
    frames = qmodel._chunk()
    launches, clustered = dec.launches, dec.cluster_launches
    model.generate_codes(texts, speaker="Vivian", min_frames=frames, max_frames=frames,
                         top_k=50, seeds=list(range(8)))
    torch.cuda.synchronize()
    layers = model.config.talker.layers
    assert dec.launches - launches == frames * layers
    assert dec.cluster_launches - clustered == frames * layers
