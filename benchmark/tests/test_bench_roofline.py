"""``roofline.py``'s operations and bytes against counts made by hand."""

from __future__ import annotations

import pytest

from benchmark import registry, roofline

C17 = registry.load_config("qwen3-tts-1.7b-int8")
C06 = registry.load_config("qwen3-tts-0.6b-bf16")


def test_talker_matmul_params():
    # 1.7B, 28 layers: wqkv 2048 x (16 + 2 x 8) x 128, wo 2048 x 2048,
    # gate / up / down 3 x 2048 x 6144.
    assert roofline.talker_matmul_params(C17) == 28 * (2048 * 4096 + 2048 * 2048 + 3 * 2048 * 6144)
    assert roofline.talker_matmul_params(C17) == 1_409_286_144
    # 0.6B: wqkv 1024 x 4096, wo 2048 x 1024, gate/up/down 3 x 1024 x 3072.
    assert roofline.talker_matmul_params(C06) == 28 * (1024 * 4096 + 2048 * 1024 + 3 * 1024 * 3072)
    assert roofline.talker_matmul_params(C06) == 440_401_920


def test_heads_and_decode_row_flops():
    # audio head 2048 x 2051; predictor 15 residual groups x (4096 x 1024 + 1024 x 2048)
    assert roofline.head_params(C17) == 2048 * 2051 + 15 * (4096 * 1024 + 1024 * 2048)
    assert roofline.head_params(C06) == 1024 * 2051 + 15 * (2048 * 512 + 512 * 2048)
    assert roofline.decode_row_flops(C17) == 2 * (1_409_286_144 + 2048 * 2051 + 94_371_840)


def test_decode_step_flops_counts_live_rows_and_keys():
    row = roofline.decode_row_flops(C17)
    # 8 rows over 300 keys: + 4 x 28 layers x 16 heads x 128 x 300 each
    assert roofline.decode_step_flops(C17, [300] * 8) == 8 * (row + 4 * 28 * 16 * 128 * 300)
    assert roofline.decode_step_flops(C17, []) == 0


def test_decode_attention_bytes_and_ops():
    # 2 rows of 100 and 0 valid keys in a 512-key cache: the empty row reads every key.
    n_bytes, ops = roofline.decode_attention_work(C17, [100, 0], 512)
    keys = 100 + 512
    assert n_bytes == 2 * 2 * 16 * 128 * 2 + 2 * 512 + 2 * keys * 8 * 128 * 2
    assert ops == 4 * keys * 16 * 128


@pytest.mark.parametrize("n_bytes, ops, by",
                         [(3.35e12, 1.0, "bytes"), (1.0, 989e12, "operations")])
def test_bound_is_the_larger_of_the_two(n_bytes, ops, by):
    t, which = roofline.bound_s(n_bytes, ops)
    assert which == by and t == pytest.approx(1.0)
