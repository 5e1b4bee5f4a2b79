"""The traffic generators: deterministic in the seed, the same work for every
seed, and the stated distributions."""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import pytest

from conftest import stored_cell

from benchmark import registry
from benchmark.reference import qwen_tts as ref
from benchmark.texts import sentence

SERVE = stored_cell("qwen3-tts-1.7b-int8.stream-open")["cell"]["traffic"]["params"]
BATCH = registry.load_cell("qwen3-tts-1.7b-int8.batch8")["traffic"]["params"]
SEEDS = [0, 7, 2**31 + 11, 2**32 + 5]


def _stream():
    return registry.load_generator("open_stream")


def _batch():
    return registry.load_generator("closed_batch")


@pytest.mark.parametrize("n_chars", [2, 20, 117, 120, 220])
def test_sentences_have_exact_lengths(n_chars):
    rng = np.random.default_rng(3)
    for _ in range(20):
        s = sentence(rng, n_chars)
        assert len(s) == n_chars and s.isascii() and s.endswith(".") and "  " not in s


def test_schedule_is_deterministic_in_the_seed():
    a = _stream().schedule(SERVE, SEEDS[2], 40.0)
    b = _stream().schedule(SERVE, SEEDS[2], 40.0)
    c = _stream().schedule(SERVE, SEEDS[3], 40.0)
    assert a == b
    assert [r["text"] for r in a] != [r["text"] for r in c]


def test_every_seed_offers_the_same_work():
    runs = [_stream().schedule(SERVE, s, 40.0) for s in SEEDS]
    frames = [Counter(r["frames"] for r in run) for run in runs]
    gaps = [sorted(np.round(np.diff([0.0] + [r["due"] for r in run]), 9)) for run in runs]
    assert all(f == frames[0] for f in frames)
    assert all(np.allclose(g, gaps[0]) for g in gaps)
    assert [r["due"] for r in runs[0]] != [r["due"] for r in runs[1]]  # another order


def test_stream_lengths_follow_the_stated_distribution():
    run = _stream().schedule(SERVE, SEEDS[0], 40.0)
    n = round(SERVE["rate"] * 40.0)
    frames = np.array([r["frames"] for r in run])
    assert len(run) == n and run[-1]["due"] <= 40.0 + 1e-9
    assert set(frames % SERVE["chunk"]) == {0}
    assert frames.min() == SERVE["min_frames"] and frames.max() == SERVE["max_frames"]
    # The median frame count, before rounding up to a chunk, is median_frames.
    assert np.median(frames) == math.ceil(SERVE["median_frames"] / 64) * 64
    dues = np.sort([r["due"] for r in run])
    assert dues[0] > 0 and np.all(np.diff(dues) > 0)
    # Exponential gaps: the mean gap is 1 / rate, its median ln 2 / rate.
    gaps = np.diff(np.concatenate([[0.0], dues]))
    assert np.isclose(gaps.mean(), 40.0 / n)
    assert abs(np.median(gaps) / gaps.mean() - math.log(2)) < 0.05
    lo, hi = SERVE["chars"]
    for r in run:
        chars = round(SERVE["chars_per_frame"] * r["frames"])
        assert len(r["text"]) == int(np.clip(chars, lo, hi))
        assert ref.prompt_length(r["text"]) <= SERVE["engine"]["max_prompt"]
    assert [r["greedy"] for r in run[:8]] == [True, False, False, False] * 2
    assert all(r["temperature"] == (0.0 if r["greedy"] else SERVE["temperature"]) for r in run)


def test_batch_calls_are_deterministic_and_of_fixed_lengths():
    a = [_batch()._call(BATCH, SEEDS[2], i) for i in range(5)]
    b = [_batch()._call(BATCH, SEEDS[2], i) for i in range(5)]
    c = [_batch()._call(BATCH, SEEDS[3], i) for i in range(5)]
    assert a == b and a != c
    want = sorted(np.round(np.linspace(*BATCH["chars"], BATCH["batch"])).astype(int))
    for call in a + c:
        assert sorted(len(t) for t in call["texts"]) == want
        assert len(call["seeds"]) == BATCH["batch"] and call["speaker"] in ref.SPEAKERS
        assert call["greedy"] == (call["index"] % BATCH["greedy_every"] == 0)
    # Every prompt lands in the same 64-token bucket: the same shapes every call.
    assert {math.ceil(max(ref.prompt_length(t) for t in call["texts"]) / 64)
            for call in a + c} == {4}
