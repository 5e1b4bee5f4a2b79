"""The decode step as a CUDA graph (``models.qwen.model._StepGraph``).

On the CPU: the model's store of step graphs (one call holds it at a time,
at most ``GRAPH_KEYS`` graphs kept, the least recently used dropped first,
every key's caches in one arena that grows to the largest) and the eager
fallback, which gets fresh buffers and no graph.

On the card (``-m chip``; skipped without one): at the benchmark cells'
shapes (1.7B int8 and 0.6B bf16, 8 rows of 120-220 characters, so a
256-slot prompt, 192 frames pinned) the graph against the same step run
eagerly in one process: codes and waveforms of a greedy and a sampled call,
and the pieces of ``stream_chunks``, bit for bit; one capture per key, made
by the first call; every later chunk replayed, and no replay counted as a
kernel wrapper's launch. Then calls of varied lengths: captures, the arena
and the memory held after them. Run on the card with
``python -m pytest tests/test_torch_port_decode_graph.py -m chip -s``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel
from rho_tts_tpu_torch.models.qwen import model as qmodel
from rho_tts_tpu_torch.ops.cuda import decode_attention

torch.set_num_threads(1)  # several test workers share the cores

FRAMES = 192
ROWS = 8


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m chip)")
    return torch.device("cuda")


def _acquire(graphs, b, s, top_k=8):
    cfg = PRESETS["tiny"].talker
    return graphs.acquire(cfg, b, s, torch.bfloat16, 4, 8, top_k,
                          torch.zeros((cfg.hidden, 40), dtype=torch.bfloat16))


def test_one_call_holds_the_graphs_and_the_oldest_key_goes_first(monkeypatch):
    monkeypatch.setattr(qmodel, "GRAPH_KEYS", 2)
    graphs = qmodel._StepGraphs()
    a = _acquire(graphs, 2, 96)
    assert _acquire(graphs, 2, 96) is None  # held: a second call goes eager
    assert _acquire(graphs, 1, 64) is None  # whatever its key
    graphs.release()
    assert _acquire(graphs, 2, 96) is a
    graphs.release()
    b = _acquire(graphs, 1, 64)
    graphs.release()
    c = _acquire(graphs, 2, 32)  # a third key: the least recently used goes
    graphs.release()
    assert list(graphs._graphs.values()) == [b, c]
    assert _acquire(graphs, 1, 64) is b and list(graphs._graphs.values()) == [c, b]


def test_every_key_lies_in_one_arena_which_grows_to_the_largest(monkeypatch):
    """The caches and ``key_valid`` of each key are views at the start of
    the model's one arena, zeroed for each call; a longer key outgrows it,
    and the graphs over the old arena go with it."""
    graphs = qmodel._StepGraphs()
    a = _acquire(graphs, 2, 96)
    arena = graphs._arena
    cfg = PRESETS["tiny"].talker
    shape = (cfg.layers, 2, 96, cfg.kv_heads, cfg.head_dim)
    assert a.cache_k.shape == a.cache_v.shape == shape and a.key_valid.shape == (2, 96)
    assert a.cache_k.is_contiguous() and a.cache_v.is_contiguous()
    assert a.cache_k.untyped_storage().data_ptr() == arena.data_ptr()
    ck, cv, kv = a.fresh()
    ck.fill_(1), cv.fill_(1), kv.fill_(True)
    assert not (a.fresh()[0].any() or a.cache_v.any() or a.key_valid.any())
    graphs.release()
    b = _acquire(graphs, 1, 64)  # smaller: the same arena, the first key kept
    assert graphs._arena is arena and list(graphs._graphs.values()) == [a, b]
    assert b.cache_k.data_ptr() == a.cache_k.data_ptr()
    assert b.lm_head is a.lm_head  # one f32 head for every key
    graphs.release()
    c = _acquire(graphs, 2, 192)  # larger: a new arena, the old keys dropped
    assert graphs._arena is not arena and list(graphs._graphs.values()) == [c]
    assert graphs._arena.numel() == qmodel._arena_layout(cfg, 2, 192, torch.bfloat16)[1][-1]


def test_the_cpu_gets_new_zeroed_buffers_and_no_graph():
    m = QwenTTSModel(PRESETS["tiny"], device="cpu")
    ck, cv, kv, graph = m._decode_buffers(2, 96, 8)
    assert graph is None and not m._step_graphs._graphs and m._step_graphs._arena is None
    assert ck.shape == cv.shape == (2, 2, 96, 2, 16) and kv.shape == (2, 96)
    assert not ck.any() and not cv.any() and not kv.any()


def _replay_is_the_step(monkeypatch):
    """Let the CPU stand in for a card: the model hands out graphs, and a
    capture runs the step once (as the real one's warm-up does) and keeps it
    as the graph, whose replay runs it again."""
    def capture(self, step, leaves, stream):
        step()
        self.graph, self.leaves = types.SimpleNamespace(replay=step), leaves

    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(QwenTTSModel, "_graphable", lambda self: True)
    monkeypatch.setattr(qmodel._StepGraph, "_capture", capture)
    monkeypatch.setattr(qmodel, "_decode_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(qmodel, "graph_captures", 0)
    monkeypatch.setattr(qmodel, "graph_replays", 0)


@pytest.mark.parametrize("quantization", [None, "int8"], ids=["dense", "int8"])
def test_the_graph_buffers_and_bookkeeping_give_the_eager_codes(monkeypatch, quantization):
    """On the CPU, a replay standing for the step: a greedy then a sampled
    call, and a stream, through the graph's own caches and state give the
    eager loop's codes and audio; each chunk's outputs are copies, not the
    state the next chunk overwrites; the counters and the span attribute
    follow capture and replay; a key is released after each call."""
    monkeypatch.setenv("RHO_TTS_TPU_DECODE_CHUNK", "8")
    m = QwenTTSModel(PRESETS["tiny"], device="cpu", quantization=quantization)
    texts = ["hello there", "a second, longer row"]
    kw = dict(min_frames=12, max_frames=30, top_k=8, seeds=[4, 5])

    def run():
        return (m.generate_codes(texts, temperature=0.0, **kw),
                m.synthesize(texts, temperature=0.9, **kw)[0],
                [w for w, _ in m.stream_chunks(texts[1], min_frames=12, max_frames=30,
                                               top_k=8, seed=6)])

    eager = run()
    _replay_is_the_step(monkeypatch)
    from rho_tts_tpu_torch.utils import profiling

    profiling.reset()
    graphed = run()
    modes = [s["attrs"]["graph"] for s in profiling.spans() if s["name"] == "qwen/decode_chunk"]
    # batch key: 4 chunks a call, captured once; the stream's key: 4 chunks
    assert modes == ["capture"] + ["replay"] * 7 + ["capture"] + ["replay"] * 3
    assert qmodel.graph_captures == 2 and qmodel.graph_replays == 12 * 8 - 2
    assert len(m._step_graphs._graphs) == 2
    assert not m._step_graphs._held  # released after each call
    for ours, ref in zip(graphed[0], eager[0]):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in list(zip(graphed[1], eager[1])) + list(zip(graphed[2], eager[2])):
        assert torch.equal(ours, ref)
    assert len(graphed[2]) == len(eager[2]) >= 2


def _texts():
    words = "a quiet river carries the morning light past the old stone mill and on".split()
    out = []
    for i, n in enumerate(np.round(np.linspace(120, 220, ROWS)).astype(int)):
        text = " ".join(words[(i + j) % len(words)] for j in range(60))
        out.append(text[:n])
    return out


def _call(model, temperature):
    """One pinned synthesize() of the cell's shape: (codes, waveforms)."""
    got = []
    generate = model._generate_codes_arrays

    def keep(*args, **kwargs):
        out = generate(*args, **kwargs)
        got.append(out[0].clone())
        return out

    model._generate_codes_arrays = keep
    try:
        waves, _ = model.synthesize(_texts(), speaker="Vivian", min_frames=FRAMES,
                                    max_frames=FRAMES, temperature=temperature, top_k=50,
                                    seeds=list(range(ROWS)))
    finally:
        del model._generate_codes_arrays
    torch.cuda.synchronize()
    return got[0], waves


def _stream(model):
    pieces = [w.clone() for w, _ in model.stream_chunks(_texts()[3], speaker="Vivian",
                                                        min_frames=FRAMES, max_frames=FRAMES,
                                                        top_k=50, seed=7)]
    torch.cuda.synchronize()
    return pieces


@pytest.mark.chip
@pytest.mark.parametrize("preset,quantization", [("1.7B", "int8"), ("0.6B", None)],
                         ids=["1.7b-int8", "0.6b-bf16"])
def test_the_graph_replays_the_eager_step_bit_for_bit(cuda_card, preset, quantization):
    model = QwenTTSModel(PRESETS[preset], seed=3, quantization=quantization, device=cuda_card)
    chunk = qmodel._chunk()
    chunks = -(-FRAMES // chunk)
    layers = model.config.talker.layers

    # The graph: the first call of a key captures (its first step runs
    # eagerly, the rest replay); every later chunk replays.
    captures, replays = qmodel.graph_captures, qmodel.graph_replays
    warm = _call(model, 0.0)
    assert qmodel.graph_captures - captures == 1
    assert qmodel.graph_replays - replays == chunks * chunk - 1
    captures, replays = qmodel.graph_captures, qmodel.graph_replays
    launches = decode_attention.launches
    greedy = _call(model, 0.0)
    sampled = _call(model, 0.9)
    assert qmodel.graph_captures == captures  # nothing captured in the "window"
    assert qmodel.graph_replays - replays == 2 * chunks * chunk
    assert decode_attention.launches == launches  # the replays' launches are the graph's
    streamed = _stream(model)  # B = 1: a key of its own
    assert qmodel.graph_captures - captures == 1

    # The same step, eagerly: no graph is handed out.
    model._step_graphs.acquire = lambda *args: None
    launches = decode_attention.launches
    eager_greedy = _call(model, 0.0)
    assert decode_attention.launches - launches == chunks * chunk * layers
    eager_sampled = _call(model, 0.9)
    eager_streamed = _stream(model)
    assert qmodel.graph_replays - replays == 2 * chunks * chunk + chunks * chunk - 1

    for what, ours, ref in (("warm-up", warm, eager_greedy), ("greedy", greedy, eager_greedy),
                            ("sampled", sampled, eager_sampled)):
        _same(f"{what} codes", [ours[0]], [ref[0]])
        _same(f"{what} waveforms", ours[1], ref[1])
    assert not torch.equal(sampled[0], greedy[0])  # the sampled call really sampled
    assert len(streamed) >= 2
    _same("stream pieces", streamed, eager_streamed)


def _same(what, ours, refs):
    """Bit-equal tensors, or a failure that says how far apart they are."""
    assert len(ours) == len(refs), f"{what}: {len(ours)} against {len(refs)}"
    for i, (o, r) in enumerate(zip(ours, refs)):
        assert o.shape == r.shape, f"{what} {i}: {tuple(o.shape)} against {tuple(r.shape)}"
        if not torch.equal(o, r):
            diff = (o.double() - r.double()).abs()
            raise AssertionError(f"{what} {i}: {int((o != r).sum())} of {o.numel()} differ, "
                                 f"largest by {float(diff.max())}")


@pytest.mark.chip
def test_calls_of_varied_lengths_keep_one_arena(cuda_card):
    """``generate_codes`` over texts of varied lengths, rows and prompt
    buckets, as a provider's traffic: at most one capture a call, never more
    than ``GRAPH_KEYS`` graphs, caches in one arena as large as the largest
    key's, and after the calls no more memory held than the arena and the
    f32 head. Printed (``-s``): each call's captures and memory against the
    same calls decoded eagerly, and the mean chunk by how it ran."""
    import json

    from rho_tts_tpu_torch.utils import profiling

    words = "a quiet river carries the morning light past the old stone mill and on".split()

    def text(n):
        return " ".join(words[j % len(words)] for j in range(n))[:n]

    # (rows, characters): max_frames follows the longest text, so the cache
    # length varies with it; 300 characters take a larger prompt bucket
    mix = [(1, 40), (8, 120), (1, 300), (8, 60), (4, 200), (1, 40), (8, 120), (2, 90)]
    model = QwenTTSModel(PRESETS["1.7B"], seed=3, quantization="int8", device=cuda_card)
    layout = model._step_graphs

    def run(eager: bool):
        if eager:
            model._step_graphs.acquire = lambda *args: None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        profiling.reset()
        base = torch.cuda.memory_allocated()
        captures, keys, out = qmodel.graph_captures, set(), []
        for rows, n in mix:
            texts = [text(n - 7 * i) for i in range(rows)]
            before = qmodel.graph_captures
            model.generate_codes(texts, speaker="Vivian", top_k=50, seeds=list(range(rows)))
            torch.cuda.synchronize()
            if not eager:
                keys.update(layout._graphs)
            out.append({"rows": rows, "chars": n, "captured": qmodel.graph_captures - before,
                        "allocated_mb": (torch.cuda.memory_allocated() - base) / 2**20,
                        "reserved_mb": torch.cuda.memory_reserved() / 2**20})
        chunks = {}
        for sp in profiling.spans():
            if sp["name"] == "qwen/decode_chunk":
                chunks.setdefault(sp["attrs"]["graph"], []).append(
                    (sp["end_ns"] - sp["start_ns"]) / 1e6)
        ms = {mode: {"chunks": len(v), "mean_ms": sum(v) / len(v)} for mode, v in chunks.items()}
        return out, qmodel.graph_captures - captures, keys, ms

    graphed, captures, keys, graphed_ms = run(eager=False)
    arena = layout._arena.numel()
    cfg = qmodel.tfm.local_config(model.config.talker, None)
    need = max(qmodel._arena_layout(cfg, k[0], k[1], k[3])[1][-1] for k in keys)
    head = layout._lm_head.numel() * 4
    eager, eager_captures, _, eager_ms = run(eager=True)
    print(json.dumps({"graphed": graphed, "eager": eager, "captures": captures,
                      "distinct_keys": len(keys), "kept_keys": len(layout._graphs),
                      "arena_mb": arena / 2**20, "head_mb": head / 2**20,
                      "chunk_ms": {"graphed": graphed_ms, "eager": eager_ms}}))
    assert eager_captures == 0
    assert len(layout._graphs) <= qmodel.GRAPH_KEYS
    assert captures == sum(row["captured"] for row in graphed) >= len(keys)
    assert all(row["captured"] <= 1 for row in graphed)
    assert arena == need  # as large as the largest key's caches, and no larger
    assert graphed[-1]["allocated_mb"] * 2**20 <= arena + head + (8 << 20)
