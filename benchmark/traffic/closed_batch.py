"""Closed-loop offline batches: back-to-back ``QwenTTSModel.synthesize()`` calls.

One client renders batches one after the other, as an offline job
(audiobooks, voice-over) does: each call takes ``batch`` texts and one
CustomVoice speaker, every row pinned to ``frames`` frames
(``min_frames = max_frames``). Every call has the same text lengths, spread
evenly over ``chars``, in an order drawn from the seed; the words, the
speaker and the rows' sampling seeds are drawn too. Every ``greedy_every``-th
call (the first included) samples greedily (temperature 0), so that its
primary codes can be judged; the others sample with ``top_k`` and
``temperature``.

Parameters (the cell's ``traffic``): ``batch``, ``frames``, ``chars``
(``[lo, hi]``), ``speakers``, ``top_k``, ``temperature``, ``greedy_every``,
``judge_greedy`` and ``judge_sampled`` (how many greedy and sampled calls
the check judges), ``chunk`` (the frames a waveform is padded to a whole number
of before it is vocoded: the program's decode chunk).

The window runs calls until ``seconds`` have passed since its start; the
call running then finishes, and only calls completed inside the window
count. A call is complete when its waveforms are on the device
(synchronised).
"""

from __future__ import annotations

import gc
import inspect
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline, system, trace, weights
from benchmark.reference import qwen_tts as ref
from benchmark.texts import sentence

WARMUP_CALL = 1 << 40  # the warm-up's stream of draws, apart from the window's


def _call(params: Dict, seed: int, index: int) -> Dict:
    """The inputs of call ``index``: texts, speaker, row seeds, sampling."""
    rng = np.random.default_rng([int(seed), int(index)])
    lo, hi = params["chars"]
    lengths = np.round(np.linspace(lo, hi, params["batch"])).astype(int)
    texts = [sentence(rng, int(n)) for n in rng.permutation(lengths)]
    greedy = index % params["greedy_every"] == 0
    return {
        "index": index,
        "texts": texts,
        "speaker": params["speakers"][int(rng.integers(len(params["speakers"])))],
        "seeds": [int(s) for s in rng.integers(0, 2**31 - 1, params["batch"])],
        "greedy": greedy,
        "temperature": 0.0 if greedy else float(params["temperature"]),
    }


def _synthesize(model, params: Dict, call: Dict):
    waves, _sr = model.synthesize(
        call["texts"], speaker=call["speaker"], min_frames=params["frames"],
        max_frames=params["frames"], temperature=call["temperature"], top_k=params["top_k"],
        seeds=call["seeds"])
    if waves[0].is_cuda:
        torch.cuda.synchronize()
    return waves


def hooks(qmodel) -> None:
    """Refuse to run where a private name the run hooks is gone: the call
    that returns a batch's codes (the check judges them) and the decode
    chunk with the arguments the traced metrics read. Without them the
    check and the metrics would read nothing, or the wrong thing."""
    missing = [n for n, ok in (
        ("QwenTTSModel._generate_codes_arrays",
         callable(getattr(qmodel.QwenTTSModel, "_generate_codes_arrays", None))),
        ("_decode_chunk", callable(getattr(qmodel, "_decode_chunk", None)))) if not ok]
    if not missing:
        params = inspect.signature(qmodel._decode_chunk).parameters
        missing = [f"_decode_chunk({a}=)" for a in ("key_valid", "steps") if a not in params]
    if missing:
        raise RuntimeError(f"the program no longer has {missing}: closed_batch cannot hook it")


def setup(ctx: Dict) -> Dict:
    """Build the model from the seed's weights and warm up one call of the
    cell's shapes."""
    hooks(system.model_module())
    model = system.build_model(ctx["config"], ctx["seed"], ctx["device"],
                               bool(ctx.get("control")))
    codes: List[torch.Tensor] = []
    generate = model._generate_codes_arrays

    def capture(*args, **kwargs):
        out = generate(*args, **kwargs)
        codes.append(out[0])  # (B, T, nq) on the device: what the call will vocode
        return out

    model._generate_codes_arrays = capture
    _synthesize(model, ctx["params"], _call(ctx["params"], ctx["seed"], WARMUP_CALL))
    codes.clear()
    return {"model": model, "codes": codes}


def window(ctx: Dict, state: Dict) -> Dict:
    """Calls back to back for ``ctx["seconds"]``; one decode chunk traced."""
    params, model = ctx["params"], state["model"]
    qmodel = system.model_module()
    stretch = None
    calls: List[Dict] = []
    if ctx["trace"]:
        # The second call's second decode chunk (or its only one): a steady stretch.
        per_call = -(-params["frames"] // params["chunk"])
        seen = {"n": 0}

        def when():
            seen["n"] += 1
            return seen["n"] == per_call + min(2, per_call)

        signature = inspect.signature(qmodel._decode_chunk)

        def before(*args, **kwargs):
            bound = signature.bind(*args, **kwargs).arguments
            key_valid, steps = bound["key_valid"], bound["steps"]
            return {"what": "decode_chunk", "steps": int(steps),
                    "row_keys0": [int(k) for k in key_valid.sum(dim=1).tolist()],
                    "cache_len": int(key_valid.shape[1])}

        stretch = trace.Stretch(qmodel._decode_chunk, when, before)
        qmodel._decode_chunk = stretch
    t0 = time.time()
    try:
        index = 0
        while time.time() - t0 < ctx["seconds"]:
            call = _call(params, ctx["seed"], index)
            call["t_start"] = time.time()
            call["waves"] = _synthesize(model, params, call)
            call["t_end"] = time.time()
            call["codes"] = state["codes"][-1]
            calls.append(call)
            index += 1
    finally:
        if stretch is not None:
            qmodel._decode_chunk = stretch.fn
    hop = ref.hop(ctx["config"])
    sr = ctx["config"]["codec"]["sample_rate"]
    for call in calls:
        call["audio_s"] = sum(w.shape[0] for w in call["waves"]) / sr
        call["ends"] = [w.shape[0] // hop for w in call["waves"]]
    record = {"kind": "batch", "t0": t0, "seconds": ctx["seconds"], "calls": calls}
    if stretch is not None and stretch.prof is not None:
        record["stretch"] = _stretch_work(ctx["config"], stretch.reduce())
    return record


def _stretch_work(cfg: Dict, st: Dict) -> Dict:
    """Add the traced chunk's model FLOPs and decode-attention work: every
    row is live, and at step t holds its prompt, its frames so far and the
    new one."""
    flops = att_bytes = att_ops = 0
    for t in range(st["steps"]):
        keys = [k + t + 1 for k in st["row_keys0"]]
        flops += roofline.decode_step_flops(cfg, keys)
        b, o = roofline.decode_attention_work(cfg, keys, st["cache_len"])
        att_bytes += b * cfg["talker"]["layers"]
        att_ops += o * cfg["talker"]["layers"]
    st.update(model_flops=flops, attention_bytes=att_bytes, attention_ops=att_ops,
              attention_calls=st["steps"] * cfg["talker"]["layers"])
    return st


def judge(ctx: Dict, state: Dict, record: Dict) -> Dict:
    """Hold the judged calls' codes and waveforms against the reference.

    ``judge_greedy`` greedy and ``judge_sampled`` sampled calls completed in
    the window, drawn from the seed; every row of each. Frees the program
    first.
    """
    params, cfg = ctx["params"], ctx["config"]
    done = [c for c in record["calls"] if c["t_end"] <= record["t0"] + record["seconds"]]
    greedy = [c for c in done if c["greedy"]]
    sampled = [c for c in done if not c["greedy"]]
    rng = np.random.default_rng([int(ctx["seed"]), 7])
    picked = []
    for pool, k in ((greedy, params["judge_greedy"]), (sampled, params["judge_sampled"])):
        picked += [pool[i] for i in sorted(rng.choice(len(pool), min(k, len(pool)),
                                                      replace=False))]
    judged = [{"texts": c["texts"], "speaker": c["speaker"], "greedy": c["greedy"],
               "codes": c["codes"].cpu(), "ends": c["ends"],
               "waves": [w.cpu() for w in c["waves"]]} for c in picked]
    attempted = sum(len(c["texts"]) for c in record["calls"])
    state.clear()
    record["calls"] = [{k2: v for k2, v in c.items() if k2 not in ("waves", "codes")}
                       for c in record["calls"]]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    device, chunk, control = ctx["device"], params["chunk"], bool(ctx.get("control"))
    with ref.run_float32():
        tree = weights.make_params(cfg, ctx["seed"], device)
        gaps, pairs = ref.Gaps(), []
        for c in judged:
            for row, text in enumerate(c["texts"]):
                # A row the call did not return is judged at its pinned length.
                end = c["ends"][row] if row < len(c["ends"]) else params["frames"]
                codes = c["codes"][row, : min(end + 1, c["codes"].shape[1])].to(device)
                g = ref.served_gaps(tree, cfg, text, c["speaker"], codes, params["frames"],
                                    system.quantization(cfg), c["greedy"])
                gaps.add(g)
                want = ref.whole_waveform(tree, cfg, codes[:end], chunk)
                # The control puts the reference's vocoder, in float8, in the program's place.
                got = (ref.whole_waveform(tree, cfg, codes[:end], chunk, low_precision=True)
                       if control else c["waves"][row].to(device) if row < len(c["waves"])
                       else None)
                pairs.append((got, want))
        readings = dict(gaps.readings(), waveform_rel_err=ref.judge_waveforms(pairs))
    return {"readings": readings, "compared": len(pairs), "tokens": gaps.count,
            "attempted": attempted, "failed": 0}
