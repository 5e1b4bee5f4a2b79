"""Closed-loop offline batches on the hybrid talker (``lfm2.py``'s configuration).

The traffic is ``closed_batch``'s, with the same parameters: back-to-back
``QwenTTSModel.synthesize()`` calls of ``batch`` texts and one speaker, every
row pinned to ``frames`` frames, every ``greedy_every``-th call greedy. The
calls, the synthesize wrapper and the hooks on the program's private names
are ``closed_batch``'s own (imported); what differs is the configuration's:
the model is built by ``lfm2.py`` (``control``: its float8 weights), the
traced chunk's work is counted by ``roofline_hybrid.py`` (with the distinct
experts each expert layer ran at each of its steps, which the program puts
on the chunk's ``qwen/decode_chunk`` span as ``experts_touched``), and the
judged calls are held against ``reference/lfm2_talker.py``: the whole
utterance teacher-forced, and, on the first judged call run again after the
window with its decode steps eager, each expert layer on its own input.
"""

from __future__ import annotations

import gc
import inspect
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import lfm2, roofline, roofline_hybrid, spans, system, trace
from benchmark.reference import lfm2_talker as ref
from benchmark.reference import qwen_tts
from benchmark.traffic import closed_batch

WARMUP_CALL = closed_batch.WARMUP_CALL


def setup(ctx: Dict) -> Dict:
    """Build the model from the seed's weights and warm up one call of the
    cell's shapes."""
    closed_batch.hooks(system.model_module())
    model = lfm2.build_model(ctx["config"], ctx["seed"], ctx["device"], bool(ctx.get("control")))
    codes: List[torch.Tensor] = []
    generate = model._generate_codes_arrays

    def capture(*args, **kwargs):
        out = generate(*args, **kwargs)
        codes.append(out[0])  # (B, T, nq) on the device: what the call will vocode
        return out

    model._generate_codes_arrays = capture
    closed_batch._synthesize(model, ctx["params"],
                             closed_batch._call(ctx["params"], ctx["seed"], WARMUP_CALL))
    codes.clear()
    return {"model": model, "codes": codes}


def window(ctx: Dict, state: Dict) -> Dict:
    """Calls back to back for ``ctx["seconds"]``; one decode chunk traced:
    the second call's second, as ``closed_batch`` traces."""
    params, model = ctx["params"], state["model"]
    qmodel = system.model_module()
    stretch = None
    calls: List[Dict] = []
    if ctx["trace"]:
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
            call = closed_batch._call(params, ctx["seed"], index)
            call["t_start"] = time.time()
            call["waves"] = closed_batch._synthesize(model, params, call)
            call["t_end"] = time.time()
            call["codes"] = state["codes"][-1]
            calls.append(call)
            index += 1
    finally:
        if stretch is not None:
            qmodel._decode_chunk = stretch.fn
    hop = qwen_tts.hop(ctx["config"])
    sr = ctx["config"]["codec"]["sample_rate"]
    for call in calls:
        call["audio_s"] = sum(w.shape[0] for w in call["waves"]) / sr
        call["ends"] = [w.shape[0] // hop for w in call["waves"]]
    record = {"kind": "batch", "t0": t0, "seconds": ctx["seconds"], "calls": calls}
    if stretch is not None and stretch.prof is not None:
        record["stretch"] = stretch_work(ctx["config"], stretch.reduce(),
                                         traced_touched(t0))
    return record


def traced_touched(t0: float) -> Optional[List[List[int]]]:
    """The program's ``experts_touched`` of the profiled decode chunk (a list
    a step of one count an expert layer), or None where it records none."""
    for s in spans.recorded() or []:
        if (s["name"] == "qwen/decode_chunk" and s["profiled"] and s["start_ns"] >= t0 * 1e9
                and "experts_touched" in s["attrs"]):
            return s["attrs"]["experts_touched"]
    return None


def stretch_work(cfg: Dict, st: Dict, touched: Optional[List[List[int]]]) -> Dict:
    """Add the traced chunk's model FLOPs, its decode-attention work over the
    attention layers and, from the program's counts, the routed-expert
    kernel's: every row is live, and at step t holds its prompt, its frames
    so far and the new one."""
    att = roofline_hybrid.attention_config(cfg)
    layers = att["talker"]["layers"]
    flops = att_bytes = att_ops = 0
    for t in range(st["steps"]):
        keys = [k + t + 1 for k in st["row_keys0"]]
        flops += roofline_hybrid.decode_step_flops(cfg, keys)
        b, o = roofline.decode_attention_work(att, keys, st["cache_len"])
        att_bytes += b * layers
        att_ops += o * layers
    st.update(model_flops=flops, attention_bytes=att_bytes, attention_ops=att_ops,
              attention_calls=st["steps"] * layers)
    if touched is not None and len(touched) == st["steps"]:
        rows = len(st["row_keys0"])
        work = [roofline_hybrid.expert_work(cfg, rows, n) for step in touched for n in step]
        st.update(experts_touched=touched, expert_calls=len(work),
                  expert_bytes=sum(b for b, _ in work), expert_ops=sum(o for _, o in work))
    return st


def expert_records(model, params: Dict, call: Dict) -> List:
    """Run ``call`` again with the decode steps eager (no CUDA graph), and
    keep each call of an expert layer, prefill and decode: its input, the
    experts the program chose and its output (``ref.expert_readings``'s
    records). The program's expert entry points are wrapped where the
    talker looks them up; the run is after the window, outside every
    measurement."""
    tfm = system.model_module().tfm
    saved = {name: getattr(tfm, name) for name in ("moe_experts", "grouped_experts")}
    records: List = []

    def keep(fn):
        def run(h, idx, weight, *rest):
            out = fn(h, idx, weight, *rest)
            records.append((h.detach().clone(), idx.clone(), out.detach().clone()))
            return out
        return run

    model._graphable = lambda: False
    for name, fn in saved.items():
        setattr(tfm, name, keep(fn))
    try:
        closed_batch._synthesize(model, params, call)
    finally:
        for name, fn in saved.items():
            setattr(tfm, name, fn)
        del model._graphable
    return records


def judge(ctx: Dict, state: Dict, record: Dict) -> Dict:
    """Hold the judged calls' codes and waveforms against the reference, as
    ``closed_batch.judge`` does, with the hybrid talker's reference, and the
    expert layers of the first judged call on their own inputs."""
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
    records = expert_records(state["model"], params, picked[0]) if picked else []
    attempted = sum(len(c["texts"]) for c in record["calls"])
    state.clear()
    record["calls"] = [{k2: v for k2, v in c.items() if k2 not in ("waves", "codes")}
                       for c in record["calls"]]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    device, chunk, control = ctx["device"], params["chunk"], bool(ctx.get("control"))
    with ref.run_float32():
        tree = lfm2.make_params(cfg, ctx["seed"], device)
        gaps, pairs = ref.Gaps(), []
        for c in judged:
            for row, text in enumerate(c["texts"]):
                # A row the call did not return is judged at its pinned length.
                end = c["ends"][row] if row < len(c["ends"]) else params["frames"]
                codes = c["codes"][row, : min(end + 1, c["codes"].shape[1])].to(device)
                gaps.add(ref.served_gaps(tree, cfg, text, c["speaker"], codes, params["frames"],
                                         c["greedy"]))
                want = qwen_tts.whole_waveform(tree, cfg, codes[:end], chunk)
                # The control puts the reference's vocoder, in float8, in the program's place.
                got = (qwen_tts.whole_waveform(tree, cfg, codes[:end], chunk, low_precision=True)
                       if control else c["waves"][row].to(device) if row < len(c["waves"])
                       else None)
                pairs.append((got, want))
        readings = dict(gaps.readings(), waveform_rel_err=qwen_tts.judge_waveforms(pairs))
        if records:
            readings.update(ref.expert_readings(tree, cfg, records))
    return {"readings": readings, "compared": len(pairs), "tokens": gaps.count,
            "attempted": attempted, "failed": 0}
