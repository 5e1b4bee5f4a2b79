"""Closed-loop offline batches on the state-space hybrid talker (``granite.py``'s configuration).

The traffic is ``closed_batch``'s, with the same parameters: back-to-back
``QwenTTSModel.synthesize()`` calls of ``batch`` texts and one speaker, every
row pinned to ``frames`` frames, every ``greedy_every``-th call greedy. The
calls, the synthesize wrapper and the hooks on the program's private names
are ``closed_batch``'s own (imported); what differs is the configuration's:
the model is built by ``granite.py`` (``control``: its float8 weights), the
traced chunk's work is counted by ``roofline_granite.py`` (with the distinct
experts each expert layer ran at each of its steps, which the program puts
on the chunk's ``qwen/decode_chunk`` span as ``experts_touched``, read as
``closed_batch_lfm2`` reads it), and the judged calls are held against
``reference/granite_talker.py``: the whole utterances teacher-forced, and,
on the first judged call run again after the window with its decode steps
eager, each expert layer and each Mamba layer on its own inputs over the
whole call (``expert_rel_err``, ``ssm_rel_err``).
"""

from __future__ import annotations

import gc
import inspect
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import granite, roofline, roofline_granite, system, trace
from benchmark.reference import granite_talker as ref
from benchmark.reference import qwen_tts
from benchmark.traffic import closed_batch
from benchmark.traffic.closed_batch_lfm2 import traced_touched

WARMUP_CALL = closed_batch.WARMUP_CALL
#: the program's names the judge's rerun wraps where the talker looks them up
WRAPPED = ("moe_experts", "grouped_experts", "_mamba_mixer", "ssm_step", "ssm_prefill")


def hooks(qmodel) -> None:
    """``closed_batch``'s hooks, and the talker's entry points the judge wraps."""
    closed_batch.hooks(qmodel)
    missing = [n for n in WRAPPED if not callable(getattr(qmodel.tfm, n, None))]
    if missing:
        raise RuntimeError(f"the program's talker has no {missing}: the judge cannot hook it")


def setup(ctx: Dict) -> Dict:
    """Build the model from the seed's weights and warm up one call of the
    cell's shapes."""
    hooks(system.model_module())
    model = granite.build_model(ctx["config"], ctx["seed"], ctx["device"],
                                bool(ctx.get("control")))
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
        record["stretch"] = stretch_work(ctx["config"], stretch.reduce(), traced_touched(t0))
    return record


def stretch_work(cfg: Dict, st: Dict, touched) -> Dict:
    """Add the traced chunk's model FLOPs, its decode-attention work over the
    attention layers, the Mamba decode kernel's work (every Mamba layer at
    every step) and, from the program's counts, the routed-expert kernel's:
    every row is live, and at step t holds its prompt, its frames so far and
    the new one."""
    att = roofline_granite.attention_config(cfg)
    layers = att["talker"]["layers"]
    flops = att_bytes = att_ops = 0
    for t in range(st["steps"]):
        keys = [k + t + 1 for k in st["row_keys0"]]
        flops += roofline_granite.decode_step_flops(cfg, keys)
        b, o = roofline.decode_attention_work(att, keys, st["cache_len"])
        att_bytes += b * layers
        att_ops += o * layers
    rows = len(st["row_keys0"])
    ssm_calls = st["steps"] * granite.sizes(cfg)["mamba"]
    ssm_bytes, ssm_ops = roofline_granite.ssm_step_work(cfg, rows)
    st.update(model_flops=flops, attention_bytes=att_bytes, attention_ops=att_ops,
              attention_calls=st["steps"] * layers, ssm_calls=ssm_calls,
              ssm_bytes=ssm_bytes * ssm_calls, ssm_ops=ssm_ops * ssm_calls)
    if touched is not None and len(touched) == st["steps"]:
        work = [roofline_granite.expert_work(cfg, rows, n) for step in touched for n in step]
        st.update(experts_touched=touched, expert_calls=len(work),
                  expert_bytes=sum(b for b, _ in work), expert_ops=sum(o for _, o in work))
    return st


def _host(t):
    return None if t is None else t.detach().to("cpu", copy=True)


def layer_records(model, params: Dict, call: Dict):
    """Run ``call`` again with the decode steps eager (no CUDA graph), and
    keep, on the host, each call of an expert layer's routed experts (its
    input, the experts chosen, its output: ``ref.expert_readings``'s
    records) and of a Mamba mixer (its input, validity, ``in_proj`` output,
    states before the call's first forward, scan output and output), prefill
    and decode, and each Mamba layer's scan state after the call
    (``ref.ssm_readings``'s). The
    program's entry points are wrapped where the talker looks them up; the
    run is after the window, outside every measurement."""
    tfm = system.model_module().tfm
    saved = {name: getattr(tfm, name) for name in WRAPPED}
    n_mamba = model.config.talker.mamba_layers
    experts: List = []
    mamba: List = []
    live: List = []  # each Mamba layer's scan state, as the call's last forward left it
    scan: Dict = {}  # the mixer's call in flight: its in_proj output and scan output

    def keep_experts(fn):
        def run(h, idx, weight, *rest):
            out = fn(h, idx, weight, *rest)
            experts.append((_host(h), _host(idx), _host(out)))
            return out
        return run

    def keep_scan(fn):
        def run(zxbcdt, *rest):
            scan["in"] = _host(zxbcdt)
            scan["gated"] = fn(zxbcdt, *rest)
            return scan["gated"]
        return run

    def keep_mamba(params_, cfg, h, conv_state, ssm_state, attn_mask):
        first = len(mamba) < n_mamba  # the call's prefill: the states it starts from
        before = (_host(conv_state), _host(ssm_state)) if first else (None, None)
        out = saved["_mamba_mixer"](params_, cfg, h, conv_state, ssm_state, attn_mask)
        gated = scan.pop("gated")
        rows = h.shape[:2]  # a decode step's scan sees (B, W), a prefill's (B, T, W)
        mamba.append((_host(h), _host(attn_mask), scan.pop("in").view(*rows, -1), *before,
                      _host(gated.view(*rows, -1)), _host(out)))
        live.append(ssm_state)
        del live[:-n_mamba]
        return out

    model._graphable = lambda: False
    tfm.moe_experts = keep_experts(saved["moe_experts"])
    tfm.grouped_experts = keep_experts(saved["grouped_experts"])
    tfm._mamba_mixer = keep_mamba
    tfm.ssm_step = keep_scan(saved["ssm_step"])
    tfm.ssm_prefill = keep_scan(saved["ssm_prefill"])
    try:
        closed_batch._synthesize(model, params, call)
        finals = [_host(s) for s in live]
    finally:
        for name, fn in saved.items():
            setattr(tfm, name, fn)
        del model._graphable
    return experts, (mamba, finals)


def judge(ctx: Dict, state: Dict, record: Dict) -> Dict:
    """Hold the judged calls' codes and waveforms against the reference, as
    ``closed_batch.judge`` does, with the state-space talker's reference (the
    judged utterances through the talker together), and the expert and
    Mamba layers of the first judged call on their own inputs."""
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
    experts, mamba = layer_records(state["model"], params, picked[0]) if picked else ([], None)
    attempted = sum(len(c["texts"]) for c in record["calls"])
    state.clear()
    record["calls"] = [{k2: v for k2, v in c.items() if k2 not in ("waves", "codes")}
                       for c in record["calls"]]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    device, chunk, control = ctx["device"], params["chunk"], bool(ctx.get("control"))
    with ref.run_float32():
        tree = granite.make_params(cfg, ctx["seed"], device)
        utterances, pairs = [], []
        for c in judged:
            for row, text in enumerate(c["texts"]):
                # A row the call did not return is judged at its pinned length.
                end = c["ends"][row] if row < len(c["ends"]) else params["frames"]
                codes = c["codes"][row, : min(end + 1, c["codes"].shape[1])].to(device)
                utterances.append({"text": text, "speaker": c["speaker"], "codes": codes,
                                   "judge_primary": c["greedy"]})
                want = qwen_tts.whole_waveform(tree, cfg, codes[:end], chunk)
                # The control puts the reference's vocoder, in float8, in the program's place.
                got = (qwen_tts.whole_waveform(tree, cfg, codes[:end], chunk, low_precision=True)
                       if control else c["waves"][row].to(device) if row < len(c["waves"])
                       else None)
                pairs.append((got, want))
        gaps = ref.Gaps()
        for g in (ref.served_gaps(tree, cfg, utterances, params["frames"]) if utterances else []):
            gaps.add(g)
        readings = dict(gaps.readings(), waveform_rel_err=qwen_tts.judge_waveforms(pairs))
        if experts:
            readings.update(ref.expert_readings(tree, cfg, experts))
        if mamba:
            readings.update(ref.ssm_readings(tree, cfg, *mamba))
    return {"readings": readings, "compared": len(pairs), "tokens": gaps.count,
            "attempted": attempted, "failed": 0}
