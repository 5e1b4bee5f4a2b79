"""Open-loop streaming traffic into ``ServingEngine``, as a TTS API server sees it.

Requests arrive on a schedule, whatever the server's state, each streamed
(``stream=True``) to a client thread that reads ``chunks()`` and copies each
piece to the host, where it stamps it. A request's times run from when it
was due, so a late generator or a queue delays it.

Parameters (the cell's ``traffic``):

* ``rate``: requests a second; ``n = round(rate * seconds)`` are due in the
  window. Their gaps are the exponential distribution's quantiles at
  ``(i + 0.5) / n`` and their frame counts the lognormal's (``median_frames``,
  ``sigma``), clipped to ``[min_frames, max_frames]`` and rounded up to whole
  ``chunk`` frames, each list in an order drawn from the seed: every seed
  offers the same work, in another order. The gaps are scaled to end at the
  window's close.
* every request is pinned to its frames (``min_frames = max_frames``); its
  text has ``chars_per_frame`` characters a frame, clipped to ``chars``
  (the engine's ``max_prompt`` bounds the prompt); words, speaker and
  sampling seed are drawn from the seed; every ``greedy_every``-th request
  (the first included) samples greedily (temperature 0), the rest at
  ``temperature``;
* ``engine``: the ``ServingEngine`` arguments (``n_slots``, ``max_prompt``,
  ``max_frames``, ``top_k``);
* ``warmup``: requests of ``warmup_frames`` served before the window;
* ``drain_s``: how long after the window's close a request may still finish;
  one that has not is failed;
* ``judge``: how many greedy and sampled requests the check holds against the
  reference, beside the longest; ``chunk`` and ``stream_context``: the
  engine's decode chunk and streaming context, which fix its pieces' windows.
"""

from __future__ import annotations

import gc
import math
import statistics
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import roofline, system, trace, weights
from benchmark.reference import qwen_tts as ref
from benchmark.texts import sentence

WARMUP = 1 << 40  # the warm-up's stream of draws, apart from the window's


def schedule(params: Dict, seed: int, seconds: float) -> List[Dict]:
    """The window's requests: due time (s from the window's start), frames,
    text, speaker, seed, temperature."""
    n = max(1, round(params["rate"] * seconds))
    rng = np.random.default_rng([int(seed), 1])
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / params["rate"])
    due = np.cumsum(gaps) * (seconds / gaps.sum())
    z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in q])
    frames = np.exp(math.log(params["median_frames"]) + params["sigma"] * z)
    chunk = params["chunk"]
    frames = np.clip(frames, params["min_frames"], params["max_frames"])
    frames = rng.permutation((np.ceil(frames / chunk) * chunk).astype(int))
    return [_request(params, rng, i, float(due[i]), int(frames[i])) for i in range(n)]


def _request(params: Dict, rng, i: int, due: float, frames: int) -> Dict:
    lo, hi = params["chars"]
    chars = int(np.clip(round(params["chars_per_frame"] * frames), lo, hi))
    greedy = i % params["greedy_every"] == 0
    return {"i": i, "due": due, "frames": frames, "text": sentence(rng, chars),
            "speaker": params["speakers"][int(rng.integers(len(params["speakers"])))],
            "seed": int(rng.integers(0, 2**31 - 1)), "greedy": greedy,
            "temperature": 0.0 if greedy else float(params["temperature"])}


class _Client(threading.Thread):
    """Reads one streamed request's pieces, copying each to the host."""

    def __init__(self, req, timeout: float):
        super().__init__(daemon=True)
        self.req, self.timeout = req, timeout
        self.pieces: List[torch.Tensor] = []
        self.t_first = self.t_last = None
        self.error = None

    def run(self):
        try:
            for piece, _sr in self.req.chunks(timeout=self.timeout):
                self.pieces.append(piece.cpu())
                self.t_last = time.time()
                if self.t_first is None:
                    self.t_first = self.t_last
        except BaseException as e:  # noqa: BLE001 — recorded: the request failed
            self.error = e


def _submit(engine, r: Dict, timeout: float) -> Dict:
    req = engine.submit(r["text"], speaker=r["speaker"], min_frames=r["frames"],
                        max_frames=r["frames"], temperature=r["temperature"], stream=True,
                        seed=r["seed"])
    client = _Client(req, timeout)
    client.start()
    return {"req": req, "client": client}


def hooks(engine) -> None:
    """Refuse to run where a private name the traced window reads is gone:
    the dispatch it profiles and the ring's state it counts the stretch's
    work from. Without them the metrics would read nothing, or the wrong thing."""
    missing = [n for n in ("_dispatch", "_key_valid", "_col", "_active", "ring", "chunk")
               if not hasattr(engine, n)]
    if missing:
        raise RuntimeError(f"ServingEngine no longer has {missing}: open_stream cannot hook it")


def setup(ctx: Dict) -> Dict:
    """Build the model and the engine; serve the warm-up requests; then idle."""
    params = ctx["params"]
    model = system.build_model(ctx["config"], ctx["seed"], ctx["device"],
                               bool(ctx.get("control")))
    engine = system.serving_engine(model, **params["engine"])
    hooks(engine)
    engine.start()
    rng = np.random.default_rng([int(ctx["seed"]), WARMUP])
    warm = [_submit(engine, _request(params, rng, i, 0.0, params["warmup_frames"]), 600.0)
            for i in range(params["warmup"])]
    for w in warm:
        w["client"].join(timeout=600.0)
        if w["client"].error is not None or w["client"].is_alive():
            raise RuntimeError(f"warm-up request failed: {w['client'].error!r}")
    return {"model": model, "engine": engine}


def _counters(engine) -> Dict:
    return {k: getattr(engine, k) for k in ("frames_decoded", "dispatches", "admissions",
                                              "requests_done")}


def window(ctx: Dict, state: Dict) -> Dict:
    """Offer the schedule; drain; stamp every request."""
    params, engine, seconds = ctx["params"], state["engine"], ctx["seconds"]
    reqs = schedule(params, ctx["seed"], seconds)
    drain = float(params["drain_s"])
    stretch = None
    t0 = time.time()
    start = _counters(engine)
    cut = {}
    if ctx["trace"]:
        def before(*args, **kwargs):
            cut.update(t=time.time(), counters=_counters(engine))
            return {"what": "serve_dispatch", "steps": int(engine.chunk),
                    "valid0": engine._key_valid.cpu().numpy(), "col0": int(engine._col),
                    "active": engine._active.copy()}

        # The first dispatch past three quarters of the window: a loaded, steady
        # stretch. Profiling stalls the engine for seconds (the profiler's stop),
        # so the traced run's stamps and counters are read up to this cut only.
        stretch = trace.Stretch(engine._dispatch, lambda: time.time() >= t0 + 0.75 * seconds,
                                before)
        engine._dispatch = stretch
    for r in reqs:
        wait = t0 + r["due"] - time.time()
        if wait > 0:
            time.sleep(wait)
        r["t_due"] = t0 + r["due"]
        r.update(_submit(engine, r, seconds + drain + 60.0))
        r["late_s"] = r["req"].t_submit - r["t_due"]
    wait = t0 + seconds - time.time()
    if wait > 0:
        time.sleep(wait)
    at_close = _counters(engine)
    deadline = t0 + seconds + drain
    for r in reqs:
        r["client"].join(timeout=max(0.0, deadline - time.time()))
    if stretch is not None:
        engine._dispatch = stretch.fn
    record = {"kind": "serve", "t0": t0, "seconds": seconds, "deadline": deadline,
              "requests": reqs, "n_slots": engine.n_slots,
              "chunk": engine.chunk, "counters_window": {k: at_close[k] - start[k] for k in start}}
    if stretch is not None and stretch.prof is not None:
        record["stretch"] = _stretch_work(ctx["config"], engine.ring, stretch.reduce())
        record["cut"] = {"t": cut["t"],
                         "counters": {k: cut["counters"][k] - start[k] for k in start}}
    return record


def _stretch_work(cfg: Dict, ring: int, st: Dict) -> Dict:
    """Add the traced dispatch's model FLOPs (live rows) and decode-attention
    work (every row's valid keys, the kernel's inputs), step by step: each
    step marks its ring column valid for the live rows and invalid for the
    rest."""
    valid, active = st.pop("valid0").copy(), st.pop("active")
    flops = att_bytes = att_ops = 0
    for t in range(st["steps"]):
        valid[:, (st["col0"] + t) % ring] = active
        keys = valid.sum(axis=1)
        flops += roofline.decode_step_flops(cfg, [int(k) for k in keys[active]])
        b, o = roofline.decode_attention_work(cfg, [int(k) for k in keys], ring)
        att_bytes += b * cfg["talker"]["layers"]
        att_ops += o * cfg["talker"]["layers"]
    st.update(model_flops=flops, attention_bytes=att_bytes, attention_ops=att_ops,
              attention_calls=st["steps"] * cfg["talker"]["layers"],
              live_rows=int(active.sum()))
    return st


def judge(ctx: Dict, state: Dict, record: Dict) -> Dict:
    """Stamp every request, close the engine, free the program, and hold the
    longest finished request and a sample drawn from the seed against the
    reference: the served codes, and the streamed pieces joined."""
    params, cfg = ctx["params"], ctx["config"]
    engine = state["engine"]
    engine.close()  # fails whatever is still queued or in flight
    for r in record["requests"]:
        r["client"].join(timeout=60.0)
    reqs, finished = record["requests"], []
    for r in reqs:
        c, req = r.pop("client"), r.pop("req")
        r["t_submit"], r["t_admit"] = req.t_submit, req.t_admit
        r["t_first"], r["t_last"] = c.t_first, c.t_last
        r["ok"] = (c.error is None and not c.is_alive() and c.t_last is not None
                   and c.t_last <= record["deadline"])
        r["error"] = None if c.error is None else repr(c.error)
        codes = req.codes if r["ok"] else None
        if r["ok"] and codes.shape[0] != r["frames"]:  # pinned: every frame up to its budget
            r["ok"], r["error"] = False, f"{codes.shape[0]} frames served of {r['frames']}"
        if r["ok"]:
            finished.append((r, codes, torch.cat(c.pieces)))
    state.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    rng = np.random.default_rng([int(ctx["seed"]), 7])
    longest = max(range(len(finished)), key=lambda j: finished[j][0]["frames"], default=None)
    picked = [] if longest is None else [longest]
    for greedy, k in ((True, params["judge"]["greedy"]), (False, params["judge"]["sampled"])):
        pool = [j for j, f in enumerate(finished) if f[0]["greedy"] == greedy and j != longest]
        picked += [pool[j] for j in rng.choice(len(pool), min(k, len(pool)), replace=False)]
    device, control = ctx["device"], bool(ctx.get("control"))
    chunk, context = params["chunk"], params["stream_context"]
    with ref.run_float32():
        tree = weights.make_params(cfg, ctx["seed"], device)
        gaps, pairs = ref.Gaps(), []
        for j in picked:
            r, codes, joined = finished[j]
            codes = torch.as_tensor(codes).to(device)
            g = ref.served_gaps(tree, cfg, r["text"], r["speaker"], codes, r["frames"],
                                system.quantization(cfg), r["greedy"])
            gaps.add(g)
            want = ref.streamed_waveform(tree, cfg, codes, r["frames"], chunk, context)
            # The control puts the reference's vocoder, in float8, in the program's place.
            got = (ref.streamed_waveform(tree, cfg, codes, r["frames"], chunk, context, True)
                   if control else joined.to(device))
            pairs.append((got, want))
        readings = dict(gaps.readings(), stream_rel_err=ref.judge_waveforms(pairs))
    # A request that never finished, finished with an error or served another
    # length than it was pinned to is no answer.
    readings["requests_failed"] = float(sum(not r["ok"] for r in reqs))
    return {"readings": readings, "compared": len(pairs), "tokens": gaps.count,
            "attempted": len(reqs), "failed": sum(not r["ok"] for r in reqs)}
