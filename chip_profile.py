"""Where the time of the port's main path goes on one NVIDIA GPU.

Run from the repository root:

    python3 chip_profile.py [--quantization int8|int4] [--w8a8-prefill] [--stage decode|prefill]
    python3 chip_profile.py --stage train|lora

Builds Qwen3-TTS 1.7B (weight-only int8 by default, or int4; batch 5,
random weights) as ``chip_smoke.py`` does and runs its ``synthesize()`` in
decode chunks of 8 steps: once to warm up, then again with one stage under
``torch.profiler``. ``--stage decode`` (the default) profiles the LAST
decode chunk of 256 frames (the full 384-slot cache); ``--stage prefill``
profiles the prefill of 128 slots (one 8-step chunk follows it).
``--w8a8-prefill`` sets ``RHO_TTS_TPU_W8A8_PREFILL=1`` (int8 only). Prints
one JSON line: the device time by kernel name (top 25), the device busy
time, the wall time of the stage and the device's idle share, and the
kernel launches (per decode step for the decode stage). ``--stage train``
and ``--stage lora`` profile one training step of ``chip_smoke.py``'s phase
11 instead (the 1.7B dense bf16, batch 4 x (64 text tokens + 256 frames);
``train_step`` with ``make_optimizer()``'s AdamW, or ``lora_train_step`` at
rank 8 on ``wqkv`` / ``wo``) after two warm-up steps. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

import chip_smoke

STEPS = 8  # decode steps per chunk while profiling
FRAMES = 256  # as chip_smoke.py: the profiled last chunk sees the full 384-slot cache


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="device time by kernel of one stage")
    parser.add_argument("--quantization", choices=["int8", "int4"], default="int8")
    parser.add_argument("--w8a8-prefill", action="store_true")
    parser.add_argument("--stage", choices=["decode", "prefill", "train", "lora"],
                        default="decode")
    args = parser.parse_args(argv)
    if args.w8a8_prefill and args.quantization != "int8":
        parser.error("--w8a8-prefill needs --quantization int8")
    if not torch.cuda.is_available():
        print("chip_profile: a CUDA device is required", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    os.environ["RHO_TTS_TPU_DECODE_CHUNK"] = str(STEPS)
    if args.w8a8_prefill:
        os.environ["RHO_TTS_TPU_W8A8_PREFILL"] = "1"
    from rho_tts_tpu_torch.models.qwen import model as qmodel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    if args.stage in ("train", "lora"):
        print(json.dumps({"profile": _profile_training(args.stage)}))
        print(smi)
        return 0
    model = qmodel.QwenTTSModel(qmodel.PRESETS["1.7B"], seed=0, quantization=args.quantization,
                                device="cuda")
    frames = FRAMES if args.stage == "decode" else STEPS
    kw = dict(min_frames=frames, max_frames=frames, top_k=50,
              seeds=list(range(len(chip_smoke.TEXTS))))
    model.synthesize(chip_smoke.TEXTS, **kw)  # warm-up
    torch.cuda.synchronize()

    # Profile one call of the stage function that synthesize() calls, with
    # the device idle before and after: the prefill, or the last decode chunk.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    attr = "_decode_chunk" if args.stage == "decode" else "_prefill"
    stage_fn = getattr(qmodel, attr)
    runs = []

    def profiled(*fargs, **kwargs):
        if args.stage == "decode" and fargs[5] + STEPS < fargs[2].shape[2]:  # slot0, cache_k
            return stage_fn(*fargs, **kwargs)  # not the last chunk
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = stage_fn(*fargs, **kwargs)
            torch.cuda.synchronize()
            runs.append((prof, (time.perf_counter() - t0) * 1e6))
        return out

    setattr(qmodel, attr, profiled)
    try:
        model.synthesize(chip_smoke.TEXTS, **kw)
    finally:
        setattr(qmodel, attr, stage_fn)
    (prof, wall_us), = runs
    mode = args.quantization + (" + w8a8 prefill" if args.w8a8_prefill else "")
    what = (f"the last decode chunk ({STEPS} steps) of {FRAMES} frames" if args.stage == "decode"
            else "the prefill (128 slots)")
    report = _summary(prof, wall_us, f"1.7B {mode} batch 5, prompt 128: {what}")
    if args.stage == "decode":
        report["launches_per_decode_step_approx"] = report["kernel_launches"] / STEPS
    print(json.dumps({"profile": report}))
    print(smi)
    return 0


def _profile_training(stage: str) -> dict:
    """One ``train_step`` or ``lora_train_step`` of phase 11 under the profiler."""
    from rho_tts_tpu_torch.models.qwen import PRESETS, lora, train
    from rho_tts_tpu_torch.models.qwen.model import init_params

    cfg = PRESETS[chip_smoke.TRAIN_PRESET]
    batch = chip_smoke._train_batch(cfg, chip_smoke.TRAIN_SHAPE, "cuda")
    params = init_params(cfg, chip_smoke.TRAIN_SEED, "cuda")
    if stage == "train":
        opt = train.make_optimizer()
        state = opt.init(params)

        def step():
            train.train_step(params, state, batch, cfg, opt)
    else:
        adapters, state, opt = lora.init_lora_train_state(cfg, params, rank=chip_smoke.LORA_RANK)

        def step():
            lora.lora_train_step(params, adapters, state, batch, cfg, opt)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    b, tt, tc = chip_smoke.TRAIN_SHAPE
    what = ("train_step (AdamW)" if stage == "train"
            else f"lora_train_step (rank {chip_smoke.LORA_RANK})")
    return _summary(prof, wall_us, f"{cfg.name} dense bf16, batch {b} x ({tt} + {tc}): {what}")


def _summary(prof, wall_us: float, what: str) -> dict:
    """Device time by kernel name (top 25), device busy time and idle share."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    # Device busy time: the union of the kernels' intervals on the timeline.
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0.0, 0])
        d[0] += e.time_range.end - e.time_range.start
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    total = sum(v[0] for v in by_name.values())
    return {
        "what": what,
        "wall_us": wall_us, "device_busy_us": busy, "device_idle_share": 1 - busy / wall_us,
        "kernel_us_total": total, "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:120], "us": v[0], "calls": v[1], "share": v[0] / total}
                        for n, v in top],
    }


if __name__ == "__main__":
    sys.exit(main())
