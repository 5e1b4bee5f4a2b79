"""Where the time of the port's main path goes on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_profile.py

Builds Qwen3-TTS 1.7B (weight-only int8, batch 5, random weights) as
``chip_smoke.py`` does and runs its 256-frame ``synthesize()`` in decode
chunks of 8 steps: once to warm up, then again with the LAST chunk (the
full 384-slot cache) under ``torch.profiler``. Prints one JSON line: the
device time by kernel name (top 25), the device busy time, the wall time
of the chunk and the device's idle share, and the kernel launches per
decode step. Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

import chip_smoke

STEPS = 8  # decode steps per chunk while profiling
FRAMES = 256  # as chip_smoke.py: the profiled last chunk sees the full 384-slot cache


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: a CUDA device is required", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    os.environ["RHO_TTS_TPU_DECODE_CHUNK"] = str(STEPS)
    from rho_tts_tpu_torch.models.qwen import model as qmodel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    model = qmodel.QwenTTSModel(qmodel.PRESETS["1.7B"], seed=0, quantization="int8", device="cuda")
    kw = dict(min_frames=FRAMES, max_frames=FRAMES, top_k=50,
              seeds=list(range(len(chip_smoke.TEXTS))))
    model.synthesize(chip_smoke.TEXTS, **kw)  # warm-up
    torch.cuda.synchronize()

    # Profile the last decode chunk alone: wrap the stage function that
    # synthesize() calls, with the device idle before and after.
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    decode_chunk = qmodel._decode_chunk
    runs = []

    def profiled(*args, **kwargs):
        if args[5] + STEPS < args[2].shape[2]:  # slot0, cache_k
            return decode_chunk(*args, **kwargs)  # not the last chunk
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = decode_chunk(*args, **kwargs)
            torch.cuda.synchronize()
            runs.append((prof, (time.perf_counter() - t0) * 1e6))
        return out

    qmodel._decode_chunk = profiled
    try:
        model.synthesize(chip_smoke.TEXTS, **kw)
    finally:
        qmodel._decode_chunk = decode_chunk
    (prof, wall_us), = runs

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
    print(json.dumps({
        "profile": {
            "what": f"1.7B int8 batch 5, prompt 128: the last decode chunk ({STEPS} steps) "
                    f"of {FRAMES} frames",
            "wall_us": wall_us, "device_busy_us": busy, "device_idle_share": 1 - busy / wall_us,
            "kernel_us_total": total, "kernel_launches": len(kernels),
            "launches_per_decode_step_approx": len(kernels) / STEPS,
            "top_kernels": [{"name": n[:120], "us": v[0], "calls": v[1], "share": v[0] / total}
                            for n, v in top],
        }
    }))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
