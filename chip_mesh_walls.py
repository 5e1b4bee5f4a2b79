"""Walls of the one-shot path unmeshed and on DP and TP meshes of one.

Run from the repository root on one NVIDIA GPU:

    python3 chip_mesh_walls.py

``chip_smoke.py`` phase 12 b in more rounds: the 1.7B int8 (random
weights from a seed), batch 5, a 128-slot prompt, 2 chunks of 64 through
``synthesize``, on three models: unmeshed (U), under
``enable_data_parallel`` (D) and under ``enable_tensor_parallel`` (T) on a
mesh of one of an NCCL world of one. Each is warmed up once, then each is
timed ``ROUNDS`` times in a seeded shuffled order, so that a drift of the
host's speed over the run does not follow the variant. Every run's codes
must equal the first run's. Prints one JSON line (every wall in order,
and each variant's walls, median, quartiles and mean), writes it to
``chiprun_out/mesh_walls.json``, then the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 6  # walls a variant: quartiles of 6 show a spread of +-20% a wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_mesh_walls: a CUDA device is required", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from rho_tts_tpu_torch.models.qwen import model as qmodel
    from rho_tts_tpu_torch.ops.cuda import _build
    from rho_tts_tpu_torch.parallel import collectives, inference, mesh

    for name in _build.build_all():
        _build.load(name)
    smi = chip_smoke.nvidia_smi_line()
    mesh.initialize_distributed(f"127.0.0.1:{mesh.free_port()}", 1, 0, local_rank=0)
    one = mesh.create_mesh(1, model_parallel=1)
    cfg = qmodel.PRESETS["1.7B"]
    frames = 2 * qmodel._chunk()
    texts = chip_smoke.TEXTS
    kw = dict(min_frames=frames, max_frames=frames, top_k=50, seeds=list(range(len(texts))))
    models = {}
    for key, enable in (("U", None), ("D", inference.enable_data_parallel),
                        ("T", inference.enable_tensor_parallel)):
        models[key] = qmodel.QwenTTSModel(cfg, seed=0, quantization="int8", device="cuda")
        if enable is not None:
            enable(models[key], one)
        models[key].synthesize(texts, **kw)  # warm-up
    torch.cuda.synchronize()

    order = "".join(np.random.default_rng(0).permutation(list("UDT" * ROUNDS)))
    walls = {key: [] for key in models}
    ref = None
    collectives.launches = 0
    for key in order:
        t0 = time.perf_counter()
        codes, _waves, _sr = chip_smoke.synthesize_codes(models[key], kw)
        torch.cuda.synchronize()
        walls[key].append(time.perf_counter() - t0)
        if ref is None:
            ref = codes
        elif not torch.equal(codes, ref):
            raise AssertionError(f"variant {key}: codes differ from the first run's")
    if collectives.launches:
        raise AssertionError(f"{collectives.launches} collectives launched on a mesh of one")
    mesh.shutdown_distributed()

    def summary(xs):
        q1, med, q3 = np.percentile(xs, [25, 50, 75])
        return {"walls_s": xs, "median_s": float(med), "q1_s": float(q1), "q3_s": float(q3),
                "mean_s": float(np.mean(xs))}

    out = {"card": smi, "preset": "1.7B", "quantization": "int8", "batch": len(texts),
           "frames": frames, "order": order, "codes_equal": True,
           "variants": {key: summary(xs) for key, xs in walls.items()}}
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "mesh_walls.json"), "w") as f:
        f.write(line + "\n")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
