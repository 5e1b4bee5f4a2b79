"""A multi-process dry run certifying process-spanning data parallelism
(PyTorch port of ``rho_tts_tpu/parallel/multihost_dryrun.py``).

N OS processes rendezvous through ``initialize_distributed`` (the plumbing
a multi-node ``torchrun`` job uses), build a mesh over the world
(``create_multihost_mesh``, model parallelism 1) and run two workloads
with rows split over the global ``data`` axis:

1. tiny-Qwen prefill plus an 8-step greedy decode chain over the stacked
   caches (``models.transformer.stack_forward``), tokens all-gathered;
2. the continuous-batching :class:`~rho_tts_tpu_torch.serving.ServingEngine`
   itself: admission prefill, ring scatters, the lagged done-flag harvest
   (all-gathered over ``data``) and retire vocode, every process driving
   the same deterministic scheduler.

Certification: every process's gathered tokens and codes equal a
process-local reference bit for bit. The processes run gloo on the CPU,
or NCCL with one card each where there are as many cards as processes.

Run one worker per process::

    python -m rho_tts_tpu_torch.parallel.multihost_dryrun \\
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I --out FILE

or the whole rendezvous with :func:`run_dryrun`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile


def _worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models import transformer as tfm
    from ..models.qwen import PRESETS
    from ..models.qwen.model import QwenTTSModel, init_params
    from ..serving import ServingEngine
    from .collectives import all_gather
    from .inference import enable_data_parallel
    from .mesh import create_multihost_mesh, initialize_distributed, shutdown_distributed

    torch.set_num_threads(1)
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           device=args.device, local_rank=args.process_id)
    dev = torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda" else \
        torch.device("cpu")
    cfg = PRESETS["tiny"]
    params = init_params(cfg, seed=0, device=dev)
    mesh = create_multihost_mesh(model_parallel=1)
    data = mesh.axis("data")

    b, p, steps = 8, 32, 8
    s = p + steps
    gen = torch.Generator(device="cpu").manual_seed(1)
    embeds = torch.randn((b, p, cfg.talker.hidden), generator=gen).to(dev, cfg.talker.dtype)
    rope = torch.arange(p, device=dev).expand(b, p)

    @torch.inference_mode()
    def program(embeds, rope):
        """Prefill + a greedy decode chain over this process's rows."""
        n = embeds.shape[0]
        ck, cv = tfm.make_kv_cache(cfg.talker, n, s, device=dev)
        key_valid = torch.zeros((n, s), dtype=torch.bool, device=dev)
        h, _ = tfm.stack_forward(params["talker"], cfg.talker, embeds, rope, kv_caches=(ck, cv),
                                 cache_len=0, attn_mask=torch.ones((n, p), dtype=torch.bool,
                                                                   device=dev),
                                 key_valid=key_valid, fused_prefill=True)
        key_valid[:, :p] = True
        lm_head = params["lm_head"].float()
        toks = [torch.argmax(h[:, -1].float() @ lm_head, dim=-1)]
        for t in range(steps):
            x = params["audio_embed"][0][toks[-1]][:, None, :]
            pos = torch.full((n, 1), p + t, dtype=torch.int64, device=dev)
            h, _ = tfm.stack_forward(params["talker"], cfg.talker, x, pos, kv_caches=(ck, cv),
                                     cache_len=p + t, key_valid=key_valid)
            key_valid[:, p + t] = True
            toks.append(torch.argmax(h[:, -1].float() @ lm_head, dim=-1))
        return torch.stack(toks, dim=1)  # (n, steps + 1)

    ref = program(embeds, rope).cpu().numpy()
    rows = slice(data.index * (b // data.size), (data.index + 1) * (b // data.size))
    toks = all_gather(program(embeds[rows], rope[rows]), 0, data).cpu().numpy()
    ok = bool(np.array_equal(toks, ref))

    texts = [
        "multi host serving row one",
        "second request rides another process",
        "third utterance fills the ring",
        "fourth row",
        "a fifth request queues behind the slots",
    ]
    n_slots = int(mesh.shape["data"])  # one slot per data shard

    def run_engine(m):
        eng = ServingEngine(m, n_slots=n_slots, max_prompt=64, max_frames=64, top_k=1)
        reqs = [eng.submit(t, min_frames=8, max_frames=64) for t in texts]
        eng.run_until_idle()
        assert all(r.done() for r in reqs)
        out = [r.codes for r in reqs]
        eng.close()
        return out

    ref_codes = run_engine(QwenTTSModel(cfg, params=params, device=dev))
    meshed = QwenTTSModel(cfg, params=params, device=dev)
    enable_data_parallel(meshed, mesh)
    mesh_codes = run_engine(meshed)
    serve_ok = all(np.array_equal(x, y) for x, y in zip(ref_codes, mesh_codes))
    ok = ok and serve_ok
    with open(args.out, "w") as fh:
        fh.write(
            f"{'OK' if ok else 'MISMATCH'} proc={args.process_id} "
            f"procs={args.num_processes} device={args.device} mesh={mesh.shape} "
            f"checksum={int(toks.sum())} serve={'OK' if serve_ok else 'MISMATCH'} "
            f"serve_slots={n_slots} serve_reqs={len(texts)} "
            f"serve_checksum={sum(int(c.sum()) for c in mesh_codes)}\n")
    shutdown_distributed()
    return 0 if ok else 1


def run_dryrun(n_processes: int = 2, timeout: int = 600, device=None):
    """Spawn the N-process rendezvous on this host; returns the per-process
    report lines. Raises on any mismatch, nonzero exit or timeout.

    ``device`` defaults to ``"cuda"`` when there are at least N cards,
    else ``"cpu"`` (gloo).
    """
    import torch

    from .mesh import free_port

    if device is None:
        device = "cuda" if torch.cuda.device_count() >= n_processes else "cpu"
    coordinator = f"127.0.0.1:{free_port()}"
    tmp = tempfile.mkdtemp(prefix="rho_tts_multihost_")
    outs = [os.path.join(tmp, f"proc{i}.txt") for i in range(n_processes)]
    env = dict(os.environ)
    src_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "rho_tts_tpu_torch.parallel.multihost_dryrun",
             "--coordinator", coordinator, "--num-processes", str(n_processes),
             "--process-id", str(i), "--out", outs[i], "--device", device],
            env=env,
        )
        for i in range(n_processes)
    ]
    try:
        codes = [pr.wait(timeout=timeout) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    reports = []
    for i, out in enumerate(outs):
        line = open(out).read().strip() if os.path.exists(out) else "(no report)"
        reports.append(line)
        if codes[i] != 0 or not line.startswith("OK"):
            raise RuntimeError(f"multihost dryrun process {i} failed (exit {codes[i]}): {line}")
    return reports


if __name__ == "__main__":
    sys.exit(_worker_main())
