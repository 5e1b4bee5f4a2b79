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
   the same deterministic scheduler;
3. with an even number of processes, the pipeline-parallel train step of
   JAX's ``dryrun_multichip``: tiny's 2 talker layers on 2 stages of a
   ``(data, pipe)`` mesh, a batch of ``4 * data``, 2 microbatches.

Certification: every process's gathered tokens and codes equal a
process-local reference bit for bit; the pipelined step's gradients
(summed over ``data``, gathered over ``pipe``) within ``PP_GRAD_TOL`` of a
process-local unpipelined step's, its loss the same on every process and
within ``PP_LOSS_RTOL`` of the unpipelined ``train_step``'s, its gathered
params within ``PP_PARAM_TOL``. The
processes run gloo on the CPU, or NCCL with one card each where there are
as many cards as processes.

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


#: JAX's dryrun bound on the pipelined loss (``__graft_entry__.py:311``)
PP_LOSS_RTOL = 1e-3
#: each leaf's first-step gradient, in units of that leaf's largest
#: unpipelined gradient: bf16 activations rounded apart by the microbatched
#: GEMMs (measured with gloo on the CPU: 0.0076 on (1, 2) and (2, 2)). A
#: backward that lost a stage's gradient, or counted it twice, is off by 1.
PP_GRAD_TOL = 2.0 ** -4
#: the params after one AdamW step (lr 1e-4) on tiny's bf16 weights, as
#: (relative, absolute): one bf16 rounding of the value (2 ** -8 of it),
#: and JAX's pipeline-test bound of 5e-4 (``tests/test_pipeline_parallel.py``:
#: the first step is sign-like, so a near-zero gradient whose sign turns
#: with the order of the sums moves a param by 2 lr). It shows that the step
#: ran, not that its gradients are right: that is ``PP_GRAD_TOL``'s part.
PP_PARAM_TOL = (2.0 ** -8, 5e-4)


def _grad_error(ours, ref) -> float:
    """The largest ``|ours - ref|`` over leaves, in units of each leaf's
    largest ``|ref|`` (absolute where a leaf has no gradient)."""
    worst = 0.0
    for o, r in zip(ours, ref):
        top = float(r.float().abs().max()) if r.numel() else 0.0
        err = float((o.float() - r.float()).abs().max()) if r.numel() else 0.0
        worst = max(worst, err / top if top > 0 else err)
    return worst


def _pipeline_step(n: int, dev) -> dict:
    """The PP train step of JAX's ``dryrun_multichip`` on this process."""
    import torch

    from ..models.qwen import PRESETS, train
    from ..models.qwen.model import init_params
    from .collectives import all_gather
    from .pipeline import create_pipeline_mesh

    cfg = PRESETS["tiny"]  # 2 talker layers: 2 stages
    mesh = create_pipeline_mesh(n, n_stages=2)
    b, tt, tc = 4 * mesh.shape["data"], 8, 16
    gen = torch.Generator(device="cpu").manual_seed(5)
    batch = {
        "text_ids": torch.randint(0, cfg.text_vocab, (b, tt), generator=gen).to(dev),
        "codes": torch.randint(0, cfg.codec.codebook_size, (b, tc, cfg.codec.n_codebooks),
                               generator=gen).to(dev),
        "codes_mask": torch.ones((b, tc), dtype=torch.bool, device=dev),
    }
    optimizer = train.make_optimizer()
    ref = init_params(cfg, 0, dev)
    _, ref_grads = train.loss_and_grads(ref, cfg, batch)
    ref, _, ref_loss = train.train_step(ref, optimizer.init(ref), batch, cfg, optimizer)
    params = train.shard_train_params(mesh, init_params(cfg, 0, dev), cfg)
    _, grads = train.loss_and_grads(params, cfg, batch, mesh=mesh, n_microbatches=2)
    grads = train.gather_train_params(mesh, train._like(params, grads), cfg)
    grad_err = _grad_error(train.leaves(grads), ref_grads)
    params, _, loss = train.train_step(params, optimizer.init(params), batch, cfg, optimizer,
                                       mesh=mesh, n_microbatches=2)
    losses = all_gather(loss.detach().float().cpu().reshape(1), 0, mesh.control)
    whole = train.leaves(train.gather_train_params(mesh, params, cfg))
    rel, atol = PP_PARAM_TOL
    err = max(float(((w.float() - r.float()).abs() - rel * r.float().abs()).max())
              for w, r in zip(whole, train.leaves(ref)))
    lp, lr = float(loss), float(ref_loss)
    ok = (bool((losses == losses[0]).all()) and abs(lp - lr) <= PP_LOSS_RTOL * max(1.0, abs(lr))
          and grad_err <= PP_GRAD_TOL and err <= atol)
    return {"ok": ok, "mesh": mesh.shape, "loss": lp, "ref_loss": lr, "grad_error": grad_err,
            "param_excess": err}


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
    pp = ""
    if args.num_processes % 2 == 0:
        step = _pipeline_step(args.num_processes, dev)
        ok = ok and step["ok"]
        pp = (f" pp={'OK' if step['ok'] else 'MISMATCH'} pp_mesh={step['mesh']} "
              f"pp_loss={step['loss']!r} pp_ref_loss={step['ref_loss']!r} "
              f"pp_grad_error={step['grad_error']:.3g} "
              f"pp_param_excess={step['param_excess']:.3g}")
    with open(args.out, "w") as fh:
        fh.write(
            f"{'OK' if ok else 'MISMATCH'} proc={args.process_id} "
            f"procs={args.num_processes} device={args.device} mesh={mesh.shape} "
            f"checksum={int(toks.sum())} serve={'OK' if serve_ok else 'MISMATCH'} "
            f"serve_slots={n_slots} serve_reqs={len(texts)} "
            f"serve_checksum={sum(int(c.sum()) for c in mesh_codes)}{pp}\n")
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
