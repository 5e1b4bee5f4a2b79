"""Where the time of the two attention kernels goes, by variants with parts removed.

Run from the repository root on one NVIDIA GPU:

    python3 chip_attention_variants.py

Builds copies of ``csrc/decode_attention.cu`` and ``csrc/attention.cu``,
each with one part removed (all of the kernel; the decode kernel's cluster
merge or its score and P.V loops; the prefill kernel's lo products or all
its products), into ``build/attention_variants/``, and times each as
``chip_smoke.py`` phase 2 times the kernels: the decode kernel at the Qwen
cells' shape, the prefill kernel at the 1.7B main-path shape. It also
sweeps the decode kernel's cluster size (flushed, and 28 distinct caches in
a CUDA graph), times both kernels with the L2 warm (no flush), and times
the pieces of one wrapper call on the host.
The variants compute wrong results: they only measure. Prints one JSON
line, then the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "attention_variants")

# (text in the source, replacement): each variant must find its text.
DECODE_VARIANTS = {
    "full": [],
    "nothing": [("  constexpr int kGpw =", "  if (a.s_len > 0) return;\n  constexpr int kGpw =")],
    "no merge": [("  // 4. The block's state", "  return;\n  // 4. The block's state")],
    "no scores, no P.V": [("    if (!tile_any[t]) continue;", "    continue;")],
}
_LO = [("        mma_bf16(oacc[2 * dp], pl, vf[0], vf[1]);\n", ""),
       ("        mma_bf16(oacc[2 * dp + 1], pl, vf[2], vf[3]);\n", "")]
PREFILL_VARIANTS = {
    "full": [],
    "nothing": [("  constexpr int kRow = D + kTcPad;",
                 "  if (a.s_len > 0) return;\n  constexpr int kRow = D + kTcPad;")],
    "no lo products": _LO,
    "no products": _LO + [
        ("        mma_bf16(oacc[2 * dp], ph, vf[0], vf[1]);\n", ""),
        ("        mma_bf16(oacc[2 * dp + 1], ph, vf[2], vf[3]);\n", ""),
        ("        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);\n", ""),
        ("        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);\n", ""),
    ],
}


def build_variants(build, name, variants):
    """Compile every variant of ``csrc/<name>.cu`` in parallel; return the libraries."""
    src = (build.CSRC / f"{name}.cu").read_text()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")] + ["-I", str(build.CSRC)]
    procs = {}
    for tag, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}.cu variant {tag!r}: {old.strip()!r} not found")
            text = text.replace(old, new)
        stem = f"{name}-{tag.replace(' ', '_').replace(',', '').replace('.', '')}"
        cu, lib = os.path.join(OUT, stem + ".cu"), os.path.join(OUT, f"lib{stem}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[tag] = (subprocess.Popen([build._nvcc(), *flags, "-o", lib, cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}.cu variant {tag!r} failed to build:\n{out}")
        libs[tag] = ctypes.CDLL(lib)
    return libs


def host_us(fn, batches=10):
    """Mean host time of one ``fn()`` in us, over batches of 200 calls with
    the device drained between them: longer runs of launches fill the
    launch queue and then time the device instead."""
    return sum(chip_smoke.host_us(fn) for _ in range(batches)) / batches


def warm_us(fn, iters=50, warmup=5):
    """Device time of one ``fn()`` in us with the L2 warm, as in the decode
    loop: ``chip_smoke.time_ms`` without its flush (the device spin before
    each launch still keeps the host's enqueue out of the interval)."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in zip(starts, ends)) / iters * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_attention_variants: a CUDA device is required", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from rho_tts_tpu_torch.ops.cuda import _build
    from rho_tts_tpu_torch.ops.cuda import attention as attn
    from rho_tts_tpu_torch.ops.cuda import decode_attention as dec

    smi = chip_smoke.nvidia_smi_line()
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    dlibs = build_variants(_build, "decode_attention", DECODE_VARIANTS)
    plibs = build_variants(_build, "attention", PREFILL_VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, hq, hkv, d = 5, 128, 16, 8, 128
    db, ds = 8, 448
    stream = torch.cuda.current_stream().cuda_stream
    report = {"shape": f"decode q({db},1,{hq},{d}) cache({db},{ds},{hkv},{d}) at frame 95; "
                       f"prefill q({b},{t},{hq},{d}) k/v({b},{t},{hkv},{d}); bf16"}

    # Decode: the benchmark cells' mask of chip_smoke.py phase 2.
    mask = chip_smoke.cell_mask(db, ds, 95)
    q, k, v = chip_smoke._attn_inputs(gen, (db, 1, hq, d), (db, ds, hkv, d), torch.bfloat16,
                                      torch.bfloat16)
    dec._plans.clear()
    dec.decode_gqa_attention(q, k, v, mask)
    (out_shape, dev, _, args), = dec._plans.values()
    out = torch.empty(out_shape, dtype=q.dtype, device="cuda")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr())
    report["decode_us"] = {}
    for tag, lib in dlibs.items():
        fn = lib.rho_decode_attention
        fn.restype, fn.argtypes = ctypes.c_int, dec._kernel().argtypes
        if fn(*ptrs, *args, 0.0, dev, stream) != 0:
            raise RuntimeError(f"decode variant {tag!r} did not launch")
        report["decode_us"][tag] = chip_smoke.time_ms(
            lambda: fn(*ptrs, *args, 0.0, dev, stream)) * 1e3

    # The decode kernel's cluster size, through the wrapper: one flushed
    # launch, and 28 distinct caches back to back in a graph.
    chain = [(q, *chip_smoke._attn_inputs(gen, q.shape, k.shape, torch.bfloat16,
                                          torch.bfloat16)[1:], mask)
             for _ in range(chip_smoke.DECODE_CHAIN)]
    plan = dec.plan_clusters
    report["decode_us_by_clusters"] = {}
    try:
        for clusters in (1, 2, 4, 8):
            dec.plan_clusters = lambda *_, n=clusters: n
            dec._plans.clear()
            report["decode_us_by_clusters"][clusters] = {
                "flushed": chip_smoke.time_ms(
                    lambda: dec.decode_gqa_attention(q, k, v, mask)) * 1e3,
                "chain": chip_smoke.chain_ms(dec.decode_gqa_attention, chain) * 1e3,
                "chain_kernel": chip_smoke.chain_kernel_ms(
                    dec.decode_gqa_attention, chain, "split_decode_kernel") * 1e3,
            }
    finally:
        dec.plan_clusters = plan
        dec._plans.clear()
    del chain

    # Prefill: the left pads of chip_smoke.py phase 2's main case.
    pmask = chip_smoke._pad_mask(t, [0, 17, 40, 127, 128])
    pq, pk, pv = chip_smoke._attn_inputs(gen, (b, t, hq, d), (b, t, hkv, d), torch.bfloat16,
                                         torch.bfloat16)
    attn._plans.clear()
    attn.fused_gqa_attention(pq, pk, pv, pmask)
    (pshape, pdev, pargs), = attn._plans.values()
    pout = torch.empty(pshape, dtype=pq.dtype, device="cuda")
    pptrs = (pq.data_ptr(), pk.data_ptr(), pv.data_ptr(), pmask.data_ptr(), pout.data_ptr())
    report["prefill_us"] = {}
    for tag, lib in plibs.items():
        fn = lib.rho_prefill_attention
        fn.restype, fn.argtypes = ctypes.c_int, attn._kernel().argtypes
        if fn(*pptrs, *pargs, 0, 1, 0.0, pdev, stream) != 0:
            raise RuntimeError(f"prefill variant {tag!r} did not launch")
        report["prefill_us"][tag] = chip_smoke.time_ms(
            lambda: fn(*pptrs, *pargs, 0, 1, 0.0, pdev, stream)) * 1e3

    report["l2_warm_us"] = {
        "decode": warm_us(lambda: dec.decode_gqa_attention(q, k, v, mask)),
        "prefill": warm_us(lambda: attn.fused_gqa_attention(pq, pk, pv, pmask)),
    }

    # The pieces of one decode wrapper call on the host.
    fn = dec._kernel()
    report["host_us"] = {
        "decode wrapper": host_us(lambda: dec.decode_gqa_attention(q, k, v, mask)),
        "prefill wrapper": host_us(lambda: attn.fused_gqa_attention(pq, pk, pv, pmask)),
        "torch.empty of the output": host_us(
            lambda: torch.empty(out_shape, dtype=q.dtype, device=q.device)),
        "torch.cuda.current_stream(dev).cuda_stream": host_us(
            lambda: torch.cuda.current_stream(q.device).cuda_stream),
        "torch._C._cuda_getCurrentRawStream(dev)": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(dev)),
        "the ctypes call with its launch": host_us(lambda: fn(*ptrs, *args, 0.0, dev, stream)),
        "a PyTorch op with one launch (zero_)": host_us(lambda: out.zero_()),
    }
    torch.cuda.synchronize()
    print(json.dumps({"attention_variants": report}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
