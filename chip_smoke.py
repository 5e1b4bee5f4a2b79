"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel of the port (``src/rho_tts_tpu_torch/
   csrc/*.cu``) with nvcc, in parallel, and load it;
2. kernels: run each kernel at the main-path shapes against its plain
   PyTorch version on the card, with the stated tolerance, and time the
   kernel, the plain version and one PyTorch library call as a yardstick;
   the attention kernels also at the shapes and masks where their designs
   can go wrong; every case launched twice and compared bit for bit; the
   int4 and w8a8 cases with their launch plans;
3. reference: the tiny preset at fp32, kernels on the card against the
   plain versions on the CPU with the same weights (prefill logits), with
   dense weights, int4 weights, and int8 weights with w8a8 prefill;
4. main path: Qwen3-TTS 1.7B, weight-only int8, batch 5 through
   ``QwenTTSModel.synthesize`` (prompt -> prefill -> 4 chunks of 64 decode
   steps -> vocoder), once to warm up and once timed, with each kernel's
   launch count read around the timed run;
5. int4 path: 1.7B with int4 weights, saved as a native checkpoint and
   served by ``QwenTTSModel.from_pretrained(dir)``, the same batch and
   frames; the codes must equal those of the model that was saved;
6. w8a8 prefill: 1.7B int8 with ``RHO_TTS_TPU_W8A8_PREFILL=1`` for this
   phase only, one decode chunk.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit
from nvidia-smi, and as its last line ``{"ok": true, "device": {...}}``.
Exits nonzero, printing no result, without a CUDA device or without the
repository's ``src/`` beside it.

``--parent DIR`` (optional) also times, in phase 2, the int4 and w8a8
kernels of another checkout of the repository unpacked at DIR (for
example ``git archive <commit>`` under ``build/``), built from its own
sources: ``parent_ms`` beside each case's ``ms``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
INT8_OP_PER_S = 1979e12  # dense int8 tensor-core peak
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2: each timed launch starts cold
SPIN_CYCLES = 1_000_000  # ~0.5 ms of device spin before each timed launch


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` in ms, each launch after an L2 flush.

    A device-side spin follows each flush, so the host has enqueued the
    start event and ``fn``'s launches before the device reaches them: the
    interval holds device work only, not the caller's host time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def host_us(fn, iters: int = 200) -> float:
    """Mean host time of one ``fn()`` call in us: what it costs the Python
    thread to enqueue it (the decode loop is bound by this)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    """Least time for the work: the larger of bytes/bandwidth and ops/peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, Hq, S, D) for the library yardstick."""
    return x.transpose(1, 2).repeat_interleave(group, dim=1)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _attn_inputs(gen, q_shape, kv_shape, q_dtype, kv_dtype, kv_pad=0):
    """Random q, k, v on the card; ``kv_pad`` > 0 makes k and v views of a
    wider tensor, so their rows are not 16-byte aligned."""
    q = torch.randn(q_shape, generator=gen, device="cuda").to(q_dtype)
    wide = (*kv_shape[:-1], kv_shape[-1] + kv_pad)
    k, v = (torch.randn(wide, generator=gen, device="cuda").to(kv_dtype)[..., :kv_shape[-1]]
            for _ in range(2))
    return q, k, v


def _held(cases, name, case, out, out2, ref, tol):
    """Record a case; fail unless finite, within tol of the plain version and
    bit-identical across two launches on the same inputs."""
    torch.cuda.synchronize()
    case.update(max_abs_err=(out.float() - ref.float()).abs().max().item(), tol=tol,
                bit_identical=bool(torch.equal(out, out2)))
    cases.append(case)
    if not bool(torch.isfinite(out).all()) or not case["max_abs_err"] <= tol \
            or not case["bit_identical"]:
        raise AssertionError(f"{name} {case}")


def _pad_mask(t, pads):
    return torch.arange(t, device="cuda")[None, :] >= torch.tensor(pads, device="cuda")[:, None]


def check_prefill(attn, gen) -> dict:
    """Prefill attention at the 1.7B main-path shape, left-padded rows, and
    the cases where the tensor-core design can go wrong: the causal skip
    with q_offset, a fully masked row, a ring of more than two key tiles,
    the tiny preset's head shape, and unaligned rows (the SIMT path). Every
    case runs twice and must give the same bits."""
    b, t, hq, hkv, d = 5, 128, 16, 8, 128
    pads = [0, 17, 40, 127, 128]  # last row: all keys masked
    mask = _pad_mask(t, pads)
    cases = []
    main = None
    # bf16 output: 1 bf16 ulp at |o| < 4 (order of sums differs);
    # f32: the CPU parity tolerance of the plain version.
    for dtype, tol, causal, q_offset, t_q, shape, kv_pad, what in (
        (torch.bfloat16, 2e-2, True, None, t, None, 0, "main path"),
        (torch.float32, 2e-5, True, None, t, None, 0, "f32"),
        (torch.float32, 2e-5, False, None, t, None, 0, "f32 not causal"),
        (torch.float32, 2e-5, True, 64, 64, None, 0, "f32 sequence-parallel shard"),
        (torch.bfloat16, 2e-2, True, 64, 64, None, 0, "causal skip with q_offset"),
        (torch.bfloat16, 2e-2, False, None, t, None, 0, "not causal"),
        (torch.bfloat16, 2e-2, True, None, 300, (3, 300, 16, 8, 128), 0, "ring of 5 key tiles"),
        (torch.bfloat16, 2e-2, True, None, 40, (2, 40, 4, 2, 16), 0, "tiny head shape"),
        (torch.float32, 2e-5, True, None, 40, (2, 40, 4, 2, 16), 0, "tiny head shape f32"),
        (torch.bfloat16, 2e-2, True, None, t, None, 1, "unaligned rows (SIMT)"),
    ):
        cb, ct, chq, chkv, cd = shape or (b, t, hq, hkv, d)
        cmask = mask if shape is None else _pad_mask(ct, [0, ct // 3, ct][:cb])
        q, k, v = _attn_inputs(gen, (cb, t_q, chq, cd), (cb, ct, chkv, cd), dtype, dtype, kv_pad)
        run = lambda: attn.fused_gqa_attention(q, k, v, cmask, causal=causal, q_offset=q_offset)
        case = {"case": what, "dtype": str(dtype).split(".")[-1], "causal": causal,
                "q_offset": q_offset, "q": list(q.shape), "kv": list(k.shape)}
        _held(cases, "prefill attention", case, run(), run(),
              attn.reference_gqa_attention(q, k, v, cmask, causal=causal, q_offset=q_offset), tol)
        if main is None:
            main = (q, k, v)
    q, k, v = main  # bf16, causal: the main path's call
    group = hq // hkv
    kernel_ms = time_ms(lambda: attn.fused_gqa_attention(q, k, v, mask))
    kernel_host_us = host_us(lambda: attn.fused_gqa_attention(q, k, v, mask))
    plain_ms = time_ms(lambda: attn.reference_gqa_attention(q, k, v, mask))
    qh, kh, vh = q.transpose(1, 2), repeat_kv(k, group), repeat_kv(v, group)
    lib_mask = (mask[:, None, None, :]
                & torch.ones((t, t), dtype=torch.bool, device="cuda").tril()[None, None])
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=lib_mask))
    pairs = t * (t + 1) // 2  # causal (query, key) pairs per (row, head)
    ops = 4 * d * b * hq * pairs
    bms, by = bound_ms(nbytes(q, k, v, mask, q), ops, BF16_FLOP_PER_S)
    return {
        "name": "prefill_gqa_attention", "route": "cuda",
        "source": "src/rho_tts_tpu_torch/csrc/attention.cu",
        "replaces": "src/rho_tts_tpu/ops/pallas/attention.py:79",
        "shape": f"q({b},{t},{hq},{d}) k/v({b},{t},{hkv},{d}) bf16",
        "max_abs_err": cases[0]["max_abs_err"], "tol": cases[0]["tol"], "cases": cases,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms, "host_us": kernel_host_us,
    }


def _decode_bound(q, k, mask):
    """The decode bound for these inputs: q and the output, the mask, and
    K/V of the valid keys only, except in rows with no valid key, which
    read every key; the products of the same keys."""
    keys = int(torch.where(mask.any(dim=1), mask.sum(dim=1), mask.shape[1]).sum())
    row = k.shape[2] * k.shape[3]
    return bound_ms(nbytes(q, mask, q) + 2 * keys * row * k.element_size(),
                    4 * keys * q.shape[2] * q.shape[3], BF16_FLOP_PER_S)


def check_decode(dec, gen) -> dict:
    """Decode attention over the 1.7B main-path cache, and the cases where
    the split-S design can go wrong: the main path's real positions (left
    pads of a 128-slot prompt, keys past the slot masked, so whole slices are
    skipped), a row with no valid key, only the newest slot valid, an f8
    cache at another split count, the tiny preset's head shape, and unaligned
    rows. Every case runs twice and must give the same bits (the merge's
    fixed order)."""
    b, s, hq, hkv, d = 5, 384, 16, 8, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    key_pos = torch.arange(s, device="cuda")[None, :]
    ragged = (key_pos < torch.tensor([384, 300, 129, 200, 5], device="cuda")[:, None]) & (
        key_pos >= torch.tensor([0, 12, 0, 100, 0], device="cuda")[:, None])  # left padding too
    prompt_pads = torch.tensor([31, 40, 105, 17, 0], device="cuda")[:, None]  # 128-slot bucket

    def at_slot(slot):
        return (key_pos <= slot) & (key_pos >= prompt_pads)

    no_key = ragged.clone()
    no_key[4] = False
    newest = (key_pos == 200).expand(b, s).contiguous()
    cases = []
    tensors = {}
    bf, f8, f32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32
    for q_dtype, kv_dtype, tol, mask, shape, kv_pad, what in (
        (bf, bf, 2e-2, ragged, None, 0, "main"),  # 1 bf16 ulp at |o| < 4
        (bf, f8, 2e-2, ragged, None, 0, "f8 cache"),  # same f32 math
        (f32, f32, 2e-5, ragged, None, 0, "f32"),
        (bf, bf, 2e-2, at_slot(128), None, 0, "slot 128"),
        (bf, bf, 2e-2, at_slot(200), None, 0, "slot 200"),
        (bf, bf, 2e-2, at_slot(383), None, 0, "slot 383"),
        (f32, f32, 2e-5, no_key, None, 0, "a row with no valid key"),
        (bf, bf, 2e-2, newest, None, 0, "only the newest slot valid"),
        (bf, f8, 2e-2, None, (2, 200, 16, 8, 128), 0, "f8 cache, other split count"),
        (f32, f32, 2e-5, None, (2, 72, 4, 2, 16), 0, "tiny head shape"),
        (bf, bf, 2e-2, None, (2, 72, 4, 2, 16), 0, "tiny head shape bf16"),
        (bf, bf, 2e-2, ragged, None, 1, "unaligned rows (scalar loads)"),
    ):
        cb, cs, chq, chkv, cd = shape or (b, s, hq, hkv, d)
        if mask is None:
            kp = torch.arange(cs, device="cuda")[None, :]
            mask = (kp >= torch.tensor([0, 9], device="cuda")[:, None]) & (kp <= cs - 30)
        q, k, v = _attn_inputs(gen, (cb, 1, chq, cd), (cb, cs, chkv, cd), q_dtype, kv_dtype,
                               kv_pad)
        run = lambda: dec.decode_gqa_attention(q, k, v, mask)
        case = {"case": what, "q/kv": f"{str(q_dtype).split('.')[-1]}/"
                f"{str(kv_dtype).split('.')[-1]}", "kv": list(k.shape),
                "splits": dec.plan_splits(cs, cb * chkv, sms)}
        _held(cases, "decode attention", case, run(), run(),
              dec.reference_decode_attention(q, k, v, mask), tol)
        tensors[what] = (q, k, v, mask)
    group = hq // hkv

    def timed(what):
        q, k, v, mask = tensors[what]
        qh, kh, vh = q.transpose(1, 2), repeat_kv(k, group), repeat_kv(v, group)
        return (time_ms(lambda: dec.decode_gqa_attention(q, k, v, mask)),
                time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask[:, None, None, :])),
                _decode_bound(q, k, mask)[0])

    q, k, v, mask = tensors["main"]
    kernel_ms, library_ms, _ = timed("main")
    kernel_host_us = host_us(lambda: dec.decode_gqa_attention(q, k, v, mask))
    plain_ms = time_ms(lambda: dec.reference_decode_attention(q, k, v, mask))
    q8, k8, v8, _ = tensors["f8 cache"]
    f8_ms = time_ms(lambda: dec.decode_gqa_attention(q8, k8, v8, mask))
    bms, by = _decode_bound(q, k, mask)
    full_bms, _ = bound_ms(nbytes(q, k, v, mask, q), 4 * d * b * hq * s, BF16_FLOP_PER_S)
    f8_bound, _ = _decode_bound(q8, k8, mask)
    at_slots = {}
    for slot in (128, 200, 383):
        k_ms, lib_ms, b_ms = timed(f"slot {slot}")
        at_slots[slot] = {"ms": k_ms, "library_ms": lib_ms, "bound_ms": b_ms}
    return {
        "name": "decode_gqa_attention", "route": "cuda",
        "source": "src/rho_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "src/rho_tts_tpu/ops/pallas/decode_attention.py:85",
        "shape": f"q({b},1,{hq},{d}) cache({b},{s},{hkv},{d}) bf16",
        "splits": dec.plan_splits(s, b * hkv, sms),
        "max_abs_err": cases[0]["max_abs_err"], "tol": cases[0]["tol"], "cases": cases,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "full_cache_bound_ms": full_bms,
        "library_ms": library_ms, "f8_cache_ms": f8_ms, "f8_cache_bound_ms": f8_bound,
        "host_us": kernel_host_us, "at_main_path_slots": at_slots,
    }


def _quantized_weight(quant, k, n, gen):
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    return quant(w)


def check_w8a8(qz, w8, gen, parent=None) -> dict:
    """w8a8 matmul at every 1.7B prefill shape (M = 5 rows x 128 slots):
    bit-identical to the plain version in every case and across two
    launches; ``parent``, another tree's wrapper module, is timed beside it."""
    cases = []
    main = None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n, out_dtype in (
        (640, 2048, 6144, torch.bfloat16),  # w_gate / w_up: the main case
        (640, 6144, 2048, torch.bfloat16),  # w_down
        (640, 2048, 4096, torch.bfloat16),  # wqkv
        (640, 2048, 2048, torch.bfloat16),  # wo
        (637, 2048, 2048, torch.bfloat16),  # ragged M
        (640, 2048, 4096, torch.float32),   # f32 output
        (70, 96, 100, torch.bfloat16),      # N % 16 != 0: the mma.sync path
    ):
        qw = _quantized_weight(qz.quantize_weight, k, n, gen)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        xf = x.float()
        sx = qz._div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
        xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        args = (xq, sx, qw["q"], qw["s"], out_dtype)
        out = w8.w8a8_matmul(*args)
        out2 = w8.w8a8_matmul(*args)
        ref = w8.reference_w8a8_matmul(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        case = {"m": m, "k": k, "n": n, "out": str(out_dtype).split(".")[-1],
                "plan": {"tokens_per_block": w8.plan(m, k, n, sms)},
                "max_abs_err": err, "tol": 0.0, "bit_identical": bool(torch.equal(out, ref)),
                "bit_identical_across_launches": bool(torch.equal(out, out2))}
        cases.append(case)
        if not (case["bit_identical"] and case["bit_identical_across_launches"]) \
                or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"w8a8 matmul not bit-identical to its plain version: {case}")
        kernel_ms = time_ms(lambda: w8.w8a8_matmul(*args))
        case["host_us"] = host_us(lambda: w8.w8a8_matmul(*args))
        plain_ms = time_ms(lambda: w8.reference_w8a8_matmul(*args))
        library_ms = time_ms(lambda: torch._int_mm(xq, qw["q"])) if m % 8 == 0 and n % 8 == 0 \
            else None
        out_bytes = m * n * out.element_size()
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(xq, sx, qw["q"], qw["s"]) + out_bytes, 2 * m * k * n, INT8_OP_PER_S)
        case.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms)
        if parent is not None:
            case["parent_ms"] = time_ms(lambda: parent.w8a8_matmul(*args))
        if main is None:
            main = case
    return {
        "name": "w8a8_matmul", "route": "cuda",
        "source": "src/rho_tts_tpu_torch/csrc/w8a8_matmul.cu",
        "replaces": "src/rho_tts_tpu/ops/pallas/w8a8_matmul.py:74",
        "shape": f"xq({main['m']},{main['k']}) int8 x q({main['k']},{main['n']}) int8 -> bf16",
        "max_abs_err": max(c["max_abs_err"] for c in cases), "tol": 0.0, "cases": cases,
        "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "host_us": main["host_us"],
        "library": "torch._int_mm(xq, q): the int8 dot only, no rescale",
    }


def check_int4(qz, i4, gen, parent=None) -> dict:
    """int4 matmul at every 1.7B decode (M = 5) and prefill (M = 640) shape,
    the other paths' shapes, and products on two streams at once. Every
    case is launched twice and must give the same bits; its launch plan is
    reported. Tolerance: bf16 out within 2e-2 * max|ref| + 1e-3 (bf16
    rounding of the output, another order of f32 sums); f32 out within 1e-5
    of max|ref|. ``parent``, another tree's wrapper module, is timed beside it."""
    cases = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def held(case, out, same, ref):
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        bf16 = out.dtype == torch.bfloat16
        case.update(max_abs_err=err, tol=2e-2 * scale + 1e-3 if bf16 else 1e-5 * scale,
                    bit_identical_across_launches=same)
        cases.append(case)
        if not bool(torch.isfinite(out).all()) or err > case["tol"] \
                or not case["bit_identical_across_launches"]:
            raise AssertionError(f"int4 matmul disagrees with its plain version: {case}")

    shapes = ((2048, 6144), (6144, 2048), (2048, 4096), (2048, 2048))  # gate/up, down, qkv, o
    for m, k, n, dtype in (
        *((5, k, n, torch.bfloat16) for k, n in shapes),    # decode; the first is the main case
        *((640, k, n, torch.bfloat16) for k, n in shapes),  # prefill (wgmma)
        (637, 2048, 2048, torch.bfloat16),  # ragged M
        (16, 2048, 2048, torch.bfloat16),   # the GEMV's largest M: two token tiles
        (40, 2000, 96, torch.bfloat16),     # K/2 not a multiple of the 64-row stage
        (70, 2048, 100, torch.bfloat16),    # N % 16 != 0: the GEMV at prefill M
        (5, 2048, 6144, torch.float32),     # f32: the GEMV path
        (640, 6144, 2048, torch.float32),
    ):
        qw = _quantized_weight(qz.pack_int4, k, n, gen)
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        args = (x, qw["q4"], qw["s"])
        out = i4.int4_matmul(*args)
        out2 = i4.int4_matmul(*args)
        ref = i4.reference_int4_matmul(*args)
        torch.cuda.synchronize()
        case = {"m": m, "k": k, "n": n, "dtype": str(dtype).split(".")[-1],
                "plan": i4.plan(dtype, m, k // 2, n, sms)}
        held(case, out, bool(torch.equal(out, out2)), ref)
        if dtype == torch.float32 or (k, n) not in shapes or m not in (5, 640):
            continue
        w_deq = (i4.unpack_int4(qw["q4"]) * qw["s"]).to(dtype)  # for the yardstick
        kernel_ms = time_ms(lambda: i4.int4_matmul(*args))
        case["host_us"] = host_us(lambda: i4.int4_matmul(*args))
        plain_ms = time_ms(lambda: i4.reference_int4_matmul(*args))
        library_ms = time_ms(lambda: torch.matmul(x, w_deq))
        case["bound_ms"], case["bound_by"] = bound_ms(
            nbytes(x, qw["q4"], qw["s"], out), 2 * m * k * n, BF16_FLOP_PER_S)
        case.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms)
        if parent is not None:
            case["parent_ms"] = time_ms(lambda: parent.int4_matmul(*args))

    # Decode products interleaved on two streams: the kernel keeps no state
    # between launches, so concurrent launches cannot disturb each other.
    pairs = []
    for k, n in ((2048, 2048), (6144, 2048)):
        qw = _quantized_weight(qz.pack_int4, k, n, gen)
        pairs.append((torch.randn((5, k), generator=gen, device="cuda").to(torch.bfloat16),
                      qw["q4"], qw["s"]))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(32):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[j].append(i4.int4_matmul(*pairs[j]))
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    for j, args in enumerate(pairs):
        ref = i4.reference_int4_matmul(*args)
        held({"m": 5, "k": args[0].shape[1], "n": 2048, "dtype": "bfloat16",
              "two_streams": 32}, outs[j][0],
             all(torch.equal(o, outs[j][0]) for o in outs[j]), ref)
    main = cases[0]
    return {
        "name": "int4_matmul", "route": "cuda",
        "source": "src/rho_tts_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "src/rho_tts_tpu/ops/pallas/int4_matmul.py:123",
        "shape": f"x({main['m']},{main['k']}) bf16 x q4({main['k'] // 2},{main['n']}) packed int4",
        "plan": main["plan"],
        "max_abs_err": main["max_abs_err"], "tol": main["tol"], "cases": cases,
        "ms": main["ms"], "kernel_ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "host_us": main["host_us"],
        "library": "torch.matmul(x, w) on the pre-dequantized bf16 weight",
    }


def load_parent(root: str):
    """The int4 and w8a8 wrapper modules of the checkout at ``root``,
    imported as another package so both trees live in one process; the
    parent builds its kernels from its own sources into its own build/."""
    pkg = os.path.join(os.path.abspath(root), "src", "rho_tts_tpu_torch")
    name = "parent_rho_tts_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(name + ".ops.cuda.int4_matmul"),
            importlib.import_module(name + ".ops.cuda.w8a8_matmul"))


# ---------------------------------------------------------------------------
# Phase 3: tiny preset, card against the CPU's plain versions
# ---------------------------------------------------------------------------


def check_against_cpu(qmodel, quantization=None, w8a8=False) -> dict:
    """Tiny preset at fp32: prefill logits through the kernels on the card
    against the plain versions on the CPU, same weights and prompt. The
    weights are quantized once, on the CPU, and copied to both devices."""
    from rho_tts_tpu_torch.models.quantization import quantize_stack
    from rho_tts_tpu_torch.ops.cuda import int4_matmul as i4
    from rho_tts_tpu_torch.ops.cuda import w8a8_matmul as w8

    cfg = qmodel.PRESETS["tiny"]
    params = qmodel.init_params(cfg, seed=3, device="cpu")
    params = _tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    if quantization is not None:
        params = {**params, "talker": quantize_stack(params["talker"], quantization)}
    logits = {}
    saved = os.environ.get("RHO_TTS_TPU_W8A8_PREFILL")
    if w8a8:
        os.environ["RHO_TTS_TPU_W8A8_PREFILL"] = "1"
    i4.launches = w8.launches = 0
    try:
        for dev in ("cpu", "cuda"):
            m = qmodel.QwenTTSModel(cfg, params=_tree_map(lambda t: t.to(dev), params), device=dev)
            arrays, _lens, p = m._build_prompt_arrays(
                ["a short prompt", "and a second, longer prompt row"], "Aria", "English", None,
                None,
            )
            a = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
            ck, cv = qmodel.tfm.make_kv_cache(cfg.talker, 2, p + 8, dtype=torch.float32,
                                              device=dev)
            kv = torch.zeros((2, p + 8), dtype=torch.bool, device=dev)
            with torch.inference_mode():
                out, *_ = qmodel._prefill(
                    m.params, cfg, a["ids_slotted"], a["text_mask"], a["codes_slotted"],
                    a["code_mask"], a["spk_ids"], a["spk_mask"], a["rope_pos"], a["attn_mask"],
                    ck, cv, kv,
                )
            logits[dev] = out.float().cpu()
    finally:
        if w8a8:
            _restore_env("RHO_TTS_TPU_W8A8_PREFILL", saved)
    launched = {"int4_matmul": i4.launches, "w8a8_matmul": w8.launches}
    want = {"int4": "int4_matmul", "int8": "w8a8_matmul" if w8a8 else None}.get(quantization)
    if want is not None and launched[want] != 5 * cfg.talker.layers:
        raise AssertionError(f"tiny {quantization}: {want} launched {launched[want]}x on the card")
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    tol = 1e-4  # fp32, TF32 off: the port's fp32 parity tolerance
    name = (quantization or "dense") + ("+w8a8" if w8a8 else "")
    if not err <= tol:
        raise AssertionError(f"tiny {name} prefill logits: card vs CPU max abs err {err} > {tol}")
    return {"weights": name, "tiny_prefill_logits_max_abs_err": err, "tol": tol,
            "launches": launched}


def _restore_env(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

TEXTS = [
    "The quick brown fox jumps over the lazy dog near the quiet river bank at dawn.",
    "Speech synthesis on a single accelerator should keep up with many listeners at once.",
    "A short line.",
    "Numbers like 1,234 and dates such as March 3rd are read out in full by the front end.",
    "Every request in this batch shares one prefill and one chunked decode loop on the card.",
]


class StageClock:
    """CUDA events around the model's stage functions, no host sync."""

    def __init__(self, qmodel):
        self.qmodel = qmodel
        self.events = {"prefill": [], "decode_chunk": [], "vocode": []}
        self.saved = {}

    def _wrap(self, name, fn):
        events = self.events[name]

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
            return out

        return timed

    def __enter__(self):
        for name, attr in (("prefill", "_prefill"), ("decode_chunk", "_decode_chunk"),
                           ("vocode", "_vocode_rows")):
            self.saved[attr] = getattr(self.qmodel, attr)
            setattr(self.qmodel, attr, self._wrap(name, self.saved[attr]))
        return self

    def __exit__(self, *exc):
        for attr, fn in self.saved.items():
            setattr(self.qmodel, attr, fn)

    def ms(self, name) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events[name])


def timed_synthesize(qmodel, model, kmods, frames: int, expected) -> dict:
    """One warm-up ``synthesize()``, then one timed with every kernel's launch
    count set to 0 just before it; ``expected(layers, steps)`` gives the
    launch counts the run must show. Returns the metrics and the timed
    run's codes and waveforms."""
    cfg = model.config
    chunk = qmodel._chunk()
    kw = dict(min_frames=frames, max_frames=frames, top_k=50, seeds=list(range(len(TEXTS))))

    t0 = time.perf_counter()
    model.synthesize(TEXTS, **kw)  # warm-up: cuBLAS/cuDNN plans, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    for mod in kmods.values():
        mod.launches = 0
    with StageClock(qmodel) as clock:
        t0 = time.perf_counter()
        codes, waves, sr = synthesize_codes(model, kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kmods.items()}

    steps = len(clock.events["decode_chunk"]) * chunk
    want = expected(cfg.talker.layers, steps)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want} ({steps} decode steps)")
    hop = cfg.codec.hop
    for i, w in enumerate(waves):
        if w.shape != ((frames + 1) * hop,) or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"waveform {i}: shape {tuple(w.shape)}, finite check failed")
    audio_s = sum(w.shape[0] for w in waves) / sr
    decode_ms = clock.ms("decode_chunk")
    return {
        "preset": cfg.name, "quantization": model.quantization, "batch": len(TEXTS),
        "decode_steps": steps, "warmup_s": warm_s, "wall_s": wall_s,
        "prefill_ms": clock.ms("prefill"), "decode_ms": decode_ms,
        "decode_ms_per_step": decode_ms / steps,
        "tokens_per_s": len(TEXTS) * steps / (decode_ms / 1e3),
        "vocode_ms": clock.ms("vocode"),
        "audio_s": audio_s, "rtf": audio_s / wall_s,
        "launches": launches,
    }, codes, waves


def synthesize_codes(model, kw):
    """``model.synthesize(TEXTS, **kw)``, also returning the codes it vocoded."""
    captured = {}
    generate = model._generate_codes_arrays

    def capture(*args, **kwargs):
        out = generate(*args, **kwargs)
        captured["codes"] = out[0]
        return out

    model._generate_codes_arrays = capture
    try:
        waves, sr = model.synthesize(TEXTS, **kw)
    finally:
        del model._generate_codes_arrays
    return captured["codes"], waves, sr


def run_main_path(qmodel, qz, kmods) -> dict:
    """Phase 4: 1.7B weight-only int8, 4 chunks; no int4 or w8a8 launch."""
    cfg = qmodel.PRESETS["1.7B"]
    t0 = time.perf_counter()
    model = qmodel.QwenTTSModel(cfg, seed=0, quantization="int8", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out, _codes, _waves = timed_synthesize(
        qmodel, model, kmods, 4 * qmodel._chunk(),
        lambda layers, steps: {"prefill_gqa_attention": layers,
                               "decode_gqa_attention": layers * steps,
                               "w8a8_matmul": 0, "int4_matmul": 0},
    )
    out["init_s"] = init_s
    out["talker_weight_bytes"] = qz.quantized_bytes(model.params["talker"])
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def run_int4_path(qmodel, qz, kmods, build_dir: str) -> dict:
    """Phase 5: 1.7B int4, exported to a native checkpoint and served from it.

    The in-memory model synthesizes once; it is saved, freed, loaded back
    with ``from_pretrained(dir)``, warmed up and timed. Its codes must equal
    the in-memory model's."""
    cfg = qmodel.PRESETS["1.7B"]
    frames = 4 * qmodel._chunk()
    kw = dict(min_frames=frames, max_frames=frames, top_k=50, seeds=list(range(len(TEXTS))))
    t0 = time.perf_counter()
    model = qmodel.QwenTTSModel(cfg, seed=0, quantization="int4", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    talker_bytes = qz.quantized_bytes(model.params["talker"])
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as ckpt:
        t0 = time.perf_counter()
        model.save_checkpoint(ckpt)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
        ref_codes, ref_waves, _sr = synthesize_codes(model, kw)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        served = qmodel.QwenTTSModel.from_pretrained(ckpt, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if served.quantization != "int4":
        raise AssertionError(f"checkpoint served as {served.quantization!r}, not int4")
    out, codes, waves = timed_synthesize(
        qmodel, served, kmods, frames,
        lambda layers, steps: {"prefill_gqa_attention": layers,
                               "decode_gqa_attention": layers * steps,
                               "w8a8_matmul": 0, "int4_matmul": 5 * layers * (1 + steps)},
    )
    if out["launches"]["int4_matmul"] != 35_980:
        raise AssertionError(f"int4 launched {out['launches']['int4_matmul']}x, not 35,980")
    if not torch.equal(codes, ref_codes):
        raise AssertionError("codes of the served checkpoint differ from the saved model's")
    waves_equal = all(torch.equal(a, b) for a, b in zip(waves, ref_waves))
    out.update(init_s=init_s, save_s=save_s, load_s=load_s, checkpoint_bytes=ckpt_bytes,
               talker_weight_bytes=talker_bytes, codes_identical=True,
               waves_identical=waves_equal,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def run_w8a8_prefill(qmodel, kmods, int8_prefill_ms: float) -> dict:
    """Phase 6: 1.7B int8 with RHO_TTS_TPU_W8A8_PREFILL=1, one decode chunk."""
    cfg = qmodel.PRESETS["1.7B"]
    saved = os.environ.get("RHO_TTS_TPU_W8A8_PREFILL")
    os.environ["RHO_TTS_TPU_W8A8_PREFILL"] = "1"
    try:
        model = qmodel.QwenTTSModel(cfg, seed=0, quantization="int8", device="cuda")
        out, _codes, _waves = timed_synthesize(
            qmodel, model, kmods, qmodel._chunk(),
            lambda layers, steps: {"prefill_gqa_attention": layers,
                                   "decode_gqa_attention": layers * steps,
                                   "w8a8_matmul": 5 * layers, "int4_matmul": 0},
        )
    finally:
        _restore_env("RHO_TTS_TPU_W8A8_PREFILL", saved)
    out["weight_only_int8_prefill_ms"] = int8_prefill_ms
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    parser.add_argument("--parent", default=None,
                        help="another checkout whose int4 and w8a8 kernels phase 2 also times")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA device is required",
              file=sys.stderr)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "rho_tts_tpu_torch")):
        print(f"chip_smoke: the port's package is missing under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from rho_tts_tpu_torch.models import quantization as qz
    from rho_tts_tpu_torch.models.qwen import model as qmodel
    from rho_tts_tpu_torch.ops.cuda import _build
    from rho_tts_tpu_torch.ops.cuda import attention as attn
    from rho_tts_tpu_torch.ops.cuda import decode_attention as dec
    from rho_tts_tpu_torch.ops.cuda import int4_matmul as i4
    from rho_tts_tpu_torch.ops.cuda import w8a8_matmul as w8

    kmods = {"prefill_gqa_attention": attn, "decode_gqa_attention": dec,
             "w8a8_matmul": w8, "int4_matmul": i4}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} (nvidia-smi: {smi}); torch {torch.__version__}"
        f" cuda {torch.version.cuda}; TF32 off for matmul and cuDNN")

    t0 = time.perf_counter()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    log(f"phase 1 build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    for name, text in _build.build_log.items():
        print(f"--- nvcc {name}.cu ---\n{text}", file=sys.stderr)

    parent_i4 = parent_w8 = None
    if args.parent is not None:
        t0 = time.perf_counter()
        parent_i4, parent_w8 = load_parent(args.parent)
        parent_i4._kernel(), parent_w8._kernel()
        log(f"phase 2 parent: {args.parent} built in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_prefill(attn, gen), check_decode(dec, gen),
               check_w8a8(qz, w8, gen, parent_w8), check_int4(qz, i4, gen, parent_i4)]
    for k in kernels:
        log(f"phase 2 {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}), "
            f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']}), "
            f"host {k['host_us']:.1f} us a call")
        for case in k["cases"][1:]:
            log(f"  case {json.dumps(case)}")
        if "parent_ms" in k["cases"][0]:
            log(f"  parent's kernel at the main case: {k['cases'][0]['parent_ms']:.4f} ms")
        if k["name"] == "decode_gqa_attention":
            log(f"  splits {k['splits']}, full-cache bound {k['full_cache_bound_ms']:.5f} ms, "
                f"f8 cache {k['f8_cache_ms']:.4f} ms, at the main path's slots "
                f"{json.dumps(k['at_main_path_slots'])}")

    for quantization, w8a8 in ((None, False), ("int4", False), ("int8", True)):
        ref = check_against_cpu(qmodel, quantization, w8a8)
        log(f"phase 3 reference: {json.dumps(ref)}")

    main_path = run_main_path(qmodel, qz, kmods)
    log(f"phase 4 main path: {json.dumps(main_path)}")
    int4_path = run_int4_path(qmodel, qz, kmods, os.path.join(os.path.dirname(src), "build"))
    int4_path["int8_talker_weight_bytes"] = main_path["talker_weight_bytes"]
    log(f"phase 5 int4 path: {json.dumps(int4_path)}")
    w8a8_path = run_w8a8_prefill(qmodel, kmods, main_path["prefill_ms"])
    log(f"phase 6 w8a8 prefill: {json.dumps(w8a8_path)}")
    paths = {"prefill_gqa_attention": ("int8", main_path),
             "decode_gqa_attention": ("int8", main_path),
             "w8a8_matmul": ("int8+w8a8 prefill", w8a8_path),
             "int4_matmul": ("int4 from checkpoint", int4_path)}
    for k in kernels:
        path_name, path = paths[k["name"]]
        k["launches"] = path["launches"][k["name"]]
        k["launches_path"] = f"1.7B {path_name}, {path['decode_steps']} decode steps"

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
