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
   int4 and w8a8 cases with their launch plans; and every kernel at the
   Chatterbox shapes (head_dim 64, group 1, K = 1024 / 4096, CFG rows;
   ``chatterbox_cases`` in each kernel's entry);
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
   phase only, one decode chunk;
7. generate(): the user-facing path, ``TTSFactory.get_tts_instance("qwen",
   ...)`` -> ``BaseTTS.generate`` -> ``QwenTTS`` -> fused DSP finalize ->
   WAV files, at PyTorch's default TF32 settings: the 5 texts once to warm
   up and once timed (launch counts, WAV readback, bit-equality with a
   direct ``synthesize`` + ``finalize_segments``, one host fetch for the
   batch's finalize, none inside it, DSP card vs CPU), then speed/pitch,
   ``stream()`` and a voice clone from a 20 s reference (see
   :func:`run_generate_path`). Each kernel's entry gains
   ``launches_generate``;
8. validation: a voice-clone ``generate()`` of the 5 texts with every
   validator live (GE2E speaker encoder, a drift forest at the trainer's
   size, Whisper tiny on random weights, beam 5): a permissive gate timed
   beside the same call without validation, a gate every segment fails
   (two model calls, the lower-drift attempt kept), one host fetch each for
   the drift statistics and the STT ids with no host wait before them, and
   card-vs-CPU checks (see :func:`run_validate_path`). Each kernel's entry
   gains ``launches_validate``;
9. serving: ``ServingEngine`` on a 1.7B CustomVoice int8 model, 8 slots,
   16 of bench.py's ragged requests (every other one streamed) with the
   admission and dispatch held under ``set_sync_debug_mode("error")``,
   beside a static batch-5 ``synthesize`` of the first 10; speculative
   serving with a ``draft-1.7B`` draft; ``QwenTTS(serving=True)`` on phase
   7's texts (see :func:`run_serving_path`). Each kernel's entry gains
   ``launches_serving``;
10. Chatterbox: bench.py config 4 through ``TTSFactory("chatterbox")`` on
    the "standard" preset (random weights, int8): one segment timed (a
    warm-up, the median of 3) with the watermark held bit for bit and no
    host wait in the decode loop before its one fetch; 4 candidates a round
    with forced drift failures; CFG-pair serving (admission and dispatch
    under ``set_sync_debug_mode("error")``) beside the lockstep loop;
    ``stream()``; int4 (see :func:`run_chatterbox_path`), each part logged
    as ``phase 10 <part> (<card>): {...}``. Each kernel's entry gains
    ``launches_chatterbox``;
11. training (see :func:`run_training_path`): the tiny preset at fp32 on
    the card against the CPU (loss, gradients, one step of each trainer);
    a full fine-tune of the 1.7B (2 + 5 ``train_step``s, batch 4 x (64 text
    tokens + 256 frames), then the train state saved, restored and held bit
    for bit); LoRA rank 8 on ``wqkv`` / ``wo`` (2 + 5 steps, the base frozen,
    then ``TTSFactory.get_tts_instance("qwen", ..., lora_path=...)`` on
    phase 7's texts); ``distill_draft`` of a ``draft-1.7B`` toward the 1.7B
    int8 target (16 texts, 96 frames, 20 steps) and one speculative decode
    with it; each part logged as ``phase 11 <part> (<card>): {...}``. Each
    kernel's entry gains ``launches_training``;
12. meshes (see :func:`run_parallel_path`): an NCCL world of one started
    by ``initialize_distributed``, one all-reduce and one all-gather timed
    directly; the 1.7B int8 one-shot path unmeshed, on a DP and a TP mesh
    of one (codes and waveforms bit-equal, exact kernel launches, no
    collective launched), then on the TP mesh with w8a8 prefill and with
    int4 weights; ``ServingEngine`` over the TP mesh of one on phase 9's
    ragged traffic against the unmeshed engine; Chatterbox "standard" over it; and every kernel at the
    per-rank shapes of TP and SP at mp = 2 and 4 for the 1.7B and Chatterbox,
    each part logged as ``phase 12 <part> (<card>): {...}``. Each kernel's
    entry gains ``launches_parallel`` and ``per_rank_cases``;
13. sharded training (see :func:`run_sharded_training_path`): phase 11's
    1.7B full fine-tune cell in an NCCL world of one: ``train_step`` on DP,
    TP and PP meshes of one bit-equal to unmeshed with no collective and no
    kernel launched, PP in 4 microbatches within ``PP_TOL`` (first-step
    gradients, losses, params), LoRA on DP, TP and PP meshes of one
    bit-equal, ``save_checkpoint`` / ``save_train_state``
    from the TP mesh of one reloaded unmeshed bit for bit, and each
    variant's step timed in a seeded shuffled order, each part logged as
    ``phase 13 <part> (<card>): {...}``. Each kernel's entry gains
    ``launches_sharded_training`` (0: training runs no kernel).
14. host-only layers (see :func:`run_host_layers_path`): phase 7's int8
    model through ``TTSFactory``'s isolation route (``ProviderProxy`` and a
    worker process on the same card, over a venv made by hand), bit-equal
    to an in-process instance; a cancel and a crash of the worker; a
    ``profiling.start_trace`` / ``stop_trace`` trace whose kernel events
    match the launch counters; the UI's callbacks (``AppState``, no
    gradio): ``generate_audio`` bit-equal to an in-process ``generate``, a
    switch to int4 that frees the int8 engine's memory; each part logged as
    ``phase 14 <part> (<card>): {...}``. Each kernel's entry gains
    ``launches_host_layers``.

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
import contextlib
import gc
import importlib
import importlib.util
import json
import logging
import math
import os
import pathlib
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
    the tiny preset's head shape, unaligned rows (the SIMT path), and
    serving's admission prefills at P = 512 with 1 and 8 rows. Every case
    runs twice and must give the same bits."""
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
        (torch.bfloat16, 2e-2, True, None, 512, (1, 512, 16, 8, 128), 0,
         "serving admission P=512 A=1"),
        (torch.bfloat16, 2e-2, True, None, 512, (8, 512, 16, 8, 128), 0,
         "serving admission P=512 A=8"),
    ):
        cb, ct, chq, chkv, cd = shape or (b, t, hq, hkv, d)
        pads = [0, ct // 3, ct][:cb] if cb <= 3 else [(ct * i) // cb for i in range(cb)]
        cmask = mask if shape is None else _pad_mask(ct, pads)
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


def ring_mask(b: int, s: int, col: int) -> torch.Tensor:
    """Serving's ring-cache masks at write column ``col``: row 0 wrapped
    (its older keys at higher columns than ``col``), rows 1-4 of different
    ages, row 5 an empty slot (no valid key), row 6 a single valid key past
    the write column, row 7 a wrapped prompt with left-pad holes."""
    key_pos = torch.arange(s, device="cuda")
    mask = torch.zeros((b, s), dtype=torch.bool, device="cuda")

    def history(n):  # the n newest columns up to and including col, wrapping
        return ((col - key_pos) % s) < n

    mask[0] = history(s - 7)
    for row, n in zip(range(1, 5), (1, 65, s // 3, s - 64)):
        mask[row] = history(n)
    mask[6] = key_pos == (col + 37) % s
    mask[7] = history(s // 2) & ~(((col - key_pos) % s >= s // 2 - 20) & (key_pos % 3 == 0))
    return mask[:b]


def check_decode(dec, gen) -> dict:
    """Decode attention over the 1.7B main-path cache, and the cases where
    the split-S design can go wrong: the main path's real positions (left
    pads of a 128-slot prompt, keys past the slot masked, so whole slices are
    skipped), a row with no valid key, only the newest slot valid, an f8
    cache at another split count, the tiny preset's head shape, unaligned
    rows, and serving's ring masks (:func:`ring_mask`) at the slot batch of
    8 over the rings of phase 9 (S = 640) and of the provider's defaults
    (S = 1,600), and at the ``draft-1.7B`` head shape (D = 64, 8 / 4 heads)
    over the speculative ring (S = 237). Every case runs twice and must give
    the same bits (the merge's fixed order)."""
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
        (bf, bf, 2e-2, ring_mask(8, 640, 200), (8, 640, 16, 8, 128), 0, "ring S=640"),
        (bf, bf, 2e-2, ring_mask(8, 640, 639), (8, 640, 16, 8, 128), 0, "ring S=640 at the end"),
        (bf, bf, 2e-2, ring_mask(8, 1600, 901), (8, 1600, 16, 8, 128), 0, "ring S=1600"),
        (bf, f8, 2e-2, ring_mask(8, 1600, 5), (8, 1600, 16, 8, 128), 0, "ring S=1600 f8"),
        (bf, bf, 2e-2, ring_mask(8, 237, 100), (8, 237, 8, 4, 64), 0, "draft-1.7B ring S=237"),
        (f32, f32, 2e-5, ring_mask(8, 237, 236), (8, 237, 8, 4, 64), 0,
         "draft-1.7B ring f32"),
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


# Chatterbox "standard" talker: hidden 1024, 30 layers, 16 query and 16 KV
# heads of 64 (group 1), ffn 4096; CFG folds each request into 2 rows.
CB_HEADS, CB_D = 16, 64
CB_MATMULS = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))  # wqkv, wo, gate/up, down


def _prefill_bound(q, k, v, mask):
    """The prefill bound for these inputs: q, k, v, the mask and the output
    once; the products of the (query, key) pairs that are causal and valid."""
    t, s = q.shape[1], k.shape[1]
    causal = torch.ones((t, s), dtype=torch.bool, device=q.device).tril(s - t)
    pairs = int((causal[None] & mask[:, None, :]).sum()) * q.shape[2]
    return bound_ms(nbytes(q, k, v, mask, q), 4 * q.shape[3] * pairs, BF16_FLOP_PER_S)


def _cfg_prompt_mask(rows: int, p: int, cond_lens, uncond_len: int = 2) -> torch.Tensor:
    """Left-padded CFG prompt rows ``[cond x k, uncond x k]`` of a P-slot bucket."""
    lens = list(cond_lens) + [uncond_len] * (rows - len(cond_lens))
    return _pad_mask(p, [p - n for n in lens])


def _cfg_decode_mask(rows: int, s: int, p: int, slot: int, cond_lens, uncond_len: int = 2):
    """The one-shot CFG decode mask at write slot ``slot``: each row's prompt
    (left-padded in a P-slot bucket) and the decoded slots up to ``slot``."""
    key_pos = torch.arange(s, device="cuda")[None, :]
    lens = list(cond_lens) + [uncond_len] * (rows - len(cond_lens))
    pads = torch.tensor([p - n for n in lens], device="cuda")[:, None]
    return (key_pos >= pads) & (key_pos <= slot)


def check_chatterbox_shapes(attn, dec, qz, w8, i4, gen) -> dict:
    """Phase 2 at the Chatterbox shapes: every kernel of its path (D = 64,
    group 1, K = 1024 / 4096), against its plain version, twice for the same
    bits, with its time, its bound for these inputs and a library call's.
    Returns the cases by kernel name."""
    bf, f8, f32 = torch.bfloat16, torch.float8_e4m3fn, torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {name: [] for name in ("prefill_gqa_attention", "decode_gqa_attention",
                                 "w8a8_matmul", "int4_matmul")}

    def timed(case, kernel, plain, library, bound):
        case.update(ms=time_ms(kernel), plain_ms=time_ms(plain),
                    library_ms=None if library is None else time_ms(library))
        case["bound_ms"], case["bound_by"] = bound

    # Prefill: 64-slot prompts of 1 request (2 rows) and 4 candidates
    # (8 rows); serving admissions of 4 requests in a 128-slot bucket.
    for dtype, tol, rows, p, cond, what in (
        (bf, 2e-2, 2, 64, [32], "generate(): 1 request, P=64"),
        (f32, 2e-5, 2, 64, [32], "f32, P=64"),
        (bf, 2e-2, 8, 64, [32] * 4, "4 candidates, P=64"),
        (bf, 2e-2, 8, 128, [70, 101, 33, 128], "serving admission A=4, P=128"),
    ):
        mask = _cfg_prompt_mask(rows, p, cond)
        q, k, v = _attn_inputs(gen, (rows, p, CB_HEADS, CB_D), (rows, p, CB_HEADS, CB_D),
                               dtype, dtype)
        run = lambda: attn.fused_gqa_attention(q, k, v, mask)  # noqa: E731
        plain = lambda: attn.reference_gqa_attention(q, k, v, mask)  # noqa: E731
        case = {"case": what, "dtype": str(dtype).split(".")[-1], "q": list(q.shape),
                "kv": list(k.shape)}
        _held(out["prefill_gqa_attention"], "chatterbox prefill attention", case, run(), run(),
              plain(), tol)
        lib_mask = (mask[:, None, None, :]
                    & torch.ones((p, p), dtype=torch.bool, device="cuda").tril()[None, None])
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        timed(case, run, plain, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=lib_mask), _prefill_bound(q, k, v, mask))

    # Decode: the one-shot cache of bench's 7 s floor (P = 64 + 2 chunks of
    # 128: S = 320) for 1 request and 4 candidates, bf16 and f8; the longest
    # default cache (S = 64 + 16 x 128); serving's ring (4 slots, chunk 64,
    # max_prompt 128, max_frames 256: S = 448) with a wrapped row, an empty
    # slot and rows of different ages.
    for q_dtype, kv_dtype, tol, rows, s, mask, what in (
        (bf, bf, 2e-2, 2, 320, _cfg_decode_mask(2, 320, 64, 200, [32]), "generate(), S=320"),
        (bf, f8, 2e-2, 2, 320, _cfg_decode_mask(2, 320, 64, 200, [32]), "f8 cache, S=320"),
        (f32, f32, 2e-5, 2, 320, _cfg_decode_mask(2, 320, 64, 319, [32]), "f32, S=320"),
        (bf, bf, 2e-2, 8, 320, _cfg_decode_mask(8, 320, 64, 250, [32] * 4),
         "4 candidates, S=320"),
        (bf, f8, 2e-2, 8, 320, _cfg_decode_mask(8, 320, 64, 250, [32] * 4),
         "4 candidates, f8 cache, S=320"),
        (bf, bf, 2e-2, 2, 2112, _cfg_decode_mask(2, 2112, 64, 1500, [40]), "S=2112"),
        (bf, bf, 2e-2, 8, 448, ring_mask(8, 448, 300), "serving ring S=448"),
        (bf, f8, 2e-2, 8, 448, ring_mask(8, 448, 447), "serving ring S=448 at the end, f8"),
    ):
        q, k, v = _attn_inputs(gen, (rows, 1, CB_HEADS, CB_D), (rows, s, CB_HEADS, CB_D),
                               q_dtype, kv_dtype)
        run = lambda: dec.decode_gqa_attention(q, k, v, mask)  # noqa: E731
        plain = lambda: dec.reference_decode_attention(q, k, v, mask)  # noqa: E731
        case = {"case": what, "q/kv": f"{str(q_dtype).split('.')[-1]}/"
                f"{str(kv_dtype).split('.')[-1]}", "q": list(q.shape), "kv": list(k.shape),
                "splits": dec.plan_splits(s, rows * CB_HEADS, sms)}
        _held(out["decode_gqa_attention"], "chatterbox decode attention", case, run(), run(),
              plain(), tol)
        qh, kh, vh = q.transpose(1, 2), k.to(q_dtype).transpose(1, 2), v.to(q_dtype).transpose(1, 2)
        timed(case, run, plain, lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask[:, None, None, :]), _decode_bound(q, k, mask))

    # w8a8 (RHO_TTS_TPU_W8A8_PREFILL=1): prefill rows of 1 request (2 x 64)
    # and 4 candidates (8 x 64). Bit-identical to the plain version.
    for m in (128, 512):
        for kk, n in CB_MATMULS:
            qw = _quantized_weight(qz.quantize_weight, kk, n, gen)
            xf = torch.randn((m, kk), generator=gen, device="cuda").to(bf).float()
            sx = qz._div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
            xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
            args = (xq, sx, qw["q"], qw["s"], bf)
            o1, o2, ref = w8.w8a8_matmul(*args), w8.w8a8_matmul(*args), \
                w8.reference_w8a8_matmul(*args)
            case = {"m": m, "k": kk, "n": n, "plan": {"tokens_per_block": w8.plan(m, kk, n, sms)}}
            _held(out["w8a8_matmul"], "chatterbox w8a8 matmul", case, o1, o2, ref, 0.0)
            timed(case, lambda: w8.w8a8_matmul(*args), lambda: w8.reference_w8a8_matmul(*args),
                  lambda: torch._int_mm(xq, qw["q"]),
                  bound_ms(nbytes(xq, sx, qw["q"], qw["s"], o1), 2 * m * kk * n, INT8_OP_PER_S))

    # int4: the decode GEMV at 2 and 8 rows, the prefill GEMM at 128 and 512.
    for m in (2, 8, 128, 512):
        for kk, n in CB_MATMULS:
            qw = _quantized_weight(qz.pack_int4, kk, n, gen)
            x = torch.randn((m, kk), generator=gen, device="cuda").to(bf)
            args = (x, qw["q4"], qw["s"])
            o1, o2, ref = i4.int4_matmul(*args), i4.int4_matmul(*args), \
                i4.reference_int4_matmul(*args)
            tol = 2e-2 * ref.float().abs().max().item() + 1e-3  # as phase 2's int4 cases
            case = {"m": m, "k": kk, "n": n, "plan": i4.plan(bf, m, kk // 2, n, sms)}
            _held(out["int4_matmul"], "chatterbox int4 matmul", case, o1, o2, ref, tol)
            w_deq = (i4.unpack_int4(qw["q4"]) * qw["s"]).to(bf)
            timed(case, lambda: i4.int4_matmul(*args), lambda: i4.reference_int4_matmul(*args),
                  lambda: torch.matmul(x, w_deq),
                  bound_ms(nbytes(x, qw["q4"], qw["s"], o1), 2 * m * kk * n, BF16_FLOP_PER_S))
    return out


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


# ---------------------------------------------------------------------------
# Phase 7: the generate() path
# ---------------------------------------------------------------------------

FINALIZE_TOL = 3e-5  # the DSP parity tolerance (tests/test_torch_port_dsp.py)
PITCH_TOL = 1e-4  # the pitch-shift parity tolerance (same file)
# The random-weight codec speaks at about -54 dBFS: the default -50 dB trim
# would cut every item to its first 10 ms window, so the phase trims at -70.
SILENCE_DB = -70.0


def _timed_method(obj, name, events, sync=False):
    """Wrap ``obj.name`` (an instance attribute) to record CUDA events around
    each call, and the host seconds when ``sync`` (synchronising at its end)."""
    inner = getattr(obj, name)

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        if sync:
            torch.cuda.synchronize()
        events.append((start, end, time.perf_counter() - t0))
        return out

    setattr(obj, name, timed)


def _event_ms(events) -> float:
    return sum(s.elapsed_time(e) for s, e, _ in events)


def _host_s(events) -> float:
    return sum(h for _, _, h in events)


def _sync_checked(fn):
    """Run ``fn()`` under ``set_sync_debug_mode("error")`` (any host wait
    raises), then check that the mode catches a fetch (its positive
    control). Returns ``fn()``'s result, still on the device."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    caught = False
    try:
        out = fn()
        try:
            torch.zeros(1, device="cuda").sum().item()
        except RuntimeError:
            caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not caught:
        raise AssertionError("sync debug mode did not catch a host fetch")
    return out


def _dsp_card_vs_cpu(dsp, pitch_fn, waves, sr, silence_db: float) -> dict:
    """The fused finalize (one and three segments, with loudness) on the card
    against the same call on the CPU copies, and ``_apply_speed_pitch``; the
    device part of the finalize must not synchronise with the host."""
    out = {}
    for what, segs in (("one segment", waves[:1]), ("three segments", waves[:3])):
        buf, meta = _sync_checked(lambda: dsp.finalize_segments(
            segs, sr, loudness=True, defer_fetch=True, silence_threshold_db=silence_db))
        length, ratio = meta.cpu().tolist()
        card = buf[: int(length)]
        cpu, cpu_ratio = dsp.finalize_segments([w.cpu() for w in segs], sr, loudness=True,
                                               silence_threshold_db=silence_db)
        err = (card.cpu() - cpu).abs().max().item() if card.shape == cpu.shape else float("inf")
        out[what] = {"samples": int(length), "max_abs_err": err, "tol": FINALIZE_TOL,
                     "decay_ratio_err": abs(ratio - cpu_ratio), "host_syncs_before_fetch": 0}
        if not err <= FINALIZE_TOL or not abs(ratio - cpu_ratio) <= 1e-4:
            raise AssertionError(f"finalize {what}: card vs CPU {out[what]}")
    sp_card = pitch_fn(waves[0])
    sp_cpu = pitch_fn(waves[0].cpu())
    err = (sp_card.cpu() - sp_cpu).abs().max().item() if sp_card.shape == sp_cpu.shape \
        else float("inf")
    out["speed 1.5 + pitch 2"] = {"samples": sp_card.shape[0], "max_abs_err": err,
                                  "tol": PITCH_TOL}
    if not err <= PITCH_TOL:
        raise AssertionError(f"speed/pitch card vs CPU {out['speed 1.5 + pitch 2']}")
    return out


def run_generate_path(qmodel, kmods, build_dir: str, smi: str) -> dict:
    """Phase 7: ``TTSFactory`` -> ``QwenTTS`` -> engine -> fused DSP -> WAV.

    a. CustomVoice 1.7B int8, ``generate(TEXTS, output_path)`` once to warm
       up and once timed (EOS masked, so every row decodes every frame);
    b. checks: results, WAV readback, exact launch counts, bit-equality
       with a direct ``synthesize`` + ``finalize_segments`` from the same
       key, one host fetch for the batch's finalize, DSP card vs CPU;
    c. voice clone from a 20 s WAV (at 16 kHz, so the reference is
       resampled on the card and capped at 10 s);
    d. ``speed=1.5, pitch_semitones=2.0``;
    e. ``stream()``: the first chunk's latency, the full length, and the
       codes of a one-shot decode of the text from the same key.
    """
    import numpy as np

    from rho_tts_tpu_torch import TTSFactory, audio_io
    from rho_tts_tpu_torch.models.qwen.model import _derive_row_seeds
    from rho_tts_tpu_torch.ops import dsp
    from rho_tts_tpu_torch.ops.resample import resample

    # The port as it runs by default: PyTorch's TF32 defaults (matmul off,
    # cuDNN on; the resample is a matmul, the codec runs bf16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(build_dir, "phase7")
    os.makedirs(out_dir, exist_ok=True)
    min_audio_sec = 1000.0  # EOS masked in every frame: exact launch counts
    t0 = time.perf_counter()
    tts = TTSFactory.get_tts_instance(
        "qwen", speaker="Vivian", model_path="Qwen3-TTS-12Hz-1.7B-CustomVoice",
        quantization="int8", device="cuda", min_audio_sec=min_audio_sec)
    tts.silence_threshold_db = SILENCE_DB
    model = tts._load_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.config
    sr, hop, chunk = model.sample_rate, cfg.codec.hop, qmodel._chunk()
    base = os.path.join(out_dir, "out")

    t0 = time.perf_counter()
    tts.generate(TEXTS, output_path=base)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    # -- a. the timed call ------------------------------------------------
    for mod in kmods.values():
        mod.launches = 0
    fetches0 = dsp.fetches
    synth_ev, final_ev, save_ev = [], [], []
    _timed_method(model, "synthesize", synth_ev, sync=True)
    _timed_method(tts, "_finalize_items", final_ev)
    _timed_method(tts, "_save_wav", save_ev)
    with StageClock(qmodel) as clock:
        t0 = time.perf_counter()
        results = tts.generate(TEXTS, output_path=base)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    del model.synthesize, tts._finalize_items, tts._save_wav
    launches = {name: mod.launches for name, mod in kmods.items()}
    finalize_fetches = dsp.fetches - fetches0
    steps = len(clock.events["decode_chunk"]) * chunk
    layers = cfg.talker.layers

    # -- b. checks --------------------------------------------------------
    want = {"prefill_gqa_attention": layers, "decode_gqa_attention": layers * steps,
            "w8a8_matmul": 0, "int4_matmul": 0}
    if launches != want:
        raise AssertionError(f"generate(): launches {launches}, expected {want} ({steps} steps)")
    if finalize_fetches != 1:
        raise AssertionError(f"generate(): {finalize_fetches} DSP host fetches, expected 1")
    if not isinstance(results, list) or len(results) != len(TEXTS) or None in results:
        raise AssertionError(f"generate(): results {results!r}")
    for i, r in enumerate(results):
        a = r.audio
        if a.device.type != "cuda" or a.dtype != torch.float32 or a.ndim != 1 \
                or not bool(torch.isfinite(a).all()) or r.duration_sec != a.shape[0] / sr \
                or not 0.9 * (steps + 1) * hop <= a.shape[0] <= (steps + 1) * hop:
            raise AssertionError(f"result {i}: {tuple(a.shape)} {a.dtype} {r.duration_sec}")
        wav, wav_sr = audio_io.load_wav(r.path)
        want_wav = audio_io._to_int16(r.numpy()).astype(np.float32) / 32768.0
        if wav_sr != sr or not np.array_equal(wav, want_wav):
            raise AssertionError(f"result {i}: WAV readback differs from result.audio")
    tts._set_seeds()
    key = tts.next_rng()  # the key the timed call's one model call drew
    waves, _ = model.synthesize(TEXTS, speaker="Vivian", language="English",
                                min_frames=int(min_audio_sec * cfg.codec.frame_rate),
                                seeds=_derive_row_seeds(key, len(TEXTS)))
    for i, (r, w) in enumerate(zip(results, waves)):
        direct, _ = dsp.finalize_segments([w], sr, loudness=True, silence_threshold_db=SILENCE_DB)
        if not torch.equal(r.audio, direct):
            raise AssertionError(f"result {i} differs from synthesize + finalize_segments")
    dsp_checks = _dsp_card_vs_cpu(dsp, lambda a: tts._apply_speed_pitch(a, 1.5, 2.0), waves, sr,
                                  SILENCE_DB)
    audio_s = sum(r.duration_sec for r in results)
    synth_s = _host_s(synth_ev)
    gen = {
        "card": smi, "preset": cfg.name, "quantization": model.quantization,
        "batch": len(TEXTS), "decode_steps": steps, "init_s": init_s, "warmup_s": warm_s,
        "generate_wall_s": wall_s, "audio_s": audio_s, "rtf": audio_s / wall_s,
        "prefill_ms": clock.ms("prefill"), "decode_ms": clock.ms("decode_chunk"),
        "vocode_ms": clock.ms("vocode"), "finalize_ms": _event_ms(final_ev),
        "synthesize_wall_s": synth_s, "engine_overhead_s": wall_s - synth_s,
        "wav_save_ms": _host_s(save_ev) * 1e3, "finalize_host_fetches": finalize_fetches,
        "launches": launches, "bit_equal_to_synthesize_finalize": True,
        "wav_readback_equal": True, "dsp_card_vs_cpu": dsp_checks,
    }

    # -- d. speed and pitch -----------------------------------------------
    # The longest text decodes as many frames alone as in the batch.
    i = max(range(len(TEXTS)), key=lambda j: len(TEXTS[j]))
    t0 = time.perf_counter()
    sp = tts.generate(TEXTS[i], speed=1.5, pitch_semitones=2.0)
    torch.cuda.synchronize()
    ratio = sp.audio.shape[0] / results[i].audio.shape[0]
    if not bool(torch.isfinite(sp.audio).all()) or abs(ratio - 1 / 1.5) > 0.01:
        raise AssertionError(f"speed 1.5: length ratio {ratio}")
    gen["speed_pitch"] = {"wall_s": time.perf_counter() - t0, "samples": sp.audio.shape[0],
                          "plain_samples": results[i].audio.shape[0], "length_ratio": ratio}

    # -- e. stream ----------------------------------------------------------
    raw = []
    inner_chunks = tts._stream_audio_chunks

    def counting_chunks(*args, **kwargs):
        for piece in inner_chunks(*args, **kwargs):
            raw.append(piece.shape[0])
            yield piece

    streamed_codes = []
    inner_decode = qmodel._decode_chunk

    def capturing_decode(*args, **kwargs):
        out = inner_decode(*args, **kwargs)
        streamed_codes.append(out[0])
        return out

    tts._stream_audio_chunks = counting_chunks
    qmodel._decode_chunk = capturing_decode
    for mod in kmods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    pieces, first_s = [], None
    try:
        for piece in tts.stream(TEXTS[0]):
            if first_s is None:
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
            pieces.append(piece.audio)
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
    finally:
        qmodel._decode_chunk = inner_decode
    del tts._stream_audio_chunks
    stream_launches = {k: m.launches for k, m in kmods.items()}
    # stream() decodes the codes a one-shot decode of the text draws from the
    # same key (its cache has the same length, so the kernel splits alike).
    tts._set_seeds()
    with torch.inference_mode():
        codes, _, _ = model._generate_codes_arrays(
            [TEXTS[0]], speaker="Vivian", language="English",
            min_frames=int(min_audio_sec * cfg.codec.frame_rate),
            seeds=_derive_row_seeds(tts.next_rng(), 1))
    streamed = torch.cat(streamed_codes, dim=1)
    if not torch.equal(streamed, codes[:, 1:1 + streamed.shape[1]]):
        raise AssertionError("stream(): codes differ from a one-shot decode from the same key")
    total = sum(p.shape[0] for p in pieces)
    frames = sum(raw) // hop
    if len(pieces) < 2 or not all(bool(torch.isfinite(p).all()) for p in pieces) \
            or frames % chunk != 1 or not 0.99 * sum(raw) <= total <= sum(raw):
        raise AssertionError(f"stream: {len(pieces)} pieces, {total} of {sum(raw)} samples")
    gen["stream"] = {"first_chunk_s": first_s, "wall_s": stream_s, "pieces": len(pieces),
                     "samples": total, "decoded_samples": sum(raw), "frames": frames,
                     "codes_equal_to_one_shot": True, "launches": stream_launches}
    gen["peak_mem_gb_customvoice"] = torch.cuda.max_memory_allocated() / 1e9
    tts.close()
    del tts, model, waves, results, sp, pieces
    gc.collect()
    torch.cuda.empty_cache()

    # -- c. voice clone -----------------------------------------------------
    ref_path = os.path.join(out_dir, "reference_16k.wav")
    ref = torch.from_numpy(audio_io.load_wav(base + "_0.wav")[0]).cuda()
    ref = ref.repeat(int(np.ceil(20 * sr / ref.shape[0])))[: 20 * sr]
    audio_io.save_wav(ref_path, resample(ref, sr, 16000), 16000)  # 20 s at 16 kHz
    clone = TTSFactory.get_tts_instance(
        "qwen", model_path="Qwen3-TTS-12Hz-1.7B-Base", reference_audio=ref_path,
        reference_text=TEXTS[0], quantization="int8", device="cuda",
        min_audio_sec=min_audio_sec)
    clone.silence_threshold_db = SILENCE_DB
    cmodel = clone._load_model()
    for mod in kmods.values():
        mod.launches = 0
    with StageClock(qmodel) as cclock:
        t0 = time.perf_counter()
        res = clone.generate(TEXTS[1])
        torch.cuda.synchronize()
        clone_s = time.perf_counter() - t0
    claunches = {name: mod.launches for name, mod in kmods.items()}
    csteps = len(cclock.events["decode_chunk"]) * chunk
    ref_codes = cmodel._reference_codes(ref_path)
    arrays, lens, bucket = cmodel._build_prompt_arrays([TEXTS[1]], None, "English", ref_path,
                                                      TEXTS[0])
    want = {"prefill_gqa_attention": layers, "decode_gqa_attention": layers * csteps,
            "w8a8_matmul": 0, "int4_matmul": 0}
    if res is None or not bool(torch.isfinite(res.audio).all()) or claunches != want \
            or ref_codes.shape != (10 * sr // hop, cfg.codec.n_codebooks) \
            or int(arrays["code_mask"].sum()) != ref_codes.shape[0]:
        raise AssertionError(f"voice clone: {claunches} vs {want}, ref codes {ref_codes.shape}")
    gen["voice_clone"] = {"wall_s": clone_s, "samples": res.audio.shape[0],
                          "reference_frames": ref_codes.shape[0], "prompt_len": lens[0],
                          "prompt_bucket": bucket, "decode_steps": csteps,
                          "prefill_ms": cclock.ms("prefill"), "launches": claunches}
    gen["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    clone.close()
    return gen


# ---------------------------------------------------------------------------
# Phase 8: the validating voice-clone generate()
# ---------------------------------------------------------------------------

VOICE_ID = "phase8-voice"
# Card-vs-CPU tolerances (float32 on both, TF32 off for matmuls; the speaker
# LSTM and the Whisper convs are float32 matmuls, so cuDNN's TF32 default
# does not reach them; the FFTs are cuFFT against pocketfft).
EMBED_TOL = 1e-5  # L2-normalized 256-d embeddings
MFCC_TOL = 5e-4  # MFCC statistics in dB, magnitudes up to ~600
AUTOCORR_RTOL = 1e-5  # formant autocorrelation, relative to r[0]
FOREST_TOL = 1e-6  # the same comparisons; the fold mean and interpolation round
WHISPER_ENC_TOL = 1e-4  # LayerNorm-ed encoder states of magnitude ~1-5
WHISPER_LOGIT_TOL = 1e-4  # teacher-forced logits of magnitude ~1


def _random_forest_tables(forest_torch, n_features: int, seed: int = 0, device="cuda"):
    """A forest at the trainer's size (``trainer.train``: 5 isotonic folds x
    200 trees, max_depth 10) with random full 2,047-node trees, random
    splits over the 286 features at their typical scales, and a random
    non-decreasing calibration table per fold with repeated thresholds."""
    import numpy as np

    rng = np.random.default_rng(seed)
    folds, trees_per_fold, depth = 5, 200, 10
    n_trees, n_nodes = folds * trees_per_fold, 2 ** (depth + 1) - 1
    inner = np.arange(n_nodes) < 2 ** depth - 1
    left = np.where(inner, 2 * np.arange(n_nodes) + 1, -1)[None].repeat(n_trees, 0)
    right = np.where(inner, 2 * np.arange(n_nodes) + 2, -1)[None].repeat(n_trees, 0)
    feature = rng.integers(0, n_features, (n_trees, n_nodes))
    # split values drawn around each feature group's scale: embedding, MFCC
    # means, MFCC stds, F0 mean and std, F1 and F2
    scale = np.concatenate([np.full(256, 0.1), np.full(13, 100.0), np.full(13, 20.0),
                            [200.0, 50.0, 800.0, 1500.0]])
    centre = np.concatenate([np.zeros(256), np.full(13, -150.0), np.full(13, 20.0),
                             [150.0, 30.0, 600.0, 1500.0]])
    threshold = centre[feature] + scale[feature] * rng.standard_normal((n_trees, n_nodes))
    leaf_p1 = rng.uniform(0, 1, (n_trees, n_nodes))
    fold_id = np.repeat(np.arange(folds), trees_per_fold)
    cal_x = np.sort(np.round(rng.uniform(0, 1, (folds, 40)), 2), axis=1)  # repeats
    cal_y = np.sort(rng.uniform(0, 1, (folds, 40)), axis=1)
    return forest_torch.tables(left, right, feature, threshold, leaf_p1, fold_id, depth,
                               cal=(cal_x, cal_y), device=device)


class _Recorder:
    """CUDA events (and host seconds) around attributes of modules, classes
    or instances for the duration of a ``with`` block."""

    def __init__(self, targets):
        self.targets = targets  # {label: (owner, attribute name)}
        self.events = {label: [] for label in targets}
        self.saved = {}

    def __enter__(self):
        for label, (owner, name) in self.targets.items():
            self.saved[label] = getattr(owner, name)
            _timed_method(owner, name, self.events[label])
        return self

    def __exit__(self, *exc):
        for label, (owner, name) in self.targets.items():
            setattr(owner, name, self.saved[label])

    def ms(self, label) -> float:
        return _event_ms(self.events[label])

    def host_s(self, label) -> float:
        return _host_s(self.events[label])


def run_validate_path(qmodel, kmods, build_dir: str, smi: str, gen7: dict) -> dict:
    """Phase 8: a voice-clone ``generate()`` with every validator live.

    Qwen3-TTS 1.7B-Base int8 clones phase 7's 20 s, 16 kHz reference; the 5
    texts go in as one ``generate()``. The GE2E speaker encoder (default
    weights, the JAX package's draw) embeds the reference at load and the
    drift features; a random forest at the trainer's size sits in the
    classifier's cache under the per-voice key (no sklearn needed); Whisper
    tiny runs on random weights (``RHO_TTS_TPU_STT_ALLOW_RANDOM=1``), beam 5,
    128 tokens, at ``text_similarity_threshold=0.0``.

    a. a permissive drift gate: every segment passes at once; timed after a
       warm-up, beside the same call without validation;
    b. a gate every segment fails (threshold 0.0, ``max_iterations=2``):
       two model calls, and each item keeps its lower-drift attempt;
    c. one host fetch for the drift statistics and one for the STT ids, and
       no host wait before them (``set_sync_debug_mode("error")``);
    d. card against CPU on the same weights and inputs: the reference
       embedding, the drift statistics, the forest, Whisper's encoder
       states and its teacher-forced logits on the card's tokens.
    """
    import numpy as np

    from rho_tts_tpu_torch import TTSFactory, audio_io
    from rho_tts_tpu_torch.models.speaker import SpeakerEncoder
    from rho_tts_tpu_torch.models.whisper import model as wmodel
    from rho_tts_tpu_torch.ops import dsp
    from rho_tts_tpu_torch.validation import classifier as clf
    from rho_tts_tpu_torch.validation.classifier import forest_torch, trainer
    from rho_tts_tpu_torch.validation.stt import stt_validator as sv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    saved_env = {k: os.environ.get(k) for k in ("RHO_TTS_TPU_STT_ALLOW_RANDOM",
                                                 "RHO_TTS_TPU_WHISPER_MODEL",
                                                 "RHO_TTS_TPU_STT_BEAM")}
    os.environ.update(RHO_TTS_TPU_STT_ALLOW_RANDOM="1", RHO_TTS_TPU_WHISPER_MODEL="whisper-tiny")
    os.environ.pop("RHO_TTS_TPU_STT_BEAM", None)  # the default, beam 5
    sv._whisper.clear()  # phase 7 ran without a Whisper checkpoint: the gate was off
    sv._whisper_failed = False
    clf.clear_cache()
    tables = _random_forest_tables(forest_torch, 286)
    forest_bytes = sum(t.numel() * t.element_size() for t in tables.values()
                       if isinstance(t, torch.Tensor))
    # the per-voice lookup's cache key: no pickle, no sklearn or joblib needed
    clf._models[VOICE_ID] = clf._forest_arrays[VOICE_ID] = tables
    clf._thresholds[VOICE_ID] = 0.5
    fallbacks0, failed0 = trainer.serial_fallbacks, sv.failed_transcriptions

    ref_path = os.path.join(build_dir, "phase7", "reference_16k.wav")
    t0 = time.perf_counter()
    tts = TTSFactory.get_tts_instance(
        "qwen", model_path="Qwen3-TTS-12Hz-1.7B-Base", reference_audio=ref_path,
        reference_text=TEXTS[0], quantization="int8", device="cuda", min_audio_sec=1000.0,
        max_iterations=1, accent_drift_threshold=1.01, text_similarity_threshold=0.0)
    tts.voice_id = VOICE_ID  # as the UI sets it
    tts.silence_threshold_db = SILENCE_DB
    tts.max_decay_retries = 1  # the decay gate is phase 7's; here one pass per gate
    model = tts._load_model()  # computes the reference embedding
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if tts.reference_embedding is None or tts.reference_embedding.shape != (256,) \
            or not np.isfinite(tts.reference_embedding).all():
        raise AssertionError(f"reference embedding {tts.reference_embedding!r}")
    cfg, sr, chunk = model.config, model.sample_rate, qmodel._chunk()
    layers = cfg.talker.layers
    ref_ev = []
    tts._reference_embedding_initialized = False
    _timed_method(tts, "_initialize_reference_embedding", ref_ev)
    tts._initialize_reference_embedding()
    del tts._initialize_reference_embedding

    outs = []
    inner_gen = tts._generate_audio

    def recording_gen(*args, **kwargs):
        res = inner_gen(*args, **kwargs)
        outs.append(res)
        return res

    tts._generate_audio = recording_gen
    drift_probs = []
    inner_probs = clf.predict_accent_drift_probability_batch

    def recording_probs(*args, **kwargs):
        res = inner_probs(*args, **kwargs)
        drift_probs.append(res)
        return res

    clf.predict_accent_drift_probability_batch = recording_probs
    out = {"card": smi, "preset": cfg.name, "quantization": model.quantization,
           "batch": len(TEXTS), "init_s": init_s, "forest": {
               "folds": 5, "trees": 1000, "max_depth": 10, "nodes_per_tree": 2047,
               "bytes_on_card": forest_bytes},
           "whisper": {"preset": "tiny", "beam": 5, "max_tokens": 128},
           "reference_embedding_ms": _event_ms(ref_ev),
           "reference_embedding_host_s": _host_s(ref_ev)}
    try:
        # -- the same clone without validation (max_iterations=1) ---------------
        tts.generate(TEXTS)  # warm-up of the model path
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = tts.generate(TEXTS)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0

        # -- a. every validator live, a permissive gate -------------------------
        tts.max_iterations = 10
        t0 = time.perf_counter()
        tts.generate(TEXTS)  # warm-up: Whisper on the card, cuFFT plans, constants
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        for mod in kmods.values():
            mod.launches = 0
        outs.clear()
        drift_probs.clear()
        fetch0 = (trainer.fetches, wmodel.fetches, dsp.fetches)
        probes = _Recorder({
            "drift_batch": (tts, "_validate_accent_drift_batch"),
            "drift_features": (trainer, "extract_features_batch_audio"),
            "forest": (forest_torch, "predict_proba"),
            "stt_batch": (tts, "_validate_text_match_batch"),
            "stt_resample": (wmodel.WhisperTranscriber, "prepare"),
            "stt_mel": (wmodel, "log_mel_spectrogram"),
            "stt_encode": (wmodel, "encode"),
            "stt_beam_decode": (wmodel, "beam_decode"),
        })
        with StageClock(qmodel) as clock, probes:
            t0 = time.perf_counter()
            results = tts.generate(TEXTS)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        launches_a = {name: mod.launches for name, mod in kmods.items()}
        fetches = {"drift_statistics": trainer.fetches - fetch0[0],
                   "stt_ids": wmodel.fetches - fetch0[1], "finalize": dsp.fetches - fetch0[2]}
        steps = len(clock.events["decode_chunk"]) * chunk
        want = {"prefill_gqa_attention": layers, "decode_gqa_attention": layers * steps,
                "w8a8_matmul": 0, "int4_matmul": 0}
        if launches_a != want or len(outs) != 1:
            raise AssertionError(f"validate (a): launches {launches_a} vs {want}, "
                                 f"{len(outs)} model calls")
        if fetches != {"drift_statistics": 1, "stt_ids": 1, "finalize": 1}:
            raise AssertionError(f"validate (a): host fetches {fetches}")
        probs_a = drift_probs[0]
        if not isinstance(results, list) or len(results) != len(TEXTS) or None in results \
                or None in probs_a or not all(0.0 <= p <= 1.0 for p in probs_a):
            raise AssertionError(f"validate (a): results {results!r}, drift {probs_a}")
        for i, r in enumerate(results):
            if not bool(torch.isfinite(r.audio).all()) or r.drift_prob != probs_a[i] \
                    or r.text_similarity is None:
                raise AssertionError(f"validate (a) item {i}: drift {r.drift_prob} vs "
                                     f"{probs_a[i]}, similarity {r.text_similarity}")
        audio_s = sum(r.duration_sec for r in results)
        validation_ms = probes.host_s("drift_batch") * 1e3 + probes.host_s("stt_batch") * 1e3
        out["a_permissive"] = {
            "generate_wall_s": wall_s, "audio_s": audio_s, "rtf": audio_s / wall_s,
            "warmup_s": warm_s, "decode_steps": steps,
            "without_validation_wall_s": plain_s,
            "without_validation_rtf": sum(r.duration_sec for r in plain) / plain_s,
            "phase7_customvoice_wall_s": gen7["generate_wall_s"],
            "validation_host_ms": validation_ms, "validation_share": validation_ms / 1e3 / wall_s,
            "drift_host_ms": probes.host_s("drift_batch") * 1e3,
            "stt_host_ms": probes.host_s("stt_batch") * 1e3,
            "drift_features_ms": probes.ms("drift_features"), "forest_ms": probes.ms("forest"),
            "stt_ms": {k: probes.ms(f"stt_{k}") for k in ("resample", "mel", "encode",
                                                            "beam_decode")},
            "drift_probs": probs_a, "text_similarity": [r.text_similarity for r in results],
            "host_fetches": fetches, "launches": launches_a,
        }
        audios = outs[0]

        # -- b. a gate every segment fails: two attempts, the lower drift kept ---
        tts.accent_drift_threshold = 0.0
        tts.max_iterations = 2
        outs.clear()
        drift_probs.clear()
        for mod in kmods.values():
            mod.launches = 0
        with StageClock(qmodel) as bclock:
            t0 = time.perf_counter()
            b_results = tts.generate(TEXTS)
            torch.cuda.synchronize()
            b_wall = time.perf_counter() - t0
        launches_b = {name: mod.launches for name, mod in kmods.items()}
        b_steps = len(bclock.events["decode_chunk"]) * chunk
        want_b = {"prefill_gqa_attention": 2 * layers, "decode_gqa_attention": layers * b_steps,
                  "w8a8_matmul": 0, "int4_matmul": 0}
        if len(outs) != 2 or len(drift_probs) != 2 or launches_b != want_b:
            raise AssertionError(f"validate (b): {len(outs)} model calls, launches {launches_b}"
                                 f" vs {want_b}")
        kept = []
        for i, r in enumerate(b_results):
            p1, p2 = drift_probs[0][i], drift_probs[1][i]
            pick = 0 if p1 <= p2 else 1  # best-by-drift: a later attempt must be lower
            direct, _ = dsp.finalize_segments([outs[pick][i]], sr, loudness=True,
                                              silence_threshold_db=SILENCE_DB)
            if r is None or r.drift_prob != min(p1, p2) or not torch.equal(r.audio, direct):
                raise AssertionError(f"validate (b) item {i}: drift {r and r.drift_prob} vs "
                                     f"{(p1, p2)}, or not the lower-drift attempt's audio")
            kept.append(pick)
        out["b_every_segment_fails"] = {
            "generate_wall_s": b_wall, "model_calls": 2, "decode_steps": b_steps,
            "drift_probs": drift_probs, "kept_attempt": kept, "launches": launches_b}

        # -- c. one fetch each, no host wait before it ------------------------
        packed, _sizes = _sync_checked(
            lambda: trainer.batch_statistics(audios, sr, audios[0].device))
        packed_host = packed.cpu()
        tr = sv._whisper[str(audios[0].device)]
        toks = _sync_checked(lambda: tr.model.tokens_on_device(
            tr.prepare(audios, [sr] * len(audios)), 128, 5))
        toks_host = toks.cpu().numpy()
        texts = [tr.tokenizer.decode([int(t) for t in row if int(t) < tr.model.cfg.eot])
                 for row in toks_host]
        out["c_sync"] = {"drift_statistics_host_waits_before_fetch": 0,
                         "stt_ids_host_waits_before_fetch": 0,
                         "stt_ids_equal_to_a": True}
        sims = [sv.calculate_text_similarity(t, x.strip()) if x.strip() else 0.0
                for t, x in zip(TEXTS, texts)]
        if sims != out["a_permissive"]["text_similarity"]:
            raise AssertionError(f"STT ids differ from (a)'s: {sims} vs "
                                 f"{out['a_permissive']['text_similarity']}")

        # -- d. card against CPU -------------------------------------------------
        checks = {}
        wav, wav_sr = audio_io.load_wav(ref_path)
        cpu_enc = SpeakerEncoder(params=_tree_map(torch.Tensor.cpu, tts.speaker_encoder.params),
                                 device="cpu")
        err = float(np.abs(cpu_enc.embed_utterance(wav, wav_sr) - tts.reference_embedding).max())
        checks["reference_embedding"] = {"max_abs_err": err, "tol": EMBED_TOL}
        trainer._encoders["cpu"] = cpu_enc
        cpu_packed, sizes = trainer.batch_statistics([a.cpu() for a in audios], sr, "cpu")
        groups = dict(zip(("mfcc_mean", "mfcc_std", "f0_mean", "f0_std", "embedding",
                           "autocorr"),
                          zip(torch.split(packed_host, sizes, dim=1),
                              torch.split(cpu_packed, sizes, dim=1))))
        for name, tol in (("mfcc_mean", MFCC_TOL), ("mfcc_std", MFCC_TOL),
                          ("embedding", EMBED_TOL)):
            card, host = groups[name]
            checks[name] = {"max_abs_err": (card - host).abs().max().item(), "tol": tol}
        card, host = groups["autocorr"]
        checks["autocorr"] = {
            "max_rel_err": ((card - host).abs() / host[:, :1].abs().clamp_min(1e-30)).max().item(),
            "tol": AUTOCORR_RTOL}
        for name in ("f0_mean", "f0_std"):  # YIN decisions may flip near a threshold
            card, host = groups[name]
            checks[name] = {"max_abs_err_hz": (card - host).abs().max().item(), "required": False}
        feats = np.stack(trainer.extract_features_batch_audio(audios, sr))
        card_p = forest_torch.predict_proba(tables, feats).cpu()
        cpu_p = forest_torch.predict_proba(forest_torch.to_device(tables, "cpu"), feats)
        checks["forest"] = {"max_abs_err": (card_p - cpu_p).abs().max().item(),
                            "tol": FOREST_TOL, "probs": card_p.tolist()}
        rows = 2
        wparams_cpu = _tree_map(torch.Tensor.cpu, tr.model.params)
        with torch.inference_mode():
            mels = wmodel.log_mel_spectrogram(torch.stack(
                tr.prepare(audios[:rows], [sr] * rows)))[:, :wmodel.CHUNK_FRAMES]
            enc = wmodel.encode(tr.model.params, tr.model.cfg, mels)
            enc_cpu = wmodel.encode(wparams_cpu, tr.model.cfg, mels.cpu())
            checks["whisper_encoder"] = {"max_abs_err": (enc.cpu() - enc_cpu).abs().max().item(),
                                         "tol": WHISPER_ENC_TOL,
                                         "max_abs": enc_cpu.abs().max().item()}
            seq = torch.cat([torch.tensor([tr.model.prompt] * rows), torch.from_numpy(
                toks_host[:rows])], dim=1)
            logits = wmodel.decoder_logits(tr.model.params, tr.model.cfg, enc, seq.to(enc.device))
            logits_cpu = wmodel.decoder_logits(wparams_cpu, tr.model.cfg, enc.cpu(), seq)
        p = len(tr.model.prompt)
        agree = (logits_cpu[:, p - 1:-1].argmax(-1) == seq[:, p:]).float().mean().item()
        checks["whisper_logits"] = {"max_abs_err": (logits.cpu() - logits_cpu).abs().max().item(),
                                    "tol": WHISPER_LOGIT_TOL,
                                    "cpu_token_agreement": agree, "required_agreement": None}
        out["d_card_vs_cpu"] = checks
        bad = {k: v for k, v in checks.items() if "tol" in v and not (
            v.get("max_abs_err", v.get("max_rel_err")) <= v["tol"])}
        if bad:
            raise AssertionError(f"validate card vs CPU: {bad}")
        out["events"] = {"serial_fallbacks": trainer.serial_fallbacks - fallbacks0,
                         "failed_transcriptions": sv.failed_transcriptions - failed0}
        if out["events"] != {"serial_fallbacks": 0, "failed_transcriptions": 0}:
            raise AssertionError(f"validate: fallback events {out['events']}")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    finally:
        clf.predict_accent_drift_probability_batch = inner_probs
        for k, v in saved_env.items():
            _restore_env(k, v)
        # Later phases run with phase 7's gate: no Whisper checkpoint, STT off.
        sv._whisper.clear()
        sv._whisper_failed = False
    tts.close()
    clf.clear_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 9: continuous-batching serving at full width
# ---------------------------------------------------------------------------

# bench.py's serving workload (its bench_serve): 24 requests of ragged
# lengths pinned by min_frames == max_frames, 8 slots, top-k 4 at 0.9. Cut
# to the first 16 requests for the script's time limit.
SERVE_DRAWN, SERVE_REQUESTS = 24, 16
SERVE_LENGTHS = (128, 192, 256, 384, 512)
SERVE_TEXT = "Serving request number {} with a ragged target length."


def _guard_sync(obj, names):
    """Run each method ``names`` of ``obj`` under ``set_sync_debug_mode("error")``:
    any host wait inside raises. Returns a function that restores them."""
    saved = {}
    for name in names:
        inner = saved[name] = getattr(obj, name)

        def guarded(*args, _inner=inner, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _inner(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        setattr(obj, name, guarded)
    return lambda: [delattr(obj, name) for name in saved]


def _drive(eng, texts, lengths, stream_every=0, temperature=0.9, seeds=None):
    """Submit one request per (text, length), pinned to its length; every
    ``stream_every``-th one (from the second) streamed; drive the engine in
    this thread until idle. Returns the requests and the wall seconds to the
    last waveform on the card."""
    t0 = time.perf_counter()
    reqs = [eng.submit(t, min_frames=n, max_frames=n, temperature=temperature,
                       stream=bool(stream_every) and i % stream_every == 1,
                       seed=None if seeds is None else seeds[i])
            for i, (t, n) in enumerate(zip(texts, lengths))]
    eng.run_until_idle()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def _serve_traffic():
    """Phase 9's requests: texts and bench.py's ragged target lengths."""
    import numpy as np

    lengths = np.random.default_rng(0).choice(SERVE_LENGTHS, size=SERVE_DRAWN).tolist()
    lengths = [int(n) for n in lengths[:SERVE_REQUESTS]]
    return [SERVE_TEXT.format(i) for i in range(SERVE_REQUESTS)], lengths


def _percentile(xs, q):
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_serving_path(qmodel, kmods, build_dir: str, smi: str, gen7: dict) -> dict:
    """Phase 9: ``ServingEngine`` at full width through the hand kernels.

    a. 1.7B CustomVoice int8 (random weights), ``ServingEngine(n_slots=8,
       max_prompt=64, max_frames=512, top_k=4)``: 2 requests to warm up,
       then 16 of bench.py's ragged requests at temperature 0.9, every
       other one streamed, timed, with the admission and the dispatch under
       ``set_sync_debug_mode("error")`` (the lagged done-flag read is the
       only wait); the first 10 once more through ``synthesize`` in batches
       of 5, as the static comparison;
    b. speculative serving: a ``draft-1.7B`` draft (random weights), gamma
       4, residual mode "draft", 8 requests of 128 frames; and the
       single-stream speculative decode of one request of 128 frames;
    c. ``QwenTTS(serving=True)``: phase 7's 5 texts to WAV files;
    d. reported, not fatal: greedy served codes against ``generate_codes``
       for 3 requests.
    """
    import numpy as np

    from rho_tts_tpu_torch import TTSFactory, serving

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = qmodel.QwenTTSModel.from_pretrained("Qwen3-TTS-12Hz-1.7B-CustomVoice",
                                                quantization="int8", device="cuda")
    cfg = model.config
    layers, hop, fr = cfg.talker.layers, cfg.codec.hop, cfg.codec.frame_rate
    chunk = qmodel._chunk()
    texts, lengths = _serve_traffic()
    out = {"card": smi, "preset": cfg.name, "quantization": model.quantization,
           "requests": SERVE_REQUESTS,
           "cut": f"{SERVE_DRAWN} requests of bench.py's serving workload cut to the first "
                  f"{SERVE_REQUESTS} for time", "lengths": lengths}
    log(f"phase 9 ({smi}): serving {SERVE_REQUESTS} requests (bench.py draws {SERVE_DRAWN}; "
        f"cut for time), lengths {lengths}")

    # -- a. the slot batch ------------------------------------------------
    eng = serving.ServingEngine(model, n_slots=8, max_prompt=64, max_frames=512, top_k=4)
    t0 = time.perf_counter()
    _drive(eng, texts[:2], [128, 128], stream_every=2)  # warm-up
    warm_s = time.perf_counter() - t0
    events = []
    inner_chunk = serving._serve_decode_chunk

    def timed_chunk(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = inner_chunk(*args, **kwargs)
        end.record()
        events.append((start, end))
        return res

    serving._serve_decode_chunk = timed_chunk
    restore = _guard_sync(eng, ("_admit", "_dispatch"))
    for mod in kmods.values():
        mod.launches = 0
    dispatches0, admissions0, frames0 = eng.dispatches, eng.admissions, eng.frames_delivered
    try:
        reqs, wall = _drive(eng, texts, lengths, stream_every=2)
    finally:
        serving._serve_decode_chunk = inner_chunk
        restore()
    launches = {name: mod.launches for name, mod in kmods.items()}
    try:  # the positive control: the mode catches a fetch
        torch.cuda.set_sync_debug_mode("error")
        torch.zeros(1, device="cuda").sum().item()
        caught = False
    except RuntimeError:
        caught = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dispatches, admissions = eng.dispatches - dispatches0, eng.admissions - admissions0
    steps = dispatches * chunk
    want = {"prefill_gqa_attention": layers * admissions,
            "decode_gqa_attention": layers * steps, "w8a8_matmul": 0, "int4_matmul": 0}
    if not caught or launches != want:
        raise AssertionError(f"serving: launches {launches} vs {want}; sync check live {caught}")
    for i, (r, n) in enumerate(zip(reqs, lengths)):
        wav, sr = r.result(timeout=60)
        if r.n_frames != n or wav.shape != (n * hop,) or not bool(torch.isfinite(wav).all()):
            raise AssertionError(f"serving request {i}: {r.n_frames} frames of {n}, "
                                 f"{tuple(wav.shape)}")
        if r.stream:
            pieces = [p for p, _sr in r.chunks(timeout=60)]
            if len(pieces) < min(2, n // chunk) or not torch.equal(torch.cat(pieces), wav):
                raise AssertionError(f"serving request {i}: {len(pieces)} streamed pieces "
                                     "do not concatenate to the result")
    audio_s = sum(lengths) / fr
    lat = [r.t_done - r.t_submit for r in reqs]
    ttfa = [r.t_first_audio - r.t_submit for r in reqs if r.stream]
    chunk_ms = [s_.elapsed_time(e) for s_, e in events]
    out["a_slot_batch"] = {
        "n_slots": 8, "ring": eng.ring, "warmup_s": warm_s, "wall_s": wall,
        "audio_s": audio_s, "aggregate_rtf": audio_s / wall,
        "engine_stats": eng.stats(), "frames_delivered": eng.frames_delivered - frames0,
        "latency_p50_s": _percentile(lat, 50), "latency_p99_s": _percentile(lat, 99),
        "ttfa_streamed_p50_s": _percentile(ttfa, 50), "ttfa_streamed_max_s": max(ttfa),
        "dispatches": dispatches, "admission_groups": admissions, "decode_steps": steps,
        "decode_ms_per_chunk": sum(chunk_ms) / len(chunk_ms),
        "decode_ms_per_step": sum(chunk_ms) / (len(chunk_ms) * chunk),
        "launches": launches, "host_waits_in_dispatch": 0,
        "streamed_pieces_concatenate_to_result": True,
    }
    log(f"phase 9 a_slot_batch ({smi}): {json.dumps(out['a_slot_batch'])}")
    eng.close()

    t0 = time.perf_counter()
    for i in range(0, 10, 5):
        mx = max(lengths[i:i + 5])
        model.synthesize(texts[i:i + 5], min_frames=mx, max_frames=mx, top_k=4,
                         temperature=0.9, seeds=list(range(i, i + 5)))
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    static_audio = sum(lengths[:10]) / fr  # the requested audio, without the padding
    out["a_static_batch5"] = {"requests": 10, "wall_s": static_wall, "audio_s": static_audio,
                              "rtf": static_audio / static_wall}
    log(f"phase 9 a_static_batch5 ({smi}): {json.dumps(out['a_static_batch5'])}")

    # -- d. greedy served codes against generate_codes (reported) ----------
    geng = serving.ServingEngine(model, n_slots=8, max_prompt=64, max_frames=128, top_k=1)
    greqs, _ = _drive(geng, texts[:3], [128] * 3, temperature=1.0)
    one = model.generate_codes(texts[:3], min_frames=128, max_frames=128, temperature=1.0,
                               top_k=1)
    parity = []
    for r, o in zip(greqs, one):
        n = min(len(o), r.n_frames)
        eq = r.codes[:n] == o[:n]
        rows_eq = eq.all(axis=1)
        parity.append({"frames": n, "equal_share": float(rows_eq.mean()),
                       "first_difference": None if rows_eq.all() else int(np.argmin(rows_eq))})
    out["d_greedy_vs_generate_codes"] = {
        "required": False, "requests": parity,
        "why": "a ring of another length splits the decode kernel's keys otherwise, so bf16 "
               "near-ties can round apart; exact parity is the CPU tests' job"}
    log(f"phase 9 d_greedy_vs_generate_codes ({smi}): "
        f"{json.dumps(out['d_greedy_vs_generate_codes'])}")
    geng.close()

    # -- b. speculative serving ----------------------------------------------
    draft = qmodel.QwenTTSModel(qmodel.PRESETS["draft-1.7B"], seed=1, device="cuda")
    seng = serving.ServingEngine(model, n_slots=8, max_prompt=64, max_frames=128, top_k=4,
                                 draft_model=draft, gamma=4, residual_mode="draft")
    t0 = time.perf_counter()
    _drive(seng, texts[:2], [64, 64])  # warm-up
    swarm = time.perf_counter() - t0
    for mod in kmods.values():
        mod.launches = 0
    rounds0, adm0 = seng.spec_rounds, seng.admissions
    sreqs, swall = _drive(seng, texts[:8], [128] * 8)
    slaunches = {name: mod.launches for name, mod in kmods.items()}
    rounds = seng.spec_rounds - rounds0
    dlayers = draft.config.talker.layers
    swant = {"prefill_gqa_attention": (layers + dlayers) * (seng.admissions - adm0),
             "decode_gqa_attention": dlayers * (seng.gamma + 1) * rounds,
             "w8a8_matmul": 0, "int4_matmul": 0}
    frames = sum(r.n_frames for r in sreqs)
    if slaunches != swant or frames != 8 * 128 or not all(
            bool(torch.isfinite(r.result(timeout=60)[0]).all()) for r in sreqs):
        raise AssertionError(f"speculative serving: {frames} frames, launches {slaunches} vs "
                             f"{swant}")
    out["b_speculative"] = {
        "draft": "draft-1.7B (random weights)", "gamma": 4, "residual_mode": "draft",
        "requests": 8, "frames": frames, "warmup_s": swarm, "wall_s": swall,
        "rounds": rounds, "frames_per_round": frames / rounds,
        "frames_per_round_per_slot": frames / rounds / 8,
        "rtf": frames / fr / swall, "launches": slaunches,
        "note": "a random draft makes acceptance meaningless: this prices the round's "
                "mechanics, not speculation's gain"}
    log(f"phase 9 b_speculative ({smi}): {json.dumps(out['b_speculative'])}")
    seng.close()

    # single-stream speculative decode (QwenTTS(draft_model_path=...)'s route)
    from rho_tts_tpu_torch.models.qwen.speculative import CHECK_EVERY, speculative_generate_codes

    speculative_generate_codes(model, draft, texts[0], max_frames=64, min_frames=64, gamma=4)
    for mod in kmods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    codes, stats = speculative_generate_codes(model, draft, texts[1], max_frames=128,
                                              min_frames=128, gamma=4)
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_launches = {name: mod.launches for name, mod in kmods.items()}
    # The host reads the loop condition once every CHECK_EVERY rounds: up to
    # CHECK_EVERY - 1 rounds after the last live one run masked.
    dispatched = min(-(-stats["rounds"] // CHECK_EVERY) * CHECK_EVERY, 128)
    one_want = {"prefill_gqa_attention": layers + dlayers,
                "decode_gqa_attention": dlayers * 5 * dispatched,
                "w8a8_matmul": 0, "int4_matmul": 0}
    # (the codes stop at a sampled special token, as in the JAX package)
    if stats["emitted"] != 128 or one_launches != one_want:
        raise AssertionError(f"single-stream speculative decode: {codes.shape} codes, "
                             f"launches {one_launches} vs {one_want}")
    out["b_single_stream"] = {"frames_before_a_special_token": int(codes.shape[0]),
                              "wall_s": one_wall, "rtf": stats["emitted"] / fr / one_wall,
                              "rounds_dispatched": dispatched, **stats,
                              "launches": one_launches}
    log(f"phase 9 b_single_stream ({smi}): {json.dumps(out['b_single_stream'])}")
    del draft, seng, model
    gc.collect()
    torch.cuda.empty_cache()

    # -- c. QwenTTS(serving=True) ---------------------------------------------
    min_audio_sec = 1000.0  # EOS masked: every request decodes its max_frames
    tts = TTSFactory.get_tts_instance(
        "qwen", speaker="Vivian", model_path="Qwen3-TTS-12Hz-1.7B-CustomVoice",
        quantization="int8", device="cuda", min_audio_sec=min_audio_sec, serving=True)
    tts.silence_threshold_db = SILENCE_DB
    tts._load_model()
    out_dir = os.path.join(build_dir, "phase9")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    tts.generate(TEXTS, output_path=os.path.join(out_dir, "warm"))
    torch.cuda.synchronize()
    cwarm = time.perf_counter() - t0
    engine = tts._serving
    for mod in kmods.values():
        mod.launches = 0
    d0, a0 = engine.dispatches, engine.admissions
    t0 = time.perf_counter()
    results = tts.generate(TEXTS, output_path=os.path.join(out_dir, "out"))
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    claunches = {name: mod.launches for name, mod in kmods.items()}
    cwant = {"prefill_gqa_attention": layers * (engine.admissions - a0),
             "decode_gqa_attention": layers * chunk * (engine.dispatches - d0),
             "w8a8_matmul": 0, "int4_matmul": 0}
    if not isinstance(results, list) or len(results) != len(TEXTS) or None in results \
            or claunches != cwant or not all(bool(torch.isfinite(r.audio).all()) and
                                             os.path.exists(r.path) for r in results):
        raise AssertionError(f"served generate(): {results!r}, launches {claunches} vs {cwant}")
    caudio = sum(r.duration_sec for r in results)
    out["c_served_generate"] = {
        "ring": engine.ring, "warmup_s": cwarm, "generate_wall_s": cwall, "audio_s": caudio,
        "rtf": caudio / cwall, "phase7_generate_wall_s": gen7["generate_wall_s"],
        "phase7_audio_s": gen7["audio_s"], "dispatches": engine.dispatches - d0,
        "launches": claunches}
    log(f"phase 9 c_served_generate ({smi}): {json.dumps(out['c_served_generate'])}")
    tts.close()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 10: the Chatterbox family (bench.py config 4)
# ---------------------------------------------------------------------------

# bench.py's bench_chatterbox: its single text, its 8-segment text, a 3 s
# 180 Hz reference at 24 kHz, a 7 s floor, the first 2 drift validations
# of every generate() forced to fail (BENCH_CB_FAILS=2).
CB_TEXT = "A single segment regenerated with the full validation loop enabled."
CB_SEGMENTS = " ".join(
    f"Sentence number {i} of the retry gauntlet runs the whole validation loop."
    for i in range(8))
CB_FAILS = 2
CB_MIN_AUDIO_SEC = 7.0
WATERMARK_TOL = 1e-6  # the embed's CPU parity tolerance (test_torch_port_watermark.py)


def _failing_chatterbox(base_cls, engine_cls, fails: int):
    """bench.py's ``FailingChatterboxTTS``: the first ``fails`` drift
    validations of each ``generate()`` are rejected."""

    class FailingChatterboxTTS(base_cls):
        _seen = 0

        def generate(self, *a, **kw):
            self._seen = 0
            return super().generate(*a, **kw)

        def _inject(self, results):
            out = []
            for p, ok in results:
                out.append((0.99, False) if self._seen < fails else (p, ok))
                self._seen += 1
            return out

        def _validate_accent_drift(self, audio, sample_rate):
            return self._inject([super()._validate_accent_drift(audio, sample_rate)])[0]

        def _validate_accent_drift_batch(self, audios, sample_rate):
            # The stock batch hook sees the overridden single hook and would
            # call it per audio (injecting twice): shadow it with the stock
            # one for this call, then inject once.
            self.__dict__["_validate_accent_drift"] = \
                engine_cls._validate_accent_drift.__get__(self)
            try:
                real = super()._validate_accent_drift_batch(audios, sample_rate)
            finally:
                del self.__dict__["_validate_accent_drift"]
            return self._inject(real)

    return FailingChatterboxTTS


class _CbClock:
    """CUDA events around the Chatterbox model's stage functions (module
    globals, looked up at each call) and the tokens each decode chunk
    returns; no host sync."""

    STAGES = ("_prefill", "_decode_chunk", "_vocode", "apply_watermark")

    def __init__(self, cbm):
        self.cbm = cbm
        self.events = {name: [] for name in self.STAGES}
        self.chunks = []  # (toks (B, steps), done (B, steps)) of each decode chunk
        self.saved = {}

    def __enter__(self):
        for name in self.STAGES:
            inner = self.saved[name] = getattr(self.cbm, name)
            events = self.events[name]

            def timed(*args, _inner=inner, _events=events, _name=name, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = _inner(*args, **kwargs)
                end.record()
                _events.append((start, end))
                if _name == "_decode_chunk":
                    self.chunks.append((res[0], res[1]))
                return res

            setattr(self.cbm, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cbm, name, fn)

    def ms(self, name) -> float:
        return sum(s.elapsed_time(e) for s, e in self.events[name])

    def n(self, name) -> int:
        return len(self.events[name])


def _launches(kmods):
    return {name: mod.launches for name, mod in kmods.items()}


def _zero(kmods):
    for mod in kmods.values():
        mod.launches = 0


def _cb_want(layers, prefills=0, steps=0, int4=False):
    """Exact launch counts: the prefill kernel once a layer a prefill, the
    decode kernel once a layer a step; int4 in the 5 matmuls of every layer
    of every forward."""
    return {"prefill_gqa_attention": layers * prefills, "decode_gqa_attention": layers * steps,
            "w8a8_matmul": 0, "int4_matmul": 5 * layers * (prefills + steps) if int4 else 0}


def _cb_timed_generate(tts, cbm, kmods, layers, text, runs: int = 3, probe=None) -> dict:
    """A warm-up ``generate()``, then ``runs`` timed (median by wall), each
    with exact launch counts; ``probe()``, a context manager, wraps the last."""
    t0 = time.perf_counter()
    tts.generate(text)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    timed = []
    for i in range(runs):
        _zero(kmods)
        last = probe is not None and i == runs - 1
        with _CbClock(cbm) as clock, (probe() if last else contextlib.nullcontext()):
            t0 = time.perf_counter()
            result = tts.generate(text)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _launches(kmods)
        steps = clock.n("_decode_chunk") * cbm.CHUNK
        want = _cb_want(layers, clock.n("_prefill"), steps,
                        int4=tts.model.quantization == "int4")
        if launches != want or clock.n("_prefill") != 1 or result is None \
                or not bool(torch.isfinite(result.audio).all()):
            raise AssertionError(f"chatterbox generate(): launches {launches} vs {want}, "
                                 f"{clock.n('_prefill')} prefills, result {result!r}")
        timed.append({
            "wall_s": wall, "audio_s": result.duration_sec, "rtf": result.duration_sec / wall,
            "prefill_ms": clock.ms("_prefill"), "decode_steps": steps,
            "decode_ms_per_step": clock.ms("_decode_chunk") / steps,
            "vocode_ms": clock.ms("_vocode"), "watermark_ms": clock.ms("apply_watermark"),
            "launches": launches})
    timed.sort(key=lambda r: r["wall_s"])
    out = dict(timed[len(timed) // 2])
    out.update(warmup_s=warm_s, runs=runs, walls_s=[r["wall_s"] for r in timed])
    return out


def run_chatterbox_path(kmods, build_dir: str, smi: str, device: str = "cuda") -> dict:
    """Phase 10: ``bench.py`` config 4 through ``TTSFactory("chatterbox")``.

    The "standard" preset at full width (hidden 1024, 30 layers, 16 heads of
    64), random weights, weight-only int8, a 3 s 180 Hz reference at 24 kHz,
    ``max_chars_per_segment=400``, ``min_audio_sec=7.0``, no silence trim:

    a. one segment, ``max_iterations=1``: a warm-up and 3 timed runs (the
       median reported) with exact launch counts; in the last, the model's
       ``generate()`` against its raw vocode + ``apply_watermark`` bit for
       bit, with no host wait before its done-bitmap fetch; the embed card
       vs CPU; ``detect_watermark`` on a marked 3 s sine;
    b. ``candidates_per_iteration=4`` (8 CFG rows) with 2 forced drift
       failures, ``max_iterations=5``; reported, not fatal: candidate i's
       first decode chunk against ``generate(seed=seeds[i])``'s;
    c. ``serving=True`` (4 slots, prompt 128, 256 frames) on the 8-segment
       text (``max_chars_per_segment=80``, 2 forced failures), a standalone
       engine's admission and dispatch first under
       ``set_sync_debug_mode("error")``; the same text lockstep beside it;
    d. ``stream()``: the first chunk's latency; its tokens and pieces
       against a one-shot ``generate()`` from the same key;
    e. ``quantization="int4"``: one run of (a)'s text.
    """
    import numpy as np

    from rho_tts_tpu_torch import TTSFactory, engine, serving_cb
    from rho_tts_tpu_torch.audio_io import save_wav
    from rho_tts_tpu_torch.models.chatterbox import model as cbm
    from rho_tts_tpu_torch.ops import watermark as wm
    from rho_tts_tpu_torch.providers.chatterbox import ChatterboxTTS

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out_dir = os.path.join(build_dir, "phase10")
    os.makedirs(out_dir, exist_ok=True)
    sr = 24000
    sine = (0.3 * np.sin(2 * np.pi * 180 * np.arange(3 * sr) / sr)).astype(np.float32)
    ref = os.path.join(out_dir, "ref.wav")
    save_wav(ref, sine, sr)
    common = dict(implementation="standard", reference_audio=ref, quantization="int8",
                  min_audio_sec=CB_MIN_AUDIO_SEC, device=device)
    failing = _failing_chatterbox(ChatterboxTTS, engine.BaseTTS, CB_FAILS)
    layers = cbm.PRESETS["standard"].talker.layers
    out = {"card": smi, "preset": "standard", "quantization": "int8",
           "weights": "random (seed 789)", "text": CB_TEXT}

    # -- a. one segment -----------------------------------------------------
    t0 = time.perf_counter()
    tts = TTSFactory.get_tts_instance("chatterbox", max_chars_per_segment=400,
                                      max_iterations=1, **common)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tts.trim_silence = False  # random-weight output sits under the trim gate
    model = tts.model
    raw = {}

    @contextlib.contextmanager
    def probe():
        """In the last timed run: the model's output and its raw vocode, and
        the decode loop under set_sync_debug_mode("error") up to its fetch."""
        inner_vocode, inner_generate = cbm._vocode, model.generate

        def spy(params, cfg, toks):
            raw["vocode"] = inner_vocode(params, cfg, toks)
            return raw["vocode"]

        def generate(*args, **kwargs):
            raw["generate"] = inner_generate(*args, **kwargs)
            return raw["generate"]

        cbm._vocode, model.generate = spy, generate
        restore = _guard_sync(model, ("_start_decode", "_decode_all"))
        try:
            yield
        finally:
            restore()
            cbm._vocode = inner_vocode
            del model.generate

    a = _cb_timed_generate(tts, cbm, kmods, layers, CB_TEXT, probe=probe)
    a["init_s"] = init_s
    _sync_checked(lambda: None)  # the positive control: the mode catches a fetch
    wav = raw["generate"]
    plain = raw["vocode"][0, : wav.shape[0]]
    marked = wm.apply_watermark(plain)
    cpu = wm.apply_watermark(plain.cpu())
    embed_err = (marked.cpu() - cpu).abs().max().item()
    sine_t = torch.from_numpy(sine).to(device)
    score, score_plain = wm.detect_watermark(wm.apply_watermark(sine_t)), \
        wm.detect_watermark(sine_t)
    a.update(generate_equals_vocode_plus_watermark=bool(torch.equal(wav, marked)),
             watermark_added=bool(not torch.equal(wav, plain)),
             host_waits_before_done_fetch=0,
             watermark_card_vs_cpu={"samples": int(wav.shape[0]), "max_abs_err": embed_err,
                                    "tol": WATERMARK_TOL},
             detect_marked_sine=score, detect_plain_sine=score_plain)
    if not (a["generate_equals_vocode_plus_watermark"] and a["watermark_added"]) \
            or not embed_err <= WATERMARK_TOL or not score > 5.0 or not score_plain < 5.0:
        raise AssertionError(f"chatterbox watermark checks: {a}")
    out["a_one_segment"] = a
    log(f"phase 10 a_one_segment ({smi}): {json.dumps(a)}")
    tts.close()

    # -- b. candidates ------------------------------------------------------
    tts = failing(max_chars_per_segment=400, max_iterations=5, candidates_per_iteration=4,
                  **common)
    tts.trim_silence = False
    model = tts.model
    rounds = []
    inner_cands = tts._generate_audio_candidates

    def counted(text, k):
        rounds.append(k)
        return inner_cands(text, k)

    tts._generate_audio_candidates = counted
    seeds_seen = []
    inner_start = model._start_decode

    def start(*args, **kwargs):
        st = inner_start(*args, **kwargs)
        seeds_seen.append(st["seeds"].cpu().tolist())
        return st

    model._start_decode = start
    _zero(kmods)
    with _CbClock(cbm) as clock:
        t0 = time.perf_counter()
        result = tts.generate(CB_TEXT)
        torch.cuda.synchronize()
        bwall = time.perf_counter() - t0
    blaunches = _launches(kmods)
    bsteps = clock.n("_decode_chunk") * cbm.CHUNK
    bwant = _cb_want(layers, clock.n("_prefill"), bsteps)
    del model._start_decode
    if result is None or blaunches != bwant or rounds != [4]:
        raise AssertionError(f"chatterbox candidates: rounds {rounds}, launches {blaunches} "
                             f"vs {bwant}, result {result!r}")
    cand_toks = clock.chunks[0][0]  # (4, 128): the first decode chunk
    parity = []
    for i, seed in enumerate(seeds_seen[0]):
        # generate(seed=...)'s first chunk, through stream_chunks (the same
        # cache and decode), stopped after it: tokens past the first
        # difference follow other histories and say nothing more.
        with _CbClock(cbm) as one:
            next(iter(model.stream_chunks(CB_TEXT, seed=seed, **tts._prime_conditionals())))
        toks = one.chunks[0][0][0]
        n = min(toks.shape[0], cand_toks.shape[1])
        eq = (toks[:n] == cand_toks[i, :n]).cpu().numpy()
        parity.append({"seed": seed, "frames": n, "equal_share": float(eq.mean()),
                       "first_difference": None if eq.all() else int(np.argmin(eq))})
    out["b_candidates"] = {
        "candidates_per_iteration": 4, "cfg_rows": 8, "max_iterations": 5, "forced_fails": 2,
        "warmup": "none: (a) warmed the kernels and the model", "wall_s": bwall,
        "audio_s": result.duration_sec,
        "rtf": result.duration_sec / bwall, "a_wall_s": a["wall_s"], "a_rtf": a["rtf"],
        "rounds": len(rounds), "attempts_charged": sum(rounds), "decode_steps": bsteps,
        "decode_ms_per_step": clock.ms("_decode_chunk") / bsteps,
        "launches": blaunches,
        "candidate_vs_generate": {
            "required": False, "frames_compared": "the first decode chunk (128)",
            "candidates": parity,
            "why": "another batch size splits the decode kernel's keys otherwise, so bf16 "
                   "near-ties of random weights can round apart; exact parity is the CPU "
                   "tests' job"}}
    log(f"phase 10 b_candidates ({smi}): {json.dumps(out['b_candidates'])}")
    tts.close()

    # -- c. serving -----------------------------------------------------------
    serve_kw = dict(max_chars_per_segment=80, max_iterations=CB_FAILS + 2, **common)
    tts = failing(serving=True, serving_slots=4, serving_max_prompt=128,
                  serving_max_frames=256, **serve_kw)
    tts.trim_silence = False
    model = tts.model
    min_frames = int(CB_MIN_AUDIO_SEC * model.cfg.codec.frame_rate)
    # A standalone engine first (also the warm-up): driven in this thread,
    # its admission and dispatch under set_sync_debug_mode("error").
    eng = serving_cb.ChatterboxServingEngine(model, n_slots=4, max_prompt=128, max_frames=256,
                                             seed=tts.seed)
    sentences = [f"Sentence number {i} of the retry gauntlet runs the whole validation loop."
                 for i in range(8)]
    tts._prime_conditionals()
    restore = _guard_sync(eng, ("_admit", "_dispatch"))
    _zero(kmods)
    t0 = time.perf_counter()
    try:
        reqs = [eng.submit(t, min_frames=min_frames, cfg_weight=tts.cfg_weight,
                           stream=i % 2 == 1) for i, t in enumerate(sentences[:4])]
        eng.run_until_idle()
        torch.cuda.synchronize()
    finally:
        restore()
    ewall = time.perf_counter() - t0
    _sync_checked(lambda: None)
    elaunches = _launches(kmods)
    ewant = _cb_want(layers, eng.admissions, eng.dispatches * eng.chunk)
    for i, r in enumerate(reqs):
        w, _sr = r.result(timeout=60)
        if r.n_frames < min_frames or w.shape != (r.n_frames * model.cfg.codec.hop,) \
                or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"chatterbox serving request {i}: {r.n_frames} frames, "
                                 f"{tuple(w.shape)}")
        if r.stream and not torch.equal(torch.cat([p for p, _ in r.chunks(timeout=60)]), w):
            raise AssertionError(f"chatterbox serving request {i}: streamed pieces differ")
    if elaunches != ewant:
        raise AssertionError(f"chatterbox serving engine: launches {elaunches} vs {ewant}")
    engine_part = {"requests": 4, "streamed": 2, "wall_s": ewall, "ring": eng.ring,
                   "admissions": eng.admissions, "dispatches": eng.dispatches,
                   "frames": sum(r.n_frames for r in reqs), "launches": elaunches,
                   "host_waits_in_admission_and_dispatch": 0}
    eng.close()

    _zero(kmods)
    t0 = time.perf_counter()
    served = tts.generate(CB_SEGMENTS)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    slaunches = _launches(kmods)
    seng = tts._serving
    swant = _cb_want(layers, seng.admissions, seng.dispatches * seng.chunk)
    if served is None or slaunches != swant or not bool(torch.isfinite(served.audio).all()):
        raise AssertionError(f"chatterbox served generate(): launches {slaunches} vs {swant}, "
                             f"{served!r}")
    sdisp, sadm = seng.dispatches, seng.admissions
    tts.close()

    tts = failing(**serve_kw)
    tts.trim_silence = False
    _zero(kmods)
    with _CbClock(cbm) as clock:
        t0 = time.perf_counter()
        lock = tts.generate(CB_SEGMENTS)
        torch.cuda.synchronize()
        lwall = time.perf_counter() - t0
    llaunches = _launches(kmods)
    lwant = _cb_want(layers, clock.n("_prefill"), clock.n("_decode_chunk") * cbm.CHUNK)
    if lock is None or llaunches != lwant:
        raise AssertionError(f"chatterbox lockstep generate(): launches {llaunches} vs {lwant}")
    out["c_serving"] = {
        "segments": 8, "forced_fails": CB_FAILS, "slots": 4, "max_prompt": 128,
        "max_frames": 256, "standalone_engine": engine_part,
        "served": {"wall_s": swall, "audio_s": served.duration_sec,
                   "rtf": served.duration_sec / swall, "admissions": sadm,
                   "dispatches": sdisp, "launches": slaunches},
        "lockstep": {"wall_s": lwall, "audio_s": lock.duration_sec,
                     "rtf": lock.duration_sec / lwall, "generate_calls": clock.n("_prefill"),
                     "decode_chunks": clock.n("_decode_chunk"), "launches": llaunches}}
    log(f"phase 10 c_serving ({smi}): {json.dumps(out['c_serving'])}")
    tts.close()

    # -- d. stream() ------------------------------------------------------------
    tts = TTSFactory.get_tts_instance("chatterbox", max_chars_per_segment=400,
                                      max_iterations=1, **common)
    tts.trim_silence = False
    model = tts.model
    keys = []
    inner_stream = model.stream_chunks

    def stream_chunks(*args, **kwargs):
        keys.append(kwargs["rng"])
        return inner_stream(*args, **kwargs)

    model.stream_chunks = stream_chunks
    pieces = []
    with _CbClock(cbm) as sclock:
        t0 = time.perf_counter()
        first_s = None
        for chunk in tts.stream(CB_TEXT):
            torch.cuda.synchronize()
            if first_s is None:
                first_s = time.perf_counter() - t0
            pieces.append(chunk.audio)
        stream_wall = time.perf_counter() - t0
    del model.stream_chunks
    # The one-shot generate() from the stream's key, with the fades the
    # stream puts on its first and last chunk (the trim is off).
    with _CbClock(cbm) as gclock:
        one = model.generate(CB_TEXT, rng=keys[0], **tts._prime_conditionals())
    one = tts._apply_fades(one, fade_in=True, fade_out=True)
    streamed = torch.cat(pieces)
    s_toks = torch.cat([c[0][0] for c in sclock.chunks])
    g_toks = torch.cat([c[0][0] for c in gclock.chunks])
    n = one.shape[0] // model.cfg.codec.hop - 1  # decoded frames after frame 0
    # The windows vocode (bf16 convolutions over other lengths) round apart
    # from the one-shot vocode: 4 bf16 ulps of the peak.
    tol = 2.0 ** -6 * one.abs().max().item()
    err = (streamed - one).abs().max().item() if streamed.shape == one.shape else float("inf")
    n_chunks = len(pieces)
    out["d_stream"] = {
        "first_chunk_s": first_s, "chunks": n_chunks, "stream_wall_s": stream_wall,
        "samples": int(streamed.shape[0]),
        "tokens_equal_generate": bool(torch.equal(s_toks[:n], g_toks[:n])),
        "max_abs_err_vs_generate": err, "tol": tol}
    if not out["d_stream"]["tokens_equal_generate"] or not err <= tol or n_chunks < 2:
        raise AssertionError(f"chatterbox stream(): {out['d_stream']}")
    log(f"phase 10 d_stream ({smi}): {json.dumps(out['d_stream'])}")
    tts.close()

    # -- e. int4 ------------------------------------------------------------------
    tts = TTSFactory.get_tts_instance("chatterbox", max_chars_per_segment=400,
                                      max_iterations=1, **{**common, "quantization": "int4"})
    tts.trim_silence = False
    _zero(kmods)
    with _CbClock(cbm) as clock:
        t0 = time.perf_counter()
        result = tts.generate(CB_TEXT)
        torch.cuda.synchronize()
        ewall = time.perf_counter() - t0
    e_launches = _launches(kmods)
    steps = clock.n("_decode_chunk") * cbm.CHUNK
    e_want = _cb_want(layers, clock.n("_prefill"), steps, int4=True)
    if result is None or e_launches != e_want:
        raise AssertionError(f"chatterbox int4: launches {e_launches} vs {e_want}")
    out["e_int4"] = {"wall_s": ewall, "audio_s": result.duration_sec,
                     "rtf": result.duration_sec / ewall, "decode_steps": steps,
                     "int4_launches_per_step": 5 * layers,
                     "decode_ms_per_step": clock.ms("_decode_chunk") / steps,
                     "launches": e_launches, "note": "one run, no warm-up"}
    log(f"phase 10 e_int4 ({smi}): {json.dumps(out['e_int4'])}")
    tts.close()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


# ---------------------------------------------------------------------------
# Phase 11: training and adaptation
# ---------------------------------------------------------------------------

# Qwen3-TTS 1.7B at full width and depth (hidden 2048, 28 layers, 16 / 8
# heads of 128, ffn 6144, 4 codebooks), dense bf16, random weights.
TRAIN_PRESET = "1.7B"
DRAFT_PRESET = "draft-1.7B"
LORA_MODEL_PATH = "Qwen3-TTS-12Hz-1.7B-CustomVoice"  # resolves to TRAIN_PRESET
TRAIN_SEED = 789  # QwenTTS's default seed: its random base is the trained one
TRAIN_SHAPE = (4, 64, 256)  # batch, text tokens, frames
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
LORA_RANK = 8
DISTILL = dict(n_texts=16, seq_frames=96, batch_size=8, steps=20, learning_rate=2e-3)
# Card vs CPU at fp32, TF32 off: the orders of the f32 sums differ. A
# gradient's error is held against its leaf's largest entry (at least 1): an
# embedding row sums every position that reads it, on the card in atomics'
# order, so a row that cancels to ~3e-4 carries the rounding of summands up
# to the leaf's maximum (on an H100: 1.5e-6 where that maximum is 1.6).
# Params after one AdamW step at lr 1e-3: 1% of lr, because the first step
# is g / (|g| + 1e-8) per element, which turns a gradient's rounding where
# |g| ~ 1e-8 into a visible fraction of the step (on an H100: 1.8e-6 after
# train_step, 4.2e-6 after distill_step).
TRAIN_TOL = {"loss_rel": 1e-5, "grad_atol_of_leaf_max": 2e-6, "grad_rtol": 1e-4,
             "param_atol": 1e-5}


def _train_batch(cfg, shape, device, seed=0):
    """A teacher-forcing batch drawn from a seeded numpy generator."""
    import numpy as np

    b, tt, tc = shape
    rng = np.random.default_rng(seed)
    return {
        "text_ids": torch.from_numpy(rng.integers(0, cfg.text_vocab, (b, tt))).to(device),
        "codes": torch.from_numpy(rng.integers(0, cfg.codec.codebook_size,
                                               (b, tc, cfg.codec.n_codebooks))).to(device),
        "codes_mask": torch.ones((b, tc), dtype=torch.bool, device=device),
    }


def _excess(ours, ref, atol: float, rtol: float = 0.0, names=None, of_max=False) -> float:
    """Largest ``|ours - ref| - rtol * |ref|`` over tensor lists, in units of
    the leaf's largest ``|ref|`` (at least 1) when ``of_max``; <= atol holds."""
    worst, where = 0.0, {}
    for i, (o, r) in enumerate(zip(ours, ref)):
        o, r = o.detach().double().cpu(), r.detach().double().cpu()
        e = ((o - r).abs() - rtol * r.abs()).flatten()
        if of_max:
            e = e / max(1.0, float(r.abs().max()))
        j = int(e.argmax())
        where[names[i] if names else i] = (float(e[j]), float(r.flatten()[j]),
                                           float(r.abs().max()))
        worst = max(worst, float(e[j]))
    if worst > atol:
        bad = {k: v for k, v in where.items() if v[0] > atol}
        raise AssertionError(f"card vs CPU: {worst} over atol {atol} (rtol {rtol}); "
                             f"leaf: (excess, ref there, max |ref|) {bad}")
    return worst


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _train_card_vs_cpu(device: str) -> dict:
    """a. The tiny preset at fp32 on the card against the CPU, same params and
    batch: ``_forward_loss`` and its gradients, one ``train_step``, one
    ``lora_train_step`` and one ``distill_step``."""
    import dataclasses

    from rho_tts_tpu_torch.models import checkpoint as ckpt
    from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel
    from rho_tts_tpu_torch.models.qwen import distill, lora, train
    from rho_tts_tpu_torch.models.qwen.model import init_params

    tol = TRAIN_TOL
    base = PRESETS["tiny"]
    cfg = dataclasses.replace(base, talker=dataclasses.replace(base.talker, dtype=torch.float32))
    out = {"tol": tol}
    cpu = init_params(cfg, 0, "cpu")
    dev = _tree_map(lambda t: t.to(device), cpu)
    batches = {d: _train_batch(cfg, (2, 8, 16), d, seed=1) for d in ("cpu", device)}
    trees = {"cpu": cpu, device: dev}

    res = {}
    for d, p in trees.items():
        res[d] = train._value_and_grad(lambda: train._forward_loss(p, cfg, batches[d]),
                                       train.leaves(p))
    out["loss_rel_err"] = _rel(res[device][0], res["cpu"][0])
    if not out["loss_rel_err"] <= tol["loss_rel"]:
        raise AssertionError(f"train card vs CPU: loss {out['loss_rel_err']}")
    names = list(ckpt.flatten(cpu))
    out["grad_excess"] = _excess(res[device][1], res["cpu"][1], tol["grad_atol_of_leaf_max"],
                                 tol["grad_rtol"], names, of_max=True)

    opt = train.make_optimizer(1e-3)
    losses = {}
    for d, p in trees.items():
        _, _, losses[d] = train.train_step(p, opt.init(p), batches[d], cfg, opt)
    out["train_step_loss_rel_err"] = _rel(losses[device], losses["cpu"])
    out["train_step_param_err"] = _excess(train.leaves(dev), train.leaves(cpu), tol["param_atol"],
                                          names=names)

    adapters = {"cpu": lora.init_lora(cfg, cpu, rank=4, seed=2)}
    adapters[device] = _tree_map(lambda t: t.to(device), adapters["cpu"])
    for d, p in trees.items():
        _, _, losses[d] = lora.lora_train_step(p, adapters[d], opt.init(adapters[d]), batches[d],
                                               cfg, opt)
    out["lora_step_loss_rel_err"] = _rel(losses[device], losses["cpu"])
    out["lora_step_param_err"] = _excess(train.leaves(adapters[device]),
                                         train.leaves(adapters["cpu"]), tol["param_atol"])

    models = {"cpu": (QwenTTSModel(cfg, params=init_params(cfg, 3, "cpu"), device="cpu"),
                      QwenTTSModel(cfg, params=init_params(cfg, 4, "cpu"), device="cpu"))}
    models[device] = tuple(QwenTTSModel(cfg, params=_tree_map(lambda t: t.to(device), m.params),
                                        device=device) for m in models["cpu"])
    batch = distill.build_batches(models["cpu"][0], distill.make_corpus(4, seed=0), 12, 4)[0]
    dopt = train.AdamW(1e-3, weight_decay=0.0)
    overlaps = {}
    for d, (target, draft) in models.items():
        b = {k: v.to(d) for k, v in batch.items()}
        _, _, losses[d], overlaps[d] = distill.distill_step(
            draft.params, dopt.init(draft.params), target.params, b, cfg, cfg,
            torch.tensor(0.9, device=d), 5, dopt)
    out["distill_step_loss_rel_err"] = _rel(losses[device], losses["cpu"])
    out["distill_step_overlap_rel_err"] = _rel(overlaps[device], overlaps["cpu"])
    out["distill_step_param_err"] = _excess(train.leaves(models[device][1].params),
                                            train.leaves(models["cpu"][1].params),
                                            tol["param_atol"])
    for key in ("train_step_loss_rel_err", "lora_step_loss_rel_err",
                "distill_step_loss_rel_err", "distill_step_overlap_rel_err"):
        if not out[key] <= tol["loss_rel"]:
            raise AssertionError(f"train card vs CPU: {key} {out[key]}")
    return out


def _timed_steps(step, kmods, warmup: int, timed: int) -> dict:
    """``warmup`` then ``timed`` calls of ``step() -> loss``: CUDA events per
    timed step, the wall of the timed ones, every loss (fetched once at the
    end), the kernels' launches over all of them."""
    _zero(kmods)
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    events = []
    t0 = time.perf_counter()
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step())
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).float().cpu().tolist()
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training: losses {losses} not finite and falling")
    return {"ms_per_step": sum(s.elapsed_time(e) for s, e in events) / timed,
            "wall_ms_per_step": wall / timed * 1e3, "losses": losses,
            "launches": _launches(kmods)}


def _no_kernels(name, launches):
    if any(launches.values()):
        raise AssertionError(f"{name}: kernel launches {launches}, expected none")


def run_training_path(qmodel, kmods, build_dir: str, smi: str, device: str = "cuda") -> dict:
    """Phase 11: training and adaptation at full width and depth.

    a. the tiny preset at fp32 on the card against the CPU (``TRAIN_TOL``);
    b. a full fine-tune of the 1.7B (dense bf16, ``make_optimizer()``'s
       AdamW): 2 + 5 ``train_step``s on one fixed batch of 4 x (64 text
       tokens + 256 frames x 4 codebooks), then ``save_train_state`` ->
       ``restore_train_state``, held bit for bit;
    c. LoRA rank 8 on ``wqkv`` and ``wo``: 2 + 5 ``lora_train_step``s, the
       base frozen bit for bit, the merge against ``base + a @ b``; then
       ``save_lora`` and ``TTSFactory.get_tts_instance("qwen", ...,
       lora_path=dir, quantization="int8")`` on phase 7's 5 texts, a warm-up
       and a timed ``generate()`` with exact launch counts;
    d. ``distill_draft`` of a ``draft-1.7B`` toward the 1.7B int8 target,
       then one ``speculative_generate_codes`` with the distilled draft.

    The training steps launch none of the four kernels (the cache-less
    forward is plain PyTorch, as in JAX); the LoRA-served ``generate()`` and
    the distillation rollouts launch the attention kernels.
    """
    import shutil

    from rho_tts_tpu_torch import TTSFactory
    from rho_tts_tpu_torch.models import checkpoint as ckpt
    from rho_tts_tpu_torch.models import quantization as qz
    from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel
    from rho_tts_tpu_torch.models.qwen import distill, lora, train
    from rho_tts_tpu_torch.models.qwen.model import init_params
    from rho_tts_tpu_torch.models.qwen.speculative import speculative_generate_codes
    from rho_tts_tpu_torch.utils import prng

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": smi}
    work = os.path.join(build_dir, "phase11")
    os.makedirs(work, exist_ok=True)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # -- a. card vs CPU ----------------------------------------------------------
    fresh()
    out["a_card_vs_cpu"] = _train_card_vs_cpu(device)
    log(f"phase 11 a_card_vs_cpu ({smi}): {json.dumps(out['a_card_vs_cpu'])}")

    cfg = PRESETS[TRAIN_PRESET]
    b, tt, tc = TRAIN_SHAPE
    batch = _train_batch(cfg, TRAIN_SHAPE, device)

    # -- b. full fine-tune ------------------------------------------------------
    fresh()
    optimizer = train.make_optimizer()
    params, state = train.init_train_state(cfg, seed=TRAIN_SEED, optimizer=optimizer,
                                           device=device)
    n_params = sum(t.numel() for t in train.leaves(params))
    n_talker = sum(t.numel() for t in train.leaves(params["talker"]))

    def full_step():
        nonlocal params, state
        params, state, loss = train.train_step(params, state, batch, cfg, optimizer)
        return loss

    part = _timed_steps(full_step, kmods, TRAIN_WARMUP, TRAIN_TIMED)
    _no_kernels("train_step", part["launches"])
    part.update(
        preset=cfg.name, batch=b, text_tokens=tt, frames=tc, codebooks=cfg.codec.n_codebooks,
        params=n_params, talker_params=n_talker, lr=optimizer.learning_rate,
        weight_decay=optimizer.weight_decay,
        frames_per_s=b * tc / (part["ms_per_step"] / 1e3),
        talker_flop_per_step=6.0 * n_talker * b * (tt + tc),
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    state_dir = os.path.join(work, "train_state")
    step_count = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.save_train_state(state_dir, params, state, step_count)
    part["save_s"] = time.perf_counter() - t0
    part["state_bytes"] = sum(os.path.getsize(os.path.join(state_dir, f))
                              for f in os.listdir(state_dir))
    t0 = time.perf_counter()
    rparams, rstate, rstep = train.restore_train_state(state_dir, cfg, optimizer, device=device)
    torch.cuda.synchronize()
    part["restore_s"] = time.perf_counter() - t0
    a, r = ckpt.flatten(params), ckpt.flatten(rparams)
    same = list(a) == list(r) and all(torch.equal(a[k], r[k]) for k in a) and rstep == step_count
    for p, rp in zip(train.leaves(params), train.leaves(rparams)):
        s, rs = state.state[p], rstate.state[rp]
        same = same and s.keys() == rs.keys() and all(torch.equal(s[k], rs[k]) for k in s)
    if not same:
        raise AssertionError("train state: the restored state differs from the saved one")
    part.update(restored_bit_equal=True,
                peak_gb_with_restore=torch.cuda.max_memory_allocated() / 1e9)
    shutil.rmtree(state_dir)
    out["b_full_finetune"] = part
    log(f"phase 11 b_full_finetune ({smi}): {json.dumps(part)}")
    del params, state, rparams, rstate, a, r, p, rp, s, rs

    # -- c. LoRA -----------------------------------------------------------------
    fresh()
    base = init_params(cfg, TRAIN_SEED, device)
    snapshot = {k: v.clone() for k, v in ckpt.flatten(base).items()}
    adapters, lstate, loptimizer = lora.init_lora_train_state(cfg, base, rank=LORA_RANK)
    merged0 = lora.apply_lora(base, adapters)["talker"]["blocks"]
    zero_merge_equal = all(torch.equal(merged0[k], base["talker"]["blocks"][k])
                           for k in adapters)
    if not zero_merge_equal:
        raise AssertionError("LoRA: the zero-init merge differs from the base")
    del merged0

    def lora_step():
        nonlocal adapters, lstate
        adapters, lstate, loss = lora.lora_train_step(base, adapters, lstate, batch, cfg,
                                                      loptimizer)
        return loss

    part = _timed_steps(lora_step, kmods, TRAIN_WARMUP, TRAIN_TIMED)
    _no_kernels("lora_train_step", part["launches"])
    part.update(rank=LORA_RANK, targets=list(adapters), adapter_params=lora.n_lora_params(adapters),
                frames_per_s=b * tc / (part["ms_per_step"] / 1e3),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, zero_init_merge_bit_equal=True)
    if not all(torch.equal(v, snapshot[k]) for k, v in ckpt.flatten(base).items()):
        raise AssertionError("LoRA: the base changed")
    part["base_bit_equal_after_steps"] = True
    del snapshot
    w = base["talker"]["blocks"]["wqkv"]
    direct = (w.float() + torch.bmm(adapters["wqkv"]["a"], adapters["wqkv"]["b"])).to(w.dtype)
    merged = lora.apply_lora(base, adapters)["talker"]["blocks"]["wqkv"]
    err = (merged.float() - direct.float()).abs().max().item()
    # The f32 sums may round apart by one bf16 ulp of the largest weight.
    tol = 2.0 ** -7 * merged.float().abs().max().item()
    if not err <= tol or torch.equal(merged, w):
        raise AssertionError(f"LoRA: merged wqkv vs base + a @ b: {err} > {tol}")
    part.update(merged_vs_direct_max_abs_err=err, merged_vs_direct_tol=tol,
                merged_bit_equal_direct=bool(torch.equal(merged, direct)))
    del direct
    adapter_dir = os.path.join(work, "adapter")
    lora.save_lora(adapter_dir, adapters, meta={"scale": 1.0, "voice": "phase11"})
    part["adapter_bytes"] = os.path.getsize(os.path.join(adapter_dir, "adapter.pt"))

    min_audio_sec = 1000.0  # EOS masked in every frame: exact launch counts
    tts = TTSFactory.get_tts_instance(
        "qwen", speaker="Vivian", model_path=LORA_MODEL_PATH, quantization="int8",
        device=device, seed=TRAIN_SEED, lora_path=adapter_dir, min_audio_sec=min_audio_sec)
    tts.silence_threshold_db = SILENCE_DB
    model = tts._load_model()
    want_q = qz.quantize_weight(merged)["q"]
    if not (torch.equal(model.params["text_embed"], base["text_embed"])
            and torch.equal(model.params["talker"]["blocks"]["wqkv"]["q"], want_q)):
        raise AssertionError("LoRA provider: not built on the trained base plus the adapter")
    del merged, want_q, base, w
    out_base = os.path.join(work, "lora_out")
    tts.generate(TEXTS, output_path=out_base)  # warm-up
    torch.cuda.synchronize()
    _zero(kmods)
    with StageClock(qmodel) as clock:
        t0 = time.perf_counter()
        results = tts.generate(TEXTS, output_path=out_base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _launches(kmods)
    layers = cfg.talker.layers
    steps = len(clock.events["decode_chunk"]) * qmodel._chunk()
    want = {"prefill_gqa_attention": layers * len(clock.events["prefill"]),
            "decode_gqa_attention": layers * steps, "w8a8_matmul": 0, "int4_matmul": 0}
    if launches != want or len(results) != len(TEXTS) \
            or not all(bool(torch.isfinite(r.audio).all()) for r in results):
        raise AssertionError(f"LoRA generate(): launches {launches} vs {want}")
    audio_s = sum(r.duration_sec for r in results)
    part["generate"] = {"provider_base_is_the_trained_base": True, "texts": len(TEXTS),
                        "decode_steps": steps, "wall_s": wall, "audio_s": audio_s,
                        "rtf": audio_s / wall, "decode_ms": clock.ms("decode_chunk"),
                        "launches": launches}
    tts.close()
    out["c_lora"] = part
    log(f"phase 11 c_lora ({smi}): {json.dumps(part)}")
    del adapters, lstate, tts, model

    # -- d. distillation -----------------------------------------------------------
    fresh()
    target = QwenTTSModel(cfg, seed=TRAIN_SEED, quantization="int8", device=device)
    draft = QwenTTSModel(PRESETS[DRAFT_PRESET], seed=1, device=device)
    rollouts, steps_ev = {}, []
    inner_build, inner_step = distill.build_batches, distill.distill_step

    def build_batches(*args, **kwargs):
        _zero(kmods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with StageClock(qmodel) as clock:
            batches = inner_build(*args, **kwargs)
        torch.cuda.synchronize()
        rollouts.update(seconds=time.perf_counter() - t0, batches=len(batches),
                        prefills=len(clock.events["prefill"]),
                        decode_steps=len(clock.events["decode_chunk"]) * qmodel._chunk(),
                        launches=_launches(kmods))
        _zero(kmods)
        return batches

    def distill_step(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = inner_step(*args, **kwargs)
        end.record()
        steps_ev.append((start, end))
        return res

    distill.build_batches, distill.distill_step = build_batches, distill_step
    try:
        t0 = time.perf_counter()
        stats = distill.distill_draft(target, draft, log_every=0, **DISTILL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        distill.build_batches, distill.distill_step = inner_build, inner_step
    step_launches = _launches(kmods)
    _no_kernels("distill_step", step_launches)
    layers = cfg.talker.layers
    want = {"prefill_gqa_attention": layers * rollouts["prefills"],
            "decode_gqa_attention": layers * rollouts["decode_steps"],
            "w8a8_matmul": 0, "int4_matmul": 0}
    if rollouts["launches"] != want or rollouts["prefills"] != rollouts["batches"]:
        raise AssertionError(f"distill rollouts: launches {rollouts['launches']} vs {want}")
    ov = stats["overlaps"]
    if not all(math.isfinite(x) for x in stats["losses"] + ov) or not ov[-1] > ov[0]:
        raise AssertionError(f"distill: overlap did not rise: {ov}")
    codes, spec = speculative_generate_codes(target, draft, TEXTS[0], speaker="Vivian",
                                             gamma=4, rng=prng.PRNGKey(0, device=device))
    out["d_distill"] = {
        "target": f"{cfg.name} int8", "draft": DRAFT_PRESET, **DISTILL,
        "wall_s": wall, "rollout_s": rollouts["seconds"], "rollout_batches": rollouts["batches"],
        "rollout_decode_steps": rollouts["decode_steps"], "rollout_launches": rollouts["launches"],
        "step_ms": sum(s.elapsed_time(e) for s, e in steps_ev) / len(steps_ev),
        "step_launches": step_launches,
        "loss_first": stats["losses"][0], "loss_last": stats["losses"][-1],
        "overlap_first": ov[0], "overlap_last": ov[-1],
        "speculative": {"frames": int(codes.shape[0]), "rounds": spec["rounds"],
                        "frames_per_round": spec["tokens_per_round"]},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"phase 11 d_distill ({smi}): {json.dumps(out['d_distill'])}")
    shutil.rmtree(work, ignore_errors=True)
    return out

# ---------------------------------------------------------------------------
# Phase 12: meshes (parallel inference) on one card
# ---------------------------------------------------------------------------

# The 1.7B talker's per-rank shapes at TP degree mp: (K, N) of w_gate / w_up,
# w_down, wqkv and wo, whole; column-parallel layers split N, row-parallel K.
Q17_HEADS, Q17_KV, Q17_D, Q17_PROMPT = 16, 8, 128, 128
Q17_MATMULS = ((2048, 6144, "col"), (6144, 2048, "row"), (2048, 4096, "col"),
               (2048, 2048, "row"))
CB_MP_MATMULS = ((1024, 4096, "col"), (4096, 1024, "row"), (1024, 3072, "col"),
                 (1024, 1024, "row"))


def _local_shape(k, n, kind, mp):
    return (k, n // mp) if kind == "col" else (k // mp, n)


def check_per_rank_shapes(attn, dec, qz, w8, i4, sharding, gen, device="cuda",
                          iters: int = 20) -> dict:
    """Phase 12 e: the four kernels at the shapes one rank of a TP (or SP)
    mesh of mp = 2 and 4 launches, for the 1.7B and Chatterbox "standard":
    attention at the local heads; w8a8 and int4 at the column shards and the
    row shards (int4's cut by ``sharding``'s repack from a whole packed
    weight); the SP prefill: every query shard at its ``q_offset``, the
    shards joined and held against the plain version and the unsharded
    kernel. Each case against its plain version at phase 2's tolerances,
    twice for the same bits, timed beside its bound. Returns the cases by
    kernel name."""
    from rho_tts_tpu_torch.parallel.mesh import Axis

    bf = torch.bfloat16
    out = {name: [] for name in ("prefill_gqa_attention", "decode_gqa_attention",
                                 "w8a8_matmul", "int4_matmul")}

    def timed(case, kernel, plain, bound):
        case.update(ms=time_ms(kernel, iters=iters), plain_ms=time_ms(plain, iters=iters))
        case["bound_ms"], case["bound_by"] = bound

    def held_int4(case, o1, o2, ref):
        tol = 2e-2 * ref.float().abs().max().item() + 1e-3  # as phase 2's int4 cases
        _held(out["int4_matmul"], "per-rank int4 matmul", case, o1, o2, ref, tol)

    for model, (hq, hkv, d), matmuls, rows, p, s, m_pre, m_dec in (
        ("1.7B", (Q17_HEADS, Q17_KV, Q17_D), Q17_MATMULS, 5, Q17_PROMPT, 384, 640, 5),
        ("chatterbox", (CB_HEADS, CB_HEADS, CB_D), CB_MP_MATMULS, 2, 64, 320, 128, 2),
    ):
        pads = [0, 17, 40, 63, 90][:rows] if rows == 5 else [0, p - 34]
        pmask = _pad_mask(p, pads)
        key_pos = torch.arange(s, device=device)[None, :]
        dmask = (key_pos >= torch.tensor(pads, device=device)[:, None]) & (key_pos <= s - 40)
        for mp in (2, 4):
            tag = {"model": model, "mp": mp}
            # kernel 1 and 2 at the local heads
            q, k, v = _attn_inputs(gen, (rows, p, hq // mp, d), (rows, p, hkv // mp, d), bf, bf)
            run = lambda: attn.fused_gqa_attention(q, k, v, pmask)  # noqa: E731
            plain = lambda: attn.reference_gqa_attention(q, k, v, pmask)  # noqa: E731
            case = dict(tag, case="TP prefill, local heads", q=list(q.shape), kv=list(k.shape))
            _held(out["prefill_gqa_attention"], "per-rank prefill", case, run(), run(), plain(),
                  2e-2)
            timed(case, run, plain, _prefill_bound(q, k, v, pmask))
            qd, kd, vd = _attn_inputs(gen, (rows, 1, hq // mp, d), (rows, s, hkv // mp, d), bf, bf)
            run = lambda: dec.decode_gqa_attention(qd, kd, vd, dmask)  # noqa: E731
            plain = lambda: dec.reference_decode_attention(qd, kd, vd, dmask)  # noqa: E731
            case = dict(tag, case="TP decode, local heads", q=list(qd.shape), kv=list(kd.shape))
            _held(out["decode_gqa_attention"], "per-rank decode", case, run(), run(), plain(),
                  2e-2)
            timed(case, run, plain, _decode_bound(qd, kd, dmask))
            # SP: every query shard at its offset over the whole K/V
            q, k, v = _attn_inputs(gen, (rows, p, hq, d), (rows, p, hkv, d), bf, bf)
            whole = attn.fused_gqa_attention(q, k, v, pmask)
            ref = attn.reference_gqa_attention(q, k, v, pmask)
            tl = p // mp
            parts = []
            for r in range(mp):
                axis = Axis("model", mp, r)
                qs = q[:, r * tl:(r + 1) * tl]
                o1 = attn.sp_fused_gqa_attention(qs, k, v, pmask, axis)
                o2 = attn.sp_fused_gqa_attention(qs, k, v, pmask, axis)
                case = dict(tag, case=f"SP prefill, query shard {r} at q_offset {r * tl}",
                            q=list(qs.shape), kv=list(k.shape))
                _held(out["prefill_gqa_attention"], "per-rank SP prefill", case, o1, o2,
                      attn.reference_gqa_attention(qs, k, v, pmask, q_offset=r * tl), 2e-2)
                parts.append(o1)
                if r == mp - 1:  # the last shard attends to the most keys
                    timed(case, lambda: attn.sp_fused_gqa_attention(qs, k, v, pmask, axis),
                          lambda: attn.reference_gqa_attention(qs, k, v, pmask,
                                                               q_offset=r * tl),
                          _prefill_bound(qs, k, v, pmask))
            joined = torch.cat(parts, dim=1)
            err_plain = (joined.float() - ref.float()).abs().max().item()
            err_whole = (joined.float() - whole.float()).abs().max().item()
            case = dict(tag, case="SP shards joined", joined_vs_plain=err_plain,
                        joined_vs_unsharded_kernel=err_whole, tol=2e-2)
            out["prefill_gqa_attention"].append(case)
            if not err_plain <= 2e-2 or not err_whole <= 2e-2:
                raise AssertionError(f"SP shards joined: {case}")
            # kernels 3 and 4 at the column and row shards
            for kk, n, kind in matmuls:
                kl, nl = _local_shape(kk, n, kind, mp)
                qw = _quantized_weight(qz.quantize_weight, kl, nl, gen)
                xf = torch.randn((m_pre, kl), generator=gen, device=device).to(bf).float()
                sx = qz._div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
                xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
                args = (xq, sx, qw["q"], qw["s"], bf)
                o1, o2 = w8.w8a8_matmul(*args), w8.w8a8_matmul(*args)
                case = dict(tag, case=f"w8a8 {kind} shard", m=m_pre, k=kl, n=nl)
                _held(out["w8a8_matmul"], "per-rank w8a8 matmul", case, o1, o2,
                      w8.reference_w8a8_matmul(*args), 0.0)
                timed(case, lambda: w8.w8a8_matmul(*args),
                      lambda: w8.reference_w8a8_matmul(*args),
                      bound_ms(nbytes(xq, sx, qw["q"], qw["s"], o1), 2 * m_pre * kl * nl,
                               INT8_OP_PER_S))
                whole_q4 = _quantized_weight(qz.pack_int4, kk, n, gen)
                if kind == "col":
                    q4 = {"q4": whole_q4["q4"][:, :nl].contiguous(), "s": whole_q4["s"][:nl]}
                else:  # the rank's contiguous K rows, repacked in halves of its own
                    shard = sharding.shard_params(_OneAxisMesh(mp), {"w": whole_q4},
                                                  {"w": {"q4": ("model", None), "s": (None,)}})
                    q4 = shard["w"]
                for m in (m_dec, m_pre):
                    x = torch.randn((m, kl), generator=gen, device=device).to(bf)
                    a4 = (x, q4["q4"], q4["s"])
                    o1, o2 = i4.int4_matmul(*a4), i4.int4_matmul(*a4)
                    case = dict(tag, case=f"int4 {'GEMV' if m == m_dec else 'GEMM'} {kind} "
                                f"shard", m=m, k=kl, n=nl)
                    held_int4(case, o1, o2, i4.reference_int4_matmul(*a4))
                    timed(case, lambda: i4.int4_matmul(*a4),
                          lambda: i4.reference_int4_matmul(*a4),
                          bound_ms(nbytes(x, q4["q4"], q4["s"], o1), 2 * m * kl * nl,
                                   BF16_FLOP_PER_S))
    return out


class _OneAxisMesh:
    """Rank 0's view of a ``model`` axis of ``mp`` for ``shard_params``: the
    cut is local, no process group."""

    def __init__(self, mp: int):
        from rho_tts_tpu_torch.parallel.mesh import Axis

        self.shape = {"data": 1, "model": mp}
        self._axis = Axis("model", mp, 0)

    def axis(self, name):
        return self._axis


def run_parallel_path(qmodel, kmods, smi: str, device: str = "cuda", preset: str = "1.7B",
                      cb_preset: str = "standard", init_method: str = None) -> dict:
    """Phase 12: the mesh layer on one card (see the module docstring).

    a. an NCCL world of one through ``initialize_distributed`` (127.0.0.1,
       a free port); one ``torch.distributed`` all-reduce and one all-gather
       of a decode step's activation (5 x 2048 bf16), called directly and
       timed as the floor of a collective on this card;
    b. the 1.7B int8, batch 5, a 128-slot prompt, 2 chunks of 64, through
       ``synthesize``: unmeshed, on a DP mesh of one, on a TP mesh of one
       (codes and waveforms bit-equal, kernels 1 / 2 launched 28 a call and
       28 a step, no collective launched); then on the TP mesh of one with
       w8a8 prefill (one chunk) and with int4 weights (one chunk);
    c. ``ServingEngine(n_slots=8)`` over the TP mesh of one on phase 9's
       traffic (16 ragged requests on 8 slots, every other one streamed,
       top-k 4): more than one admission group, every length exact, codes
       equal the unmeshed engine's; admission and dispatch under the sync
       check;
    d. Chatterbox "standard" int8 over a TP mesh of one, one segment:
       tokens and waveform equal the unmeshed run's;
    e. the per-rank kernel shapes (:func:`check_per_rank_shapes`).
    The process group is torn down at the end.
    """
    import numpy as np
    import torch.distributed as dist

    from rho_tts_tpu_torch import serving
    from rho_tts_tpu_torch.models import quantization as qz
    from rho_tts_tpu_torch.models.chatterbox import model as cbm
    from rho_tts_tpu_torch.ops.cuda import attention as attn
    from rho_tts_tpu_torch.ops.cuda import decode_attention as dec
    from rho_tts_tpu_torch.ops.cuda import int4_matmul as i4
    from rho_tts_tpu_torch.ops.cuda import w8a8_matmul as w8
    from rho_tts_tpu_torch.parallel import collectives, inference, mesh, sharding

    t_phase = time.perf_counter()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out = {"card": smi}

    # -- a. NCCL world of one -------------------------------------------------
    t0 = time.perf_counter()
    if init_method is None:
        init_method = f"127.0.0.1:{mesh.free_port()}"
    mesh.initialize_distributed(init_method, 1, 0, device=device, local_rank=0)
    init_s = time.perf_counter() - t0
    x = torch.randn((5, 2048), device=device).to(torch.bfloat16)
    gathered = torch.empty((5, 2048), dtype=torch.bfloat16, device=device)
    ar_ms = time_ms(lambda: dist.all_reduce(x), iters=20)
    ag_ms = time_ms(lambda: dist.all_gather_into_tensor(gathered, x), iters=20)
    if not torch.equal(gathered, x):
        raise AssertionError("an all-gather over a world of one changed its input")
    out["a_world_of_one"] = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                             "init_s": init_s, "all_reduce_ms": ar_ms, "all_gather_ms": ag_ms,
                             "activation": "(5, 2048) bf16"}
    log(f"phase 12 a_world_of_one ({smi}): {json.dumps(out['a_world_of_one'])}")

    # -- b. the one-shot path on meshes of one -----------------------------------
    cfg = qmodel.PRESETS[preset]
    layers, chunk = cfg.talker.layers, qmodel._chunk()
    frames = 2 * chunk
    kw = dict(min_frames=frames, max_frames=frames, top_k=50, seeds=list(range(len(TEXTS))))
    one = mesh.create_mesh(1, model_parallel=1)
    models = {}
    for name, enable in (("unmeshed", None), ("dp_mesh_of_one", inference.enable_data_parallel),
                         ("tp_mesh_of_one", inference.enable_tensor_parallel)):
        models[name] = qmodel.QwenTTSModel(cfg, seed=0, quantization="int8", device=device)
        if enable is not None:
            enable(models[name], one)
        models[name].synthesize(TEXTS, **kw)  # warm-up
    _sync(device)

    def attention_want(steps, w8a8=0, int4=0):
        return {"prefill_gqa_attention": layers, "decode_gqa_attention": layers * steps,
                "w8a8_matmul": w8a8, "int4_matmul": int4}

    def run(m, name, frames_, want):
        kw_ = dict(kw, min_frames=frames_, max_frames=frames_)
        _zero(kmods)
        collectives.launches = 0
        t0 = time.perf_counter()
        codes, waves, _sr = synthesize_codes(m, kw_)
        _sync(device)
        wall = time.perf_counter() - t0
        launches, coll = _launches(kmods), collectives.launches
        steps = codes.shape[1] - 1  # frame 0 comes from the prefill
        if launches != want(steps) or coll != 0:
            raise AssertionError(f"phase 12 b {name}: launches {launches} vs {want(steps)}, "
                                 f"{coll} collectives")
        if codes.shape[0] != len(TEXTS) or not all(bool(torch.isfinite(w).all()) for w in waves):
            raise AssertionError(f"phase 12 b {name}: codes {tuple(codes.shape)}")
        return {"wall_s": wall, "decode_steps": steps, "launches": launches,
                "collective_launches": coll}, codes, waves

    # Each variant twice, in an order that alternates (U D T T D U): a wall
    # that follows the order and not the mesh shows as a spread.
    order = list(models) + list(models)[::-1]
    b = {"preset": preset, "quantization": "int8", "batch": len(TEXTS), "frames": frames,
         "order": order}
    ref = None
    for name in order:
        res, codes, waves = run(models[name], name, frames, attention_want)
        if ref is None:
            ref = (codes, waves)
        elif not torch.equal(codes, ref[0]) or not all(torch.equal(a, z)
                                                       for a, z in zip(waves, ref[1])):
            raise AssertionError(f"phase 12 b: {name}'s codes or waveforms differ from the "
                                 "unmeshed run's")
        walls = b.get(name, {}).get("walls_s", []) + [res.pop("wall_s")]
        b[name] = dict(res, walls_s=walls)
    b["codes_and_waves_bit_equal"] = True
    model = models["tp_mesh_of_one"]
    saved = os.environ.get("RHO_TTS_TPU_W8A8_PREFILL")
    os.environ["RHO_TTS_TPU_W8A8_PREFILL"] = "1"
    try:
        b["tp_w8a8_prefill"], _, _ = run(model, "tp w8a8", chunk,
                                         lambda st: attention_want(st, w8a8=5 * layers))
    finally:
        _restore_env("RHO_TTS_TPU_W8A8_PREFILL", saved)
    del model, models
    gc.collect()
    model4 = qmodel.QwenTTSModel(cfg, seed=0, quantization="int4", device=device)
    inference.enable_tensor_parallel(model4, one)
    b["tp_int4"], _, _ = run(model4, "tp int4", chunk,
                             lambda st: attention_want(st, int4=5 * layers * (1 + st)))
    del model4
    gc.collect()
    out["b_oneshot"] = b
    log(f"phase 12 b_oneshot ({smi}): {json.dumps(b)}")

    # -- c. ServingEngine over the TP mesh of one --------------------------------
    smodel = qmodel.QwenTTSModel.from_pretrained("Qwen3-TTS-12Hz-1.7B-CustomVoice"
                                                 if preset == "1.7B" else "tiny-CustomVoice",
                                                 quantization="int8", device=device)
    texts, lengths = _serve_traffic()

    def serve(m, guard):
        eng = serving.ServingEngine(m, n_slots=8, max_prompt=64, max_frames=512, top_k=4)
        restore = _guard_sync(eng, ("_admit", "_dispatch")) if guard else (lambda: None)
        _zero(kmods)
        collectives.launches = 0
        try:
            reqs, wall = _drive(eng, texts, lengths, stream_every=2)
        finally:
            restore()
        res = {"wall_s": wall, "dispatches": eng.dispatches, "admission_groups": eng.admissions,
               "launches": _launches(kmods), "collective_launches": collectives.launches}
        if [r.n_frames for r in reqs] != lengths:
            raise AssertionError(f"phase 12 c: frames {[r.n_frames for r in reqs]} vs {lengths}")
        codes = [r.codes for r in reqs]
        eng.close()
        return res, codes

    c = {"requests": len(texts), "lengths": lengths,
         "traffic": "phase 9's: ragged lengths on 8 slots, every other one streamed, top-k 4 "
                    "at temperature 0.9"}
    c["unmeshed"], ref_codes = serve(smodel, False)
    inference.enable_tensor_parallel(smodel, one)
    c["tp_mesh_of_one"], tp_codes = serve(smodel, device == "cuda")
    steps = c["tp_mesh_of_one"]["dispatches"] * chunk
    want = {"prefill_gqa_attention": layers * c["tp_mesh_of_one"]["admission_groups"],
            "decode_gqa_attention": layers * steps, "w8a8_matmul": 0, "int4_matmul": 0}
    if (c["tp_mesh_of_one"]["launches"] != want or c["tp_mesh_of_one"]["collective_launches"]
            or c["tp_mesh_of_one"]["admission_groups"] < 2):
        raise AssertionError(f"phase 12 c: {c['tp_mesh_of_one']} vs {want}, and more than "
                             "one admission group")
    if not all(np.array_equal(a, z) for a, z in zip(ref_codes, tp_codes)):
        raise AssertionError("phase 12 c: served codes over the mesh differ from the unmeshed "
                             "engine's")
    c["codes_equal"], c["host_waits_in_dispatch"] = True, 0
    del smodel
    gc.collect()
    out["c_serving"] = c
    log(f"phase 12 c_serving ({smi}): {json.dumps(c)}")

    # -- d. Chatterbox over the TP mesh of one -----------------------------------
    cb = cbm.ChatterboxModel.from_pretrained(device=device, implementation=cb_preset,
                                             quantization="int8", seed=789)
    cb_layers = cb.cfg.talker.layers
    min_new = cbm.CHUNK - 30  # at least one chunk of decode

    @torch.inference_mode()
    def cb_run(name):
        _zero(kmods)
        collectives.launches = 0
        t0 = time.perf_counter()
        st = cb._start_decode(CB_TEXT, None, 1.0, 0.6, None, None, min_new, None, seeds=[7])
        toks, done = cb._decode_all(st, 1.0, 0.6, min_new, None)
        _sync(device)
        wall = time.perf_counter() - t0
        res = {"wall_s": wall, "decode_steps": toks.shape[1] - 1, "launches": _launches(kmods),
               "collective_launches": collectives.launches}
        want = _cb_want(cb_layers, 1, res["decode_steps"])
        if res["launches"] != want or res["collective_launches"]:
            raise AssertionError(f"phase 12 d {name}: {res} vs {want}")
        return res, toks.cpu(), done.cpu()

    d = {"preset": cb_preset, "quantization": "int8", "text": CB_TEXT, "seed": 7,
         "min_new_tokens": min_new}
    d["unmeshed"], t_ref, d_ref = cb_run("unmeshed")
    inference.enable_tensor_parallel(cb, one)
    d["tp_mesh_of_one"], t_tp, d_tp = cb_run("tp")
    if not torch.equal(t_ref, t_tp) or not torch.equal(d_ref, d_tp):
        raise AssertionError("phase 12 d: Chatterbox tokens over the mesh differ")
    d["tokens_equal"] = True
    del cb
    gc.collect()
    out["d_chatterbox"] = d
    log(f"phase 12 d_chatterbox ({smi}): {json.dumps(d)}")
    mesh.shutdown_distributed()

    # -- e. per-rank kernel shapes ---------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(12)
    out["e_per_rank"] = check_per_rank_shapes(attn, dec, qz, w8, i4, sharding, gen, device)
    n_cases = sum(len(v) for v in out["e_per_rank"].values())
    log(f"phase 12 e_per_rank ({smi}): {n_cases} cases held in "
        f"{time.perf_counter() - t0:.1f} s: {json.dumps(out['e_per_rank'])}")
    out["wall_s"] = time.perf_counter() - t_phase
    if device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


# ---------------------------------------------------------------------------
# Phase 13: sharded training on one card
# ---------------------------------------------------------------------------

SHARDED_WALLS = 6  # timed steps a variant, as chip_mesh_walls.py
PP_MICROBATCHES = 4
# b. PP of one stage in 4 microbatches against the unmicrobatched step: the
# GEMMs run at other shapes, so bf16 rounds apart. The first-step gradients:
# each leaf within 2 ** -4 of its largest unmicrobatched gradient (the dry
# run's bound, ``multihost_dryrun.PP_GRAD_TOL``); a backward that lost a
# microbatch's or a stage's gradient, or counted it twice, is off by 1/4 to
# 1. The loss: 1e-3 relative (on an H100: 6.3e-6). The params after 2 AdamW
# steps at lr 1e-4, a step at most: 2 lr where a near-zero gradient's sign
# turns with the order of the sums (AdamW's update is ~lr * sign(g) there),
# plus one bf16 rounding of the value (2 ** -7 of it); so 2 ** -6 of the
# value plus 5e-4, JAX's pipeline-test bound (on an H100: 4.1e-4 beyond
# 2 ** -7 of the value). That bound shows the steps ran; the gradients'
# bound is the one that sees the schedule's backward.
PP_TOL = {"grad_of_leaf_max": 2.0 ** -4, "loss_rel": 1e-3, "param_rel": 2.0 ** -6,
          "param_atol": 5e-4}


def run_sharded_training_path(qmodel, kmods, build_dir: str, smi: str, device: str = "cuda",
                              preset: str = TRAIN_PRESET, shape=TRAIN_SHAPE,
                              init_method: str = None) -> dict:
    """Phase 13: sharded training on one card, in an NCCL world of one.

    Phase 11's full fine-tune cell (the 1.7B dense bf16, batch 4 x (64 text
    tokens + 256 frames x 4 codebooks), ``make_optimizer()``'s AdamW at lr
    1e-4, seed 789), each variant from the same seeded init, one at a time,
    freed before the next; the reference params wait on the host.

    a. 2 ``train_step``s unmeshed (twice: the steps are deterministic), on a
       DP mesh of one, a TP mesh of one (``train.shard_train_params``) and a
       PP mesh of one (``pipeline_train_step``, one microbatch): losses and
       every param bit-equal to the unmeshed run's, no collective and no
       kernel launched;
    b. PP of one stage in ``PP_MICROBATCHES`` microbatches: the first-step
       gradients, the losses and the params within ``PP_TOL`` of the
       unmeshed run;
    c. 2 ``lora_train_step``s (rank 8 on ``wqkv`` / ``wo``, the adapters
       made from this rank's shards) on DP, TP and PP meshes of one: losses
       and adapters bit-equal to unmeshed, the base frozen;
    d. ``save_checkpoint`` of a ``QwenTTSModel`` over the TP mesh of one and
       ``save_train_state(mesh=...)`` of the TP state, reloaded unmeshed: bit
       for bit (params and AdamW moments); the files, under
       ``build_dir/phase13``, are deleted after;
    e. walls: one train state stepped by every variant (on meshes of one
       their shards are the same tensors), ``SHARDED_WALLS`` steps each in a
       seeded shuffled order; medians, quartiles, the peak.
    """
    import shutil

    import numpy as np

    from rho_tts_tpu_torch.models import checkpoint as ckpt
    from rho_tts_tpu_torch.models.qwen import PRESETS, QwenTTSModel
    from rho_tts_tpu_torch.models.qwen import lora, train
    from rho_tts_tpu_torch.models.qwen.model import init_params
    from rho_tts_tpu_torch.parallel import collectives, mesh, pipeline

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    _free(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"card": smi}
    if init_method is None:
        init_method = f"127.0.0.1:{mesh.free_port()}"
    mesh.initialize_distributed(init_method, 1, 0, device=device, local_rank=0)
    meshes = {"dp": mesh.create_mesh(1, model_parallel=1),
              "tp": mesh.create_mesh(1, model_parallel=1),
              "pp": pipeline.create_pipeline_mesh(1, n_stages=1)}
    cfg = PRESETS[preset]
    batch = _train_batch(cfg, shape, device)
    optimizer = train.make_optimizer()
    steps = 2

    def run(name, m=None, n_microbatches=None):
        """``steps`` train steps of one variant from the seeded init: the
        losses, the params on the host, the launches."""
        mesh_ = meshes.get(name.split("_")[0]) if m is None else m
        params = init_params(cfg, TRAIN_SEED, device)
        if mesh_ is not None:
            params = train.shard_train_params(mesh_, params, cfg)
        state = optimizer.init(params)
        _zero(kmods)
        collectives.launches = 0
        losses = []
        for _ in range(steps):
            if n_microbatches is None:
                params, state, loss = train.train_step(params, state, batch, cfg, optimizer,
                                                       mesh=mesh_)
            else:
                params, state, loss = pipeline.pipeline_train_step(
                    params, state, batch, cfg, optimizer, mesh_, n_microbatches)
            losses.append(loss)
        losses = [float(x) for x in losses]
        res = {"losses": losses, "launches": _launches(kmods),
               "collective_launches": collectives.launches}
        _no_kernels(f"phase 13 {name}", res["launches"])
        if res["collective_launches"]:
            raise AssertionError(f"phase 13 {name}: {res['collective_launches']} collectives")
        host = {k: v.cpu() for k, v in ckpt.flatten(params).items()}
        del params, state
        _free(device)
        return res, host

    def same(a, b):
        return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)

    # -- a. meshes of one, bit for bit ---------------------------------------------
    a = {"preset": preset, "batch": shape, "steps": steps, "lr": optimizer.learning_rate}
    a["unmeshed"], ref = run("unmeshed")
    a["unmeshed_repeat"], again = run("unmeshed")
    if a["unmeshed_repeat"]["losses"] != a["unmeshed"]["losses"] or not same(again, ref):
        raise AssertionError("phase 13 a: two unmeshed runs differ (nondeterministic steps)")
    del again
    for name, mb in (("dp", None), ("tp", None), ("pp", 1)):
        a[name], got = run(name, n_microbatches=mb)
        if a[name]["losses"] != a["unmeshed"]["losses"] or not same(got, ref):
            raise AssertionError(f"phase 13 a {name}: losses {a[name]['losses']} or params "
                                 "differ from the unmeshed run's")
        del got
    a["bit_equal"] = True
    out["a_meshes_of_one"] = a
    log(f"phase 13 a_meshes_of_one ({smi}): {json.dumps(a)}")

    # -- b. PP, one stage, 4 microbatches ------------------------------------------
    def first_grads(mesh_=None, n_microbatches=None):
        """Every leaf's first-step gradient from the seeded init (flat)."""
        params = init_params(cfg, TRAIN_SEED, device)
        if mesh_ is not None:
            params = train.shard_train_params(mesh_, params, cfg)
        _, grads = train.loss_and_grads(params, cfg, batch, mesh=mesh_,
                                        n_microbatches=n_microbatches)
        names = list(ckpt.flatten(params))
        del params
        return dict(zip(names, grads))

    b = {"n_microbatches": PP_MICROBATCHES, "tol": PP_TOL}
    ref_grads = {k: v.cpu() for k, v in first_grads().items()}
    _free(device)
    worst, worst_leaf = 0.0, None
    for k, g in first_grads(meshes["pp"], PP_MICROBATCHES).items():
        r = ref_grads[k].to(device).float()
        top = float(r.abs().max()) if r.numel() else 0.0
        err = float((g.float() - r).abs().max()) if r.numel() else 0.0
        err = err / top if top > 0 else err
        if err >= worst:
            worst, worst_leaf = err, k
    b.update(grad_error_of_leaf_max=worst, grad_worst_leaf=worst_leaf)
    del ref_grads, g, r
    _free(device)
    if not worst <= PP_TOL["grad_of_leaf_max"]:
        raise AssertionError(f"phase 13 b: first-step gradients {worst} of the leaf maximum "
                             f"apart at {worst_leaf}")
    t0 = time.perf_counter()
    b["pp"], got = run(f"pp_m{PP_MICROBATCHES}", meshes["pp"], PP_MICROBATCHES)
    b["wall_s"] = time.perf_counter() - t0
    b["loss_rel_err"] = max(_rel(x, y) for x, y in zip(b["pp"]["losses"],
                                                       a["unmeshed"]["losses"]))
    excess, n_diff, n_all = 0.0, 0, 0
    for k, v in ref.items():
        d = (got[k].float() - v.float()).abs()
        excess = max(excess, float((d - PP_TOL["param_rel"] * v.float().abs()).max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
    b.update(param_excess=excess, params_differing=n_diff / n_all)
    if not b["loss_rel_err"] <= PP_TOL["loss_rel"] or not excess <= PP_TOL["param_atol"]:
        raise AssertionError(f"phase 13 b: {b}")
    del got, ref
    out["b_pp_microbatched"] = b
    log(f"phase 13 b_pp_microbatched ({smi}): {json.dumps(b)}")

    # -- c. LoRA on meshes of one ----------------------------------------------------
    def lora_run(name):
        mesh_ = meshes.get(name)
        base = init_params(cfg, TRAIN_SEED, device)
        if mesh_ is not None:
            base = train.shard_train_params(mesh_, base, cfg)
        snapshot = {k: v.clone() for k, v in ckpt.flatten(base["talker"]).items()}
        adapters, lstate, lopt = lora.init_lora_train_state(cfg, base, rank=LORA_RANK)
        _zero(kmods)
        collectives.launches = 0
        losses = [lora.lora_train_step(base, adapters, lstate, batch, cfg, lopt, mesh=mesh_)[2]
                  for _ in range(steps)]
        res = {"losses": [float(x) for x in losses], "launches": _launches(kmods),
               "collective_launches": collectives.launches,
               "base_frozen": all(torch.equal(v, snapshot[k])
                                  for k, v in ckpt.flatten(base["talker"]).items())}
        _no_kernels(f"phase 13 c {name}", res["launches"])
        if res["collective_launches"] or not res["base_frozen"]:
            raise AssertionError(f"phase 13 c {name}: {res}")
        host = {k: v.cpu() for k, v in ckpt.flatten(adapters).items()}
        del base, snapshot, adapters, lstate
        _free(device)
        return res, host

    c = {"rank": LORA_RANK, "targets": list(lora.DEFAULT_TARGETS), "steps": steps}
    c["unmeshed"], lref = lora_run("unmeshed")
    for name in ("dp", "tp", "pp"):
        c[name], got = lora_run(name)
        if c[name]["losses"] != c["unmeshed"]["losses"] or not same(got, lref):
            raise AssertionError(f"phase 13 c {name}: not bit-equal to the unmeshed LoRA run")
    c["bit_equal"] = True
    out["c_lora"] = c
    log(f"phase 13 c_lora ({smi}): {json.dumps(c)}")
    del lref, got

    # -- d. checkpoints from the TP mesh of one -----------------------------------
    work = os.path.join(build_dir, "phase13")
    tp = meshes["tp"]
    d = {}
    params = train.shard_train_params(tp, init_params(cfg, TRAIN_SEED, device), cfg)
    state = optimizer.init(params)
    for _ in range(steps):
        params, state, _ = train.train_step(params, state, batch, cfg, optimizer, mesh=tp)
    t0 = time.perf_counter()
    train.save_train_state(os.path.join(work, "state"), params, state, steps, mesh=tp, cfg=cfg)
    d["save_train_state_s"] = time.perf_counter() - t0
    rp, rstate, rstep = train.restore_train_state(os.path.join(work, "state"), cfg, optimizer,
                                                  device=device)
    ok = rstep == steps and same(ckpt.flatten(rp), ckpt.flatten(params))
    for p, q in zip(train.leaves(params), train.leaves(rp)):
        s1, s2 = state.state[p], rstate.state[q]
        ok = ok and s1.keys() == s2.keys() and all(torch.equal(s1[k], s2[k]) for k in s1)
    if not ok:
        raise AssertionError("phase 13 d: the TP train state reloaded unmeshed differs")
    d["train_state_bit_equal"] = True
    del rp, rstate, state
    _free(device)
    model = QwenTTSModel(cfg, params=params, device=device, model_path=LORA_MODEL_PATH)
    from rho_tts_tpu_torch.parallel import inference

    inference.enable_tensor_parallel(model, tp)
    t0 = time.perf_counter()
    model.save_checkpoint(os.path.join(work, "ckpt"))
    d["save_checkpoint_s"] = time.perf_counter() - t0
    loaded, manifest = ckpt.load_params(os.path.join(work, "ckpt"), family="qwen", device=device)
    if not same(ckpt.flatten(loaded), ckpt.flatten(model.params)) \
            or manifest.get("variant") != "custom-voice":
        raise AssertionError("phase 13 d: the TP checkpoint reloaded unmeshed differs")
    d["checkpoint_bit_equal"] = True
    d["bytes"] = sum(os.path.getsize(os.path.join(root, f))
                     for root, _, files in os.walk(work) for f in files)
    shutil.rmtree(work, ignore_errors=True)
    del model, loaded, params
    _free(device)
    out["d_checkpoints"] = d
    log(f"phase 13 d_checkpoints ({smi}): {json.dumps(d)}")

    # -- e. walls -------------------------------------------------------------------
    params = init_params(cfg, TRAIN_SEED, device)
    state = optimizer.init(params)
    steppers = {
        "U": lambda: train.train_step(params, state, batch, cfg, optimizer),
        "D": lambda: train.train_step(params, state, batch, cfg, optimizer, mesh=meshes["dp"]),
        "T": lambda: train.train_step(params, state, batch, cfg, optimizer, mesh=meshes["tp"]),
        "P": lambda: pipeline.pipeline_train_step(params, state, batch, cfg, optimizer,
                                                  meshes["pp"], 1),
        "M": lambda: pipeline.pipeline_train_step(params, state, batch, cfg, optimizer,
                                                  meshes["pp"], PP_MICROBATCHES)}
    for step in steppers.values():  # warm-up
        step()
    _sync(device)
    order = "".join(np.random.default_rng(0).permutation(list("UDTPM" * SHARDED_WALLS)))
    walls = {k: [] for k in steppers}
    for key in order:
        t0 = time.perf_counter()
        steppers[key]()
        _sync(device)
        walls[key].append(time.perf_counter() - t0)

    def summary(xs):
        q1, med, q3 = np.percentile(xs, [25, 50, 75])
        return {"walls_ms": [x * 1e3 for x in xs], "median_ms": med * 1e3, "q1_ms": q1 * 1e3,
                "q3_ms": q3 * 1e3, "mean_ms": float(np.mean(xs)) * 1e3}

    names = {"U": "unmeshed", "D": "dp", "T": "tp", "P": "pp_m1", "M": f"pp_m{PP_MICROBATCHES}"}
    e = {"order": order, **{names[k]: summary(v) for k, v in walls.items()}}
    for k in "DTPM":
        e[names[k]]["median_vs_unmeshed"] = e[names[k]]["median_ms"] / e["unmeshed"]["median_ms"]
    del params, state, steppers
    mesh.shutdown_distributed()
    if device == "cuda":
        e["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["e_walls"] = e
    log(f"phase 13 e_walls ({smi}): {json.dumps(e)}")
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = {k: sum(out["a_meshes_of_one"][v]["launches"][k]
                              for v in ("unmeshed", "dp", "tp", "pp"))
                       + out["b_pp_microbatched"]["pp"]["launches"][k]
                       + sum(out["c_lora"][v]["launches"][k]
                             for v in ("unmeshed", "dp", "tp", "pp"))
                       for k in kmods}
    return out


# ---------------------------------------------------------------------------
# Phase 14: the host-only layers on the card
# ---------------------------------------------------------------------------

HOST_MODEL_PATH = "Qwen3-TTS-12Hz-1.7B-CustomVoice"  # phase 7's model
HOST_KW = dict(speaker="Vivian", quantization="int8", min_audio_sec=1000.0)  # EOS masked
CANCEL_AFTER_S = 1.0
TRACE_FRAMES = 64  # one decode chunk: a 192-step generate() traces ~1e6 events
MEM_SLACK_BYTES = 64 << 20
UI_MODEL_ID, UI_VOICE_ID = "qwen-1.7b-custom", "builtin-vivian"


def _fake_venv(venvs, root: str) -> str:
    """The qwen venv the isolation layer looks for, made by hand (no pip):
    an interpreter script that runs this interpreter, and a current marker."""
    py = os.path.join(root, "qwen", "bin", "python")
    os.makedirs(os.path.dirname(py), exist_ok=True)
    with open(py, "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(py, 0o755)
    with open(os.path.join(root, "qwen", venvs.MARKER_FILE), "w") as f:
        f.write(venvs.source_hash())
    return py


@contextlib.contextmanager
def _isolated_qwen(factory_cls, venvs, root: str, src: str):
    """``TTSFactory`` as after qwen's ``ImportError`` (qwen served through
    ``ProviderProxy``), the venvs under ``root``, ``src`` on the workers'
    ``PYTHONPATH``; all restored after."""
    factory_cls._register_default_providers()
    saved = (factory_cls._providers, factory_cls._isolated_providers, venvs.VENVS_ROOT,
             os.environ.get("PYTHONPATH"))
    factory_cls._providers = {k: v for k, v in saved[0].items() if k != "qwen"}
    factory_cls._isolated_providers = set(saved[1]) | {"qwen"}
    venvs.VENVS_ROOT = pathlib.Path(root)
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (src, saved[3]) if p)
    try:
        yield
    finally:
        factory_cls._providers, factory_cls._isolated_providers, venvs.VENVS_ROOT = saved[:3]
        _restore_env("PYTHONPATH", saved[3])


def _drive_host_sequence(tts, out_dir: str, device: str, chunked=None) -> dict:
    """The sequence both instances of part a run: a warm-up
    ``generate(TEXTS, base)``, a timed one, ``stream(TEXTS[0])``."""
    tts.generate(TEXTS, os.path.join(out_dir, "warm"))
    _sync(device)
    t0 = time.perf_counter()
    results = tts.generate(TEXTS, os.path.join(out_dir, "out"))
    _sync(device)
    wall = time.perf_counter() - t0
    kw = {} if chunked is None else {"chunked": chunked}
    t0 = time.perf_counter()
    segments = list(tts.stream(TEXTS[0], **kw))
    _sync(device)
    return {"results": results, "wall_s": wall, "segments": segments,
            "stream_s": time.perf_counter() - t0}


def _compare_host_runs(proxied: dict, local: dict) -> dict:
    """Part a's checks: WAV bytes, segment counts, durations, streamed segments."""
    import numpy as np

    from rho_tts_tpu_torch import audio_io

    rp, rl = proxied["results"], local["results"]
    if not isinstance(rp, list) or len(rp) != len(TEXTS) or None in rp \
            or not isinstance(rl, list) or len(rl) != len(TEXTS) or None in rl:
        raise AssertionError(f"phase 14 a: results {rp!r} / {rl!r}")
    samples = []
    for i, (p, q) in enumerate(zip(rp, rl)):
        with open(p.path, "rb") as f:
            pb = f.read()
        with open(q.path, "rb") as f:
            qb = f.read()
        if pb != qb:
            a, _ = audio_io.load_wav(p.path)
            b, _ = audio_io.load_wav(q.path)
            diff = (np.abs(np.round(a * 32768).astype(np.int64) - np.round(b * 32768)
                           .astype(np.int64)).max() if a.shape == b.shape else -1)
            raise AssertionError(f"phase 14 a: item {i}'s WAV differs across processes "
                                 f"({len(pb)} / {len(qb)} bytes, largest difference "
                                 f"{diff} int16 LSB)")
        if (p.segments_count, p.duration_sec) != (q.segments_count, q.duration_sec):
            raise AssertionError(f"phase 14 a: item {i}: {p} / {q}")
        samples.append((len(pb) - 44) // 2)
    sp, sl = proxied["segments"], local["segments"]
    if len(sp) != len(sl) or not sp:
        raise AssertionError(f"phase 14 a: {len(sp)} streamed segments, {len(sl)} in process")
    for i, (p, q) in enumerate(zip(sp, sl)):
        # the proxy's audio is the WAV's int16 / 32768; the in-process one as saved
        a = np.round(p.numpy() * 32768.0).astype(np.int64)
        b = audio_io._to_int16(q.numpy()).astype(np.int64)
        if a.shape != b.shape or not np.array_equal(a, b) or p.duration_sec != q.duration_sec:
            d = int(np.abs(a - b).max()) if a.shape == b.shape else -1
            raise AssertionError(f"phase 14 a: streamed segment {i} differs ({a.shape} / "
                                 f"{b.shape}, largest difference {d} int16 LSB)")
    return {"wav_samples": samples, "segments_count": [r.segments_count for r in rp],
            "streamed_segments": len(sp), "streamed_samples": [int(p.audio.shape[0]) for p in sp],
            "bit_equal": True}


def _count_trace_kernels(path: str) -> dict:
    """Kernel events of a ``torch.profiler`` trace named after the attention
    kernels (the bf16 prefill's tensor-core kernel, the decode kernel)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {"prefill_gqa_attention": "tc_prefill_kernel",
             "decode_gqa_attention": "split_decode_kernel"}
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    out = {k: sum(1 for n in kernels if v in n) for k, v in names.items()}
    out["kernel_events"] = len(kernels)
    out["events"] = len(events)
    return out


def _mem(device) -> int:
    return torch.cuda.memory_allocated() if device == "cuda" else 0


def run_host_layers_path(qmodel, kmods, build_dir: str, smi: str, src: str,
                         device: str = "cuda", model_path: str = HOST_MODEL_PATH,
                         trace_frames: int = TRACE_FRAMES) -> dict:
    """Phase 14: the host-only layers driving the card (see the module doc).

    a. ``TTSFactory.get_tts_instance("qwen", ...)`` routed to
       ``ProviderProxy`` as after an ``ImportError`` of the provider, over a
       venv made by hand under ``build_dir/phase14`` (no pip): the worker
       runs phase 7's int8 model in its own process and CUDA context. The
       same calls on an in-process instance built with the same kwargs: the
       WAVs, segment counts, durations and streamed segments bit-equal;
    b. a proxied ``generate`` cancelled after ``CANCEL_AFTER_S`` returns
       None with the worker alive and serving the next call; then the
       worker is killed with a request in flight and the proxy gives the
       JAX package's sequence: a "restarted" error, the restarted worker's
       "Expected 'init'" (it is sent no ``INIT``), then "not running";
    c. ``profiling.start_trace`` / ``stop_trace`` around one ``synthesize``
       of the batch for ``trace_frames`` steps: the written trace names
       kernels 1 and 2 as often as their launch counters count;
    d. the UI's callbacks (``AppState``, no gradio) on a temporary config:
       ``generate_audio`` bit-equal to an in-process ``generate`` with the
       kwargs ``build_tts_kwargs`` gives, the history saved; a switch to
       int4 frees the int8 engine's memory (within ``MEM_SLACK_BYTES``) and
       launches kernel 4.
    """
    import shutil
    import threading

    import numpy as np

    from rho_tts_tpu_torch import CancellationToken, TTSFactory, audio_io
    from rho_tts_tpu_torch.isolation import ProviderProxy, venvs
    from rho_tts_tpu_torch.models.qwen.config import resolve_config
    from rho_tts_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    # The port's defaults, as a fresh worker process runs it: TF32 off for
    # matmuls, on for cuDNN.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    _free(device)
    root = os.path.join(build_dir, "phase14")
    shutil.rmtree(root, ignore_errors=True)
    for d in ("proxy", "local", "cancel", "ui"):
        os.makedirs(os.path.join(root, d))
    kw = dict(HOST_KW, model_path=model_path, device=device)
    mcfg = resolve_config(model_path)
    layers = mcfg.talker.layers
    out = {"card": smi, "model_path": model_path}
    relay = logging.getLogger("rho_tts_tpu_torch.isolation.procman")  # the worker's stderr
    relay.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stderr)
    relay.addHandler(handler)

    # -- a. the factory's isolation route ---------------------------------
    _fake_venv(venvs, os.path.join(root, "venvs"))
    with _isolated_qwen(TTSFactory, venvs, os.path.join(root, "venvs"), src):
        t0 = time.perf_counter()
        proxy = TTSFactory.get_tts_instance("qwen", **kw)
        ready_s = time.perf_counter() - t0
        try:
            if not isinstance(proxy, ProviderProxy):
                raise AssertionError(f"phase 14 a: the route gave {type(proxy)}")
            proxied = _drive_host_sequence(proxy, os.path.join(root, "proxy"), device)
            t0 = time.perf_counter()
            alive = proxy.ping()
            ping_ms = (time.perf_counter() - t0) * 1e3
            if not alive:
                raise AssertionError("phase 14 a: the worker did not answer ping()")

            # -- b. cancel, then a crash ----------------------------------
            token, fired = CancellationToken(), []

            def cancel():
                fired.append(time.perf_counter())
                token.cancel()

            timer = threading.Timer(CANCEL_AFTER_S, cancel)
            timer.start()
            cancelled = proxy.generate(TEXTS, os.path.join(root, "cancel", "c"),
                                       cancellation_token=token)
            t_none = time.perf_counter()
            timer.join()
            if cancelled is not None or not fired:
                raise AssertionError(f"phase 14 b: a cancelled generate gave {cancelled!r}")
            if not proxy.ping():
                raise AssertionError("phase 14 b: the worker did not answer after the cancel")
            after = proxy.generate(TEXTS, os.path.join(root, "cancel", "after"))
            if not isinstance(after, list) or len(after) != len(TEXTS) or None in after \
                    or not all(os.path.isfile(r.path) for r in after):
                raise AssertionError(f"phase 14 b: the generate after the cancel gave {after!r}")
            # The worker dies with a request in flight: killed as soon as the
            # frame is written. The proxy restarts it and raises; the new
            # worker is sent no INIT, so it answers the next request with an
            # ERROR and exits; a dead worker is then refused before any write.
            pipe = proxy._worker._pipe

            def write_then_kill(msg_type, **payload):
                type(pipe).write(pipe, msg_type, **payload)
                pipe.proc.kill()
                pipe.proc.wait(timeout=60)

            pipe.write = write_then_kill
            crash = []
            for i in range(3):
                try:
                    proxy.generate(TEXTS[2], os.path.join(root, "cancel", "crash.wav"))
                    crash.append(None)
                except RuntimeError as e:
                    crash.append(str(e))
                if i == 1:
                    restarted = proxy._worker._pipe.proc
                    restarted.wait(timeout=120)  # it exits after its ERROR
            want = ("Worker crashed and was restarted", "Worker error: Expected 'init' as first "
                    "message", "Worker is not running")
            if not all((e or "").startswith(w) for e, w in zip(crash, want)):
                raise AssertionError(f"phase 14 b: after the kill the proxy gave {crash}")
        finally:
            proxy.close()
    b = {"cancel_to_none_s": t_none - fired[0], "cancel_after_s": CANCEL_AFTER_S,
         "ping_after_cancel": True, "files_after_cancel": len(after),
         "crash_sequence": crash, "restarted_worker_exit": restarted.returncode}

    t0 = time.perf_counter()
    tts = TTSFactory.get_tts_instance("qwen", **kw)
    model = tts._load_model()
    _sync(device)
    local_init_s = time.perf_counter() - t0
    local = _drive_host_sequence(tts, os.path.join(root, "local"), device, chunked=False)
    a = _compare_host_runs(proxied, local)
    a.update(worker_ready_s=ready_s, proxied_wall_s=proxied["wall_s"],
             in_process_wall_s=local["wall_s"],
             isolation_cost_s=proxied["wall_s"] - local["wall_s"],
             proxied_stream_s=proxied["stream_s"], in_process_stream_s=local["stream_s"],
             in_process_init_s=local_init_s, ping_ms=ping_ms)
    out["a_isolation"] = a
    log(f"phase 14 a_isolation ({smi}): {json.dumps(a)}")
    out["b_cancel_crash"] = b
    log(f"phase 14 b_cancel_crash ({smi}): {json.dumps(b)}")

    # -- c. a profiler trace ----------------------------------------------
    trace_dir = os.path.join(root, "trace")
    syn = dict(speaker="Vivian", min_frames=trace_frames, max_frames=trace_frames, top_k=50,
               seeds=list(range(len(TEXTS))))
    _zero(kmods)
    if not profiling.start_trace(trace_dir) or profiling.start_trace(trace_dir):
        raise AssertionError("phase 14 c: start_trace did not start exactly one trace")
    try:
        waves, _sr = model.synthesize(TEXTS, **syn)
        _sync(device)
    finally:
        t0 = time.perf_counter()
        profiling.stop_trace()
        stop_s = time.perf_counter() - t0
    launches_c = _launches(kmods)
    traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)
              if n.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"phase 14 c: {len(traces)} trace files under {trace_dir}")
    t0 = time.perf_counter()
    counted = _count_trace_kernels(traces[0])
    c = {"frames": trace_frames, "trace_bytes": os.path.getsize(traces[0]),
         "stop_trace_s": stop_s, "parse_s": time.perf_counter() - t0, "launches": launches_c,
         "trace_counts": counted}
    steps = -(-trace_frames // qmodel._chunk()) * qmodel._chunk()  # whole decode chunks
    c["decode_steps"] = steps
    want = {"prefill_gqa_attention": layers, "decode_gqa_attention": layers * steps}
    for name, n in want.items():
        if launches_c[name] != n or (device == "cuda" and counted[name] != n):
            raise AssertionError(f"phase 14 c: {name} launched {launches_c[name]} times, "
                                 f"{counted[name]} in the trace, expected {n}")
    shutil.rmtree(trace_dir, ignore_errors=True)
    out["c_trace"] = c
    log(f"phase 14 c_trace ({smi}): {json.dumps(c)}")
    del waves, model
    tts.close()
    del tts, local, proxied

    # -- d. the UI's callbacks --------------------------------------------
    from rho_tts_tpu_torch.ui import callbacks as cb
    from rho_tts_tpu_torch.ui import config as cfgmod
    from rho_tts_tpu_torch.ui.state import AppState

    ui_dir = os.path.join(root, "ui")
    saved_env = {k: os.environ.get(k) for k in (cfgmod.CONFIG_ENV, cfgmod.HISTORY_ENV)}
    os.environ[cfgmod.CONFIG_ENV] = os.path.join(ui_dir, "config.json")
    os.environ[cfgmod.HISTORY_ENV] = os.path.join(ui_dir, "history.json")
    try:
        cfg = cfgmod.AppConfig()
        cfg.models = [m for m in cfg.models if m.id == UI_MODEL_ID]
        cfg.voices = [v for v in cfg.voices if v.id == UI_VOICE_ID]
        if model_path != HOST_MODEL_PATH:  # a rehearsal at another size
            cfg.models[0].model_path = model_path
        cfgmod.save_config(cfg)
        state = AppState()
        status = [cb.set_model_serving(state, UI_MODEL_ID, "int8", "none")]
        params = cb.load_parameters(state, UI_VOICE_ID, UI_MODEL_ID)
        params.update(max_iterations=1, min_audio_sec=HOST_KW["min_audio_sec"])
        if device != "cuda":
            params["device"] = device
        status.append(cb.save_parameters(state, UI_VOICE_ID, UI_MODEL_ID, params))
        if not all(s.startswith("✅") for s in status):
            raise AssertionError(f"phase 14 d: {status}")
        _free(device)
        mem0 = _mem(device)

        def click(tag):
            _zero(kmods)
            t0 = time.perf_counter()
            updates = list(cb.generate_audio(state, UI_MODEL_ID, UI_VOICE_ID, TEXTS[0],
                                             output_dir=os.path.join(ui_dir, tag)))
            _sync(device)
            wall = time.perf_counter() - t0
            path, msg = updates[-1]
            if not path or not msg.startswith("✅") or not os.path.isfile(path):
                raise AssertionError(f"phase 14 d {tag}: generate_audio ended with {updates[-1]}")
            return path, wall, _launches(kmods)

        path8, wall8, launches8 = click("int8")
        mem_int8 = _mem(device)
        with open(os.environ[cfgmod.HISTORY_ENV]) as f:
            history = json.load(f)
        if len(history) != 1 or history[0]["output_path"] != path8:
            raise AssertionError(f"phase 14 d: history on disk {history}")
        kwargs = state.build_tts_kwargs(state.config.get_model(UI_MODEL_ID),
                                        state.config.get_voice(UI_VOICE_ID))
        ref = TTSFactory.get_tts_instance("qwen", **kwargs)
        ref_path = os.path.join(ui_dir, "in_process.wav")
        ref.generate(TEXTS[0], ref_path)
        ref.close()
        del ref
        with open(path8, "rb") as f, open(ref_path, "rb") as g:
            if f.read() != g.read():
                raise AssertionError("phase 14 d: the UI's WAV differs from an in-process "
                                     "generate with build_tts_kwargs' kwargs")
        status = cb.set_model_serving(state, UI_MODEL_ID, "int4", "none")
        mem_switched = _mem(device)
        if not status.startswith("✅") or abs(mem_switched - mem0) > MEM_SLACK_BYTES:
            raise AssertionError(f"phase 14 d: {status}; memory {mem0} B before the first "
                                 f"engine, {mem_switched} B after the switch's close")
        path4, wall4, launches4 = click("int4")
        mem_int4 = _mem(device)
        state.invalidate_tts()
        _free(device)
        mem_end = _mem(device)
        if launches4["int4_matmul"] == 0 or launches8["int4_matmul"] != 0 \
                or launches4["decode_gqa_attention"] != launches8["decode_gqa_attention"] \
                or launches4["prefill_gqa_attention"] != launches8["prefill_gqa_attention"]:
            raise AssertionError(f"phase 14 d: launches int8 {launches8}, int4 {launches4}")
        w8, _ = audio_io.load_wav(path8)
        w4, _ = audio_io.load_wav(path4)
        steps = launches8["decode_gqa_attention"] // layers
        for tag, w in (("int8", w8), ("int4", w4)):
            if not 0 < w.shape[0] <= (steps + 1) * mcfg.codec.hop or not np.isfinite(w).all():
                raise AssertionError(f"phase 14 d {tag}: {w.shape[0]} samples for {steps} steps")
        d = {"walls_s": {"int8": wall8, "int4": wall4}, "decode_steps": steps,
             "samples": {"int8": int(w8.shape[0]), "int4": int(w4.shape[0])},
             "memory_bytes": {"before": mem0, "int8_engine": mem_int8, "after_switch": mem_switched,
                              "int4_engine": mem_int4, "after_close": mem_end},
             "launches": {"int8": launches8, "int4": launches4}, "bit_equal_in_process": True,
             "history_saved": True}
    finally:
        for k, v in saved_env.items():
            _restore_env(k, v)
    out["d_ui"] = d
    log(f"phase 14 d_ui ({smi}): {json.dumps(d)}")
    relay.removeHandler(handler)
    shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {name: {"c_trace": launches_c[name], "d_ui_int8": launches8[name],
                              "d_ui_int4": launches4[name]} for name in kmods}
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def _free(device):
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


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
    cb_cases = check_chatterbox_shapes(attn, dec, qz, w8, i4, gen)
    for k in kernels:
        k["chatterbox_cases"] = cb_cases[k["name"]]
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
        for case in k["chatterbox_cases"]:
            log(f"  chatterbox case {json.dumps(case)}")

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
    build_dir = os.path.join(os.path.dirname(src), "build")
    gen_path = run_generate_path(qmodel, kmods, build_dir, smi)
    log(f"phase 7 generate(): {json.dumps(gen_path)}")
    val_path = run_validate_path(qmodel, kmods, build_dir, smi, gen_path)
    log(f"phase 8 validate(): {json.dumps(val_path)}")
    t0 = time.perf_counter()
    serve_path = run_serving_path(qmodel, kmods, build_dir, smi, gen_path)
    log(f"phase 9 serving: every part passed in {time.perf_counter() - t0:.1f} s, peak "
        f"{serve_path['peak_mem_gb']:.2f} GB")
    t0 = time.perf_counter()
    cb_path = run_chatterbox_path(kmods, build_dir, smi)
    log(f"phase 10 chatterbox: every part passed in {time.perf_counter() - t0:.1f} s, peak "
        f"{cb_path['peak_mem_gb']:.2f} GB")
    t0 = time.perf_counter()
    train_path = run_training_path(qmodel, kmods, build_dir, smi)
    log(f"phase 11 training: every part passed in {time.perf_counter() - t0:.1f} s")
    mesh_path = run_parallel_path(qmodel, kmods, smi)
    log(f"phase 12 meshes: every part passed in {mesh_path['wall_s']:.1f} s, peak "
        f"{mesh_path['peak_mem_gb']:.2f} GB")
    sharded_path = run_sharded_training_path(qmodel, kmods, build_dir, smi)
    log(f"phase 13 sharded training: every part passed in {sharded_path['wall_s']:.1f} s, "
        f"peak {sharded_path['e_walls']['peak_gb']:.2f} GB")
    host_path = run_host_layers_path(qmodel, kmods, build_dir, smi, src)
    log(f"phase 14 host layers: every part passed in {host_path['wall_s']:.1f} s")
    paths = {"prefill_gqa_attention": ("int8", main_path),
             "decode_gqa_attention": ("int8", main_path),
             "w8a8_matmul": ("int8+w8a8 prefill", w8a8_path),
             "int4_matmul": ("int4 from checkpoint", int4_path)}
    for k in kernels:
        path_name, path = paths[k["name"]]
        k["launches"] = path["launches"][k["name"]]
        k["launches_path"] = f"1.7B {path_name}, {path['decode_steps']} decode steps"
        k["launches_generate"] = gen_path["launches"][k["name"]]
        k["launches_validate"] = {"a": val_path["a_permissive"]["launches"][k["name"]],
                                  "b": val_path["b_every_segment_fails"]["launches"][k["name"]]}
        k["launches_serving"] = {
            "slot_batch": serve_path["a_slot_batch"]["launches"][k["name"]],
            "speculative": serve_path["b_speculative"]["launches"][k["name"]],
            "served_generate": serve_path["c_served_generate"]["launches"][k["name"]]}
        k["launches_chatterbox"] = {
            "a_one_segment": cb_path["a_one_segment"]["launches"][k["name"]],
            "b_candidates": cb_path["b_candidates"]["launches"][k["name"]],
            "c_served": cb_path["c_serving"]["served"]["launches"][k["name"]],
            "c_lockstep": cb_path["c_serving"]["lockstep"]["launches"][k["name"]],
            "e_int4": cb_path["e_int4"]["launches"][k["name"]]}
        k["launches_training"] = {
            "train_step": train_path["b_full_finetune"]["launches"][k["name"]],
            "lora_step": train_path["c_lora"]["launches"][k["name"]],
            "lora_generate": train_path["c_lora"]["generate"]["launches"][k["name"]],
            "distill": train_path["d_distill"]["rollout_launches"][k["name"]]
            + train_path["d_distill"]["step_launches"][k["name"]]}
        mb = mesh_path["b_oneshot"]
        k["launches_parallel"] = {
            "b_unmeshed": mb["unmeshed"]["launches"][k["name"]],
            "b_dp_mesh_of_one": mb["dp_mesh_of_one"]["launches"][k["name"]],
            "b_tp_mesh_of_one": mb["tp_mesh_of_one"]["launches"][k["name"]],
            "b_tp_w8a8_prefill": mb["tp_w8a8_prefill"]["launches"][k["name"]],
            "b_tp_int4": mb["tp_int4"]["launches"][k["name"]],
            "c_served_tp": mesh_path["c_serving"]["tp_mesh_of_one"]["launches"][k["name"]],
            "d_chatterbox_tp": mesh_path["d_chatterbox"]["tp_mesh_of_one"]["launches"][k["name"]]}
        k["per_rank_cases"] = mesh_path["e_per_rank"][k["name"]]
        k["launches_sharded_training"] = sharded_path["launches"][k["name"]]
        k["launches_host_layers"] = host_path["launches"][k["name"]]
        if not any(k["launches_parallel"].values()):
            raise AssertionError(f"phase 12: {k['name']} was launched no time on the mesh path")

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
