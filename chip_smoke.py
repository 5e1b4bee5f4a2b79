"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every CUDA kernel of the port (``src/rho_tts_tpu_torch/
   csrc/*.cu``) with nvcc, in parallel, and load it;
2. kernels: run each kernel at the main-path shapes against its plain
   PyTorch version on the card, with the stated tolerance, and time the
   kernel, the plain version and one PyTorch library call as a yardstick;
3. reference: the tiny preset at fp32, kernels on the card against the
   plain versions on the CPU with the same weights (prefill logits);
4. main path: Qwen3-TTS 1.7B, weight-only int8, batch 5 through
   ``QwenTTSModel.synthesize`` (prompt -> prefill -> 4 chunks of 64 decode
   steps -> vocoder), once to warm up and once timed, with each kernel's
   launch count read around the timed run.

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit
from nvidia-smi, and as its last line ``{"ok": true, "device": {...}}``.
Exits nonzero, printing no result, without a CUDA device or without the
repository's ``src/`` beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2: each timed launch starts cold


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
    """Mean device time of ``fn()`` in ms, each launch after an L2 flush."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


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


def check_prefill(attn, gen) -> dict:
    """Prefill attention at the 1.7B main-path shape, left-padded rows."""
    b, t, hq, hkv, d = 5, 128, 16, 8, 128
    pads = torch.tensor([0, 17, 40, 127, 128], device="cuda")  # last row: all keys masked
    mask = torch.arange(t, device="cuda")[None, :] >= pads[:, None]
    cases = []
    main = None
    for dtype, tol, causal, q_offset, t_q in (
        # bf16 output: 1 bf16 ulp at |o| < 4 (order of sums differs)
        (torch.bfloat16, 2e-2, True, None, t),
        # f32: the CPU parity tolerance of the plain version
        (torch.float32, 2e-5, True, None, t),
        (torch.float32, 2e-5, False, None, t),
        (torch.float32, 2e-5, True, 64, 64),  # a sequence-parallel shard's queries
    ):
        q = torch.randn((b, t_q, hq, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
        out = attn.fused_gqa_attention(q, k, v, mask, causal=causal, q_offset=q_offset)
        ref = attn.reference_gqa_attention(q, k, v, mask, causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        cases.append({"dtype": str(dtype).split(".")[-1], "causal": causal,
                      "q_offset": q_offset, "max_abs_err": err, "tol": tol})
        if not finite or err > tol:
            raise AssertionError(f"prefill attention {cases[-1]} finite={finite}")
        if main is None:
            main = (q, k, v)
    q, k, v = main  # bf16, causal: the main path's call
    group = hq // hkv
    kernel_ms = time_ms(lambda: attn.fused_gqa_attention(q, k, v, mask))
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
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
    }


def check_decode(dec, gen) -> dict:
    """Decode attention over the 1.7B main-path cache, ragged mask."""
    b, s, hq, hkv, d = 5, 384, 16, 8, 128
    valid_to = torch.tensor([384, 300, 129, 200, 5], device="cuda")
    key_pos = torch.arange(s, device="cuda")[None, :]
    mask = (key_pos < valid_to[:, None]) & (key_pos >= torch.tensor(
        [0, 12, 0, 100, 0], device="cuda")[:, None])  # left padding too
    cases = []
    tensors = {}
    for q_dtype, kv_dtype, tol in (
        (torch.bfloat16, torch.bfloat16, 2e-2),  # main path: 1 bf16 ulp at |o| < 4
        (torch.bfloat16, torch.float8_e4m3fn, 2e-2),  # f8 cache, same f32 math
        (torch.float32, torch.float32, 2e-5),
    ):
        q = torch.randn((b, 1, hq, d), generator=gen, device="cuda").to(q_dtype)
        k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(kv_dtype)
        v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(kv_dtype)
        out = dec.decode_gqa_attention(q, k, v, mask)
        ref = dec.reference_decode_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        name = f"{str(q_dtype).split('.')[-1]}/{str(kv_dtype).split('.')[-1]}"
        cases.append({"q/kv": name, "max_abs_err": err, "tol": tol})
        if not finite or err > tol:
            raise AssertionError(f"decode attention {cases[-1]} finite={finite}")
        tensors[name] = (q, k, v)
    q, k, v = tensors["bfloat16/bfloat16"]
    group = hq // hkv
    kernel_ms = time_ms(lambda: dec.decode_gqa_attention(q, k, v, mask))
    plain_ms = time_ms(lambda: dec.reference_decode_attention(q, k, v, mask))
    q8, k8, v8 = tensors["bfloat16/float8_e4m3fn"]
    f8_ms = time_ms(lambda: dec.decode_gqa_attention(q8, k8, v8, mask))
    qh, kh, vh = q.transpose(1, 2), repeat_kv(k, group), repeat_kv(v, group)
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask[:, None, None, :]))
    ops = 4 * d * b * hq * s
    bms, by = bound_ms(nbytes(q, k, v, mask, q), ops, BF16_FLOP_PER_S)
    f8_bound, _ = bound_ms(nbytes(q8, k8, v8, mask, q8), ops, BF16_FLOP_PER_S)
    return {
        "name": "decode_gqa_attention", "route": "cuda",
        "source": "src/rho_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "src/rho_tts_tpu/ops/pallas/decode_attention.py:85",
        "shape": f"q({b},1,{hq},{d}) cache({b},{s},{hkv},{d}) bf16",
        "max_abs_err": cases[0]["max_abs_err"], "tol": cases[0]["tol"], "cases": cases,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
        "f8_cache_ms": f8_ms, "f8_cache_bound_ms": f8_bound,
    }


# ---------------------------------------------------------------------------
# Phase 3: tiny preset, card against the CPU's plain versions
# ---------------------------------------------------------------------------


def check_against_cpu(qmodel) -> dict:
    """Tiny preset at fp32: prefill logits through the kernels on the card
    against the plain versions on the CPU, same weights and prompt."""
    cfg = qmodel.PRESETS["tiny"]
    params = qmodel.init_params(cfg, seed=3, device="cpu")
    params = _tree_map(lambda t: t.float() if t.is_floating_point() else t, params)
    logits = {}
    for dev in ("cpu", "cuda"):
        m = qmodel.QwenTTSModel(cfg, params=_tree_map(lambda t: t.to(dev), params), device=dev)
        arrays, _lens, p = m._build_prompt_arrays(
            ["a short prompt", "and a second, longer prompt row"], "Aria", "English", None, None
        )
        a = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        ck, cv = qmodel.tfm.make_kv_cache(cfg.talker, 2, p + 8, dtype=torch.float32, device=dev)
        kv = torch.zeros((2, p + 8), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            out, *_ = qmodel._prefill(
                m.params, cfg, a["ids_slotted"], a["text_mask"], a["codes_slotted"],
                a["code_mask"], a["spk_ids"], a["spk_mask"], a["rope_pos"], a["attn_mask"],
                ck, cv, kv,
            )
        logits[dev] = out.float().cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    tol = 1e-4  # fp32, TF32 off: the port's fp32 parity tolerance
    if not err <= tol:
        raise AssertionError(f"tiny prefill logits: card vs CPU max abs err {err} > {tol}")
    return {"tiny_prefill_logits_max_abs_err": err, "tol": tol}


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


def run_main_path(qmodel, attn, dec) -> dict:
    cfg = qmodel.PRESETS["1.7B"]
    chunk = qmodel._chunk()
    frames = 4 * chunk
    t0 = time.perf_counter()
    model = qmodel.QwenTTSModel(cfg, seed=0, quantization="int8", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kw = dict(min_frames=frames, max_frames=frames, top_k=50, seeds=list(range(len(TEXTS))))

    t0 = time.perf_counter()
    model.synthesize(TEXTS, **kw)  # warm-up: cuBLAS/cuDNN plans, allocator
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    attn.launches = 0
    dec.launches = 0
    with StageClock(qmodel) as clock:
        t0 = time.perf_counter()
        waves, sr = model.synthesize(TEXTS, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    prefill_launches, decode_launches = attn.launches, dec.launches

    layers = cfg.talker.layers
    steps = len(clock.events["decode_chunk"]) * chunk
    if prefill_launches != layers:
        raise AssertionError(f"prefill kernel launched {prefill_launches}x, expected {layers}")
    if decode_launches != layers * steps:
        raise AssertionError(
            f"decode kernel launched {decode_launches}x, expected {layers} x {steps} steps"
        )
    hop = cfg.codec.hop
    for i, w in enumerate(waves):
        if w.shape != ((frames + 1) * hop,) or not bool(torch.isfinite(w).all()):
            raise AssertionError(f"waveform {i}: shape {tuple(w.shape)}, finite check failed")
    audio_s = sum(w.shape[0] for w in waves) / sr
    decode_ms = clock.ms("decode_chunk")
    return {
        "preset": cfg.name, "quantization": "int8", "batch": len(TEXTS), "decode_steps": steps,
        "init_s": init_s, "warmup_s": warm_s, "wall_s": wall_s,
        "prefill_ms": clock.ms("prefill"), "decode_ms": decode_ms,
        "decode_ms_per_step": decode_ms / steps,
        "tokens_per_s": len(TEXTS) * steps / (decode_ms / 1e3),
        "vocode_ms": clock.ms("vocode"),
        "audio_s": audio_s, "rtf": audio_s / wall_s,
        "launches": {"prefill_gqa_attention": prefill_launches,
                     "decode_gqa_attention": decode_launches},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA device is required",
              file=sys.stderr)
        return 1
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "rho_tts_tpu_torch")):
        print(f"chip_smoke: the port's package is missing under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from rho_tts_tpu_torch.models.qwen import model as qmodel
    from rho_tts_tpu_torch.ops.cuda import _build
    from rho_tts_tpu_torch.ops.cuda import attention as attn
    from rho_tts_tpu_torch.ops.cuda import decode_attention as dec


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

    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = [check_prefill(attn, gen), check_decode(dec, gen)]
    for k in kernels:
        log(f"phase 2 {k['name']}: max_abs_err {k['max_abs_err']:.3g} (tol {k['tol']}), "
            f"kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms ({k['bound_by']})")

    ref = check_against_cpu(qmodel)
    log(f"phase 3 reference: {json.dumps(ref)}")

    main_path = run_main_path(qmodel, attn, dec)
    log(f"phase 4 main path: {json.dumps(main_path)}")
    for k in kernels:
        k["launches"] = main_path["launches"][k["name"]]

    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
