"""Where the time of the int4 and w8a8 matmul kernels goes, by variants with parts removed.

Run from the repository root on one NVIDIA GPU:

    python3 chip_matmul_variants.py

Builds copies of ``csrc/int4_matmul.cu`` and ``csrc/w8a8_matmul.cu``, each
with one part removed or changed (all of the kernel; the GEMV's cluster
merge, its products, its weight or x copies, x staged by plain loads, one
commit group instead of four; the wgmma kernels' products, their high-half
products, their weight unpacking or their epilogue), into
``build/matmul_variants/``, and times
each at the 1.7B main-path shapes as ``chip_smoke.py`` phase 2 times the
kernels. It also sweeps the GEMV's plans (column tile, cluster size) and the
int4 prefill's token tile, asks the runtime how many GEMV clusters fit on
the card at once, and times the kernels with the L2 warm. The variants compute wrong results: they only
measure. Prints one JSON line, then the card's name and power limit. Needs
a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

import chip_smoke
from chip_attention_variants import warm_us

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "matmul_variants")

# (text in the source, replacement): each variant must find its text.
INT4_VARIANTS = {
    "full": [],
    "nothing": [
        ("  constexpr int kTok = 8 * NT;\n", "  constexpr int kTok = 8 * NT;\n  if (a.kh > 0) return;\n"),
        ("  using L = MmLayout<BT>;\n  extern", "  using L = MmLayout<BT>;\n  if (kh > 0) return;\n  extern"),
    ],
    "gemv: no merge": [("  merge_splits<__nv_bfloat16>(cluster, part, kTok, a, m0, n0);\n}", "}")],
    "gemv: no products": [("for (int kk = q * per + rgi; kk < s_hi;", "for (int kk = q * per + rgi; kk < 0;")],
    "gemv: no weight copies": [
        ("      copy_rows(a, qrow, n0, wsm, wrow, min(cr, q * per * 16), min(cr, (q + 1) * per * 16));\n", "")],
    "gemv: no x copies": [("        cp_async16(xs + row * xrow + r, src, ok ? 16 : 0);\n",
                           "        (void)src;\n")],
    "gemv: x by loads": [("    if (a.xvec) {\n", "    if (false) {\n")],
    "gemv: one commit group": [("constexpr int kGvGroups = 4;", "constexpr int kGvGroups = 1;")],
    "wgmma: lo products only": [
        ("      hopper::Wgmma<BT>::bf16(acc0, hi[0], dhi + 2 * kk);\n"
         "      hopper::Wgmma<BT>::bf16(acc1, hi[1], dhi + 2 * kk);\n", "")],
    "wgmma: no products": [
        ("      hopper::Wgmma<BT>::bf16(acc0, lo[0], dlo + 2 * kk);\n"
         "      hopper::Wgmma<BT>::bf16(acc1, lo[1], dlo + 2 * kk);\n"
         "      hopper::Wgmma<BT>::bf16(acc0, hi[0], dhi + 2 * kk);\n"
         "      hopper::Wgmma<BT>::bf16(acc1, hi[1], dhi + 2 * kk);\n", "")],
    "wgmma: no unpack": [
        ("      unpack_fragments(*reinterpret_cast<const uint32_t*>(wk + off[0]),",
         "      for (int i = 0; i < 8; ++i) lo[i / 4][i % 4] = hi[i / 4][i % 4] = 0x3F80u * (kk + 1);\n"
         "      if (0) unpack_fragments(*reinterpret_cast<const uint32_t*>(wk + off[0]),")],
    "wgmma: no epilogue": [("  // Epilogue: acc * s[n], one rounding, staged in the ring for coalesced stores.\n",
                            "  if (kh > 0) return;\n")],
}
# The full kernel plus an entry that asks the runtime how many GEMV clusters
# of a plan fit on the card at once.
_OCCUPANCY = """
extern "C" int rho_gemv_max_clusters(int m, int kh, int n, int ct, int cluster, int slice) {
  const GemvArgs a{nullptr, nullptr, nullptr, nullptr, m, kh, n, ct, slice, 1, 1};
  const int nt = m > 8 ? 2 : 1;
  const int cap = std::min(round16(slice), kGvChunkRows);
  const int tok = 8 * nt;
  const int row_groups = kGmThreads / 32 / (ct / 32);
  const int smem = tok * ct * 4 + cap * (ct + 16) + 2 * tok * (cap + 8) * 2 +
                   (row_groups > 1 ? row_groups * tok * ct * 4 : 0);
  if (smem > 48 * 1024 &&
      hopper::allow_smem(reinterpret_cast<const void*>(gemv_mma_kernel<1>), smem) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(n, ct), cluster, cdiv(m, tok));
  cfg.blockDim = dim3(kGmThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(&clusters, gemv_mma_kernel<1>, &cfg) != cudaSuccess) return -1;
  return clusters;
}
"""
INT4_VARIANTS["occupancy"] = [("\n}  // namespace\n", "\n}  // namespace\n" + _OCCUPANCY)]

W8A8_VARIANTS = {
    "full": [],
    "nothing": [("  using L = WgLayout<BT, TO>;\n  extern", "  using L = WgLayout<BT, TO>;\n  if (k_len > 0) return;\n  extern")],
    "no products": [("      hopper::Wgmma<BT>::s8(acc0, a0, dx + 2 * kk);\n"
                     "      hopper::Wgmma<BT>::s8(acc1, a1, dx + 2 * kk);\n", "")],
    "no epilogue": [("  // Epilogue: (float(acc) * sx[m]) * ws[n], one rounding, staged in the ring.\n",
                     "  if (k_len > 0) return;\n")],
}


def build_variants(build, name, variants):
    """Compile every variant of ``csrc/<name>.cu`` in parallel; return the libraries."""
    src = (build.CSRC / f"{name}.cu").read_text()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for tag, edits in variants.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}.cu variant {tag!r}: {old.strip()[:60]!r} not found")
            text = text.replace(old, new)
        stem = f"{name}-{''.join(c if c.isalnum() else '_' for c in tag)}"
        cu, lib = os.path.join(OUT, stem + ".cu"), os.path.join(OUT, f"lib{stem}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[tag] = (subprocess.Popen([build._nvcc(), *flags, "-I", str(build.CSRC), "-o", lib, cu],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for tag, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}.cu variant {tag!r} failed to build:\n{out}")
        libs[tag] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_matmul_variants: a CUDA device is required", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from rho_tts_tpu_torch.models import quantization as qz
    from rho_tts_tpu_torch.ops.cuda import _build
    from rho_tts_tpu_torch.ops.cuda import int4_matmul as i4
    from rho_tts_tpu_torch.ops.cuda import w8a8_matmul as w8

    smi = chip_smoke.nvidia_smi_line()
    os.makedirs(OUT, exist_ok=True)
    _build.build_all()
    ilibs = build_variants(_build, "int4_matmul", INT4_VARIANTS)
    wlibs = build_variants(_build, "w8a8_matmul", W8A8_VARIANTS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    report = {}

    def int4_case(m, k, n):
        w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
        qw = qz.pack_int4(w)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        return (x.data_ptr(), qw["q4"].data_ptr(), qw["s"].data_ptr(), out.data_ptr()), (x, qw, out)

    def int4_call(fn, ptrs, m, kh, n, p):
        bt, ct, cl, sl = (p[1], 0, 0, 0) if p[0] == "wgmma" else (0, *p[1:])
        return lambda: fn(*ptrs, 1, m, kh, n, bt, ct, cl, sl, 0, stream)

    # int4: the main decode and prefill shapes through every variant.
    report["int4_us"] = {}
    keep = []
    for m, k, n in ((5, 2048, 6144), (640, 2048, 6144)):
        ptrs, tensors = int4_case(m, k, n)
        keep.append(tensors)
        p = i4.plan(torch.bfloat16, m, k // 2, n, sms)
        row = report["int4_us"][f"({m},{k},{n}) {p}"] = {}
        for tag, lib in ilibs.items():
            if (tag.startswith("gemv") and m > 16) or (tag.startswith("wgmma") and m <= 16) \
                    or tag == "occupancy":
                continue
            fn = lib.rho_int4_matmul
            fn.restype, fn.argtypes = ctypes.c_int, i4._kernel().argtypes
            call = int4_call(fn, ptrs, m, k // 2, n, p)
            if call() != 0:
                raise RuntimeError(f"int4 variant {tag!r} did not launch")
            row[tag] = chip_smoke.time_ms(call) * 1e3
        row["full, L2 warm"] = warm_us(int4_call(i4._kernel(), ptrs, m, k // 2, n, p))

    # The GEMV's plans and the prefill's block shapes at the four 1.7B shapes.
    fn = i4._kernel()
    report["int4_gemv_us_by_plan"] = {}
    report["int4_prefill_us_by_block"] = {}
    for k, n in ((2048, 6144), (6144, 2048), (2048, 4096), (2048, 2048)):
        kh = k // 2
        ptrs, tensors = int4_case(5, k, n)
        keep.append(tensors)
        row = report["int4_gemv_us_by_plan"][f"(5,{k},{n})"] = {}
        occ = ilibs["occupancy"].rho_gemv_max_clusters
        occ.restype, occ.argtypes = ctypes.c_int, [ctypes.c_int] * 6
        for ct in (64, 128):
            for cl in (1, 2, 4, 8):
                sl = -(-kh // cl)
                row[f"ct {ct} cluster {cl}"] = chip_smoke.time_ms(
                    int4_call(fn, ptrs, 5, kh, n, ("gemv", ct, cl, sl))) * 1e3
                row[f"ct {ct} cluster {cl}: clusters {-(-n // ct)}, at once at most"] = \
                    occ(5, kh, n, ct, cl, sl)
        ptrs, tensors = int4_case(640, k, n)
        keep.append(tensors)
        row = report["int4_prefill_us_by_block"][f"(640,{k},{n})"] = {}
        for bt in (64, 128):
            row[f"{bt} tokens x 128 columns"] = chip_smoke.time_ms(
                int4_call(fn, ptrs, 640, kh, n, ("wgmma", bt))) * 1e3

    # w8a8 at the main shape through every variant.
    m, k, n = 640, 2048, 6144
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    qw = qz.quantize_weight(w)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16).float()
    sx = qz._div(x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), 127.0)
    xq = torch.round(x / sx).clamp(-127, 127).to(torch.int8)
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    ptrs = (xq.data_ptr(), sx.data_ptr(), qw["q"].data_ptr(), qw["s"].data_ptr(), out.data_ptr())
    bt = w8.plan(m, k, n, sms)
    report["w8a8_us"] = {}
    for tag, lib in wlibs.items():
        wfn = lib.rho_w8a8_matmul
        wfn.restype, wfn.argtypes = ctypes.c_int, w8._kernel().argtypes
        call = lambda: wfn(*ptrs, 1, m, k, n, bt, 0, stream)
        if call() != 0:
            raise RuntimeError(f"w8a8 variant {tag!r} did not launch")
        report["w8a8_us"][tag] = chip_smoke.time_ms(call) * 1e3
    report["w8a8_us"]["full, L2 warm"] = warm_us(lambda: w8._kernel()(*ptrs, 1, m, k, n, bt, 0, stream))
    e = torch.empty(1, device="cuda")
    report["a PyTorch op with one launch (add_), us"] = chip_smoke.time_ms(lambda: e.add_(1)) * 1e3
    torch.cuda.synchronize()
    print(json.dumps({"matmul_variants": report}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
