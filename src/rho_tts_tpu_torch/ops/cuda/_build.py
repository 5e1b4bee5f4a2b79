"""Build the port's hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` source of the package is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
at first use, into ``build/rho_tts_tpu_torch/`` at the repository root.
The sources are compiled in parallel, one ``nvcc`` process each. A library
is named after a hash of its source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

Nothing here falls back: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "rho_tts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel source: nvcc's report (registers, shared memory, spills)
build_log: Dict[str, str] = {}
#: wall seconds of the last build that compiled anything
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel source whose library is missing; return the paths."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    targets = {src.stem: (src, _library_path(src)) for src in sources}
    todo = {name: st for name, st in targets.items() if not st[1].exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for name, (src, lib) in todo.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                lib,
            )
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: lib for name, (_src, lib) in targets.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building all first)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no kernel source csrc/{name}.cu")
            lib = ctypes.CDLL(str(paths[name]))
            _libs[name] = lib
        return lib
