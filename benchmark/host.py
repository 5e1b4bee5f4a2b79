"""What the host did during a run's window, to tell a slow run's cause.

The cells are host-bound: the pace of the program's launch loop is the
pace of one CPU core. A snapshot before and after the window gives the
machine's CPU steal and idle shares over it (``/proc/stat``), the process's
CPU seconds and context switches, the CPU seconds of its busiest threads by
name, the cores' clock, and the card's clocks, power and temperature
(``nvidia-smi``). Nothing here is a metric: the run prints the line on
standard error, beside its checks.
"""

from __future__ import annotations

import os
import resource
import subprocess
from pathlib import Path
from typing import Dict, Optional

GPU_QUERY = "clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active"


def _cpu_times() -> Optional[list]:
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except OSError:
        return None


def _threads() -> Dict[str, float]:
    """CPU seconds of each of this process's threads, by ``name#tid``."""
    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    for task in Path("/proc/self/task").glob("*"):
        try:
            stat = (task / "stat").read_text()
        except OSError:
            continue
        name = stat[stat.index("(") + 1: stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        out[f"{name}#{task.name}"] = (int(fields[11]) + int(fields[12])) / tick
    return out


def _mhz() -> Optional[float]:
    try:
        with open("/proc/cpuinfo") as f:
            vals = [float(ln.split(":")[1]) for ln in f if ln.startswith("cpu MHz")]
        return sum(vals) / len(vals) if vals else None
    except OSError:
        return None


def _gpu() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_QUERY}",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def snapshot() -> Dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"stat": _cpu_times(), "user": ru.ru_utime, "sys": ru.ru_stime,
            "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw, "threads": _threads(),
            "mhz": _mhz(), "gpu": _gpu(), "affinity": sorted(os.sched_getaffinity(0))}


def report(a: Dict, b: Dict, wall_s: float) -> Dict:
    """The window's host readings from snapshots ``a`` (before) and ``b`` (after)."""
    out = {"wall_s": round(wall_s, 3), "cpu_user_s": round(b["user"] - a["user"], 3),
           "cpu_sys_s": round(b["sys"] - a["sys"], 3),
           "ctx_voluntary": b["nvcsw"] - a["nvcsw"], "ctx_involuntary": b["nivcsw"] - a["nivcsw"],
           "cores": len(a["affinity"]), "mhz": [a["mhz"], b["mhz"]], "gpu": [a["gpu"], b["gpu"]]}
    if a["stat"] and b["stat"]:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        total = sum(d) or 1
        # user nice system idle iowait irq softirq steal ...
        out["machine_steal"] = round(d[7] / total, 4) if len(d) > 7 else None
        out["machine_idle"] = round((d[3] + d[4]) / total, 4)
    used = {k: b["threads"][k] - a["threads"].get(k, 0.0) for k in b["threads"]}
    top = sorted(used.items(), key=lambda kv: -kv[1])[:4]
    out["threads"] = len(b["threads"])
    out["busiest_threads_s"] = [[k, round(v, 3)] for k, v in top]
    return out
