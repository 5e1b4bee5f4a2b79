"""95th percentile of the requests' wait in the engine's queue:
``t_admit - t_submit`` (the program's host stamps), over every request due in
the window; one never admitted counts to the drain deadline. In a traced run,
over the requests submitted before the profiled stretch began, each wait cut
there: the profiler's stop stalls the engine."""

from benchmark.stats import p95

UNIT = "s"


def read(record):
    if record.get("kind") != "serve":
        return None
    cut = record.get("cut", {}).get("t")
    end = cut if cut is not None else record["deadline"]
    waits = []
    for r in record["requests"]:
        if r["t_submit"] >= end:
            continue
        admit = r["t_admit"] if r["t_admit"] is not None else end
        waits.append(min(admit, end) - r["t_submit"])
    return p95(waits)
