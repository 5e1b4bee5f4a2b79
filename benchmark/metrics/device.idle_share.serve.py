"""Share of the traced serving dispatch (host start to last device
operation's end) in which no device operation ran."""

from benchmark.stats import stretch

UNIT = "%"


def read(record):
    st = stretch(record, "serve_dispatch")
    if st is None or st["window_ns"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_ns"] / st["window_ns"])
