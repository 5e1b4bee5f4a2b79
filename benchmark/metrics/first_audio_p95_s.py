"""95th percentile, over every request due in the window, of the time from its
due time to the client's receipt (on the host) of its first streamed piece."""

from benchmark.stats import due_times, p95

UNIT = "s"


def read(record):
    if record.get("kind") != "serve":
        return None
    return p95(due_times(record, "t_first"))
