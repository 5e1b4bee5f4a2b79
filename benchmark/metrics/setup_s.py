"""Set-up: from the process's start to the window's (loading, weights, warm-up)."""

UNIT = "s"


def read(record):
    return record["setup_s"]
