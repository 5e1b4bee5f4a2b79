"""Live rows decoded over the slot batch's capacity: the engine's
``frames_decoded`` over its decode steps (``dispatches`` times its chunk) times
``n_slots``, counted from the window's start to its close, or in a traced run
to the profiled stretch's start (the profiler's stop stalls the engine)."""

UNIT = "%"


def read(record):
    if record.get("kind") != "serve":
        return None
    c = record.get("cut", {}).get("counters") or record["counters_window"]
    steps = c["dispatches"] * record["chunk"]
    return None if steps == 0 else 100.0 * c["frames_decoded"] / (steps * record["n_slots"])
