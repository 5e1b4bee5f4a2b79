"""Seconds of audio from the calls completed in the window, over the wall
seconds from the window's start to the end of the last of them."""

UNIT = "audio_s/s"


def read(record):
    if record.get("kind") != "batch":
        return None
    end = record["t0"] + record["seconds"]
    done = [c for c in record["calls"] if c["t_end"] <= end]
    if not done:
        return None
    return sum(c["audio_s"] for c in done) / (max(c["t_end"] for c in done) - record["t0"])
