"""Newline-delimited JSON wire protocol for the isolation worker.

One JSON object per line, ``{"type": <str>, ...payload}``. Requests flow
parent → worker; responses worker → parent. CANCEL is one-way and may
arrive while a GENERATE is in flight (the worker's reader thread routes
it around the blocking command queue). Waveforms are exchanged as file
paths, never as payload bytes, which keeps frames tiny and the protocol
debuggable with a text editor.

The port's own copy of ``rho_tts_tpu/isolation/protocol.py``: the same
frame types, version and bytes (key order, compact separators), so a
parent of either package can talk to a worker of the other.
"""

from __future__ import annotations

import json
from typing import Any

PROTOCOL_VERSION = 1

# Requests (parent → worker)
INIT = "init"
GENERATE = "generate"
STREAM = "stream"
CANCEL = "cancel"
SHUTDOWN = "shutdown"
PING = "ping"

REQUEST_TYPES = frozenset({INIT, GENERATE, STREAM, CANCEL, SHUTDOWN, PING})

# Responses (worker → parent)
READY = "ready"
RESULT = "result"
SEGMENT_RESULT = "segment_result"
ERROR = "error"
CANCELLED = "cancelled"
PONG = "pong"

RESPONSE_TYPES = frozenset({READY, RESULT, SEGMENT_RESULT, ERROR, CANCELLED, PONG})


class MessageError(ValueError):
    """A frame failed to parse or carried no type."""


def encode_message(msg_type: str, **payload: Any) -> str:
    """Serialize one message as a compact JSON line (newline included)."""
    return json.dumps({"type": msg_type, **payload}, separators=(",", ":")) + "\n"


def decode_message(line: str) -> dict:
    """Parse one JSON line into a message dict.

    Raises:
        MessageError: on malformed JSON or a frame without a ``type``.
    """
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as exc:
        raise MessageError(f"Malformed protocol frame: {exc}") from exc
    if not isinstance(msg, dict) or "type" not in msg:
        raise MessageError(f"Protocol frame missing 'type': {line[:120]!r}")
    return msg
