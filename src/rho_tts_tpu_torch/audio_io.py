"""Host-side audio I/O: WAV read/write and format conversion.

WAVs are written by the standard library's ``wave`` module, with the same
bytes as the JAX package's ``audio_io`` for the same samples. A waveform
tensor on the device is fetched to the host once, as float32, and
converted to int16 there. Compressed formats
(mp3/flac/ogg) are encoded by invoking ``ffmpeg`` directly.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from typing import Tuple

import numpy as np
import torch

from .exceptions import FormatConversionError

SUPPORTED_FORMATS = {"wav", "mp3", "flac", "ogg"}

_FFMPEG_CODECS = {
    "mp3": ["-codec:a", "libmp3lame", "-qscale:a", "2"],
    "flac": ["-codec:a", "flac"],
    "ogg": ["-codec:a", "libvorbis", "-qscale:a", "5"],
}


def _to_int16(audio: np.ndarray) -> np.ndarray:
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)


def to_host(audio) -> np.ndarray:
    """A waveform (tensor on any device, or array-like) as host float32 (N,)."""
    if isinstance(audio, torch.Tensor):
        return audio.detach().to(torch.float32).cpu().numpy().reshape(-1)
    return np.asarray(audio, dtype=np.float32).reshape(-1)


def save_wav(path: str, audio, sample_rate: int) -> None:
    """Save a mono waveform (values in [-1, 1]) as 16-bit PCM WAV."""
    pcm = _to_int16(to_host(audio))
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm.tobytes())


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Load a WAV file as a mono float32 waveform in [-1, 1].

    Supports 16-bit, 24-bit, 32-bit PCM and 32-bit float WAVs. Multi-channel
    audio is averaged down to mono.
    """
    with wave.open(path, "rb") as wf:
        n_channels = wf.getnchannels()
        sampwidth = wf.getsampwidth()
        sample_rate = wf.getframerate()
        n_frames = wf.getnframes()
        raw = wf.readframes(n_frames)

    if sampwidth == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif sampwidth == 4:
        # Heuristic: WAVE_FORMAT_IEEE_FLOAT is not distinguishable via the
        # wave module; treat as int32 PCM (the common case for wave-written
        # files) unless values look like IEEE floats.
        ints = np.frombuffer(raw, dtype=np.int32)
        floats = np.frombuffer(raw, dtype=np.float32)
        if np.all(np.isfinite(floats)) and floats.size and np.abs(floats).max() <= 4.0:
            data = floats.astype(np.float32)
        else:
            data = ints.astype(np.float32) / 2147483648.0
    elif sampwidth == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    elif sampwidth == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, sample_rate


def _find_ffmpeg() -> str:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise FormatConversionError(
            "ffmpeg is required for mp3/flac/ogg conversion but was not found on PATH."
        )
    return ffmpeg


def convert_format(wav_path: str, target_format: str) -> str:
    """Convert a WAV file to mp3/flac/ogg via ffmpeg.

    The original WAV is removed on success; the converted path is returned.

    Raises:
        FormatConversionError: for unsupported formats or encode failures.
    """
    if target_format not in _FFMPEG_CODECS:
        raise FormatConversionError(
            f"Unsupported target format '{target_format}'. "
            f"Supported: {', '.join(sorted(SUPPORTED_FORMATS))}"
        )
    ffmpeg = _find_ffmpeg()
    converted_path = wav_path.rsplit(".", 1)[0] + f".{target_format}"
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-i", wav_path]
    cmd += _FFMPEG_CODECS[target_format]
    cmd += [converted_path]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except Exception as exc:  # noqa: BLE001 — wrap every failure uniformly
        raise FormatConversionError(f"Failed to convert to {target_format}: {exc}")
    if proc.returncode != 0:
        raise FormatConversionError(
            f"Failed to convert to {target_format}: {proc.stderr.strip()[-500:]}"
        )
    os.remove(wav_path)
    return converted_path
