"""GE2E-class speaker encoder in PyTorch.

Counterpart of ``rho_tts_tpu/models/speaker/encoder.py``:

  16 kHz mono → volume normalization → energy VAD trim → 40 log-mels
  (25 ms / 10 ms) → 3-layer LSTM(256) → linear + ReLU → L2 normalize.

The parameters keep the JAX tree and its layout (``lstm[i].{w_ih (D, 4H),
w_hh (H, 4H), bias (4H,)}``, ``proj (H, E)``, ``proj_bias``), so a JAX tree
crosses through ``from_jax.params_from_numpy`` unchanged. The LSTM runs as
a loop of float32 matmuls with the gate order i, f, g, o, not as
``nn.LSTM``: cuDNN's RNNs may use TF32 under PyTorch's default
``torch.backends.cudnn.allow_tf32``, while float32 matmuls do not unless
the caller turns on ``torch.backends.cuda.matmul.allow_tf32``.

Utterance embeddings average overlapping 160-frame partial windows, all
batched into one forward pass.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ...ops import spectral
from ...ops.features import device_constant
from ...ops.resample import resample
from ...utils import prng

Params = Dict[str, Any]

SAMPLE_RATE = 16000
N_MELS = 40
WIN_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
# resemblyzer passes n_fft = win_length = 400 (25 ms) to librosa's
# melspectrogram, not the next power of two.
N_FFT = 400
HIDDEN = 256
LAYERS = 3
EMBED = 256
PARTIAL_FRAMES = 160
TARGET_DBFS = -30.0
VAD_WINDOW_MS = 30
VAD_THRESHOLD_DB = -40.0


def init_params(key: torch.Tensor, input_dim: int = N_MELS, device=None) -> Params:
    """The JAX package's random init bit for bit: the same ``jax.random``
    splits and uniform draws from a threefry key ``(2,)`` (``utils.prng``)."""
    key = torch.as_tensor(key, dtype=torch.int64)
    key = key.to(device) if device is not None else key
    params: Params = {"lstm": []}
    dims = [input_dim] + [HIDDEN] * LAYERS
    keys = prng.split(key, LAYERS + 1)
    scale = 1.0 / np.sqrt(HIDDEN)
    for layer in range(LAYERS):
        k1, k2 = prng.split(keys[layer], 2)
        params["lstm"].append({
            "w_ih": prng.uniform(k1, (dims[layer], 4 * HIDDEN), -scale, scale),
            "w_hh": prng.uniform(k2, (HIDDEN, 4 * HIDDEN), -scale, scale),
            "bias": torch.zeros(4 * HIDDEN, device=key.device),
        })
    params["proj"] = prng.uniform(keys[-1], (HIDDEN, EMBED), -0.05, 0.05)
    params["proj_bias"] = torch.zeros(EMBED, device=key.device)
    return params


def load_pretrained(path: str, device=None) -> Params:
    """Convert a pretrained GE2E checkpoint into this module's layout.

    Accepts the resemblyzer ``pretrained.pt`` format (torch state dict,
    possibly wrapped as ``{"model_state": ...}``) or an ``.npz`` with the
    same key names. Torch LSTM tensors are ``weight_ih_l{k}`` (4H, D) /
    ``weight_hh_l{k}`` (4H, H) with i,f,g,o gate order and two bias
    vectors that sum; the final ``linear`` is (E, H) + bias.
    """
    if path.endswith(".npz"):
        with np.load(path) as z:
            state = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in z.items()}
    else:
        from ..hf_weights import read_torch_state

        state = read_torch_state(path)
    if not state:
        raise FileNotFoundError(f"No speaker-encoder weights at {path}")

    dev = torch.device(device or "cpu")
    params: Params = {"lstm": []}
    for layer in range(LAYERS):
        w_ih = state[f"lstm.weight_ih_l{layer}"].float()  # (4H, D)
        w_hh = state[f"lstm.weight_hh_l{layer}"].float()  # (4H, H)
        bias = torch.zeros(w_ih.shape[0])
        for name in (f"lstm.bias_ih_l{layer}", f"lstm.bias_hh_l{layer}"):
            if name in state:
                bias = bias + state[name].float()
        params["lstm"].append({"w_ih": w_ih.T.contiguous().to(dev),
                               "w_hh": w_hh.T.contiguous().to(dev), "bias": bias.to(dev)})
    proj = state["linear.weight"].float()  # (E, H)
    params["proj"] = proj.T.contiguous().to(dev)
    bias = state.get("linear.bias")
    params["proj_bias"] = (bias.float() if bias is not None else torch.zeros(proj.shape[0])).to(dev)
    return params


def _lstm_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) → (B, T, H). Gate order i, f, g, o (torch convention)."""
    b, t, _ = x.shape
    x_proj = x @ p["w_ih"] + p["bias"]  # (B, T, 4H): one matmul for every step
    h = x.new_zeros((b, HIDDEN))
    c = x.new_zeros((b, HIDDEN))
    hs = []
    for step in range(t):
        gates = x_proj[:, step] + h @ p["w_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _forward(params: Params, mels: torch.Tensor) -> torch.Tensor:
    """mels: (B, T, n_mels) → L2-normalized embeddings (B, EMBED)."""
    x = mels
    for layer_params in params["lstm"]:
        x = _lstm_layer(layer_params, x)
    e = torch.relu(x[:, -1] @ params["proj"] + params["proj_bias"])
    return e / torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True), 1e-8)


def _forward_windows(params: Params, mels: torch.Tensor, starts: torch.Tensor,
                     win_valid: torch.Tensor) -> torch.Tensor:
    """Utterance embeddings from per-utterance partial windows, batched.

    mels: (B, T, n_mels), zero-masked past each utterance's valid frames.
    starts: (B, Nw) window offsets (padded entries may repeat).
    win_valid: (B, Nw) bool — which windows belong to each utterance.
    Returns (B, EMBED): masked mean of the window embeddings, renormalized
    (same math as :meth:`SpeakerEncoder.embed_utterance`).
    """
    b, nw = starts.shape
    idx = torch.clamp(starts[:, :, None]
                      + torch.arange(PARTIAL_FRAMES, device=mels.device)[None, None, :],
                      0, mels.shape[1] - 1)  # (B, Nw, P)
    win = mels[torch.arange(b, device=mels.device)[:, None, None], idx]  # (B, Nw, P, M)
    e = _forward(params, win.reshape(b * nw, PARTIAL_FRAMES, mels.shape[-1])).reshape(b, nw, -1)
    w = win_valid.to(torch.float32)[..., None]
    mean = (e * w).sum(dim=1) / torch.clamp_min(w.sum(dim=1), 1.0)
    return mean / torch.clamp_min(torch.linalg.vector_norm(mean, dim=-1, keepdim=True), 1e-8)


def log_mel(wav: torch.Tensor) -> torch.Tensor:
    """(..., S) 16 kHz waveforms → (..., T, 40) log-mel frames.

    librosa's melspectrogram defaults, as resemblyzer calls it: periodic
    Hann, centred constant (zero) padding on librosa>=0.10.
    """
    wav = torch.as_tensor(wav).to(torch.float32)
    dev = str(wav.device)
    window = device_constant("hann", dev, WIN_LENGTH)
    spec = spectral.stft(wav, N_FFT, HOP_LENGTH, WIN_LENGTH, window, center=True,
                         pad_mode="constant")
    mels = torch.matmul(device_constant("mel", dev, SAMPLE_RATE, N_FFT, N_MELS),
                        spec.abs() ** 2)  # (..., n_mels, T)
    return torch.log(torch.clamp_min(mels, 1e-10)).transpose(-1, -2)


def preprocess(wav, source_sr: int) -> np.ndarray:
    """Resample to 16 kHz, normalize volume to -30 dBFS, trim silence (host numpy)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if source_sr != SAMPLE_RATE:
        wav = resample(torch.from_numpy(wav), source_sr, SAMPLE_RATE).numpy()
    if wav.size == 0:
        return wav
    # Volume normalization
    rms = np.sqrt(np.mean(wav**2))
    if rms > 1e-8:
        target = 10 ** (TARGET_DBFS / 20)
        wav = wav * (target / rms)
    # Energy VAD: drop frames below threshold (moving RMS over 30 ms)
    win = int(SAMPLE_RATE * VAD_WINDOW_MS / 1000)
    if wav.size > win:
        n = (wav.size // win) * win
        frames = wav[:n].reshape(-1, win)
        frame_rms = np.sqrt(np.mean(frames**2, axis=1))
        voiced = frame_rms > 10 ** (VAD_THRESHOLD_DB / 20)
        # Dilate the voiced mask by one frame each side (smooth transitions)
        voiced = np.convolve(voiced.astype(np.float32), np.ones(3), "same") > 0
        if voiced.any():
            wav = np.concatenate([frames[voiced].reshape(-1), wav[n:]])
    return wav


class SpeakerEncoder:
    """Utterance-level speaker embedding extractor on ``device``.

    Weight resolution order: explicit ``params`` → explicit
    ``weights_path`` → ``RHO_TTS_TPU_SPEAKER_WEIGHTS`` env var → random
    init from ``seed`` (the JAX package's draw, bit for bit).
    """

    def __init__(self, params: Optional[Params] = None, seed: int = 0,
                 weights_path: Optional[str] = None, device: str = "cuda"):
        self.device = torch.device(device)
        if params is None:
            path = weights_path or os.environ.get("RHO_TTS_TPU_SPEAKER_WEIGHTS")
            if path:
                params = load_pretrained(path, device=self.device)
            else:
                params = init_params(prng.PRNGKey(seed, device=self.device))
        self.params = params

    def embed_utterance(self, wav, source_sr: int) -> np.ndarray:
        """Embed one utterance: mean of partial-window embeddings, renormed.

        The volume normalization and VAD run on the host (a tensor is
        fetched first), the log-mels and the LSTM on the encoder's device.
        """
        if isinstance(wav, torch.Tensor):
            wav = wav.detach().cpu().numpy()
        wav = preprocess(wav, source_sr)
        mels = log_mel(torch.from_numpy(wav).to(self.device))
        t = mels.shape[0]
        if t < PARTIAL_FRAMES:
            mels = torch.nn.functional.pad(mels, (0, 0, 0, PARTIAL_FRAMES - t))
            t = PARTIAL_FRAMES
        # 50%-overlap partial windows, batched into one forward pass
        starts = list(range(0, max(t - PARTIAL_FRAMES, 0) + 1, PARTIAL_FRAMES // 2)) or [0]
        batch = torch.stack([mels[s: s + PARTIAL_FRAMES] for s in starts])
        with torch.inference_mode():
            mean = _forward(self.params, batch).mean(dim=0)
        mean = mean.cpu().numpy()
        return mean / max(np.linalg.norm(mean), 1e-8)

    def embed_batch(self, wavs, source_srs) -> np.ndarray:
        """Embed several utterances (host loop; partials batched per wav)."""
        return np.stack([self.embed_utterance(w, sr) for w, sr in zip(wavs, source_srs)])
