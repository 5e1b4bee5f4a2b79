"""Whisper-class speech recognizer in PyTorch.

Counterpart of ``rho_tts_tpu/models/whisper/model.py``: an 80-channel
log-mel frontend → two GELU convs (stride 1, 2) + sinusoidal positions →
pre-norm transformer encoder; a decoder with learned positions, causal
self-attention over a preallocated KV cache and cross-attention onto the
encoder states; logits through the tied token embedding. Sizes follow the
published tiny/base configs; weights load from an HF safetensors directory.

The parameter tree is the JAX package's, except that the conv stem keeps
torch's (Cout, Cin, K) layout (HF's; ``from_jax.params_from_numpy``
converts). The convs and every projection run as float32 matmuls, not
cuDNN convolutions, so PyTorch's default ``cudnn.allow_tf32`` cannot round
them. Attention is plain tensor ops (f32 MHA, head_dim 64 on tiny): none
of the port's kernels (bf16 causal GQA, 128-wide heads) fits it.

Decoding runs a fixed ``max_tokens`` loop, as the JAX scan does: no early
exit and no host wait inside it; the host fetches the (B, max_tokens) ids
once (:data:`fetches`).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...ops import spectral
from ...ops.features import device_constant

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_FRAMES = 3000  # 30 s

#: Host fetches of decoded token ids (one per transcribed batch).
fetches = 0


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = N_MELS
    d_model: int = 384
    encoder_layers: int = 4
    decoder_layers: int = 4
    heads: int = 6
    vocab: int = 51865
    max_target_positions: int = 448
    # special tokens (multilingual vocab)
    sot: int = 50258
    eot: int = 50257
    lang_en: int = 50259
    task_transcribe: int = 50359
    no_timestamps: int = 50363


PRESETS = {
    "tiny": WhisperConfig(),
    "base": WhisperConfig(d_model=512, encoder_layers=6, decoder_layers=6, heads=8),
    "test": WhisperConfig(d_model=64, encoder_layers=2, decoder_layers=2, heads=2, vocab=1000,
                          sot=997, eot=996, lang_en=998, task_transcribe=999, no_timestamps=995,
                          max_target_positions=64),
}


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------


def log_mel_spectrogram(wav: torch.Tensor) -> torch.Tensor:
    """(..., S) 16 kHz waveforms → (..., T, 80) normalized log-mel frames
    (reflect-padded STFT; the last frame dropped, as Whisper does; each
    row clamped 8 decades below its own maximum)."""
    wav = torch.as_tensor(wav).to(torch.float32)
    dev = str(wav.device)
    spec = spectral.stft(wav, N_FFT, HOP, N_FFT, device_constant("hann", dev, N_FFT),
                         center=True, pad_mode="reflect")
    power = (spec.abs() ** 2)[..., :-1]
    mel = torch.matmul(device_constant("mel", dev, SAMPLE_RATE, N_FFT, N_MELS), power)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(-1, -2)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: WhisperConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a seeded generator on ``device``: the JAX init's
    shapes and scales, with a torch generator's values (parity with the JAX
    package goes through ``from_jax.params_from_numpy``)."""
    device = torch.device(device or "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d = cfg.d_model

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * scale

    def zeros(n):
        return torch.zeros(n, device=device)

    def linear(din, dout, bias=True):
        p = {"w": normal((din, dout), 1.0 / np.sqrt(din))}
        if bias:
            p["b"] = zeros(dout)
        return p

    def ln():
        return {"g": torch.ones(d, device=device), "b": zeros(d)}

    def attn():
        return {"q": linear(d, d), "k": linear(d, d, bias=False), "v": linear(d, d),
                "o": linear(d, d)}

    def block(cross: bool):
        p = {"ln1": ln(), "attn": attn(), "ln_mlp": ln(), "mlp1": linear(d, 4 * d),
             "mlp2": linear(4 * d, d)}
        if cross:
            p["ln_cross"] = ln()
            p["cross"] = attn()
        return p

    return {
        "conv1": {"w": normal((d, cfg.n_mels, 3), 0.02), "b": zeros(d)},
        "conv2": {"w": normal((d, d, 3), 0.02), "b": zeros(d)},
        "enc_pos": torch.as_tensor(_sinusoids(CHUNK_FRAMES // 2, d), device=device),
        "enc_blocks": [block(False) for _ in range(cfg.encoder_layers)],
        "enc_ln": ln(),
        "tok_embed": normal((cfg.vocab, d), 0.02),
        "dec_pos": normal((cfg.max_target_positions, d), 0.01),
        "dec_blocks": [block(True) for _ in range(cfg.decoder_layers)],
        "dec_ln": ln(),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ln(p, x):
    return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps=1e-5)


def _linear(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def _conv1d(x: torch.Tensor, p, stride: int = 1) -> torch.Tensor:
    """x (B, T, Cin), w (Cout, Cin, K): ``nn.Conv1d(padding=(K-1)//2)`` as a
    float32 matmul over unfolded frames."""
    w = p["w"]
    cout, cin, k = w.shape
    pad = (k - 1) // 2
    frames = F.pad(x, (0, 0, pad, pad)).unfold(1, k, stride)  # (B, T', Cin, K)
    b, t = frames.shape[:2]
    return frames.reshape(b, t, cin * k) @ w.reshape(cout, cin * k).T + p["b"]


def _mlp(blk, x):
    h = _ln(blk["ln_mlp"], x)
    return _linear(blk["mlp2"], F.gelu(_linear(blk["mlp1"], h)))


def _heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)  # (B, H, T, dh)


def _attend(q, k, v, mask=None):
    """q (B,H,Tq,dh), k/v (B,H,Tk,dh) → (B, Tq, H*dh); scale split over q and k."""
    scale = q.shape[-1] ** -0.25
    scores = (q * scale) @ (k * scale).transpose(-1, -2)
    if mask is not None:
        scores = torch.where(mask, scores, -1e30)
    out = torch.softmax(scores, dim=-1) @ v
    b, h, t, dh = out.shape
    return out.transpose(1, 2).reshape(b, t, h * dh)


def _attention(p, x, heads, kv=None, mask=None):
    """Standard MHA; kv=(K, V) in (B, H, T, dh) overrides self-attention."""
    q = _heads(_linear(p["q"], x), heads)
    if kv is None:
        kv = (_heads(_linear(p["k"], x), heads), _heads(_linear(p["v"], x), heads))
    return _linear(p["o"], _attend(q, kv[0], kv[1], mask))


def _cross_kv(params: Params, heads: int, enc: torch.Tensor):
    return [(_heads(_linear(blk["cross"]["k"], enc), heads),
             _heads(_linear(blk["cross"]["v"], enc), heads)) for blk in params["dec_blocks"]]


@torch.inference_mode()
def encode(params: Params, cfg: WhisperConfig, mels: torch.Tensor) -> torch.Tensor:
    """mels (B, 3000, 80) → encoder states (B, 1500, d)."""
    x = F.gelu(_conv1d(mels, params["conv1"]))
    x = F.gelu(_conv1d(x, params["conv2"], stride=2))
    x = x + params["enc_pos"][None, : x.shape[1]]
    for blk in params["enc_blocks"]:
        x = x + _attention(blk["attn"], _ln(blk["ln1"], x), cfg.heads)
        x = x + _mlp(blk, x)
    return _ln(params["enc_ln"], x)


@torch.inference_mode()
def decoder_logits(params: Params, cfg: WhisperConfig, enc: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Full (uncached) teacher-forced decoder pass → logits (B, T, vocab).

    The uncached reference of the KV-cached decode, and the surface the
    card is held to against the CPU (logits are robust where argmax ties
    are not).
    """
    t = tokens.shape[1]
    x = params["tok_embed"][tokens] + params["dec_pos"][:t][None]
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    for blk, kv in zip(params["dec_blocks"], _cross_kv(params, cfg.heads, enc)):
        x = x + _attention(blk["attn"], _ln(blk["ln1"], x), cfg.heads, mask=causal)
        x = x + _attention(blk["cross"], _ln(blk["ln_cross"], x), cfg.heads, kv=kv)
        x = x + _mlp(blk, x)
    return _ln(params["dec_ln"], x) @ params["tok_embed"].T


class _Decoder:
    """KV-cached decoder steps over preallocated caches (L, N, H, S, dh)."""

    def __init__(self, params: Params, cfg: WhisperConfig, enc: torch.Tensor, rows: int,
                 length: int):
        self.params, self.heads = params, cfg.heads
        per = rows // enc.shape[0]

        def per_beam(t):  # each encoder row's K/V repeated for its beams
            return t.unsqueeze(1).expand(t.shape[0], per, *t.shape[1:]).reshape(rows,
                                                                                *t.shape[1:])

        self.cross = [(per_beam(k), per_beam(v)) for k, v in _cross_kv(params, cfg.heads, enc)]
        shape = (cfg.decoder_layers, rows, cfg.heads, length, cfg.d_model // cfg.heads)
        self.cache_k = enc.new_zeros(shape)
        self.cache_v = enc.new_zeros(shape)

    def step(self, tokens: torch.Tensor, pos0: int) -> torch.Tensor:
        """tokens (N, T) at positions pos0..pos0+T-1 → last-position logits."""
        p = self.params
        t = tokens.shape[1]
        end = pos0 + t
        # positions past the table read its last row, as JAX's clamped gather does
        pos = torch.arange(pos0, end, device=tokens.device).clamp_max(p["dec_pos"].shape[0] - 1)
        x = p["tok_embed"][tokens] + p["dec_pos"][pos][None]
        mask = None
        if t > 1:  # the prompt pass: causal over the written prefix
            mask = (torch.arange(end, device=x.device)[None, :]
                    <= pos0 + torch.arange(t, device=x.device)[:, None])
        for li, blk in enumerate(p["dec_blocks"]):
            h = _ln(blk["ln1"], x)
            q = _heads(_linear(blk["attn"]["q"], h), self.heads)
            self.cache_k[li, :, :, pos0:end] = _heads(_linear(blk["attn"]["k"], h), self.heads)
            self.cache_v[li, :, :, pos0:end] = _heads(_linear(blk["attn"]["v"], h), self.heads)
            att = _attend(q, self.cache_k[li, :, :, :end], self.cache_v[li, :, :, :end], mask)
            x = x + _linear(blk["attn"]["o"], att)
            x = x + _attention(blk["cross"], _ln(blk["ln_cross"], x), self.heads,
                               kv=self.cross[li])
            x = x + _mlp(blk, x)
        return _ln(p["dec_ln"], x[:, -1]) @ p["tok_embed"].T

    def reorder(self, rows: torch.Tensor) -> None:
        """Keep cache rows ``rows`` (each survivor takes its parent's cache)."""
        self.cache_k = self.cache_k.index_select(1, rows)
        self.cache_v = self.cache_v.index_select(1, rows)


def _prompt_tokens(prompt: List[int], rows: int, device) -> torch.Tensor:
    """(rows, P) prompt ids made by fills (no upload from host memory)."""
    one = torch.stack([torch.full((), int(t), dtype=torch.int64, device=device) for t in prompt])
    return one[None].expand(rows, -1)


@torch.inference_mode()
def greedy_decode(params: Params, cfg: WhisperConfig, enc: torch.Tensor, prompt: List[int],
                  max_tokens: int) -> torch.Tensor:
    """Greedy decode over the KV cache, ``max_tokens`` fixed steps.
    Returns (B, max_tokens) on the device; EOT repeats after the first."""
    b = enc.shape[0]
    p_len = len(prompt)
    dec = _Decoder(params, cfg, enc, b, p_len + max_tokens)
    tok = torch.argmax(dec.step(_prompt_tokens(prompt, b, enc.device), 0), dim=-1)
    done = tok == cfg.eot
    out = torch.empty((b, max_tokens), dtype=torch.int64, device=enc.device)
    for t in range(max_tokens):
        out[:, t] = tok
        if t + 1 == max_tokens:
            break  # the next token would not be returned
        nxt = torch.argmax(dec.step(tok[:, None], p_len + t), dim=-1)
        nxt = torch.where(done, cfg.eot, nxt)
        done = done | (nxt == cfg.eot)
        tok = nxt
    return out


def _top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_decode(params: Params, cfg: WhisperConfig, enc: torch.Tensor, prompt: List[int],
                max_tokens: int, beams: int = 5) -> torch.Tensor:
    """Batched beam search, ``max_tokens`` fixed steps. Returns (B, max_tokens).

    The JAX package's algorithm: the K beams fold into the batch (B*K
    rows), each step takes the top K of the K*V candidate scores per
    batch element, reorders the KV cache rows by the survivors' parents and
    records (token, parent); finished beams ride along frozen (their only
    continuation is EOT at logprob 0). The best length-normalized beam is
    backtracked on the device.
    """
    b, k = enc.shape[0], beams
    bk = b * k
    v = params["tok_embed"].shape[0]
    p_len = len(prompt)
    dev = enc.device
    dec = _Decoder(params, cfg, enc, bk, p_len + max_tokens)

    logits = dec.step(_prompt_tokens(prompt, bk, dev), 0)
    logprobs0 = torch.log_softmax(logits.reshape(b, k, v)[:, 0], dim=-1)  # (B, V)
    cum, tok0 = _top_k_stable(logprobs0, k)  # K distinct first tokens
    done = tok0 == cfg.eot
    tok = tok0
    # a finished beam's only continuation: EOT at logprob 0 (an indexed
    # store of a Python number would upload it from the host)
    frozen = torch.where(torch.arange(v, device=dev) == cfg.eot, 0.0, -torch.inf)
    base = (torch.arange(b, device=dev) * k)[:, None]
    toks_seq = torch.empty((max_tokens - 1, b, k), dtype=torch.int64, device=dev)
    parents_seq = torch.empty_like(toks_seq)
    for t in range(max_tokens - 1):
        lp = torch.log_softmax(dec.step(tok.reshape(bk, 1), p_len + t), dim=-1).reshape(b, k, v)
        lp = torch.where(done[..., None], frozen, lp)
        cum, flat = _top_k_stable((cum[..., None] + lp).reshape(b, k * v), k)
        parent = flat // v
        tok = flat % v
        dec.reorder((base + parent).reshape(-1))
        done = torch.gather(done, 1, parent) | (tok == cfg.eot)
        toks_seq[t], parents_seq[t] = tok, parent

    # Backtrack every final beam at once; score by length-normalized cum.
    idx = torch.arange(k, device=dev)[None, :].expand(b, k)
    seqs = torch.empty((b, k, max_tokens), dtype=torch.int64, device=dev)
    for t in range(max_tokens - 2, -1, -1):
        seqs[..., t + 1] = torch.gather(toks_seq[t], 1, idx)
        idx = torch.gather(parents_seq[t], 1, idx)
    seqs[..., 0] = torch.gather(tok0, 1, idx)  # idx: each chain's root beam
    lens = (seqs != cfg.eot).sum(dim=-1).to(torch.float32)
    best = torch.argmax(cum / torch.clamp_min(lens, 1.0), dim=1)  # the first maximum
    return torch.gather(seqs, 1, best[:, None, None].expand(b, 1, max_tokens))[:, 0]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class WhisperModel:
    def __init__(self, cfg: WhisperConfig, params: Optional[Params] = None, seed: int = 0,
                 device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = params if params is not None else init_params(cfg, seed, self.device)

    @property
    def prompt(self) -> List[int]:
        c = self.cfg
        return [c.sot, c.lang_en, c.task_transcribe, c.no_timestamps]

    def transcribe_tokens(self, wav, max_tokens: int = 128, beam_size: int = 1) -> np.ndarray:
        """(S,) 16 kHz waveform → token ids (max_tokens,)."""
        return self.transcribe_tokens_batch([wav], max_tokens, beam_size)[0]

    def tokens_on_device(self, wavs, max_tokens: int = 128, beam_size: int = 1) -> torch.Tensor:
        """16 kHz waveforms → token ids (B, max_tokens) on the device: one
        mel / encode / decode pass for the batch, nothing fetched. Each clip
        is cut or zero-padded to the 30 s window."""
        n = CHUNK_FRAMES * HOP
        rows = [torch.as_tensor(w).to(device=self.device, dtype=torch.float32).reshape(-1)[:n]
                for w in wavs]
        batch = torch.stack([F.pad(w, (0, n - w.shape[0])) for w in rows])
        with torch.inference_mode():
            mels = log_mel_spectrogram(batch)[:, :CHUNK_FRAMES]
            enc = encode(self.params, self.cfg, mels)
            if beam_size > 1:
                return beam_decode(self.params, self.cfg, enc, self.prompt, max_tokens,
                                   beam_size)
            return greedy_decode(self.params, self.cfg, enc, self.prompt, max_tokens)

    def transcribe_tokens_batch(self, wavs, max_tokens: int = 128,
                                beam_size: int = 1) -> np.ndarray:
        """List of 16 kHz waveforms → token ids (B, max_tokens) on the host
        (one fetch). ``beam_size>1`` switches to batched beam search."""
        global fetches
        toks = self.tokens_on_device(wavs, max_tokens, beam_size)
        fetches += 1
        return toks.cpu().numpy()


class FallbackTokenizer:
    """Deterministic id→printable-text mapping for checkpoint-less hosts.

    The real Whisper vocabulary ships with a checkpoint; the fallback keeps
    the full STT gate executable (mel → encode → cached decode → detokenize
    → normalize → fuzzy match) with the same device compute.
    """

    _ALPHABET = "abcdefghijklmnopqrstuvwxyz "

    def decode(self, ids) -> str:
        return "".join(self._ALPHABET[int(i) % len(self._ALPHABET)] for i in ids)


class WhisperTranscriber:
    """Transcription facade with checkpoint + tokenizer management."""

    def __init__(self, model: WhisperModel, tokenizer=None, has_real_weights: bool = False):
        self.model = model
        self.has_real_tokenizer = tokenizer is not None
        self.tokenizer = tokenizer if tokenizer is not None else FallbackTokenizer()
        self.has_real_weights = has_real_weights

    @classmethod
    def from_pretrained(cls, model_path: str, device: str = "cuda") -> "WhisperTranscriber":
        """The preset is the longest preset name in the path's basename
        (``tiny`` by default); a directory's HF safetensors and
        ``tokenizer.json`` load when present, else random weights."""
        cfg = PRESETS.get("tiny")
        base = os.path.basename(os.path.normpath(str(model_path))).lower()
        matches = [n for n in PRESETS if n in base]
        if matches:
            cfg = PRESETS[max(matches, key=len)]
        params = None
        tokenizer = None
        if os.path.isdir(model_path):
            try:
                params = _load_hf_checkpoint(model_path, cfg, device)
            except Exception as e:  # noqa: BLE001
                logger.warning("Whisper checkpoint load failed: %s", e)
            tok_file = os.path.join(model_path, "tokenizer.json")
            if os.path.exists(tok_file):
                try:
                    from tokenizers import Tokenizer

                    tokenizer = Tokenizer.from_file(tok_file)
                except Exception:  # noqa: BLE001
                    pass
        model = WhisperModel(cfg, params=params, device=device)
        return cls(model, tokenizer, has_real_weights=params is not None)

    def transcribe(self, wav, sample_rate: int) -> str:
        return self.transcribe_batch([wav], [sample_rate])[0]

    def prepare(self, wavs, sample_rates) -> List[torch.Tensor]:
        """Clips at 16 kHz on the model's device, each in the 30 s window:
        one batched resample per source rate, nothing fetched."""
        from ...ops.resample import resample_batch

        n16 = CHUNK_FRAMES * HOP  # 30 s at 16 kHz
        dev = self.model.device
        bysr: dict = {}
        for i, sr in enumerate(sample_rates):
            bysr.setdefault(int(sr), []).append(i)
        prepped: list = [None] * len(wavs)
        for sr, idxs in bysr.items():
            g = math.gcd(sr, SAMPLE_RATE)
            n_src = n16 * (sr // g) // (SAMPLE_RATE // g)  # full-window source samples
            rows = [torch.as_tensor(wavs[i]).to(device=dev, dtype=torch.float32)
                    .reshape(-1)[:n_src] for i in idxs]
            stacked = torch.stack([F.pad(w, (0, n_src - w.shape[0])) for w in rows])
            res = resample_batch(stacked, sr, SAMPLE_RATE, n16)
            for j, i in enumerate(idxs):
                prepped[i] = res[j]
        return prepped

    def transcribe_batch(self, wavs, sample_rates) -> list:
        """Transcribe several clips in one batched device pass; the host
        fetches only the (B, max_tokens) ids.

        Beam 5 by default, the reference's faster-whisper default;
        ``RHO_TTS_TPU_STT_BEAM=1`` selects greedy decoding.
        """
        beam = int(os.environ.get("RHO_TTS_TPU_STT_BEAM", "5"))
        toks_batch = self.model.transcribe_tokens_batch(self.prepare(wavs, sample_rates),
                                                        beam_size=beam)
        out = []
        for toks in toks_batch:
            ids = [int(t) for t in toks if int(t) < self.model.cfg.eot]
            out.append(self.tokenizer.decode(ids))
        return out


def _load_hf_checkpoint(model_path: str, cfg: WhisperConfig, device="cuda") -> Optional[Params]:
    """HF whisper safetensors in this module's layout, on ``device``."""
    from ..hf_weights import read_safetensors

    t = read_safetensors(model_path)
    if t is None:
        return None
    dev = torch.device(device)

    def g(name, transpose=False):
        for pfx in ("model.", ""):
            if pfx + name in t:
                x = t[pfx + name].to(torch.float32)
                return (x.T if transpose else x).contiguous().to(dev)
        raise KeyError(name)

    def attn(prefix):
        return {
            "q": {"w": g(f"{prefix}.q_proj.weight", True), "b": g(f"{prefix}.q_proj.bias")},
            "k": {"w": g(f"{prefix}.k_proj.weight", True)},
            "v": {"w": g(f"{prefix}.v_proj.weight", True), "b": g(f"{prefix}.v_proj.bias")},
            "o": {"w": g(f"{prefix}.out_proj.weight", True),
                  "b": g(f"{prefix}.out_proj.bias")},
        }

    def ln(prefix):
        return {"g": g(f"{prefix}.weight"), "b": g(f"{prefix}.bias")}

    def mlp(p):
        return {"mlp1": {"w": g(f"{p}.fc1.weight", True), "b": g(f"{p}.fc1.bias")},
                "mlp2": {"w": g(f"{p}.fc2.weight", True), "b": g(f"{p}.fc2.bias")}}

    params: Params = {
        # convs: HF (out, in, k), this module's layout as well
        "conv1": {"w": g("encoder.conv1.weight"), "b": g("encoder.conv1.bias")},
        "conv2": {"w": g("encoder.conv2.weight"), "b": g("encoder.conv2.bias")},
        "enc_pos": g("encoder.embed_positions.weight"),
        "tok_embed": g("decoder.embed_tokens.weight"),
        "dec_pos": g("decoder.embed_positions.weight"),
        "enc_blocks": [
            {"ln1": ln(f"encoder.layers.{i}.self_attn_layer_norm"),
             "attn": attn(f"encoder.layers.{i}.self_attn"),
             "ln_mlp": ln(f"encoder.layers.{i}.final_layer_norm"),
             **mlp(f"encoder.layers.{i}")}
            for i in range(cfg.encoder_layers)
        ],
        "dec_blocks": [
            {"ln1": ln(f"decoder.layers.{i}.self_attn_layer_norm"),
             "attn": attn(f"decoder.layers.{i}.self_attn"),
             "ln_cross": ln(f"decoder.layers.{i}.encoder_attn_layer_norm"),
             "cross": attn(f"decoder.layers.{i}.encoder_attn"),
             "ln_mlp": ln(f"decoder.layers.{i}.final_layer_norm"),
             **mlp(f"decoder.layers.{i}")}
            for i in range(cfg.decoder_layers)
        ],
        "enc_ln": ln("encoder.layer_norm"),
        "dec_ln": ln("decoder.layer_norm"),
    }
    logger.info("Loaded Whisper weights from %s", model_path)
    return params
