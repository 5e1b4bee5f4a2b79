"""Plain reference of the Qwen-class codec-LM TTS model, in float32.

It follows the model the benchmark's configuration files describe (a
decoder-only talker over text and audio-code embeddings, a residual code
predictor of one two-layer MLP per residual codebook, and an RVQ codec
decoder of transposed convolutions and dilated residual blocks), written as
straightforward PyTorch: one causal forward over the whole sequence, no KV
cache, no batching, no kernels. It imports nothing of the program under
test, and it takes only the inputs the benchmark made (weights in the
layout ``benchmark/weights.py`` builds, texts, speakers) and the program's
outputs, which it judges.

Everything here runs in float32 with TF32 off (``run_float32``), one
sequence at a time and one layer at a time, so that it fits beside nothing
on the card once the program's state is freed.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

#: named speakers of the CustomVoice checkpoints (row of the speaker table)
SPEAKERS = ["Chelsie", "Aidan", "Vivian", "Ryan", "Aria", "Ethan", "Luna", "Harper", "James"]
#: the byte tokenizer's first id after its three specials
BYTE_OFFSET = 3
LANGUAGE = "English"


@contextlib.contextmanager
def run_float32():
    """Full float32 matmuls and convolutions: TF32 off for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Prompt
# ---------------------------------------------------------------------------


def text_ids(text: str) -> List[int]:
    """The byte tokenizer: UTF-8 bytes past the specials, after the language tag."""
    return [b + BYTE_OFFSET for b in f"{LANGUAGE}: {text}".encode("utf-8")]


def prompt_length(text: str) -> int:
    """Tokens of one prompt: the speaker slot, the text, the BOS frame."""
    return 1 + len(text_ids(text)) + 1


def speaker_row(speaker: str) -> int:
    if speaker not in SPEAKERS:
        raise ValueError(f"unknown speaker {speaker!r}")
    return SPEAKERS.index(speaker)


def audio_bos(cfg: Dict) -> int:
    return cfg["codec"]["codebook_size"]


def audio_eos(cfg: Dict) -> int:
    return cfg["codec"]["codebook_size"] + 1


def prompt_embeds(params: Dict, cfg: Dict, text: str, speaker: str) -> torch.Tensor:
    """``(n, hidden)`` f32: speaker row, text rows, the BOS code's row."""
    ids = torch.tensor(text_ids(text), device=params["text_embed"].device)
    spk = params["speaker_embed"][speaker_row(speaker)].float()
    txt = params["text_embed"][ids].float()
    bos = params["audio_embed"][0][audio_bos(cfg)].float()
    return torch.cat([spk[None], txt, bos[None]], dim=0)


def code_embeds(params: Dict, codes: torch.Tensor) -> torch.Tensor:
    """``(T, nq)`` codes -> ``(T, hidden)`` f32: the sum of the codebooks' rows."""
    table = params["audio_embed"]
    out = table[0][codes[:, 0]].float()
    for q in range(1, codes.shape[1]):
        out = out + table[q][codes[:, q]].float()
    return out


# ---------------------------------------------------------------------------
# Talker
# ---------------------------------------------------------------------------


def dequantize(w: torch.Tensor, quantization: Optional[str]) -> torch.Tensor:
    """The weight the served model multiplies by, as f32.

    ``int8``: symmetric per output channel, ``s = max(absmax over the input
    axis, 1e-8) / 127``, values ``round(w / s)`` (half to even) clipped to
    [-127, 127]. ``int4``: the same with 7. Anything else: ``w`` itself.
    """
    wf = w.float()
    levels = {"int8": 127.0, "int4": 7.0}.get(quantization or "none")
    if levels is None:
        return wf
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / levels
    return torch.round(wf / scale).clamp(-levels, levels) * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the two halves of each head: ``x`` ``(T, H, D)``, ``pos`` ``(T,)``."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d))
    ang = pos[:, None].double() * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def talker_hidden(params: Dict, cfg: Dict, x: torch.Tensor,
                  quantization: Optional[str]) -> torch.Tensor:
    """Causal forward of the talker over one whole sequence ``x`` ``(T, hidden)``.

    Positions are 0..T-1. Returns the final-normed hidden states ``(T, hidden)``.
    """
    t_cfg = cfg["talker"]
    hq, hkv, d = t_cfg["q_heads"], t_cfg["kv_heads"], t_cfg["head_dim"]
    eps, theta = t_cfg["rms_eps"], t_cfg["rope_theta"]
    blocks = params["talker"]["blocks"]
    t = x.shape[0]
    pos = torch.arange(t, device=x.device)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    for layer in range(t_cfg["layers"]):
        def w(name):
            return dequantize(blocks[name][layer], quantization)

        h = rms_norm(x, blocks["attn_norm"][layer], eps)
        qkv = h @ w("wqkv")
        q = qkv[:, : hq * d].reshape(t, hq, d)
        k = qkv[:, hq * d: (hq + hkv) * d].reshape(t, hkv, d)
        v = qkv[:, (hq + hkv) * d:].reshape(t, hkv, d)
        q, k = rope(q, pos, theta), rope(k, pos, theta)
        k = k.repeat_interleave(hq // hkv, dim=1)  # query head h reads KV head h // group
        v = v.repeat_interleave(hq // hkv, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        attn = torch.einsum("hqk,khd->qhd", probs, v).reshape(t, hq * d)
        x = x + attn @ w("wo")
        h = rms_norm(x, blocks["mlp_norm"][layer], eps)
        x = x + (F.silu(h @ w("w_gate")) * (h @ w("w_up"))) @ w("w_down")
    return rms_norm(x, params["talker"]["final_norm"], eps)


def residual_logits(params: Dict, cfg: Dict, h: torch.Tensor, tok0: torch.Tensor) -> torch.Tensor:
    """The code predictor: ``(Q, T, codebook)`` logits of the residual codebooks
    from the talker's hidden state and the frame's primary code."""
    size = cfg["codec"]["codebook_size"]
    e0 = params["audio_embed"][0][tok0.clamp_max(size - 1)].float()
    x = torch.cat([h, e0], dim=-1)
    w1 = params["code_predictor"]["w1"].float()
    w2 = params["code_predictor"]["w2"].float()
    hidden = F.silu(torch.einsum("td,qdc->qtc", x, w1))
    return torch.einsum("qtc,qce->qte", hidden, w2)


def served_gaps(params: Dict, cfg: Dict, text: str, speaker: str, codes: torch.Tensor,
                min_frames: int, quantization: Optional[str], judge_primary: bool) -> Dict:
    """Judge one served utterance, teacher-forced on its own codes.

    ``codes`` ``(T, nq)``: frame 0's primary code from the prompt, each later
    frame's from the talker's state after the previous frame. For every
    judged token, the gap by which the reference's logit of the served token
    lies below the reference's best (EOS excluded on frames under
    ``min_frames``, where the program masks it). Primary codes are judged only
    where ``judge_primary`` (greedy requests); residual codes always, since
    the program picks them by argmax. Returns the widest gaps, their sums
    and the counts.
    """
    codes = codes.long()
    n_frames = codes.shape[0]
    eos = audio_eos(cfg)
    prompt = prompt_embeds(params, cfg, text, speaker)
    seq = torch.cat([prompt, code_embeds(params, codes[:-1])], dim=0)
    h = talker_hidden(params, cfg, seq, quantization)
    # The state that chose frame f's primary code sits at position n - 1 + f.
    h_frames = h[prompt.shape[0] - 1:]
    logits = h_frames @ params["lm_head"].float()
    masked = torch.arange(n_frames, device=codes.device) < min_frames
    logits[masked, eos] = float("-inf")
    out = {"primary_gap": 0.0, "primary_gap_sum": 0.0, "primary_tokens": 0,
           "residual_gap": 0.0, "residual_gap_sum": 0.0, "residual_tokens": 0}
    if judge_primary:
        served = logits.gather(1, codes[:, :1])[:, 0]
        gap = logits.max(dim=1).values - served
        out.update(primary_gap=float(gap.max()), primary_gap_sum=float(gap.sum()),
                   primary_tokens=n_frames)
    # Residuals of frame 0 are zeros by construction; an EOS frame is not heard.
    audible = codes[1:, 0] != eos
    if bool(audible.any()):
        rows = torch.nonzero(audible)[:, 0] + 1
        res = residual_logits(params, cfg, h_frames[rows], codes[rows, 0])  # (Q, R, V)
        served = res.gather(2, codes[rows, 1:].T[..., None])[..., 0]
        gap = res.max(dim=2).values - served
        out.update(residual_gap=float(gap.max()), residual_gap_sum=float(gap.sum()),
                   residual_tokens=int(served.numel()))
    return out


class Gaps:
    """The widest and the mean gap of every judged primary and residual code."""

    def __init__(self):
        self.widest = {"primary": 0.0, "residual": 0.0}
        self.sums = {"primary": 0.0, "residual": 0.0}
        self.tokens = {"primary": 0, "residual": 0}

    def add(self, g: Dict) -> None:
        for kind in self.widest:
            self.widest[kind] = max(self.widest[kind], g[f"{kind}_gap"])
            self.sums[kind] += g[f"{kind}_gap_sum"]
            self.tokens[kind] += g[f"{kind}_tokens"]

    def readings(self) -> Dict[str, float]:
        out = {}
        for kind in self.widest:
            out[f"{kind}_gap"] = self.widest[kind]
            out[f"{kind}_gap_mean"] = self.sums[kind] / max(self.tokens[kind], 1)
        return out

    @property
    def count(self) -> int:
        return sum(self.tokens.values())


# ---------------------------------------------------------------------------
# Codec decoder (vocoder)
# ---------------------------------------------------------------------------


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 and back: the control's precision below bf16."""
    return x.to(torch.float8_e4m3fn).float()


def vocode(params: Dict, cfg: Dict, codes: torch.Tensor, low_precision: bool = False
           ) -> torch.Tensor:
    """``(B, T, nq)`` codes (specials clamped) -> ``(B, T * hop)`` waveform in f32.

    ``low_precision``: every convolution's input and weight rounded to float8
    e4m3 (the control).
    """
    c = cfg["codec"]
    r = _fp8 if low_precision else (lambda x: x)
    books = params["codec"]["rvq"]["codebooks"].float()
    codes = codes.long().clamp_max(c["codebook_size"] - 1)
    frames = sum(books[q][codes[..., q]] for q in range(codes.shape[-1]))
    dec = params["codec"]["decoder"]

    def conv(x, w, stride=1, dilation=1):
        k = w.shape[-1]
        return F.conv1d(r(x), r(w.float()), stride=stride, dilation=dilation,
                        padding=dilation * (k - 1) // 2)

    def leaky(x):
        return torch.where(x >= 0, x, 0.1 * x)

    x = conv(frames.transpose(1, 2), dec["conv_pre"])
    for w, rb, rate in zip(dec["ups"], dec["resblocks"], c["upsample_rates"]):
        k = w.shape[-1]
        n = x.shape[-1]
        x = F.conv_transpose1d(r(leaky(x)), r(w.float()), stride=rate,
                               padding=(k - rate) // 2)[..., : n * rate]
        for wd, wp, dil in zip(rb["convs_d"], rb["convs_p"], c["resblock_dilations"]):
            x = x + conv(leaky(conv(leaky(x), wd, dilation=dil)), wp)
    x = conv(leaky(x), dec["conv_post"])
    return torch.tanh(x)[:, 0, :]


def hop(cfg: Dict) -> int:
    return math.prod(cfg["codec"]["upsample_rates"])


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def whole_waveform(params: Dict, cfg: Dict, codes: torch.Tensor, chunk: int,
                   low_precision: bool = False) -> torch.Tensor:
    """One utterance's waveform ``(T * hop,)``: its ``(T, nq)`` codes followed by
    code-0 frames up to a whole number of ``chunk`` frames, vocoded together,
    cut to the utterance."""
    t = codes.shape[0]
    padded = F.pad(codes.long(), (0, 0, 0, _round_up(t, chunk) - t))
    return vocode(params, cfg, padded[None], low_precision)[0, : t * hop(cfg)]


def stream_windows(n_frames: int, max_frames: int, chunk: int,
                   context: int) -> List[Tuple[int, int, int, int]]:
    """The streamed pieces of an utterance of ``n_frames`` frames that ran to
    its frame budget ``max_frames``, one per decode chunk harvested:
    ``(lo, hi, emit_from, emit_to)``. A piece vocodes frames ``[lo, hi)`` with
    ``context`` frames of left context and keeps ``[emit_from, emit_to)``;
    until the last chunk the newest ``context`` frames are held back as the
    next piece's right context."""
    pieces, emitted, frames = [], 0, 1  # frame 0 comes from the prompt
    while True:
        frames += chunk
        finished = frames >= max_frames
        total = min(frames, n_frames)
        safe = total if finished else max(total - context, 0)
        if safe > emitted:
            pieces.append((max(emitted - context, 0), total, emitted, safe))
            emitted = safe
        if finished:
            return pieces


def streamed_waveform(params: Dict, cfg: Dict, codes: torch.Tensor, max_frames: int, chunk: int,
                      context: int, low_precision: bool = False) -> torch.Tensor:
    """The streamed pieces of one utterance, joined: each window of
    :func:`stream_windows` padded with code-0 frames to whole chunks, vocoded,
    and cut to the frames it emits."""
    hp = hop(cfg)
    out = []
    for lo, hi, e0, e1 in stream_windows(codes.shape[0], max_frames, chunk, context):
        win = codes[lo:hi].long()
        win = F.pad(win, (0, 0, 0, _round_up(hi - lo, chunk) - (hi - lo)))
        wav = vocode(params, cfg, win[None], low_precision)[0]
        out.append(wav[(e0 - lo) * hp: (e1 - lo) * hp])
    return torch.cat(out)


def relative_error(got: Optional[torch.Tensor], want: torch.Tensor) -> float:
    """``||got - want|| / ||want||`` over one waveform; a waveform missing or of
    another length is infinitely wrong."""
    if got is None or got.shape != want.shape:
        return float("inf")
    return float(torch.linalg.vector_norm(got.float() - want) /
                 torch.linalg.vector_norm(want).clamp_min(1e-12))


def judge_waveforms(pairs: Sequence[Tuple[Optional[torch.Tensor], torch.Tensor]]) -> float:
    """The widest relative error over ``(program, reference)`` waveform pairs."""
    return max((relative_error(g, w) for g, w in pairs), default=0.0)
