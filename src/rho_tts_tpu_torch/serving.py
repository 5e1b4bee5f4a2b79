"""Continuous-batching serving engine for the codec-LM TTS model (PyTorch port).

Counterpart of ``rho_tts_tpu/serving.py``. A fixed SLOT BATCH of
``n_slots`` rows that requests join and leave at decode-chunk boundaries
(continuous batching):

* **Ring-buffer KV cache.** One ``(L, B, S, Hkv, D)`` cache; every row
  writes the same global column each step and the column wraps mod S.
  RoPE encodes position and ``key_valid`` masks each row to its own live
  history, so attention runs with ``slot_causal=False``: the decode kernel
  (``ops.cuda.decode_attention``) takes the complete ``(B, S)`` mask, whose
  valid keys wrap and are no prefix.
* **Admission at chunk boundaries.** New requests prefill into a fresh
  contiguous cache (the prefill kernel) and their rows are scattered into
  the ring at columns ``[(col-P) mod S, col)``.
* **Per-row decode state on the device** (RoPE base, frame counter, EOS
  floor, temperature, seed, the code log): a chunk is a Python loop of
  eager steps that reads none of it back.
* **Lagged harvest.** Chunk k's done flags, a ``(B, steps)`` bitmap, are
  copied into pinned host memory behind an event and read after chunk
  k+1 has been dispatched: the only wait of the loop. Retirement,
  streaming and admission run one chunk behind; the ring holds one chunk
  of slack for it. The codes stay in the device-resident ``(B, F, nq)``
  log and are vocoded from there.

Sampling is schedule-reproducible: row noise at frame ``f`` is a pure
function of ``(request seed, f)`` (``models.qwen.model._sample_token_seeded``,
bit for bit the JAX package's), so served codes equal ``generate_codes``'s
for the same seed, and the JAX package's served codes.

Threads and streams: the engine owns one CUDA stream and launches all its
work on it, whichever thread drives it (:meth:`ServingEngine.step` or the
:meth:`ServingEngine.start` thread). Waveforms handed to a caller come with
an event recorded on that stream, and the caller's current stream waits on
it (:meth:`ServeRequest.result`, :meth:`ServeRequest.chunks`,
``ServeRequest.wav``). On the CPU the same code runs without streams.

With a ``draft_model``, the slot batch decodes by draft-verify speculation
(``serving_spec``).

Mesh serving (a model put on a mesh by ``parallel.inference``; one
process per GPU): slot rows split over ``data`` (``n_slots`` must be a
multiple of it) and KV heads over ``model`` under tensor parallelism, the
layout of the one-shot paths. Every rank submits the same requests in the
same order and every rank keeps the same schedule, so every rank reaches
the same collectives in the same order and resolves every request with the
whole result. The schedule is the mesh's first rank's: at each step it
picks the admission group from its queue, drops cancelled and expired
requests and notes which slot rows were cancelled, and broadcasts that by
submission index over the mesh's gloo ``control`` axis; the other ranks
apply it to their own queues (waiting for a request their caller has not
submitted yet) and never read their own clocks, cancel flags or thread
timing. A background thread (:meth:`ServingEngine.start`) stops when the
first rank stops. An admission group prefills on every data rank (it is small and
bucketed) and each rank scatters the rows it holds; a chunk's done flags
are all-gathered over ``data`` before their lagged copy (on the card the
gather is queued on the engine's stream, so the copy still adds no host
wait); retirement and streaming vocode from the code log all-gathered over
``data``. Speculative serving over a mesh raises, as the JAX package's
does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue as _queue
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .models import transformer as tfm
from .models.qwen.model import (
    PROMPT_BUCKET,
    QwenTTSModel,
    _chunk,
    _gumbel_noise,
    _predict_residuals,
    _prefill,
    _round_up,
    _sample_token_seeded,
    _sample_with_noise,
    _vocode,
    _vocode_rows,
)
from .models.qwen.speculative import _embed_codes, _suppress_eos
from .parallel.collectives import all_gather, broadcast
from .utils import profiling

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

#: how long a rank waits for a request the mesh's first rank admitted
FOLLOW_TIMEOUT_S = 600.0

# One lock for all requests' done-callback registration.
_CB_LOCK = threading.Lock()


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``: one pinned, asynchronous copy on
    the card (no host wait), a copy on the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def _record(device: torch.device):
    """An event recorded on the current stream (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _ready(t: torch.Tensor, ev) -> torch.Tensor:
    """Make the caller's current stream wait for ``t``'s producer event."""
    if ev is not None and t.is_cuda:
        s = torch.cuda.current_stream(t.device)
        s.wait_event(ev)
        t.record_stream(s)
    return t


class _Lagged:
    """A small device tensor on its way to the host: a pinned copy behind an
    event, read (the loop's one wait) when the next dispatch is queued."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = _record(t.device)
        else:
            self.host, self.event = t.clone(), None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


# ---------------------------------------------------------------------------
# Device programs (eager; the JAX package's compiled programs)
# ---------------------------------------------------------------------------


def _serve_decode_chunk(params: Params, cache_k, cache_v, key_valid, codes_buf, cfg, col0: int,
                        rope_next, last_codes, done, active, seeds, temperature, frames_done,
                        min_frames, steps: int, top_k: int, tp=None):
    """``steps`` decode steps over the slot batch with ring writes at global
    column ``col0 + t`` (mod S). Caches, ``key_valid`` and ``codes_buf`` are
    written in place.

    Differs from ``models.qwen.model._decode_chunk`` as serving needs: a
    per-row EOS floor (``frames_done`` / ``min_frames`` per row), a write
    column that wraps, ``slot_causal=False`` attention, and an ``active``
    mask so empty slots mark no column valid. The chunk's codes append to
    ``codes_buf`` at each row's frame positions (the frame at the first EOS
    and after it zeroed; positions past the log's end dropped). ``tp``: the
    mesh axis the weights are sharded over.

    Returns ``(done_chunk (B, steps), last_codes, done, rope_next,
    frames_done)``.
    """
    b = last_codes.shape[0]
    s = cache_k.shape[2]
    lm_head = params["lm_head"].float()  # f32 logits over the bf16 head, as JAX's dot
    ar = torch.arange(steps, device=seeds.device)
    frames = frames_done[None, :] + ar[:, None]  # (steps, B)
    # Every step's sampler noise in one batched pass: a pure function of
    # (seed, frame), both known before the chunk runs.
    noise = _gumbel_noise(seeds, frames, top_k)
    attn_mask = active[:, None]
    codes_seq, done_seq = [], []
    for t in range(steps):
        slot = (col0 + t) % s
        h, _ = tfm.stack_forward(
            params["talker"], cfg.talker, _embed_codes(params, last_codes)[:, None, :],
            (rope_next + t)[:, None],
            kv_caches=(cache_k, cache_v), cache_len=slot, attn_mask=attn_mask,
            key_valid=key_valid, slot_causal=False, tp=tp,
        )
        key_valid[:, slot] = active
        h_last = h[:, -1]
        logits = h_last.float() @ lm_head
        _suppress_eos(logits, cfg.audio_eos, frames[t] < min_frames)
        tok0 = _sample_with_noise(logits, temperature, top_k, noise[t])
        newly_done = tok0 == cfg.audio_eos
        dead = done | ~active
        tok0 = torch.where(dead, cfg.audio_pad, tok0)
        res = _predict_residuals(params, cfg, h_last, tok0.clamp_max(cfg.codec.codebook_size - 1),
                                 tp)
        res = torch.where(dead[:, None], 0, res)
        last_codes = torch.cat([tok0[:, None], res], dim=-1)
        done = done | newly_done
        codes_seq.append(last_codes)
        done_seq.append(done)
    codes_chunk = torch.stack(codes_seq, dim=1)  # (B, steps, nq)
    done_chunk = torch.stack(done_seq, dim=1)  # (B, steps)
    codes_z = torch.where(done_chunk[..., None], 0, codes_chunk)
    tfm.scatter_rows(codes_buf, frames_done[:, None] + ar[None, :], codes_z,
                     keep=active[:, None].expand(b, steps))
    return done_chunk, last_codes, done, rope_next + steps, frames_done + steps


def _insert_rows(cache_k, cache_v, key_valid, rows, pk, pv, pvalid, col0: int) -> None:
    """Scatter freshly prefilled prompt rows into the ring, in place.

    The prompt occupies columns ``[(col0-P) mod S, col0)`` of each row; the
    admitted rows' ``key_valid`` is rebuilt from scratch (True on real
    prompt columns only). Duplicate ``rows`` (bucket padding repeats the
    last admit) write identical data.
    """
    s = cache_k.shape[2]
    p = pk.shape[2]
    cols = (torch.arange(p, device=rows.device) + (col0 - p)) % s
    fresh = torch.zeros((rows.shape[0], s), dtype=torch.bool, device=rows.device)
    fresh[:, cols] = pvalid
    key_valid[rows] = fresh
    cache_k[:, rows[:, None], cols[None, :]] = pk.to(cache_k.dtype)
    cache_v[:, rows[:, None], cols[None, :]] = pv.to(cache_v.dtype)


def _vocode_windows(params: Params, cfg, codes_buf, rows, los, ends, w: int):
    """Vocode per-row windows ``codes_buf[row, lo:lo+w]`` (frames >= end
    zeroed) for streaming; the windows never leave the device."""
    idx = los[:, None] + torch.arange(w, device=los.device)[None, :]
    win = codes_buf[rows[:, None], idx]
    win = torch.where((idx < ends[:, None])[..., None], win, 0)
    return _vocode(params, cfg, win)


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


class ServeRequest:
    """Handle for one submitted utterance; a minimal future.

    With ``stream=True``, audio is also delivered incrementally through
    :meth:`chunks` as decode chunks harvest (sliding-window vocode).
    Waveforms are 1-D float32 tensors on the model's device.
    """

    def __init__(self, text: str, speaker: Optional[str], language: str,
                 ref_audio: Optional[str], ref_text: Optional[str], min_frames: int,
                 max_frames: int, temperature: float, stream: bool = False, priority: int = 0,
                 expires_s: Optional[float] = None, seed: int = 0):
        self.text = text
        self.speaker = speaker
        self.language = language
        self.ref_audio = ref_audio
        self.ref_text = ref_text
        self.min_frames = int(min_frames)
        self.max_frames = int(max_frames)
        self.temperature = float(temperature)
        self.stream = bool(stream)
        self.priority = int(priority)
        self.expires_s = expires_s
        self.seed = int(seed)

        self._event = threading.Event()
        self._cancelled = threading.Event()
        self._done_cbs: List[Any] = []
        self._chunk_q = _queue.Queue() if stream else None
        self._wav: Optional[torch.Tensor] = None
        self._wav_ready = None  # event on the engine's stream
        self._codes_np: Optional[np.ndarray] = None  # trimmed (n_frames, nq)
        self._codes_ref = None  # (device codes group, row-in-group, end, event)
        self.sample_rate: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.n_frames: int = 0
        self.t_submit = time.time()
        self.t_admit: Optional[float] = None
        self.t_first_audio: Optional[float] = None
        self.t_done: Optional[float] = None
        self._sid = -1  # submission index within its engine (set at enqueue)

    @property
    def wav(self) -> Optional[torch.Tensor]:
        """The waveform (None until resolved), ready on the caller's stream."""
        if self._wav is None:
            return None
        return _ready(self._wav, self._wav_ready)

    def chunks(self, timeout: Optional[float] = None):
        """Yield waveform pieces ``(tensor (S,), sr)`` as they are generated.

        Only for ``stream=True`` requests. The pieces concatenate to
        :meth:`result`'s waveform. Raises on error or cancellation once the
        stream ends.
        """
        if self._chunk_q is None:
            raise ValueError("request was not submitted with stream=True")
        while True:
            item = self._chunk_q.get(timeout=timeout)
            if item is None:
                break
            piece, sr, ev = item
            yield _ready(piece, ev), sr
        if self.error is not None:
            raise self.error
        if self.cancelled:
            raise RuntimeError("request was cancelled")

    @property
    def codes(self) -> Optional[np.ndarray]:
        """Trimmed ``(n_frames, nq)`` int32 code matrix; fetched from the
        device on first access (the serving loop never pays the transfer)."""
        if self._codes_np is None and self._codes_ref is not None:
            arr, b, end, ev = self._codes_ref
            self._codes_np = _ready(arr, ev)[b, :end].cpu().numpy().astype(np.int32)
            self._codes_ref = None
        return self._codes_np

    def cancel(self) -> None:
        """Cooperative cancel: queued requests are dropped at admission,
        active ones retired (without vocoding) at the next chunk boundary."""
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Tuple[torch.Tensor, int]:
        """Block until finished; returns (waveform (T,) float32 tensor, sr).

        Raises the stored error on failure and ``RuntimeError`` on
        cancellation or ``TimeoutError`` on timeout.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not finished after {timeout}s")
        if self.error is not None:
            raise self.error
        if self.cancelled:
            raise RuntimeError("request was cancelled")
        return self.wav, int(self.sample_rate)

    def add_done_callback(self, fn) -> None:
        """Call ``fn(self)`` when the request resolves (success, error or
        cancellation); at once if already resolved. Callbacks run on the
        serving thread: keep them cheap (e.g. a queue put)."""
        fire = False
        with _CB_LOCK:
            if self._event.is_set():
                fire = True
            else:
                self._done_cbs.append(fn)
        if fire:
            fn(self)

    def _resolve(self) -> None:
        self.t_done = time.time()
        with _CB_LOCK:
            cbs, self._done_cbs = self._done_cbs, []
            self._event.set()
        for fn in cbs:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — callbacks must not kill serving
                logger.exception("ServeRequest done-callback failed")


class _Slot:
    """Host-side bookkeeping for one batch row: frame counters and the EOS
    position (from the harvested done flags); the codes live on the device."""

    __slots__ = ("req", "done_seen", "frames", "emitted", "pieces", "cancel")

    def __init__(self):
        self.req: Optional[ServeRequest] = None
        self.cancel = False  # the request's cancel, as the schedule saw it
        self.done_seen: Optional[int] = None  # frame index of the first EOS, if seen
        self.frames = 0  # frames harvested so far (frame 0 included)
        self.emitted = 0  # frames already streamed out (stream=True rows)
        self.pieces: List[torch.Tensor] = []  # streamed waveform pieces


def _fingerprint(req: ServeRequest) -> int:
    """A request's content as a 32-bit number (ranks compare theirs)."""
    key = (req.text, req.speaker, req.language, req.ref_audio, req.ref_text, req.seed,
           req.min_frames, req.max_frames, req.temperature, req.stream,
           getattr(req, "cfg_weight", None))
    return zlib.crc32(repr(key).encode())


def _flat(pairs: List[Tuple[int, int]], n: int) -> List[int]:
    """Up to ``n`` pairs as a flat list of ``2 * n``, padded with -1."""
    out = [v for p in pairs for v in p]
    return out + [-1] * (2 * n - len(out))


def _pairs(flat: List[int], count: int) -> List[Tuple[int, int]]:
    """The first ``count`` pairs of a flat list."""
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(count)]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class ServingEngine:
    """Slot-batched continuous serving over one :class:`QwenTTSModel`.

    ``n_slots`` fixes the decode batch; ``max_prompt`` and ``max_frames``
    bound a request's prompt tokens and generated frames, which together
    size the KV ring. Submit from any thread; drive with :meth:`step` /
    :meth:`run_until_idle` (deterministic) or :meth:`start` (a background
    thread). A model on a mesh serves over it (see the module docstring).
    """

    def __init__(self, model: QwenTTSModel, n_slots: int = 8, max_prompt: int = 256,
                 max_frames: int = 768, top_k: Optional[int] = None, seed: int = 0,
                 stream_context: int = 32, max_queue: Optional[int] = None,
                 draft_model: Optional[QwenTTSModel] = None, gamma: int = 4,
                 residual_mode: str = "draft"):
        tfm.require_dense(model.config.talker, "ServingEngine")
        if draft_model is not None:
            tfm.require_dense(draft_model.config.talker, "speculative serving")
        self.model = model
        self.cfg = model.config
        self.device = torch.device(model.device)
        self.chunk = _chunk()
        self.n_slots = int(n_slots)
        self.max_prompt = _round_up(int(max_prompt), PROMPT_BUCKET)
        self.max_frames = _round_up(int(max_frames), self.chunk)
        self.top_k = int(self.cfg.top_k if top_k is None else top_k)
        self.stream_context = int(stream_context)

        # Speculative serving (serving_spec): the draft proposes gamma tokens
        # per round, the target verifies them in one T=gamma+1 forward.
        self.draft = draft_model
        self.gamma = int(gamma)
        self.residual_mode = residual_mode
        if draft_model is not None:
            if residual_mode not in ("strict", "draft"):
                raise ValueError(f"Unknown residual_mode: {residual_mode!r}")
            if self.gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            dcfg = draft_model.config
            if dcfg.audio_vocab != self.cfg.audio_vocab or dcfg.text_vocab != self.cfg.text_vocab:
                raise ValueError("draft must share the target's text and codec vocabularies")
            if model.mesh is not None or draft_model.mesh is not None:
                raise NotImplementedError(
                    "speculative serving over a device mesh is not wired yet; "
                    "serve the draft single-device")
        # Ring capacity. Non-speculative: prompt + frames + one chunk of
        # lagged-retirement slack. Speculative: per-row columns rewind past
        # rejected proposals and reset at admission (no wrap); slack for the
        # in-flight block and two lagged dispatches of k rounds.
        if draft_model is None:
            self.ring = self.max_prompt + self.max_frames + self.chunk
        else:
            self.spec_k = max(1, int(os.environ.get("RHO_TTS_TPU_SPEC_ROUNDS", "4")))
            self.ring = self.max_prompt + self.max_frames + (2 * self.spec_k + 1) * (
                self.gamma + 1)

        self._start(seed, max_queue)

    def _start(self, seed: int, max_queue: Optional[int]) -> None:
        """The engine's mesh layout, CUDA stream, device state and scheduler."""
        self.mesh = self.model.mesh
        self._data = None if self.mesh is None else self.mesh.axis("data")
        self._tp = self.model.tp_axis
        #: the mesh's control axis when it has more than one rank
        self._ctl = (self.mesh.control if self.mesh is not None and self.mesh.control.size > 1
                     else None)
        dp = 1 if self._data is None else self._data.size
        if self.n_slots % dp:
            raise ValueError(
                f"n_slots ({self.n_slots}) must be a multiple of the mesh data axis ({dp})")
        #: this rank's slot rows are [_row_lo, _row_lo + _n_local)
        self._n_local = self.n_slots // dp
        self._row_lo = 0 if self._data is None else self._data.index * self._n_local
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
            # The weights were written on the caller's stream.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            self._alloc_state()
        self._init_scheduling(seed, max_queue)

    def _on_stream(self):
        """Inference mode on the engine's stream (every method that launches work)."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._stream is not None:
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _alloc_state(self) -> None:
        """The ring, the per-row decode state and the code log, on the device
        (this rank's slot rows and, under TP, KV heads)."""
        b, dev, nq = self._n_local, self.device, self.cfg.codec.n_codebooks
        i64 = dict(dtype=torch.int64, device=dev)
        self._cache_k, self._cache_v = self.model._shard_kv(b, self.ring)
        self._key_valid = torch.zeros((b, self.ring), dtype=torch.bool, device=dev)
        self._last_codes = torch.zeros((b, nq), **i64)
        self._done = torch.ones((b,), dtype=torch.bool, device=dev)
        self._active_dev = torch.zeros((b,), dtype=torch.bool, device=dev)
        self._rope_next = torch.zeros((b,), **i64)
        self._frames_done = torch.zeros((b,), **i64)
        self._min_frames = torch.zeros((b,), **i64)
        self._temp = torch.full((b,), float(self.cfg.temperature), dtype=torch.float32,
                                device=dev)
        # Row i at frame f draws from fold_in(fold_in(base, seed), f).
        self._seeds = torch.zeros((b,), **i64)
        # Frame 0 plus up to max_frames of decode, with one chunk of slack so
        # streaming windows can slice a full bucket at the tail.
        self._codes_buf = torch.zeros((b, self.max_frames + self.chunk, nq), **i64)
        if self.draft is not None:
            self._d_cache_k, self._d_cache_v = tfm.make_kv_cache(
                self.draft.config.talker, b, self.ring, device=dev)
            self._d_key_valid = torch.zeros((b, self.ring), dtype=torch.bool, device=dev)
            self._spec_cols = torch.zeros((b,), **i64)  # per-row write columns

    def _init_scheduling(self, seed: int, max_queue: Optional[int]) -> None:
        """Host-side scheduling state: queue, slots, locks, stats."""
        self._seed0 = int(seed)
        self._n_submitted = 0  # drives default per-request seeds
        self._n_enqueued = 0  # submission indices (the schedule's request ids)
        self._queued = False  # requests stayed queued after this step's admission
        self._active = np.zeros(self.n_slots, bool)  # host mirror (scheduling)
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._col = 0  # global write column (kept in [0, ring))
        self.max_queue = max_queue  # backpressure: submit() raises when full
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._loop_error: Optional[BaseException] = None
        # Lagged harvest: (payload on its way to the host, row -> request)
        self._pending: Optional[Tuple[_Lagged, List[Optional[ServeRequest]]]] = None

        self.frames_decoded = 0  # real (harvested, pre-EOS) frames
        self.frames_delivered = 0  # frames in resolved waveforms
        self.requests_done = 0
        self.spec_rounds = 0  # speculative draft/verify rounds dispatched
        self.dispatches = 0  # decode chunks (or speculative dispatches) launched
        self.admissions = 0  # admission groups prefilled
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def _own(self, rows: List[int]) -> Tuple[List[int], List[int]]:
        """The positions in ``rows`` (global slot rows) whose row this rank
        holds, and those rows' local indices."""
        js = [j for j, r in enumerate(rows) if 0 <= r - self._row_lo < self._n_local]
        return js, [rows[j] - self._row_lo for j in js]

    def _codes_log(self) -> torch.Tensor:
        """The whole ``(n_slots, F, ...)`` code log: every data rank's rows
        (this rank's own log without a data axis)."""
        return all_gather(self._codes_buf, 0, self._data)

    # -- submission ---------------------------------------------------------

    def submit(self, text: str, speaker: Optional[str] = None, language: str = "English",
               ref_audio: Optional[str] = None, ref_text: Optional[str] = None,
               min_frames: int = 0, max_frames: Optional[int] = None,
               temperature: Optional[float] = None, stream: bool = False, priority: int = 0,
               expires_s: Optional[float] = None, seed: Optional[int] = None) -> ServeRequest:
        """Queue one utterance; returns a future-like :class:`ServeRequest`.

        ``stream=True`` also delivers audio incrementally via
        :meth:`ServeRequest.chunks`. ``priority``: higher admits first (FIFO
        within a level). ``expires_s``: a request still queued this long
        after submission is dropped at admission with a ``TimeoutError``.
        ``seed``: per-request sampling seed (sampling is a pure function of
        (seed, frame), so results match ``QwenTTSModel.generate_codes(...,
        seeds=[seed])``); by default a deterministic per-submission value
        from the engine seed and the submission index.
        """
        if seed is None:
            seed = self._default_seed()
        if max_frames is None:
            max_frames = int(np.clip(len(text) * 1.0 + 50, self.chunk, self.max_frames))
        max_frames = min(_round_up(int(max_frames), self.chunk), self.max_frames)
        req = ServeRequest(
            text, speaker, language, ref_audio, ref_text,
            min_frames=min(int(min_frames), max_frames), max_frames=max_frames,
            temperature=self.cfg.temperature if temperature is None else temperature,
            stream=stream, priority=priority, expires_s=expires_s, seed=seed,
        )
        return self._enqueue(req)

    def _default_seed(self) -> int:
        """Deterministic, collision-free per-submission seed."""
        with self._lock:
            idx = self._n_submitted
            self._n_submitted += 1
        return (self._seed0 * 1_000_003 + idx) & 0x7FFFFFFF

    def _enqueue(self, req: ServeRequest) -> ServeRequest:
        """Priority-FIFO insert, and wake the serving thread."""
        priority = req.priority
        with self._wake:
            # Counted before any refusal, so ranks keep the same indices.
            req._sid = self._n_enqueued
            self._n_enqueued += 1
            if self._loop_error is not None:
                raise RuntimeError(
                    f"serving engine is down: {self._loop_error!r}") from self._loop_error
            if self.max_queue is not None and len(self._queue) >= self.max_queue:
                raise RuntimeError(f"serving queue full ({self.max_queue}); apply backpressure")
            if priority == 0 or all(q.priority >= priority for q in self._queue):
                self._queue.append(req)
            else:
                idx = next((i for i, q in enumerate(self._queue) if q.priority < priority),
                           len(self._queue))
                self._queue.insert(idx, req)
            self._wake.notify()
        return req

    # -- scheduling ---------------------------------------------------------

    def _free_rows(self) -> List[int]:
        return [i for i in range(self.n_slots) if not self._active[i]]

    @staticmethod
    def _end_request(req: ServeRequest) -> None:
        if req._chunk_q is not None:
            req._chunk_q.put(None)
        req._resolve()

    def _plan(self, stop: bool) -> Tuple[bool, List[ServeRequest]]:
        """This step's schedule, the same on every rank: whether to stop and
        the admission group (see the module docstring). Drops cancelled and
        expired requests, marks cancelled slot rows and sets ``_queued``."""
        ctl = self._ctl
        n = self.n_slots
        if ctl is None or ctl.index == 0:
            picked, drops = [], []
            if not stop:
                free = len(self._free_rows())
                with self._lock:
                    now = time.time()
                    while len(picked) < free and len(drops) < n and self._queue:
                        req = self._queue.popleft()
                        if req.cancelled:
                            drops.append((req, 1))
                        elif req.expires_s is not None and now - req.t_submit > req.expires_s:
                            drops.append((req, 2))
                        else:
                            picked.append(req)
                    self._queued = bool(self._queue)
            cancel = [int(s.req is not None and s.req.cancelled) for s in self._slots]
            if ctl is not None:
                rec = [int(stop), int(self._queued), len(picked), len(drops)]
                rec += _flat([(r._sid, _fingerprint(r)) for r in picked], n)
                rec += _flat([(r._sid, why) for r, why in drops], n)
                rec += cancel
                broadcast(torch.tensor(rec, dtype=torch.int64), ctl)
        else:
            rec = broadcast(torch.zeros(4 + 5 * n, dtype=torch.int64), ctl).tolist()
            stop, self._queued = bool(rec[0]), bool(rec[1])
            with self._wake:
                picked = [self._take(sid, fp) for sid, fp in _pairs(rec[4:], rec[2])]
                drops = [(self._take(sid), why) for sid, why in
                         _pairs(rec[4 + 2 * n:], rec[3])]
            cancel = rec[4 + 4 * n:]
        for slot, c in zip(self._slots, cancel):
            if c and not slot.cancel:
                slot.cancel = True
                slot.req._cancelled.set()
        for req, why in drops:
            if why == 1:
                req._cancelled.set()
            else:
                req.error = TimeoutError(f"queued longer than expires_s={req.expires_s}s")
            self._end_request(req)
        return stop, picked

    def _take(self, sid: int, fp: Optional[int] = None) -> ServeRequest:
        """Remove request ``sid`` from the queue, waiting until this rank's
        caller has submitted it (the lock held). ``fp``: its fingerprint on
        the first rank, which it must match."""
        deadline = time.monotonic() + FOLLOW_TIMEOUT_S
        while True:
            req = next((r for r in self._queue if r._sid == sid), None)
            if req is not None:
                break
            left = deadline - time.monotonic()
            if left <= 0 or self._stop.is_set():
                raise RuntimeError(
                    f"request #{sid} was scheduled on the mesh's first rank but never "
                    "submitted here: every rank must submit the same requests in order")
            self._wake.wait(timeout=min(left, 0.05))
        if fp is not None and _fingerprint(req) != fp:
            raise RuntimeError(f"request #{sid} differs from the mesh's first rank's: every "
                               "rank must submit the same requests in order")
        self._queue.remove(req)
        return req

    def _admit(self, picked: List[ServeRequest]) -> int:
        """Move the planned admission group into free slots; one bucketed
        prefill per group. Returns the number admitted."""
        if not picked:
            return 0
        with profiling.stage("serve/admit_build"):
            built = self._admit_build(picked)
        if not built:
            return 0
        with profiling.stage("serve/admit_prefill"):
            return self._admit_prefill(built)

    def _admit_build(self, picked: List[ServeRequest]):
        """Host-side prompt arrays of an admission group."""
        built = []
        for req in picked:
            arrays, lens, p = self.model._build_prompt_arrays(
                [req.text], req.speaker, req.language, req.ref_audio, req.ref_text)
            if lens[0] > self.max_prompt:
                req.error = ValueError(
                    f"prompt is {lens[0]} tokens; engine max_prompt={self.max_prompt}")
                self._end_request(req)
                continue
            built.append((req, arrays, lens[0], p))
        return built

    def _admit_prefill(self, built) -> int:
        """Prefill the admission group and scatter it into the ring."""
        free = self._free_rows()
        p_group = max(p for _, _, _, p in built)
        a_real = len(built)
        a = 1 << (a_real - 1).bit_length()  # admit-batch bucket (1, 2, 4, 8, ...)
        rows_real = free[:a_real]
        dev = self.device

        def pad_row(arrays, n, p_from):
            """Left-extend one request's arrays from p_from to p_group."""
            d = p_group - p_from
            return {
                "ids_slotted": np.pad(arrays["ids_slotted"], ((0, 0), (d, 0))),
                "text_mask": np.pad(arrays["text_mask"], ((0, 0), (d, 0))),
                "codes_slotted": np.pad(arrays["codes_slotted"], ((0, 0), (d, 0), (0, 0))),
                "code_mask": np.pad(arrays["code_mask"], ((0, 0), (d, 0))),
                "spk_ids": arrays["spk_ids"],
                "spk_mask": np.pad(arrays["spk_mask"], ((0, 0), (d, 0))),
                "rope_pos": np.maximum(np.arange(p_group, dtype=np.int64) - (p_group - n),
                                       0)[None],
                "attn_mask": (np.arange(p_group) >= (p_group - n))[None],
            }

        padded = [pad_row(arrays, n, p) for _, arrays, n, p in built]
        sj = {}
        for k in padded[0]:
            rows = [pr[k] for pr in padded]
            rows += [rows[-1]] * (a - a_real)  # bucket padding repeats the last row
            sj[k] = _upload(np.concatenate(rows, axis=0), dev)

        # Bucket padding duplicates the LAST REAL row (the same target row):
        # duplicate scatters carry identical values.
        def pad(xs):
            return xs + [xs[-1]] * (a - a_real)

        min_f = _upload(np.array(pad([r.min_frames for r, _, _, _ in built]), np.int64), dev)
        temps = _upload(np.array(pad([r.temperature for r, _, _, _ in built]), np.float32), dev)
        lens = _upload(np.array(pad([n for _, _, n, _ in built]), np.int64), dev)
        seed_vals = _upload(np.array(pad([r.seed for r, _, _, _ in built]), np.int64), dev)

        def prefill(model):
            pk, pv = model._shard_kv(a, p_group)
            pkv = torch.zeros((a, p_group), dtype=torch.bool, device=dev)
            return _prefill(model.params, model.config, sj["ids_slotted"], sj["text_mask"],
                            sj["codes_slotted"], sj["code_mask"], sj["spk_ids"], sj["spk_mask"],
                            sj["rope_pos"], sj["attn_mask"], pk, pv, pkv, tp=model.tp_axis)

        logits, pk, pv, pkv = prefill(self.model)
        # Frame 0 from the prefill logits with the per-request (seed, 0) key,
        # the same draw as the one-shot path; EOS masked under a floor.
        _suppress_eos(logits, self.cfg.audio_eos, min_f > 0)
        tok0 = _sample_token_seeded(logits, seed_vals, torch.zeros_like(seed_vals), temps,
                                    self.top_k)
        # Every data rank prefilled the group; each scatters the rows it holds.
        js, local = self._own(pad(rows_real))
        if js:
            pick = self._picker(js, a)
            rows_t = _upload(np.array(local, np.int64), dev)
            # Speculative: columns are per-row and reset at admission, the
            # prompt at [0, p_group). Otherwise it ends at the current global
            # column.
            ins_col = p_group if self.draft is not None else self._col
            _insert_rows(self._cache_k, self._cache_v, self._key_valid, rows_t, pick(pk, 1),
                         pick(pv, 1), pick(pkv), ins_col)
            if self.draft is not None:
                # The draft prefills the same prompt arrays into its own ring;
                # its logits are unused (frame 0 samples from the target).
                _dl, dpk, dpv, dpkv = prefill(self.draft)
                _insert_rows(self._d_cache_k, self._d_cache_v, self._d_key_valid, rows_t,
                             pick(dpk, 1), pick(dpv, 1), pick(dpkv), ins_col)
                self._spec_cols.index_fill_(0, rows_t, p_group)
            self._admit_state(rows_t, pick(tok0), pick(lens), pick(min_f), pick(temps),
                              pick(seed_vals))
        self.admissions += 1

        now = time.time()
        for j, (req, _, _, _) in enumerate(built):
            row = rows_real[j]
            self._active[row] = True
            slot = self._slots[row]
            slot.req = req
            slot.pieces = []
            slot.emitted = 0
            slot.done_seen = None  # EOS at frame 0 surfaces via the done carry
            slot.frames = 1
            slot.cancel = False
            req.t_admit = now
        return a_real

    def _picker(self, js: List[int], a: int):
        """``pick(x, dim=0)``: the admission group's entries ``js`` of ``x``
        along ``dim`` (all of them, as they are, when ``js`` is the group)."""
        if js == list(range(a)):
            return lambda x, dim=0: x
        sel = _upload(np.array(js, np.int64), self.device)
        return lambda x, dim=0: x.index_select(dim, sel)

    def _admit_state(self, rows, tok0, lens, min_f, temps, seed_vals) -> None:
        """Write the admitted rows into every per-row state tensor.

        Frame 0 of the code log is the prefill-sampled primary token
        (residuals zero, as ``generate_codes``); the rest of the row is
        zeroed, so the previous occupant's log never leaks through.
        """
        a, nq = tok0.shape[0], self.cfg.codec.n_codebooks
        first = torch.cat([tok0[:, None], tok0.new_zeros((a, nq - 1))], dim=-1)
        row0 = torch.zeros((a,) + tuple(self._codes_buf.shape[1:]), dtype=torch.int64,
                           device=tok0.device)
        row0[:, 0, 0] = tok0
        self._last_codes[rows] = first
        self._done[rows] = tok0 == self.cfg.audio_eos
        self._active_dev.index_fill_(0, rows, True)
        self._rope_next[rows] = lens
        self._frames_done.index_fill_(0, rows, 1)  # frame 0 = the prefill-sampled token
        self._min_frames[rows] = min_f
        self._temp[rows] = temps
        self._codes_buf[rows] = row0
        self._seeds[rows] = seed_vals

    def _flush(self) -> None:
        """Harvest the outstanding lagged dispatch, if any."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._harvest_one(pending)

    def _harvest_one_spec(self, pending) -> None:
        """Harvest one speculative dispatch: per-row real-frame counts and EOS
        from the packed ``(k, B, 2)`` ``[n_real, hit_eos]`` array."""
        payload, owners = pending
        with profiling.stage("serve/harvest"):
            hv = payload.numpy()
        retire: List[int] = []
        emits: List[Tuple[int, int, int, int]] = []
        for row in range(self.n_slots):
            req = owners[row]
            slot = self._slots[row]
            if req is None or slot.req is not req:
                continue
            n_real = int(hv[:, row, 0].sum())
            if slot.done_seen is None:
                slot.frames += n_real
                self.frames_decoded += n_real
                if bool(hv[:, row, 1].any()):
                    slot.done_seen = slot.frames
            self._after_harvest(row, req, slot, emits, retire)
        if emits:
            self._emit_stream(emits)
        if retire:
            self._retire(retire)

    def _harvest_one(self, pending) -> None:
        """Read one chunk's done flags and retire finished rows."""
        if self.draft is not None:
            return self._harvest_one_spec(pending)
        payload, owners = pending
        with profiling.stage("serve/harvest"):
            dones = payload.numpy()
        retire: List[int] = []
        emits: List[Tuple[int, int, int, int]] = []  # (row, lo, hi, emit_from)
        steps = dones.shape[1]
        for row in range(self.n_slots):
            req = owners[row]
            slot = self._slots[row]
            if req is None or slot.req is not req:
                continue  # the row was empty, or re-admitted since this chunk ran
            if slot.done_seen is None:
                hit = np.nonzero(dones[row])[0]
                if hit.size:
                    slot.done_seen = slot.frames + int(hit[0])
                    self.frames_decoded += int(hit[0]) + 1
                else:
                    self.frames_decoded += steps
                slot.frames += steps
            self._after_harvest(row, req, slot, emits, retire)
        if emits:
            self._emit_stream(emits)
        if retire:
            self._retire(retire)

    def _after_harvest(self, row, req, slot, emits, retire) -> None:
        """Queue a streaming row's new window and mark finished rows."""
        finished = slot.done_seen is not None or slot.frames >= req.max_frames or slot.cancel
        if req.stream and not slot.cancel:
            total = slot.done_seen if slot.done_seen is not None else slot.frames
            total = max(min(total, req.max_frames), 1)
            safe = total if finished else max(total - self.stream_context, 0)
            if safe > slot.emitted:
                lo = self._widen_lo(max(slot.emitted - self.stream_context, 0), total)
                emits.append((row, lo, total, slot.emitted))
                slot.emitted = safe
        if finished:
            retire.append(row)

    def _emit_stream(self, emits: List[Tuple[int, int, int, int]]) -> None:
        """Vocode sliding windows for streaming rows and push the pieces.

        Windows with the same padded length share one vocoder call reading
        the device code log; a window with ``stream_context`` frames of left
        context reproduces the full-utterance vocode of its emitted samples.
        """
        log = self._codes_log()
        by_len: Dict[int, List[Tuple[int, int, int, int]]] = {}
        for row, lo, hi, emit_from in emits:
            by_len.setdefault(_round_up(hi - lo, self.chunk), []).append((row, lo, hi, emit_from))
        for w, group in by_len.items():
            with profiling.stage("serve/stream_vocode"):
                rows = _upload(np.array([g[0] for g in group], np.int64), self.device)
                los = _upload(np.array([g[1] for g in group], np.int64), self.device)
                ends = _upload(np.array([g[2] for g in group], np.int64), self.device)
                wav = self._stream_vocode(log, rows, los, ends, w)
                pieces = []
                for b, (row, lo, hi, emit_from) in enumerate(group):
                    emit_to = self._slots[row].emitted  # set before the dispatch
                    pieces.append(self._stream_piece(wav[b], lo, hi, emit_from, emit_to))
                ev = _record(self.device)
                for (row, _lo, _hi, _ef), piece in zip(group, pieces):
                    slot = self._slots[row]
                    slot.pieces.append(piece)
                    if slot.req.t_first_audio is None:
                        slot.req.t_first_audio = time.time()
                    slot.req._chunk_q.put((piece, self.model.sample_rate, ev))

    def _widen_lo(self, lo: int, hi: int) -> int:
        """Model hook: widen a streaming window's start frame. Default: as is."""
        return lo

    def _stream_vocode(self, log, rows, los, ends, w: int):
        """Model hook: vocode per-row sliding windows from the whole device log."""
        return _vocode_windows(self.model.params, self.cfg, log, rows, los, ends, w)

    def _stream_piece(self, wav_row, lo: int, hi: int, emit_from: int, emit_to: int):
        """Model hook: one emitted piece of a window covering frames ``[lo, hi)``."""
        hop = self.cfg.codec.hop
        return wav_row[(emit_from - lo) * hop: (emit_to - lo) * hop]

    def _retire(self, rows: List[int]) -> None:
        """Trim and (bucket-)vocode finished rows from the device code log;
        free their slots.

        Rows are freed BEFORE vocoding so this step's admission can refill
        them: the vocode and code gathers queued here run ahead of any
        re-admission's writes on the engine's stream.
        """
        _js, local = self._own(rows)
        if local:
            rows_t = _upload(np.array(local, np.int64), self.device)
            self._active_dev.index_fill_(0, rows_t, False)
            self._done.index_fill_(0, rows_t, True)
        log = self._codes_log()
        by_len: Dict[int, List[Tuple[ServeRequest, int, int]]] = {}
        for row in rows:
            slot = self._slots[row]
            req = slot.req
            self._active[row] = False
            slot.req = None
            if slot.cancel:
                slot.pieces = []
                self._end_request(req)
                continue
            end = slot.done_seen if slot.done_seen is not None else slot.frames
            end = max(min(end, req.max_frames), 1)
            req.n_frames = end
            self.frames_delivered += end
            if req.stream:
                # The streamed pieces ARE the waveform (the final flush went
                # out in _emit_stream); the codes are snapshotted, since the
                # row's log is rewritten by the next admission.
                codes = log[row, :end][None].clone()
                req._wav = (torch.cat(slot.pieces) if slot.pieces else
                            torch.zeros(0, dtype=torch.float32, device=self.device))
                ev = _record(self.device)
                req._codes_ref = (codes, 0, end, ev)
                req._wav_ready = ev
                req.sample_rate = self.model.sample_rate
                slot.pieces = []
                slot.emitted = 0
                self.requests_done += 1
                self._end_request(req)
                continue
            by_len.setdefault(_round_up(end, self.chunk), []).append((req, row, end))

        with profiling.stage("serve/retire_vocode"):
            for t, group in by_len.items():
                rows_arr = _upload(np.array([g[1] for g in group], np.int64), self.device)
                ends_arr = _upload(np.array([g[2] for g in group], np.int64), self.device)
                wav, codes_masked = self._retire_vocode(log, rows_arr, ends_arr, t)
                wavs = [self._finish_wav(wav[b], end) for b, (_r, _row, end) in enumerate(group)]
                ev = _record(self.device)
                for b, (req, _row, end) in enumerate(group):
                    req._codes_ref = (codes_masked, b, end, ev)
                    req._wav, req._wav_ready = wavs[b], ev
                    req.sample_rate = self.model.sample_rate
                    self.requests_done += 1
                    req._resolve()

    def _retire_vocode(self, log, rows_arr, ends_arr, t: int):
        """Model hook: vocode retiring rows from the whole device log; returns
        (waveforms (G, t*hop), the masked codes (G, t, nq) behind the lazy
        ``ServeRequest.codes``)."""
        return _vocode_rows(self.model.params, self.cfg, log, rows_arr, ends_arr, t)

    def _finish_wav(self, wav_row, end: int):
        """Model hook: the final per-request waveform from its vocoded row."""
        return wav_row[: end * self.cfg.codec.hop]

    # -- main loop ----------------------------------------------------------

    def _dispatch(self) -> _Lagged:
        """Dispatch ONE decode chunk (or k speculative rounds) over the slot
        batch; returns the lagged-harvest payload."""
        self.dispatches += 1
        if self.draft is not None:
            from .serving_spec import _spec_serve_rounds

            (harvest, self._codes_buf, self._last_codes, self._done, self._spec_cols,
             self._rope_next, self._frames_done) = _spec_serve_rounds(
                self.model.params, self.draft.params,
                self._cache_k, self._cache_v, self._key_valid,
                self._d_cache_k, self._d_cache_v, self._d_key_valid,
                self._codes_buf, self.cfg, self.draft.config, self._spec_cols,
                self._rope_next, self._last_codes, self._done, self._active_dev,
                self._seeds, self._temp, self._frames_done, self._min_frames,
                self.gamma, self.top_k, self.residual_mode, self.spec_k,
            )
            self.spec_rounds += self.spec_k
            return _Lagged(harvest)
        (done_chunk, self._last_codes, self._done, self._rope_next,
         self._frames_done) = _serve_decode_chunk(
            self.model.params, self._cache_k, self._cache_v, self._key_valid, self._codes_buf,
            self.cfg, self._col, self._rope_next, self._last_codes, self._done,
            self._active_dev, self._seeds, self._temp, self._frames_done, self._min_frames,
            self.chunk, self.top_k, self._tp,
        )
        self._col = (self._col + self.chunk) % self.ring
        return _Lagged(all_gather(done_chunk, 0, self._data))

    def step(self) -> bool:
        """One scheduler iteration: admit -> dispatch a chunk -> harvest the
        previous chunk (its fetch overlaps the new chunk's execution).
        Single-threaded driver only. Returns True if any work was done."""
        return self._step(False)[0]

    def _step(self, stop: bool) -> Tuple[bool, bool]:
        """:meth:`step`, asking to stop; returns (work done, stop agreed)."""
        with self._on_stream():
            with profiling.stage("serve/admit"):
                stop, picked = self._plan(stop)
                if stop:
                    return False, True
                self._admit(picked)
            if self._active.any():
                owners = [self._slots[i].req for i in range(self.n_slots)]
                with profiling.stage("serve/dispatch"):
                    payload = self._dispatch()
                if self._t_first is None:
                    self._t_first = time.time()
                prev, self._pending = self._pending, (payload, owners)
                if prev is not None:
                    self._harvest_one(prev)
                self._t_last = time.time()
                return True, False
            if self._pending is not None:
                self._flush()
                self._t_last = time.time()
                return True, False
            return False, False

    def run_until_idle(self) -> None:
        """Drive the loop until queue, slots and pending harvest drain."""
        while True:
            self.step()
            if not (self._queued or self._active.any() or self._pending is not None):
                return

    def start(self) -> None:
        """Serve on a background thread until :meth:`stop` (on a mesh, until
        the first rank's :meth:`stop`; every rank starts one)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            try:
                while True:
                    worked, stop = self._step(self._stop.is_set())
                    if stop:
                        break
                    if not worked:
                        with self._wake:
                            if not self._queue and not self._stop.is_set():
                                self._wake.wait(timeout=0.05)
            except BaseException as e:  # noqa: BLE001
                # A dead serving thread must not strand waiters: fail every
                # queued and in-flight request with the error.
                logger.exception("serving loop failed; failing outstanding work")
                self._loop_error = e
                self._stop.set()
                self._fail_outstanding(RuntimeError(f"serving loop failed: {e!r}"))

        self._thread = threading.Thread(target=loop, daemon=True, name="tts-serving")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._wake:
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def close(self) -> None:
        """Stop serving, fail outstanding work (queued and in-flight requests
        resolve with a ``RuntimeError``) and release the KV ring."""
        self.stop()
        self._fail_outstanding(RuntimeError("serving engine closed"))
        if self._stream is not None:
            self._stream.synchronize()
        self._cache_k = self._cache_v = self._key_valid = None
        self._codes_buf = None
        if self.draft is not None:
            self._d_cache_k = self._d_cache_v = self._d_key_valid = None
            self._spec_cols = None

    def _fail_outstanding(self, error: BaseException) -> None:
        """Resolve every queued and in-flight request with ``error``."""
        with self._lock:
            abandoned = list(self._queue)
            self._queue.clear()
        for slot in self._slots:
            if slot.req is not None:
                abandoned.append(slot.req)
                slot.req = None
                slot.pieces = []
        self._active[:] = False
        for req in abandoned:
            if not req.done():
                req.error = error
                self._end_request(req)
        self._pending = None

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        wall = (self._t_last - self._t_first
                if self._t_first is not None and self._t_last is not None else 0.0)
        audio_sec = self.frames_delivered / self.cfg.codec.frame_rate
        return {
            "requests_done": self.requests_done,
            "frames_decoded": self.frames_decoded,
            "frames_delivered": self.frames_delivered,
            "serve_wall_s": wall,
            "aggregate_rtf": (audio_sec / wall) if wall > 0 else 0.0,
        }
