"""Drift-classifier trainer: feature extraction on the device + host-side forest fit.

Counterpart of ``rho_tts_tpu/validation/classifier/trainer.py``. Feature
vector (286-d, format-compatible with the reference so datasets transfer):
256-d speaker embedding, 13 MFCC means, 13 MFCC stds, F0 mean/std over
voiced frames, and F1/F2 formants. Features come from ``ops.features`` and
``models.speaker``; the cost-sensitive RandomForest + isotonic calibration +
threshold sweep runs on the host (tiny data; sklearn and joblib are
imported by the functions that need them).

CLI::

    python -m rho_tts_tpu_torch.validation.classifier.trainer --dataset-dir DIR
"""

from __future__ import annotations

import logging
import math
import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

# Speaker encoders by device (shared with similarity validation)
_encoders: Dict[str, object] = {}

#: Times :func:`extract_features_batch_audio` fell back to the serial path
#: (the JAX package's best-effort semantics; the chip smoke run requires 0).
serial_fallbacks = 0
#: Host fetches of the batched drift statistics (one per batch).
fetches = 0


def _get_encoder(device):
    key = str(torch.device(device))
    if key not in _encoders:
        from ...models.speaker import SpeakerEncoder

        _encoders[key] = SpeakerEncoder(device=key)
    return _encoders[key]


def _load_audio(audio, sample_rate: Optional[int]):
    if isinstance(audio, str):
        from ...audio_io import load_wav

        return load_wav(audio)
    if sample_rate is None:
        raise ValueError("sample_rate is required for in-memory audio")
    if isinstance(audio, torch.Tensor):
        return audio.detach().to(torch.float32).reshape(-1), int(sample_rate)
    return np.asarray(audio, np.float32).reshape(-1), int(sample_rate)


def extract_features(
    audio: Union[str, np.ndarray, torch.Tensor],
    sample_rate: Optional[int] = None,
    device=None,
) -> Optional[np.ndarray]:
    """Speaker/acoustic/prosodic features for one utterance (286-d, host numpy).

    Accepts a wav path or an in-memory waveform. A tensor is processed on
    its device, host input on ``device`` (default ``"cuda"``). Returns None
    on failure (callers treat that as "skip validation").
    """
    try:
        from ...ops import features as feats
        from ...ops.resample import resample

        wav, sr = _load_audio(audio, sample_rate)
        dev = wav.device if isinstance(wav, torch.Tensor) else torch.device(device or "cuda")
        wav = torch.as_tensor(wav).to(dev)

        embed = _get_encoder(dev).embed_utterance(wav, sr)
        y = resample(wav, sr, feats.MFCC_SR) if sr != feats.MFCC_SR else wav
        m = feats.mfcc(y).cpu().numpy().astype(np.float32)
        mfcc_mean = m.mean(axis=1)
        mfcc_std = m.std(axis=1)

        f0, voiced = feats.f0_yin(y)
        f0_voiced = f0[voiced]
        f0_mean = float(np.mean(f0_voiced)) if f0_voiced.size else 0.0
        f0_std = float(np.std(f0_voiced)) if f0_voiced.size else 0.0

        f1, f2 = feats.estimate_formants(y)

        return np.concatenate([embed, mfcc_mean, mfcc_std, [f0_mean, f0_std, f1, f2]])
    except Exception as e:  # noqa: BLE001 — feature failure is non-fatal
        logger.error("Error processing %s: %s", audio if isinstance(audio, str) else "<array>", e)
        return None


def extract_features_batch(paths, progress_callback=None, progress_interval=10, device=None):
    """Feature-extract many files; returns (features list, ok mask)."""
    out, ok = [], []
    for i, p in enumerate(paths):
        f = extract_features(p, device=device)
        out.append(f)
        ok.append(f is not None)
        if progress_callback and ((i + 1) % progress_interval == 0 or i + 1 == len(paths)):
            progress_callback(f"Extracting: {i + 1}/{len(paths)}")
    return out, ok


# ---------------------------------------------------------------------------
# Batched in-memory feature extraction (the validation hot path)
#
# The whole batch runs on the device — resampling, MFCC statistics, YIN
# pitch picking, speaker VAD + LSTM embedding, formant autocorrelation — and
# the host fetches only the small per-clip statistics, once a batch.
# ---------------------------------------------------------------------------

_YIN_FRAME = 2048
_YIN_HOP = 512
_MFCC_HOP = 512
_MFCC_NFFT = 2048
_LPC_ORDER = 18  # max(12, 16000 // 1000 + 2), matching estimate_formants
_LPC_FRAME = 400  # 25 ms at 16 kHz


def _bucket(n: int, minimum: int = 16000) -> int:
    """Next power-of-two bucket >= max(n, minimum) (bounds the shapes)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _drift_device_core(spk_params, wavs16: torch.Tensor, lens16: torch.Tensor, nwb: int):
    """All drift features for a bucketed 16 kHz batch, on the device.

    wavs16 (B, L) zero-padded; lens16 (B,) int64 valid lengths. Returns
    small per-clip statistics only: (mfcc_mean (B,13), mfcc_std (B,13),
    f0_mean (B,), f0_std (B,), embeds (B,256), autocorr r (B, order+1)).
    Nothing here waits for the device.
    """
    from ...models.speaker import encoder as spk_enc
    from ...ops import features as feats

    b, l = wavs16.shape
    dev = wavs16.device
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731

    # ---- MFCC statistics (masked; zero padding past each clip's length
    # IS the librosa>=0.10 constant-pad boundary semantics) ----
    mean, std = feats._mfcc_stats_batch(wavs16, 1 + lens16 // _MFCC_HOP, feats.MFCC_SR, 13,
                                        _MFCC_NFFT, _MFCC_HOP, 128)

    # ---- F0 via YIN, picked and reduced on the device ----
    tau_min = max(int(feats.MFCC_SR / 2093.0), 1)
    tau_max = min(int(feats.MFCC_SR / 65.41) + 1, _YIN_FRAME // 2)
    # YIN frames are masked to lie fully inside the valid region below, so
    # the zero tail never reaches a counted frame.
    cmnd, e0 = feats._yin_cmnd(wavs16, _YIN_FRAME, _YIN_HOP, tau_max)  # (B, T, tau)
    f0, voiced = feats.yin_pick_device(cmnd, e0, feats.MFCC_SR, tau_min, tau_max, _YIN_FRAME,
                                       0.1, 0.5)
    yin_counts = torch.clamp_min((lens16 - _YIN_FRAME) // _YIN_HOP + 1, 1)
    frame_ok = ar(f0.shape[-1])[None, :] < yin_counts[:, None]
    vmask = (voiced & frame_ok).to(torch.float32)
    cnt = torch.clamp_min(vmask.sum(-1), 1.0)
    f0_mean = (f0 * vmask).sum(-1) / cnt
    f0_var = (((f0 - f0_mean[:, None]) ** 2) * vmask).sum(-1) / cnt
    any_voiced = vmask.sum(-1) > 0
    f0_mean = torch.where(any_voiced, f0_mean, 0.0)
    f0_std = torch.where(any_voiced, torch.sqrt(f0_var), 0.0)

    # ---- Speaker embedding: normalize → VAD → log-mel → LSTM windows ----
    jmask = (ar(l)[None, :] < lens16[:, None]).to(torch.float32)
    denom = torch.clamp_min(lens16.to(torch.float32), 1.0)
    rms = torch.sqrt((wavs16 * wavs16 * jmask).sum(-1) / denom)
    target = 10.0 ** (spk_enc.TARGET_DBFS / 20)
    gain = torch.where(rms > 1e-8, target / torch.clamp_min(rms, 1e-8), 1.0)
    w = wavs16 * gain[:, None]

    win = int(spk_enc.SAMPLE_RATE * spk_enc.VAD_WINDOW_MS / 1000)
    nfr = l // win
    frames = w[:, : nfr * win].reshape(b, nfr, win)
    frame_rms = torch.sqrt((frames * frames).mean(-1))
    voiced_fr = frame_rms > 10.0 ** (spk_enc.VAD_THRESHOLD_DB / 20)
    # Dilate by one frame each side (conv ones(3) > 0), then clip to the
    # frames that exist in the per-clip computation (fully within lens).
    v = voiced_fr.to(torch.float32)
    dil = v + F.pad(v[:, 1:], (0, 1)) + F.pad(v[:, :-1], (1, 0))
    nfr_valid = lens16 // win  # frames fully inside the valid region
    voiced_fr = (dil > 0) & (ar(nfr)[None, :] < nfr_valid[:, None])
    n_voiced = voiced_fr.sum(-1)
    # Per-clip semantics: if nothing passes the VAD (or the clip is shorter
    # than one frame), keep the signal as-is.
    use_vad = (n_voiced > 0) & (lens16 > win)
    # Stable-compact the voiced frames to the front, preserving order
    # (key 0 for voiced, 1 for the rest, as argsort(~voiced, stable)).
    order = torch.sort((~voiced_fr).to(torch.uint8), dim=-1, stable=True).indices
    compact = torch.gather(frames, 1, order[..., None].expand(b, nfr, win))
    keep = ar(nfr)[None, :] < n_voiced[:, None]
    compact = F.pad((compact * keep[..., None]).reshape(b, nfr * win), (0, l - nfr * win))
    # Append the sub-frame remainder wav[nfr_valid*win : lens16].
    rem_len = lens16 - nfr_valid * win
    jr = ar(win)[None, :]
    src = torch.clamp(nfr_valid[:, None] * win + jr, 0, l - 1)
    rem_ok = jr < rem_len[:, None]
    rem_vals = torch.gather(w, 1, src) * rem_ok
    dst = torch.clamp(n_voiced[:, None] * win + jr, 0, l - 1)
    compact = compact.scatter_add(1, dst, torch.where(rem_ok, rem_vals, 0.0))
    spk_len = torch.where(use_vad, n_voiced * win + rem_len, lens16)
    spk_wav = torch.where(use_vad[:, None], compact, w)

    mels = spk_enc.log_mel(spk_wav)  # (B, Tm, 40)
    t_frames = 1 + spk_len // spk_enc.HOP_LENGTH
    mels = torch.where((ar(mels.shape[1])[None, :] < t_frames[:, None])[..., None], mels, 0.0)
    half = spk_enc.PARTIAL_FRAMES // 2
    starts = (ar(nwb) * half)[None, :].expand(b, nwb)
    win_valid = (starts + spk_enc.PARTIAL_FRAMES <= t_frames[:, None]) | (ar(nwb)[None, :] == 0)
    embeds = spk_enc._forward_windows(spk_params, mels, starts, win_valid)

    # ---- Formants: windowed mid-file frame autocorrelation ----
    y_pre = torch.cat([wavs16[:, :1], wavs16[:, 1:] - 0.97 * wavs16[:, :-1]], dim=-1)
    start = torch.clamp_min(lens16 // 2 - _LPC_FRAME // 2, 0)
    fidx = torch.clamp(start[:, None] + ar(_LPC_FRAME)[None, :], 0, l - 1)
    frame = torch.gather(y_pre, 1, fidx) * (fidx < lens16[:, None])  # clip at the valid end
    hann = 0.5 - 0.5 * torch.cos(2.0 * math.pi * ar(_LPC_FRAME).to(torch.float32)
                                 / (_LPC_FRAME - 1))
    frame = frame * hann[None, :]
    r = torch.stack([(frame[:, : _LPC_FRAME - k] * frame[:, k:]).sum(-1)
                     for k in range(_LPC_ORDER + 1)], dim=-1)
    return mean, std, f0_mean, f0_std, embeds, r


def _core_inputs(audios, of: int, nf: int, device):
    """(raw (B, Lb) zero-padded, 16 kHz batch width) on ``device``."""
    raw_lens = [int(np.prod(np.shape(a))) for a in audios]
    if of == nf:
        lbkt = _bucket(max(raw_lens) + _MFCC_NFFT)
        l16 = lbkt
    else:
        lbkt = _bucket(max(raw_lens))
        l16 = _bucket(-(-nf * lbkt // of) + _MFCC_NFFT)
    rows = [torch.as_tensor(a).to(device=device, dtype=torch.float32).reshape(-1) for a in audios]
    stacked = torch.stack([F.pad(r, (0, lbkt - r.shape[0])) for r in rows])
    return stacked, raw_lens, l16


def batch_statistics(audios, sample_rate: int, device) -> Tuple[torch.Tensor, List[int]]:
    """The device part of :func:`extract_features_batch_audio`: every clip's
    drift statistics packed in one (B, 13+13+1+1+256+19) float64 tensor on
    ``device`` (MFCC mean, MFCC std, F0 mean, F0 std, embedding, formant
    autocorrelation), and the widths of those groups. Nothing here waits
    for the device."""
    from ...models.speaker import encoder as spk_enc
    from ...ops import features as feats
    from ...ops.resample import resample_batch

    b = len(audios)
    sr = int(sample_rate)
    g = math.gcd(sr, feats.MFCC_SR)
    of, nf = sr // g, feats.MFCC_SR // g
    stacked, raw_lens, l16 = _core_inputs(audios, of, nf, device)
    # fills, not an upload from host memory (which would wait for the device)
    lens16 = torch.stack([torch.full((), math.ceil(nf * n / of), dtype=torch.int64,
                                     device=device) for n in raw_lens])
    if of != nf:
        tgt = -(-nf * stacked.shape[-1] // of)
        wav16 = resample_batch(stacked, of, nf, tgt)
        stacked = F.pad(wav16, (0, l16 - wav16.shape[-1]))
    t_max = 1 + l16 // 160  # speaker mel frames upper bound
    nwb = max((t_max - spk_enc.PARTIAL_FRAMES) // (spk_enc.PARTIAL_FRAMES // 2) + 1, 1)
    nwb = -(-nwb // 4) * 4
    with torch.inference_mode():
        stats = _drift_device_core(_get_encoder(device).params, stacked, lens16, nwb)
        sizes = [s.reshape(b, -1).shape[1] for s in stats]
        return torch.cat([s.reshape(b, -1).to(torch.float64) for s in stats], dim=1), sizes


def extract_features_batch_audio(audios, sample_rate: int, device=None):
    """286-d features for a batch of in-memory waveforms (shared rate).

    Returns a list of np.ndarray (None per failed clip). Numerically
    matches :func:`extract_features` to float tolerance. The whole batch
    runs in one pass over bucketed shapes on the waveforms' device (host
    arrays go to ``device``, default ``"cuda"``); the host fetches the
    statistics once and finds the LPC roots on an (order+1)-element
    autocorrelation per clip. On failure it falls back to the serial path
    (counted in :data:`serial_fallbacks`).
    """
    global serial_fallbacks, fetches
    from ...ops import features as feats

    if not audios:
        return []
    first = audios[0]
    dev = first.device if isinstance(first, torch.Tensor) else torch.device(device or "cuda")
    try:
        packed, sizes = batch_statistics(audios, sample_rate, dev)
        host = packed.cpu().numpy()  # the one fetch of the batch
        fetches += 1
        mean, std, f0_mean, f0_std, embeds, r = np.split(host, np.cumsum(sizes)[:-1], axis=1)
        out = []
        for i in range(len(audios)):
            # LPC roots on the host (tiny): same math as estimate_formants
            f1, f2 = feats.formants_from_autocorr(r[i], _LPC_ORDER)
            out.append(np.concatenate([embeds[i], mean[i], std[i],
                                       [f0_mean[i, 0], f0_std[i, 0], f1, f2]]))
        return out
    except Exception as e:  # noqa: BLE001 — fall back to the serial path
        serial_fallbacks += 1
        logger.warning("Batched feature extraction failed (%s); serial fallback", e)
        return [extract_features(a, sample_rate=sample_rate, device=dev) for a in audios]


def train(
    dataset_dir: str,
    voice_id: Optional[str] = None,
    output_path: Optional[str] = None,
    progress_callback: Optional[Callable[[str], None]] = None,
    device=None,
):
    """Train the accent-drift classifier from a good/ + bad/ dataset.

    Cost model: a missed bad clip (false negative) costs 5× a false alarm,
    reflected both in class weights and in the threshold sweep. The fitted
    forest is isotonic-calibrated so the output is a usable probability.
    Features are extracted on ``device`` (default ``"cuda"``).

    Saves a dict of {model, optimal_threshold, costs, metrics, date} via
    joblib to ``output_path`` / the per-voice store / the bundled global
    path.
    """
    from datetime import datetime

    import joblib
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.metrics import brier_score_loss
    from sklearn.model_selection import train_test_split

    if output_path is None:
        if voice_id is not None:
            models_dir = os.path.join(os.path.expanduser("~"), ".rho_tts_tpu", "models")
            os.makedirs(models_dir, exist_ok=True)
            output_path = os.path.join(models_dir, f"{voice_id}_classifier.pkl")
        else:
            output_path = os.path.join(os.path.dirname(__file__), "voice_quality_model.pkl")

    def report(msg: str):
        logger.info(msg)
        if progress_callback:
            progress_callback(msg)

    report("Voice quality classifier training")

    # Gather files
    labeled_files = []
    for label, folder in enumerate(["good", "bad"]):
        folder_path = os.path.join(dataset_dir, folder)
        if not os.path.exists(folder_path):
            raise FileNotFoundError(f"Dataset folder not found: {folder_path}")
        wavs = sorted(f for f in os.listdir(folder_path) if f.endswith(".wav"))
        labeled_files.extend((os.path.join(folder_path, f), label) for f in wavs)

    total = len(labeled_files)
    X, y = [], []
    for i, (path, label) in enumerate(labeled_files):
        feat = extract_features(path, device=device)
        if feat is not None:
            X.append(feat)
            y.append(label)
        if (i + 1) % 10 == 0 or i + 1 == total:
            pct = (i + 1) * 100 // total if total else 0
            report(f"Extracting: {i + 1}/{total} ({pct}%) — {os.path.basename(path)}")

    X, y = np.array(X), np.array(y)
    n_good, n_bad = int(np.sum(y == 0)), int(np.sum(y == 1))
    report(f"Loaded {len(X)} samples ({n_good} good, {n_bad} bad)")

    if len(X) < 5:
        raise ValueError(
            f"Not enough samples to train a classifier (found {len(X)}, need at "
            f"least 5). Add .wav files to {dataset_dir}/good/ and {dataset_dir}/bad/."
        )

    X_train, X_test, y_train, y_test = train_test_split(
        X, y, test_size=0.2, random_state=42, stratify=y
    )
    report(f"Train/test split: {len(X_train)} train, {len(X_test)} test")

    fn_cost, fp_cost = 5.0, 1.0
    n_good_tr, n_bad_tr = np.sum(y_train == 0), np.sum(y_train == 1)
    total_tr = len(y_train)
    class_weights = {
        0: (total_tr / (2 * max(n_good_tr, 1))) * fn_cost,
        1: (total_tr / (2 * max(n_bad_tr, 1))) * fp_cost,
    }

    base_model = RandomForestClassifier(
        n_estimators=200,
        max_depth=10,
        min_samples_leaf=10,
        min_samples_split=20,
        max_features="sqrt",
        random_state=42,
        class_weight=class_weights,
    )
    model = CalibratedClassifierCV(base_model, method="isotonic", cv=5)
    report("Training model (this may take a moment)...")
    model.fit(X_train, y_train)
    report("Training complete! Optimizing threshold...")

    probs = model.predict_proba(X_test)[:, 1]
    best_cost, optimal_threshold = float("inf"), 0.18
    for thresh in np.arange(0.01, 1.0, 0.01):
        pred = (probs >= thresh).astype(int)
        fp = np.sum((y_test == 0) & (pred == 1))
        fn = np.sum((y_test == 1) & (pred == 0))
        cost = (fn * fn_cost + fp * fp_cost) / len(y_test)
        if cost < best_cost:
            best_cost, optimal_threshold = cost, float(thresh)

    brier = brier_score_loss(y_test, probs)
    report(f"Optimal threshold: {optimal_threshold:.3f}")

    joblib.dump(
        {
            "model": model,
            "model_name": "RandomForest",
            "optimal_threshold": optimal_threshold,
            "fn_cost": fn_cost,
            "fp_cost": fp_cost,
            "training_date": datetime.now().isoformat(),
            "class_distribution": {"good": n_good, "bad": n_bad},
            "expected_cost": best_cost,
            "brier_score": brier,
        },
        output_path,
    )
    report(f"Model saved to {output_path} (threshold: {optimal_threshold:.3f}, brier: {brier:.4f})")
    return output_path


if __name__ == "__main__":
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    parser = argparse.ArgumentParser(description="Train the voice quality classifier")
    parser.add_argument("--dataset-dir", required=True, help="Dir with good/ and bad/ wavs")
    parser.add_argument("--voice-id", default=None, help="Voice ID for the per-voice store")
    parser.add_argument("--output", default=None, help="Explicit output model path")
    parser.add_argument("--device", default="cuda", help='"cuda", "cuda:N" or "cpu"')
    args = parser.parse_args()
    train(args.dataset_dir, voice_id=args.voice_id, output_path=args.output, device=args.device)
