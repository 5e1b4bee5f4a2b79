"""Quality-validation stack: drift classifier, STT text match, similarity.

Counterpart of ``rho_tts_tpu/validation``. Validators accept in-memory
(waveform, sample_rate) pairs, waveforms as tensors on the model's device,
so the retry loop never round-trips through temp WAV files; file paths are
still accepted everywhere for API compatibility.
"""
