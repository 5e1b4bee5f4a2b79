"""Speaker encoder (GE2E-class) for similarity validation and drift-classifier
features, in PyTorch.

Counterpart of ``rho_tts_tpu/models/speaker``: a 3-layer LSTM over 40
log-mel frames → 256-d L2-normalized utterance embedding.
"""

from .encoder import SpeakerEncoder, load_pretrained
