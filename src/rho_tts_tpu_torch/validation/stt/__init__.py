"""STT-based validation: transcription, number normalization, fuzzy match."""
