"""TTS providers of the port (``qwen``, ``chatterbox``)."""
