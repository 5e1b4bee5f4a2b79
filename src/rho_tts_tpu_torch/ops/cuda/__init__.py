"""Hand-written Hopper kernels (``csrc/*.cu``) and their PyTorch wrappers."""
