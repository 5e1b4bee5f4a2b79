"""Hand-written Hopper kernels (``csrc/*.cu``) and their PyTorch wrappers."""

import torch


def check_no_autograd(kernel: str, plain: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record a kernel's output.

    The kernels have no backward (the JAX package's Pallas kernels have none
    either), so a launch under grad mode on inputs that require grad would
    return a tensor with no ``grad_fn`` and cut the gradient silently. The
    wrappers call this on every device, so the CPU behaves as the card.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: call it under torch.no_grad() or "
            f"torch.inference_mode(), or call {plain} (plain PyTorch) for gradients"
        )
