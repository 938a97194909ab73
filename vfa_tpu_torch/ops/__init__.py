"""The port's ops. Where a layer has a serving-only kernel beside a chain
that autograd differentiates, its function here takes the kernel for
bfloat16 inputs when `not needs_grad(...)`, on any device."""

import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
