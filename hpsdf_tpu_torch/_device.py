"""The default device of the port's entry points: the CUDA device.

Every public function that takes a ``device`` defaults to ``"cuda"`` and
resolves it here. Without a CUDA device that raises: the port never moves
to the CPU by itself. The CPU runs the kernels' plain versions, and only
when the caller asks for it with ``device="cpu"``.

On CUDA tensors a wrapper either launches the kernel that computes its
gradient or refuses to run where one is asked for (``refuse_grad``): no
wrapper returns a tensor cut off from an input that requires a gradient.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device=DEFAULT) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device on a machine without one."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev


def wants_grad(*tensors) -> bool:
    """Whether autograd records and one of ``tensors`` requires a
    gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel without a backward would be asked for a
    gradient."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{what} has no backward kernel: it cannot carry "
                           "a gradient")
