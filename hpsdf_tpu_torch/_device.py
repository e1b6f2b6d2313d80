"""The default device of the port's entry points: the CUDA device.

Every public function that takes a ``device`` defaults to ``"cuda"`` and
resolves it here. Without a CUDA device that raises: the port never moves
to the CPU by itself. The CPU runs the kernels' plain versions, and only
when the caller asks for it with ``device="cpu"``.
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
