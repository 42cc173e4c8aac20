"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  Without a
card they raise: the caller has to ask for the CPU (``device="cpu"``,
as the tests do), and nothing drops to it silently.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device``; a bare ``"cuda"`` names the
    current card with its index, so it compares equal to the device of
    the tensors made there."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the "
                "CPU through the plain PyTorch versions of the kernels"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
