"""The port's one device rule.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``. A
request for CUDA on a machine without it raises: nothing falls back to the
CPU behind the caller's back, so a run on the CPU is always one somebody
asked for (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT = "cuda"


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` (default ``cuda``) as a ``torch.device``; raises when CUDA
    is requested and absent."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
