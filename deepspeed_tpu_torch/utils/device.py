"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. Without CUDA and without an explicit device it raises:
the port never carries on on the CPU by itself.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device=\"cpu\" to run the plain "
                "PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} asked for CUDA and none "
                           "is available; pass device=\"cpu\" for the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {str(device)!r}: expected 'cuda' or 'cpu'")
    return dev
