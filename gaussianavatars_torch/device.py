"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. A request
for CUDA on a host without a GPU raises: nothing carries on quietly on the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device, raising when CUDA is not there.

    On CUDA this also pins float32 matmuls and convolutions to full float32
    (no TF32): the JAX package runs every matmul on the render path at
    `Precision.HIGHEST`, and the FLAME blendshapes and LBS feed the frames
    that place every Gaussian.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def route(t: torch.Tensor, cuda_fn, plain_fn):
    """`cuda_fn` (a kernel's wrapper) for a tensor on a CUDA device,
    `plain_fn` (its plain version) for one on the CPU; nothing falls back
    from one to the other, and any other device raises."""
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"no kernel and no plain version for device {t.device}")
