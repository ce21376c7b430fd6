"""GaussianAvatars in PyTorch and CUDA for NVIDIA Hopper.

The port of `gaussianavatars_tpu` (JAX on a TPU). Module paths and names
follow the JAX package so each function has an obvious counterpart there;
the JAX package stays the reference the port is tested against.

This package imports torch and numpy only: nothing of JAX and nothing of
`gaussianavatars_tpu`.
"""

from gaussianavatars_torch.device import resolve_device

__all__ = ["resolve_device"]
