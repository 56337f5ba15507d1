"""Hand-written Hopper kernels (``csrc/``) + their plain PyTorch versions."""

from repro_torch.kernels.ops import attention, matmul
