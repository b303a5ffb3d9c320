"""Device gate for the hand-written kernels.

Counterpart of the JAX package's ``core/hw.py:on_tpu``.  There the gate
asks which platform the next computation targets; here the tensors in hand
already say where they live, so the gate asks them.  A kernel wrapper runs
its plain PyTorch version for CPU tensors, launches its kernel when
``on_cuda`` holds, and raises otherwise.
"""

from __future__ import annotations

import torch

__all__ = ["on_cuda", "kernel_device", "KERNEL_CAPABILITY"]

# The kernels are compiled for sm_90a (Hopper).
KERNEL_CAPABILITY = (9, 0)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device of compute
    capability 9.0 (H100 / H200)."""
    devices = {t.device for t in tensors}
    return len(devices) == 1 and kernel_device(devices.pop())


def kernel_device(device) -> bool:
    """True when ``device`` is a CUDA device of compute capability 9.0: the
    build-time gate of paths that choose a kernel only where it runs (the
    JAX package's ``on_tpu``)."""
    if device is None:
        return False
    device = torch.device(device)
    return (device.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.get_device_capability(device) == KERNEL_CAPABILITY)
