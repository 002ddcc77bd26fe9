"""img2img-turbo in PyTorch on one NVIDIA H100 (Hopper, sm_90a).

The counterpart of the JAX package `img2img_turbo_tpu`, module for module:
the same NHWC layouts, the uint8-in/uint8-out serving path and the paired
and unpaired training steps, with every Pallas kernel of those paths
rewritten by hand for Hopper (CUDA C++ under `csrc/`) and a plain PyTorch
version beside each kernel. The package imports `torch` and never `jax`,
nor any module of the JAX package: it keeps its own copy of the configs.
"""

__version__ = "0.2.0"


def resolve_device(device=None):
    """The device an entry point runs on: `device` when given, else the
    first CUDA card. Without a card the caller must ask for the CPU
    (device="cpu"); nothing falls back to it silently."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda", 0)
