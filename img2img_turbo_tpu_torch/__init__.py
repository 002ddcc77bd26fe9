"""img2img-turbo in PyTorch on one NVIDIA H100 (Hopper, sm_90a).

The counterpart of the JAX package `img2img_turbo_tpu`, module for module:
the same NHWC layouts and uint8-in/uint8-out serving path, with every Pallas
kernel of that path rewritten by hand for Hopper (CUDA C++ under `csrc/`,
one Triton kernel) and a plain PyTorch version beside each kernel. The
package imports `torch` and never `jax`; from the reference package it
reads only the jax-free `img2img_turbo_tpu.configs` dataclasses.
"""

__version__ = "0.1.0"
