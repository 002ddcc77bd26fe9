"""Attention: kernel K2 (CUDA, `csrc/attention.cu`) and its plain version.

Counterpart of `img2img_turbo_tpu/ops/attention.py:204
flash_attention_folded` (Pallas body `_flash_heads_kernel :151`) and of
`_mha_xla :479-487`. Inputs stay in the folded (B, S, H*hd) layout.
`mha_ref` is both the kernel's plain version (its correctness yardstick,
and what the wrapper computes on a CPU tensor) and what the plain engine
(`use_kernels=False`) runs.

On the card every attention of the main path goes through the kernel,
whatever Sq (the TPU's `sq >= 256` dispatch gate was a tiling choice). The
kernel takes hd = 64 (UNet) and hd = 512 (the one-head VAE mid attention);
other head sizes raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from img2img_turbo_tpu_torch.ops import _build

HEAD_DIMS = (64, 512)


def _fn():
    lib = _build.load("attention")
    f = lib.flash_attention_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def mha_ref(q, k, v, num_heads: int):
    """Plain version (the counterpart of `_mha_xla`): fp32 scores and
    softmax, probabilities cast to v.dtype, fp32 accumulation."""
    b, sq, d = q.shape
    skv = k.shape[1]
    hd = d // num_heads
    qh = q.reshape(b, sq, num_heads, hd).transpose(1, 2)
    kh = k.reshape(b, skv, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, skv, num_heads, hd).transpose(1, 2)
    s = (qh.float() @ kh.float().transpose(-1, -2)) / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    o = (p.to(v.dtype).float() @ vh.float()).to(q.dtype)
    return o.transpose(1, 2).reshape(b, sq, d)


def flash_attention_folded(q, k, v, num_heads: int):
    """K2. q: (B, Sq, D), k/v: (B, Skv, D), D = num_heads * hd; returns
    (B, Sq, D). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_folded: unsupported device "
                         f"{q.device}")
    b, sq, d = q.shape
    skv = k.shape[1]
    if d % num_heads or d // num_heads not in HEAD_DIMS:
        raise ValueError(f"flash_attention_folded: head dim "
                         f"{d}/{num_heads} not in {HEAD_DIMS}")
    if skv < 1 or sq < 1:
        raise ValueError("flash_attention_folded: empty sequence")
    for name, t, shape in (("q", q, (b, sq, d)), ("k", k, (b, skv, d)),
                           ("v", v, (b, skv, d))):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"bfloat16 on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be contiguous, 16-byte aligned")
    o = torch.empty_like(q)
    err = _fn()(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                b, sq, skv, num_heads, d // num_heads, _build.stream())
    _build.check(err, "flash_attention_bf16")
    _build.launch_counts["flash_attention_folded"] += 1
    return o
