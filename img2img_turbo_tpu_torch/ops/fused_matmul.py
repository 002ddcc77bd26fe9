"""LayerNorm + matmul engine wrapper: kernel K3 (CUDA, `csrc/fused_matmul.cu`).

Counterpart of `img2img_turbo_tpu/ops/fused_matmul.py:321 fused` (Pallas
body `_kernel :186`, plain reference `_ref :155-183`):

- fused(x, (w,), (b,))                       plain matmul: proj_in/out
- fused(..., ln=(s, b))                      LN + matmul: cross-attn q
- fused(..., residual=r)                     residual added after the cast
- fused(x, (wq, wk, wv), ..., ln=...)        shared-LN 3-output self qkv
- fused(ctx, (wk, wv), ...)                  2-output cross kv
- fused(x, (w_packed,), (b_packed,), gate=True, ln=...)
                                             (xn@wv+bv) * gelu_erf(xn@wg+bg)

Weights are nn.Linear's (Co, C) (the transpose of the JAX layout), one
packed (2Co, C) with the value rows first in gate mode: the kernel reads
them as they are, so neither a loaded model nor a training step with live
weights transposes them. `fused_ref` is the kernel's exact plain version:
the wrapper computes it on a CPU tensor, and it decides the kernel's
correctness. `fused_plain` is what the plain engine (`use_kernels=False`)
runs, and the yardstick of the kernel's speed. On a CUDA tensor the wrapper
launches the kernel or raises. The wrapper counts its launches, and its
launches by (M, C, Co, outputs, LN, gate, residual) in
`_build.launch_shapes`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from img2img_turbo_tpu_torch.ops import _build


def _fn():
    lib = _build.load("fused_matmul")
    f = lib.fused_matmul_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last dim: fp32 statistics and affine, rounded once
    to x.dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps)
    return (xn * scale.float() + bias.float()).to(x.dtype)


def fused_ref(x, ws, bs, *, ln=None, residual=None, gate: bool = False,
              eps: float = 1e-5):
    """Plain version (the counterpart of `_ref`): fp32 LayerNorm rounded to
    x.dtype, fp32 matmuls + bias, exact-erf gate, cast, then the residual
    added in x.dtype. Weights (Co, C), or one packed (2Co, C) in gate
    mode."""
    if gate:
        co = ws[0].shape[0] // 2
        ws = (ws[0][:co], ws[0][co:])
        bs = (bs[0][:co], bs[0][co:])
    xh = x if ln is None else layer_norm(x, ln[0], ln[1], eps)
    ys = [xh.float() @ w.float().t() + b.float() for w, b in zip(ws, bs)]
    if gate:
        ys = [ys[0] * F.gelu(ys[1])]
    outs = []
    for y in ys:
        y = y.to(x.dtype)
        if residual is not None:
            y = y + residual
        outs.append(y)
    return tuple(outs)


def fused_plain(x, ws, bs, *, ln=None, residual=None, gate: bool = False,
                eps: float = 1e-5):
    """The plain engine's K3: LayerNorm as in `fused_ref`, then one
    F.linear in x.dtype per weight, the exact-erf gate on the packed
    output's halves, and the residual added last. Weights as nn.Linear holds
    them: (Co, C) each, or one packed (2Co, C) in gate mode; a bias may be
    None."""
    dt = x.dtype
    xh = x if ln is None else layer_norm(x, ln[0], ln[1], eps)
    ys = [F.linear(xh, w.to(dt), None if b is None else b.to(dt))
          for w, b in zip(ws, bs)]
    if gate:
        h, g = ys[0].chunk(2, dim=-1)
        ys = [h * F.gelu(g)]
    if residual is not None:
        ys = [y + residual for y in ys]
    return tuple(ys)


def _check(name, t, shape, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected {dtype} "
                         f"on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def fused(x, ws, bs, *, ln=None, residual=None, gate: bool = False,
          eps: float = 1e-5):
    """K3 on (..., C) inputs; returns a tuple of (..., Co) outputs (one per
    weight, or one in gate mode). ws: (Co, C) bf16 each, nn.Linear's
    layout, or one packed (2Co, C) in gate mode, value rows first; bs: fp32
    (Co,) each (packed (2Co,) in gate mode); ln: (scale, bias) fp32 over C;
    residual: (..., Co), one output only."""
    if not 1 <= len(ws) <= 3 or len(ws) != len(bs):
        raise ValueError("fused: 1-3 weights with one bias each")
    if gate and len(ws) != 1:
        raise ValueError("fused: gate mode takes one packed (2Co, C) weight")
    if residual is not None and len(ws) != 1:
        raise ValueError("fused: a residual needs a single output")
    c = x.shape[-1]
    co = ws[0].shape[0] // (2 if gate else 1)
    for i, w in enumerate(ws):
        if tuple(w.shape) != (2 * co if gate else co, c):
            raise ValueError(f"fused: w{i} {tuple(w.shape)} is not nn.Linear's "
                             f"(Co, C) layout for C = {c}")
    if x.device.type == "cpu":
        return fused_ref(x, ws, bs, ln=ln, residual=residual, gate=gate,
                         eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused: unsupported device {x.device}")
    lead = x.shape[:-1]
    if c % 8 or co % 8:
        raise ValueError(f"fused: C={c} and Co={co} must be multiples of 8")
    m = x.numel() // c
    dev, bf = x.device, torch.bfloat16
    x2 = x.reshape(m, c)
    _check("x", x2, (m, c), bf, dev)
    for i, (w, b) in enumerate(zip(ws, bs)):
        _check(f"w{i}", w, (2 * co if gate else co, c), bf, dev)
        _check(f"b{i}", b, (2 * co if gate else co,), torch.float32, dev)
    if ln is not None:
        _check("ln_scale", ln[0], (c,), torch.float32, dev)
        _check("ln_bias", ln[1], (c,), torch.float32, dev)
    res2 = None
    if residual is not None:
        res2 = residual.reshape(m, co)
        _check("residual", res2, (m, co), bf, dev)
    n_out = 1 if gate else len(ws)
    ys = [torch.empty((m, co), device=dev, dtype=bf) for _ in range(n_out)]
    wp = [_build.ptr(w) for w in ws] + [_build.ptr(None)] * (3 - len(ws))
    bp = [_build.ptr(b) for b in bs] + [_build.ptr(None)] * (3 - len(bs))
    yp = [_build.ptr(y) for y in ys] + [_build.ptr(None)] * (3 - n_out)
    err = _fn()(_build.ptr(x2),
                _build.ptr(None if ln is None else ln[0]),
                _build.ptr(None if ln is None else ln[1]),
                *wp, *bp, _build.ptr(res2), *yp, m, c, co, n_out, int(gate),
                float(eps), _build.stream())
    _build.check(err, "fused_matmul_bf16")
    _build.launch_counts["fused_matmul"] += 1
    _build.launch_shapes["fused_matmul", (m, c, co, n_out, ln is not None,
                                          gate, res2 is not None)] += 1
    return tuple(y.reshape(*lead, co) for y in ys)
