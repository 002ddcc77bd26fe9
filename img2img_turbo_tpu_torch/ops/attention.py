"""Attention: kernels K2, K7 and K9 (CUDA, `csrc/attention.cu`,
`csrc/attention_bwd.cu`), their plain versions, and the autograd Function
that pairs K2 with K7.

Counterparts of `img2img_turbo_tpu/ops/attention.py:204
flash_attention_folded` (K2, Pallas body `_flash_heads_kernel :151`, with
its `return_lse` output), `:390 flash_attention_folded_bwd` (K7), and of
`_mha_xla :479-487` and the custom VJP `_mha_flash :490-509`: their inputs
stay in the folded (B, S, H*hd) layout. K9, `:85 flash_attention` on
(B, H, S, d) tensors, is reached through the public `default_attention`
(`:523-531`), with `scaled_dot_product_attention` (`:36`) as its plain
version and `flash_attention_ref` (fp32 throughout, one rounding) as its
exact reference; no model path calls it.

`mha_ref` is both K2's plain version (its correctness yardstick, and what
the wrapper computes on a CPU tensor) and what the plain engine
(`use_kernels=False`) runs; `attention_bwd_ref` is K7's: P recomputed from
lse, fp32 throughout, one rounding.

On the card every attention of the main path goes through the kernels,
whatever Sq (the TPU's `sq >= 256` dispatch gate was a tiling choice). The
kernels take hd = 64 (UNet) and hd = 512 (the one-head VAE mid attention);
other head sizes raise. The forward kernel's tiling is chosen in
`csrc/attention.cu`, which reports it (`flash_attention_plan`); the
backward's, with its split of the dk/dv walk and its scratch size, in
`csrc/attention_bwd.cu` (`flash_attention_bwd_plan`).
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
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _bwd_lib():
    lib = _build.load("attention_bwd")
    f = lib.flash_attention_bwd_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        ws = lib.flash_attention_bwd_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 5
        ws.restype = ctypes.c_longlong
        plan = lib.flash_attention_bwd_plan
        plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
    return lib


def flash_attention_bwd_plan(b: int, h: int, sq: int, skv: int,
                             hd: int) -> dict:
    """K7's launch plan for a call, as `csrc/attention_bwd.cu` chooses it
    (CUDA only: the plan lives in the library). At hd 64: each kernel's
    grid, tiles and ring stages, the splits of the dk/dv kernel's Q walk,
    and the kernels a call launches. At hd 512: the scores and products
    kernels' grids (of the first band), tiles and ring stages, the bands of
    Q rows, and the kernels a call launches."""
    p = (ctypes.c_int * 16)()
    _build.check(_bwd_lib().flash_attention_bwd_plan(b, h, sq, skv, hd, p),
                 "flash_attention_bwd_plan")
    if hd == 512:
        return dict(scores_grid=tuple(p[0:3]), scores_tile=(p[3], p[4]),
                    scores_stages=p[5], products_grid=tuple(p[6:9]),
                    products_tile=(p[9], p[15]), products_k_step=p[10],
                    products_stages=p[11], bands=p[12], band_rows=p[13],
                    kernels=p[14])
    return dict(dq_grid=tuple(p[0:3]), dq_rows=p[3], dq_kv_tile=p[4],
                dq_stages=p[5], dkv_grid=tuple(p[6:9]), dkv_rows=p[9],
                dkv_q_tile=p[10], dkv_stages=p[11], split=p[12],
                q_tiles_a_split=p[13], kernels=p[14])


def _bhsd_fn():
    lib = _build.load("attention")
    f = lib.flash_attention_bhsd_bf16
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _heads(t, num_heads):
    """(B, S, H*hd) -> (B, H, S, hd) fp32."""
    b, s, d = t.shape
    return t.float().reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _fold(t, dtype):
    """(B, H, S, hd) -> (B, S, H*hd) in dtype."""
    b, h, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, h * hd).to(dtype)


def mha_ref(q, k, v, num_heads: int, return_lse: bool = False):
    """Plain version (the counterpart of `_mha_xla`): fp32 scores and
    softmax, probabilities cast to v.dtype, fp32 accumulation. With
    return_lse also the (B, Sq, H) fp32 logsumexp of the scaled scores."""
    hd = q.shape[-1] // num_heads
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)) \
        / math.sqrt(hd)
    p = torch.softmax(s, dim=-1)
    o = _fold(p.to(v.dtype).float() @ _heads(v, num_heads), q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).transpose(1, 2).contiguous()


def attention_bwd_ref(q, k, v, o, do, lse, num_heads: int):
    """K7's plain version: P = exp(S*scale - lse) recomputed from the saved
    logsumexp, dV = P^T dO, dS = P * (dO V^T - delta) with
    delta = rowsum(dO * O), dQ = dS K * scale, dK = dS^T Q * scale; fp32
    throughout, each result rounded once to its input's dtype."""
    hd = q.shape[-1] // num_heads
    scale = 1.0 / math.sqrt(hd)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    oh, doh = _heads(o, num_heads), _heads(do, num_heads)
    p = torch.exp(qh @ kh.transpose(-1, -2) * scale
                  - lse.float().transpose(1, 2)[..., None])
    dv = p.transpose(-1, -2) @ doh
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (doh @ vh.transpose(-1, -2) - delta)
    dq = ds @ kh * scale
    dk = ds.transpose(-1, -2) @ qh * scale
    return _fold(dq, q.dtype), _fold(dk, k.dtype), _fold(dv, v.dtype)


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"bfloat16 on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous, 16-byte aligned")


def _check_qkv(what, q, k, v, num_heads):
    b, sq, d = q.shape
    skv = k.shape[1]
    if d % num_heads or d // num_heads not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {d}/{num_heads} not in "
                         f"{HEAD_DIMS}")
    if skv < 1 or sq < 1:
        raise ValueError(f"{what}: empty sequence")
    for name, t, shape in (("q", q, (b, sq, d)), ("k", k, (b, skv, d)),
                           ("v", v, (b, skv, d))):
        _check(name, t, shape, q.device)
    return b, sq, skv, d


def flash_attention_folded(q, k, v, num_heads: int, return_lse: bool = False):
    """K2. q: (B, Sq, D), k/v: (B, Skv, D), D = num_heads * hd; returns
    (B, Sq, D), and with return_lse also the (B, Sq, H) fp32 logsumexp.
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, num_heads, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_folded: unsupported device "
                         f"{q.device}")
    b, sq, skv, d = _check_qkv("flash_attention_folded", q, k, v, num_heads)
    o = torch.empty_like(q)
    lse = (torch.empty((b, sq, num_heads), device=q.device,
                       dtype=torch.float32) if return_lse else None)
    err = _fn()(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                _build.ptr(lse), b, sq, skv, num_heads, d // num_heads,
                _build.stream())
    _build.check(err, "flash_attention_bf16")
    _build.launch_counts["flash_attention_folded"] += 1
    _build.launch_shapes["flash_attention_folded",
                         (b, sq, skv, num_heads, d // num_heads)] += 1
    return (o, lse) if return_lse else o


def flash_attention_folded_bwd(q, k, v, o, do, lse, num_heads: int):
    """K7: (dq, dk, dv) of flash_attention_folded from the forward's output
    o and logsumexp lse (B, Sq, H) fp32, and the output cotangent do. One
    call launches its kernels (at hd 64: the delta/lse prologue, dq, dk/dv
    and, for a split Q walk, the split reduction; at hd 512: the prologue,
    then a scores and a products kernel per band of Q rows) into a scratch
    buffer the library sizes. CPU tensors take the plain
    version."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, lse, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_folded_bwd: unsupported device "
                         f"{q.device}")
    b, sq, skv, d = _check_qkv("flash_attention_folded_bwd", q, k, v,
                               num_heads)
    _check("o", o, q.shape, q.device)
    _check("do", do, q.shape, q.device)
    if lse.device != q.device or lse.dtype != torch.float32 \
            or tuple(lse.shape) != (b, sq, num_heads) \
            or not lse.is_contiguous():
        raise ValueError(f"lse: {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}, expected contiguous float32 "
                         f"{(b, sq, num_heads)} on {q.device}")
    lib = _bwd_lib()
    hd = d // num_heads
    ws = torch.empty(lib.flash_attention_bwd_workspace_bytes(
        b, sq, skv, num_heads, hd), device=q.device, dtype=torch.uint8)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = lib.flash_attention_bwd_bf16(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        _build.ptr(do), _build.ptr(lse), _build.ptr(ws), _build.ptr(dq),
        _build.ptr(dk), _build.ptr(dv), b, sq, skv, num_heads, hd,
        _build.stream())
    _build.check(err, "flash_attention_bwd_bf16")
    _build.launch_counts["flash_attention_folded_bwd"] += 1
    _build.launch_shapes["flash_attention_folded_bwd",
                         (b, sq, skv, num_heads, hd)] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K2 forward, K7 backward (the counterpart of `_mha_flash`'s custom
    VJP): saves q, k, v, o and lse; the backward rebuilds P from lse."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int):
        o, lse = flash_attention_folded(q, k, v, num_heads, return_lse=True)
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_folded_bwd(q, k, v, o, do.contiguous(),
                                                lse, ctx.num_heads)
        return dq, dk, dv, None


def flash_attention_ref(q, k, v):
    """K9's exact reference: q (B, H, Sq, d), k/v (B, H, Skv, d); scores,
    softmax and the PV product in fp32, one rounding to q.dtype."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def scaled_dot_product_attention(q, k, v):
    """K9's plain version (the counterpart of the XLA reference, :36):
    q (B, H, Sq, d), k/v (B, H, Skv, d); fp32 scores and softmax,
    probabilities cast to v.dtype, fp32 accumulation, one rounding."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(s, dim=-1)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


def flash_attention(q, k, v):
    """K9: non-causal attention on (B, H, S, d) tensors, ragged Sq, any
    Skv (masked). q (B, H, Sq, 64), k/v (B, H, Skv, 64), bf16; returns
    (B, H, Sq, 64). CPU tensors take the plain version; a CUDA tensor with
    another head dim raises."""
    if q.device.type == "cpu":
        return scaled_dot_product_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d != 64:
        raise ValueError(f"flash_attention: head dim {d}, the kernel takes "
                         f"64")
    if sq < 1 or skv < 1:
        raise ValueError("flash_attention: empty sequence")
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, h, skv, d)),
                           ("v", v, (b, h, skv, d))):
        _check(name, t, shape, q.device)
    o = torch.empty_like(q)
    err = _bhsd_fn()(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                     _build.ptr(o), b, h, sq, skv, _build.stream())
    _build.check(err, "flash_attention_bhsd_bf16")
    _build.launch_counts["flash_attention"] += 1
    return o


def default_attention(q, k, v):
    """The package's public attention op on (B, H, S, d) tensors (the
    counterpart of :523-531): K9 on a CUDA tensor (head dim 64), the plain
    version on a CPU tensor. The JAX package's Sq >= 256 gate chose its
    TPU tiling; on the card every Sq takes the kernel."""
    return flash_attention(q, k, v)
