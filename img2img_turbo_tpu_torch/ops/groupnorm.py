"""GroupNorm statistics: kernel K5 and the folded-affine combine (CUDA,
`csrc/groupnorm.cu`), and their plain versions.

Counterpart of `img2img_turbo_tpu/ops/groupnorm.py:54 group_norm_coeffs`
(Pallas body `_partial_stats_kernel :45`) and of
`img2img_turbo_tpu/ops/fused_conv.py:1782 combine_stats`.

`partial_stats` writes per-tile, per-channel fp32 sum and sum of squares of
a (B, S, C) activation as (B, n_tiles, 2, C); `combine_stats` turns such
partials (its own, or those the conv kernels K1 and K6 emit) into the
folded GroupNorm affine (a, b) with var = max(E[x^2] - mean^2, 0). Tiles
cover `TILE_ROWS` rows each, so the VAE's 262,144 elements per channel at
512^2 are summed as 1,024 partials of 256 and never as one long serial
fp32 sum. Rows past S are masked, so any spatial size is exact.
`group_norm_coeffs` launches both kernels from one host call, so a
GroupNorm of the kernel path costs two launches and no PyTorch kernel;
`combine_stats` on emitted stats costs one. `partial_stats_ref` and
`combine_stats_ref` are the plain versions (what a CPU tensor takes);
`group_norm_coeffs_plain` is the plain engine's two-pass version of the
same coefficients.

What bounds it on the H100: bytes (one read of x, no tensor-core work),
and for the combine its launch; the combine's device time is a few
microseconds, its host time one ctypes call.
"""

from __future__ import annotations

import ctypes

import torch

from img2img_turbo_tpu_torch.ops import _build

TILE_ROWS = 256


def _lib():
    lib = _build.load("groupnorm")
    if lib.group_norm_coeffs.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.group_norm_partial_stats.argtypes = [vp, i, vp, i, i, i, vp]
        lib.group_norm_combine.argtypes = [vp, i, vp, vp, i, vp, vp, i, i, i,
                                           ctypes.c_float, ctypes.c_longlong,
                                           vp]
        lib.group_norm_coeffs.argtypes = [vp, i, vp, vp, vp, i, vp, vp, i, i,
                                          i, i, ctypes.c_float, vp]
        for f in (lib.group_norm_partial_stats, lib.group_norm_combine,
                  lib.group_norm_coeffs):
            f.restype = i
    return lib


def partial_stats_ref(x):
    """Plain version: (B, ..., C) -> (B, n_tiles, 2, C) fp32 partial sums over
    TILE_ROWS-row tiles of the flattened spatial dim."""
    b, c = x.shape[0], x.shape[-1]
    xr = x.reshape(b, -1, c).float()
    s = xr.shape[1]
    n_tiles = -(-s // TILE_ROWS)
    xr = torch.nn.functional.pad(xr, (0, 0, 0, n_tiles * TILE_ROWS - s))
    xt = xr.reshape(b, n_tiles, TILE_ROWS, c)
    return torch.stack([xt.sum(2), (xt * xt).sum(2)], dim=2)


def combine_stats_ref(partials, scale, bias, num_groups: int, eps: float,
                      count: int, acc=torch.float64):
    """Plain version of the combine: (B, n_tiles, 2, C) partial sums ->
    folded GroupNorm affine (a, b), each (B, C) fp32. count = elements per
    channel (H*W of the stats source). The group moments and the variance
    (E[x^2] - E[x]^2, which cancels) are taken in `acc`, fp64 unless the
    caller asks for fp32, a and b rounded once to fp32."""
    bsz, _, _, c = partials.shape
    cg = c // num_groups
    m = partials.to(acc).sum(dim=1).view(bsz, 2, num_groups, cg) \
        .sum(dim=-1) / (count * cg)                              # (B, 2, G)
    mean, ex2 = m[:, 0], m[:, 1]
    inv = torch.addcmul(ex2, mean, mean, value=-1.0).clamp_(min=0.0) \
        .add_(eps).rsqrt_()
    a = inv[..., None] * scale.to(acc).view(num_groups, cg)      # (B, G, cg)
    bterm = torch.addcmul(bias.to(acc).view(num_groups, cg),
                          mean[..., None], a, value=-1.0)
    return a.view(bsz, c).float(), bterm.view(bsz, c).float()


def _check_x(what, x):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    vec = 16 // x.element_size()
    if not x.is_contiguous() or x.ndim < 3 or x.shape[-1] % vec \
            or x.data_ptr() % 16:
        raise ValueError(f"{what}: needs a contiguous, 16-byte aligned "
                         f"(B, ..., C) tensor with C a multiple of {vec}, "
                         f"got shape {tuple(x.shape)}")
    b, c = x.shape[0], x.shape[-1]
    return b, x.numel() // (b * c), c


def _check_affine(what, scale, bias, c, num_groups, device):
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != device or t.dtype != scale.dtype \
                or t.dtype not in (torch.bfloat16, torch.float32) \
                or tuple(t.shape) != (c,) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous ({c},) "
                             f"bf16 or fp32 tensor on {device} (both of one "
                             f"dtype), got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"{what}: {c} channels in {num_groups} groups")


def partial_stats(x):
    """K5. x: (B, ..., C) -> (B, n_tiles, 2, C) fp32 per-tile sums.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    take only contiguous bf16 (C a multiple of 8) or fp32 (of 4) input."""
    if x.device.type == "cpu":
        return partial_stats_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"partial_stats: unsupported device {x.device}")
    b, s, c = _check_x("partial_stats", x)
    out = torch.empty((b, -(-s // TILE_ROWS), 2, c), device=x.device,
                      dtype=torch.float32)
    _build.check(_lib().group_norm_partial_stats(
        _build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(out), b, s,
        c, _build.stream()), "group_norm_partial_stats")
    _build.launch_counts["group_norm_stats"] += 1
    _build.launch_shapes["group_norm_stats", (b, s, c)] += 1
    return out


def combine_stats(partials, scale, bias, num_groups: int, eps: float,
                  count: int):
    """(B, n_tiles, 2, C) partial sums -> folded GroupNorm affine (a, b), each
    (B, C) fp32. count = elements per channel (H*W of the stats source).
    CPU tensors take the plain version; on CUDA tensors one launch of the
    combine kernel (scale and bias bf16 or fp32)."""
    if partials.device.type == "cpu":
        return combine_stats_ref(partials, scale, bias, num_groups, eps,
                                 count)
    if partials.device.type != "cuda":
        raise ValueError(f"combine_stats: unsupported device "
                         f"{partials.device}")
    if partials.dtype != torch.float32 or partials.ndim != 4 \
            or partials.shape[2] != 2 or not partials.is_contiguous():
        raise ValueError(f"combine_stats: partials must be contiguous fp32 "
                         f"(B, n_tiles, 2, C), got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    bsz, n_tiles, _, c = partials.shape
    _check_affine("combine_stats", scale, bias, c, num_groups,
                  partials.device)
    out = torch.empty((2, bsz, c), device=partials.device,
                      dtype=torch.float32)
    _build.check(_lib().group_norm_combine(
        _build.ptr(partials), n_tiles, _build.ptr(scale), _build.ptr(bias),
        int(scale.dtype == torch.bfloat16), _build.ptr(out[0]),
        _build.ptr(out[1]), bsz, c, num_groups, eps, count, _build.stream()),
        "group_norm_combine")
    _build.launch_counts["group_norm_combine"] += 1
    _build.launch_shapes["group_norm_combine",
                         (bsz, n_tiles, c, num_groups)] += 1
    return out[0], out[1]


def group_norm_coeffs(x, scale, bias, num_groups: int, eps: float):
    """Folded (a, b), each (B, C) fp32, with GN(x)*scale+bias == x*a + b.
    x: (B, H, W, C) or (B, S, C). One-pass statistics from K5's partials:
    on a CUDA tensor both kernels from one host call, on a CPU tensor the
    plain versions (through the two wrappers)."""
    if x.device.type == "cpu":
        count = x.numel() // (x.shape[0] * x.shape[-1])
        return combine_stats(partial_stats(x), scale, bias, num_groups, eps,
                             count)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_coeffs: unsupported device {x.device}")
    b, s, c = _check_x("group_norm_coeffs", x)
    _check_affine("group_norm_coeffs", scale, bias, c, num_groups, x.device)
    part = torch.empty((b, -(-s // TILE_ROWS), 2, c), device=x.device,
                       dtype=torch.float32)
    out = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    _build.check(_lib().group_norm_coeffs(
        _build.ptr(x), int(x.dtype == torch.bfloat16), _build.ptr(part),
        _build.ptr(scale), _build.ptr(bias),
        int(scale.dtype == torch.bfloat16), _build.ptr(out[0]),
        _build.ptr(out[1]), b, s, c, num_groups, eps, _build.stream()),
        "group_norm_coeffs")
    _build.launch_counts["group_norm_stats"] += 1
    _build.launch_counts["group_norm_combine"] += 1
    _build.launch_shapes["group_norm_stats", (b, s, c)] += 1
    return out[0], out[1]


def group_norm_coeffs_plain(x, scale, bias, num_groups: int, eps: float):
    """The plain engine's (a, b) (the counterpart of `_gn_xla`,
    layers.py:186): two-pass fp32 statistics over each whole group."""
    bsz, c = x.shape[0], x.shape[-1]
    xf = x.reshape(bsz, -1, num_groups, c // num_groups).float()
    mean = xf.mean(dim=(1, 3))
    var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
    a = torch.rsqrt(var + eps)[..., None] \
        * scale.float().reshape(num_groups, -1)
    bterm = bias.float().reshape(num_groups, -1) - mean[..., None] * a
    return a.reshape(bsz, c), bterm.reshape(bsz, c)
