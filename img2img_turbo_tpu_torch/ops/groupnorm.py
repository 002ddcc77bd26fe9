"""GroupNorm statistics: kernel K5 (Triton) and the folded-affine combine.

Counterpart of `img2img_turbo_tpu/ops/groupnorm.py:54 group_norm_coeffs`
(Pallas body `_partial_stats_kernel :45`) and of
`img2img_turbo_tpu/ops/fused_conv.py:1782 combine_stats`.

The kernel writes per-tile, per-channel fp32 sum and sum of squares of a
(B, S, C) activation as (B, n_tiles, 2, C); the combine (plain torch) turns
those partials into the folded GroupNorm affine (a, b) with
var = max(E[x^2] - mean^2, 0). Tiles cover `TILE_ROWS` rows each, so the
VAE's 262,144 elements per channel at 512^2 are summed as 1,024 partials of
256 and never as one long serial fp32 sum. Rows past S are masked, so any
spatial size is exact. `group_norm_coeffs_plain` is the plain engine's
two-pass version of the same coefficients.

What bounds it on the H100: a pure streaming reduction (one read of x, no
tensor-core work), so memory bandwidth; a Triton block reduction over
(256 rows x 64 channels) reaches that as well as a CUDA kernel would.
"""

from __future__ import annotations

import functools

import torch

from img2img_turbo_tpu_torch.ops import _build

TILE_ROWS = 256
_BLOCK_C = 64


@functools.lru_cache(maxsize=None)
def _triton_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def partial_stats(x_ptr, out_ptr, S, C, n_tiles,
                      TS: tl.constexpr, BC: tl.constexpr):
        b = tl.program_id(0)
        t = tl.program_id(1)
        cb = tl.program_id(2)
        rows = t * TS + tl.arange(0, TS)
        cols = cb * BC + tl.arange(0, BC)
        cmask = cols < C
        mask = (rows < S)[:, None] & cmask[None, :]
        offs = b.to(tl.int64) * S * C + rows[:, None].to(tl.int64) * C \
            + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        s1 = tl.sum(x, axis=0)
        s2 = tl.sum(x * x, axis=0)
        base = out_ptr + ((b * n_tiles + t) * 2).to(tl.int64) * C
        tl.store(base + cols, s1, mask=cmask)
        tl.store(base + C + cols, s2, mask=cmask)

    return partial_stats


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


def partial_stats(x):
    """K5. x: (B, ..., C) -> (B, n_tiles, 2, C) fp32 per-tile sums.

    CPU tensors take the plain version; CUDA tensors launch the Triton
    kernel and take only contiguous bf16/fp32 input."""
    if x.device.type == "cpu":
        return partial_stats_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"partial_stats: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"partial_stats: unsupported dtype {x.dtype}")
    if not x.is_contiguous() or x.ndim < 3:
        raise ValueError("partial_stats: needs a contiguous (B, ..., C) "
                         f"tensor, got shape {tuple(x.shape)}")
    b, c = x.shape[0], x.shape[-1]
    s = x.numel() // (b * c)
    n_tiles = -(-s // TILE_ROWS)
    out = torch.empty((b, n_tiles, 2, c), device=x.device,
                      dtype=torch.float32)
    grid = (b, n_tiles, -(-c // _BLOCK_C))
    _triton_kernel()[grid](x, out, s, c, n_tiles, TS=TILE_ROWS,
                           BC=_BLOCK_C, num_warps=4)
    _build.launch_counts["group_norm_stats"] += 1
    return out


def combine_stats(partials, scale, bias, num_groups: int, eps: float,
                  count: int):
    """(B, n_tiles, 2, C) partial sums -> folded GroupNorm affine (a, b), each
    (B, C) fp32. count = elements per channel (H*W of the stats source)."""
    bsz, _, _, c = partials.shape
    cg = c // num_groups
    # few, fused torch ops: this runs once per GroupNorm of the request
    m = partials.sum(dim=1).view(bsz, 2, num_groups, cg).sum(dim=-1) \
        / (count * cg)                                           # (B, 2, G)
    mean, ex2 = m[:, 0], m[:, 1]
    inv = torch.addcmul(ex2, mean, mean, value=-1.0).clamp_(min=0.0) \
        .add_(eps).rsqrt_()
    a = inv[..., None] * scale.float().view(num_groups, cg)      # (B, G, cg)
    bterm = torch.addcmul(bias.float().view(num_groups, cg), mean[..., None],
                          a, value=-1.0)
    return a.view(bsz, c), bterm.view(bsz, c)


def group_norm_coeffs(x, scale, bias, num_groups: int, eps: float):
    """Folded (a, b), each (B, C) fp32, with GN(x)*scale+bias == x*a + b.
    x: (B, H, W, C) or (B, S, C). One-pass statistics from K5's partials."""
    count = x.numel() // (x.shape[0] * x.shape[-1])
    return combine_stats(partial_stats(x), scale, bias, num_groups, eps,
                         count)


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
