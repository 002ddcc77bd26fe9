"""Conv wrappers: kernels K1 and K4 (the conv engine of `csrc/conv.cu`), and
K6 and K8's du, kernels of their own in the same library.

Counterparts of `img2img_turbo_tpu/ops/fused_conv.py:889
fused_gn_silu_conv3x3` (K1), `:1688 upsample2x_conv3x3` (K4) and `:1350
downsample2x_conv3x3` (K6), and of the du of
`img2img_turbo_tpu/models/layers.py:351 pallas_bwd` (K1 on the output
gradient with the flipped, io-swapped weights), which here reads the
forward's packed weight as it is (`conv3x3_input_grad`). All keep the JAX
layouts: activations (B, H, W, C), conv weights HWIO (3, 3, C, Co).

Each kernel has two plain versions. `*_ref` is its exact counterpart (fp32
arithmetic, one rounding to the activation dtype, as the kernel does): a
wrapper computes it on a CPU tensor, and it is the yardstick of the
kernel's correctness. `*_plain` is the composition the plain engine
(`use_kernels=False`) runs, op by op in the activation dtype, and the
yardstick of the kernel's speed. On a CUDA tensor a wrapper launches the
kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from img2img_turbo_tpu_torch.ops import _build


def _lib():
    lib = _build.load("conv")
    if lib.conv3x3_bf16.argtypes is None:
        lib.conv3x3_bf16.argtypes = [ctypes.c_void_p] * 12 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.conv3x3_bf16.restype = ctypes.c_int
        lib.conv_stats_tiles.argtypes = [ctypes.c_int] * 7
        lib.conv_stats_tiles.restype = ctypes.c_int
        lib.conv_workspace_bytes.argtypes = [ctypes.c_int] * 7
        lib.conv_workspace_bytes.restype = ctypes.c_long
        lib.conv_plan.argtypes = [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.conv_plan.restype = None
        lib.downsample3x3_bf16.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.downsample3x3_bf16.restype = ctypes.c_int
        lib.downsample_stats_tiles.argtypes = [ctypes.c_int] * 6
        lib.downsample_stats_tiles.restype = ctypes.c_int
        lib.downsample_workspace_bytes.argtypes = [ctypes.c_int] * 6
        lib.downsample_workspace_bytes.restype = ctypes.c_long
        lib.conv3x3_dgrad_bf16.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.conv3x3_dgrad_bf16.restype = ctypes.c_int
        lib.conv_dgrad_workspace_bytes.argtypes = [ctypes.c_int] * 5
        lib.conv_dgrad_workspace_bytes.restype = ctypes.c_long
    return lib


def fold_upsample_weights(w):
    """(3,3,C,Co) -> (2,2,2,2,C,Co): per-phase 2x2 taps on the low-res input
    such that conv3x3(nearest_up2x(x)) at output (2i+a, 2j+b) is
    sum_{p,q} x[i+a+p-1, j+b+q-1] @ wf[a,b,p,q] (the algebra of
    `_fold_upsample_weights`, fused_conv.py:1443). Summed in fp32, then
    cast back to w.dtype."""
    wf = w.float()
    wr0 = torch.stack([wf[0], wf[1] + wf[2]])         # a=0: rows (i-1, i)
    wr1 = torch.stack([wf[0] + wf[1], wf[2]])         # a=1: rows (i, i+1)
    wr = torch.stack([wr0, wr1])                      # (2, 2, 3, C, Co)
    wc0 = torch.stack([wr[:, :, 0], wr[:, :, 1] + wr[:, :, 2]], dim=2)
    wc1 = torch.stack([wr[:, :, 0] + wr[:, :, 1], wr[:, :, 2]], dim=2)
    return torch.stack([wc0, wc1], dim=1).to(w.dtype).contiguous()


def pack_weights(w):
    """(..., C, Co) conv weights -> (taps, ceil(C/8), ceil(Co/8)*8, 8): the
    K-major core-matrix layout the CUDA kernel's tensor-core B operand
    reads, zero-padded. taps = the product of the leading dims (9 for a
    3x3 HWIO weight, 16 for folded upsample weights, 1 for a (Csk, Co)
    1x1). Built once when the weights are loaded."""
    c, co = w.shape[-2:]
    w = w.reshape(-1, c, co)
    c8, cop = -(-c // 8), -(-co // 8) * 8
    w = F.pad(w, (0, cop - co, 0, 8 * c8 - c))
    return w.reshape(w.shape[0], c8, 8, cop).permute(0, 1, 3, 2).contiguous()


def unpack_weights(w_packed, c: int, co: int):
    """`pack_weights`' inverse: (taps, ceil(C/8), ceil(Co/8)*8, 8) ->
    (taps, C, Co), the padding dropped."""
    taps, c8, cop, _ = w_packed.shape
    return w_packed.permute(0, 1, 3, 2).reshape(taps, 8 * c8, cop)[:, :c, :co]


def upsample_nearest_2x(x):
    """Nearest 2x upsample of NHWC x, as a broadcast (its backward is a
    plain sum, with no scatter: deterministic on the card)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c)


def _conv_nhwc(x, w_oihw, bias=None):
    """NHWC SAME conv (3x3 or 1x1) with an OIHW weight, in x's dtype."""
    pad = w_oihw.shape[-1] // 2
    return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, bias,
                    padding=pad).permute(0, 2, 3, 1)


def _oihw(w_hwio):
    return w_hwio.permute(3, 2, 0, 1)


def output_stats(y, acc=torch.float32):
    """(B, H, W, C) -> (B, 1, 2, C) fp32 sum and sum of squares: one tile,
    accumulated in `acc`. The plain versions (`*_ref`) take fp64, rounded
    once to fp32, which frees the sums from their order and so from the
    call's other channels: a column-parallel conv's (`models/layers.py`)
    equal the whole conv's. The plain engine keeps fp32."""
    ya = y.to(acc)
    return torch.stack([ya.sum((1, 2)), (ya * ya).sum((1, 2))],
                       dim=1)[:, None].float()


def conv3x3_ref(x, w, bias, a=None, b=None, extra_bias=None, residual=None,
                skip_x=None, skip_w=None, emit_stats: bool = False):
    """Plain version of K1 (the counterpart of `_xla_fallback`,
    fused_conv.py:275): the prologue in fp32 rounded to x.dtype, the conv
    and the epilogue in fp32, one rounding; stats are one (B, 1, 2, Co)
    tile of the stored y."""
    h = x
    if a is not None:
        h = F.silu(x.float() * a[:, None, None, :].float()
                   + b[:, None, None, :].float()).to(x.dtype)
    y = _conv_nhwc(h.float(), _oihw(w.float())) + bias.float()
    if extra_bias is not None:
        y = y + extra_bias[:, None, None, :].float()
    if skip_x is not None:
        y = y + skip_x.float() @ skip_w.float()
    if residual is not None:
        y = y + residual.float()
    y = y.to(x.dtype)
    return y, (output_stats(y, torch.float64) if emit_stats
                else None)


def upsample2x_conv3x3_ref(x, w, bias, skip_x=None, skip_w=None,
                           emit_stats: bool = False):
    """Plain version of K4: conv2d(upsample_nearest_2x(x)) + bias [+ skip],
    in fp32 with one rounding."""
    y = _conv_nhwc(upsample_nearest_2x(x.float()), _oihw(w.float())) \
        + bias.float()
    if skip_x is not None:
        y = y + skip_x.float() @ skip_w.float()
    y = y.to(x.dtype)
    return y, (output_stats(y, torch.float64) if emit_stats
                else None)


def downsample_size(n: int, pad_lo: int) -> int:
    """Output size of the stride-2 conv3x3 with (pad_lo, 1) padding
    (fused_conv.py:1362), odd n included."""
    return (n + pad_lo - 2) // 2 + 1


def _pad_down(x_nchw, pad_lo: int):
    return F.pad(x_nchw, (pad_lo, 1, pad_lo, 1))


def downsample2x_conv3x3_ref(x, w, bias, pad_lo: int,
                             emit_stats: bool = False):
    """Plain version of K6: the stride-2 conv3x3 of x on (pad_lo, 1)
    padding, plus bias, in fp32 with one rounding; stats are one
    (B, 1, 2, Co) tile of the stored y (the true output only)."""
    y = F.conv2d(_pad_down(x.float().permute(0, 3, 1, 2), pad_lo),
                 _oihw(w.float()), stride=2).permute(0, 2, 3, 1) \
        + bias.float()
    y = y.to(x.dtype)
    return y, (output_stats(y, torch.float64) if emit_stats
                else None)


def downsample2x_conv3x3_plain(x, w, bias, pad_lo: int,
                               emit_stats: bool = False):
    """The plain engine's K6 (the JAX strided XLA conv, layers.py:632):
    F.conv2d(stride=2) on the explicit (pad_lo, 1) padding, in x.dtype,
    with the weight as nn.Conv2d holds it (Co, C, 3, 3); stats by
    `output_stats` when asked."""
    dt = x.dtype
    y = F.conv2d(_pad_down(x.permute(0, 3, 1, 2), pad_lo), w.to(dt),
                 None if bias is None else bias.to(dt),
                 stride=2).permute(0, 2, 3, 1)
    return y, (output_stats(y) if emit_stats else None)


def gn_silu_conv3x3_plain(x, w, bias, a=None, b=None, extra_bias=None,
                          residual=None, skip_x=None, skip_w=None,
                          skip_bias=None):
    """The plain engine's K1 (the counterpart of `_xla_fallback`,
    fused_conv.py:275): each op in x.dtype as PyTorch rounds it: x*a + b
    with (a, b) cast to x.dtype, SiLU, the conv with its bias, then
    extra_bias, residual and the 1x1 skip conv added one by one. Weights as
    nn.Conv2d holds them: w (Co, C, 3, 3), skip_w (Co, Csk, 1, 1)."""
    dt = x.dtype
    h = x
    if a is not None:
        h = F.silu(x * a[:, None, None, :].to(dt)
                   + b[:, None, None, :].to(dt))
    y = _conv_nhwc(h, w.to(dt), None if bias is None else bias.to(dt))
    if extra_bias is not None:
        y = y + extra_bias[:, None, None, :].to(dt)
    if residual is not None:
        y = y + residual
    if skip_x is not None:
        y = y + _conv_nhwc(skip_x, skip_w.to(dt),
                           None if skip_bias is None else skip_bias.to(dt))
    return y


def upsample2x_conv3x3_plain(x, w, bias, skip_x=None, skip_w=None,
                             skip_bias=None):
    """The plain engine's K4: conv3x3(upsample_nearest_2x(x)) [+ the 1x1
    skip conv], in x.dtype; weights as nn.Conv2d holds them."""
    dt = x.dtype
    y = _conv_nhwc(upsample_nearest_2x(x), w.to(dt),
                   None if bias is None else bias.to(dt))
    if skip_x is not None:
        y = y + _conv_nhwc(skip_x, skip_w.to(dt),
                           None if skip_bias is None else skip_bias.to(dt))
    return y


def _dgrad_weight(w_packed, c: int, co: int):
    """The forward conv weight of a packed (9, ceil(C/8), Cop, 8) buffer as
    F.conv_transpose2d takes it: (Co, C, 3, 3)."""
    return unpack_weights(w_packed, c, co).reshape(3, 3, c, co).permute(
        3, 2, 0, 1)


def conv3x3_input_grad_ref(gy, w_packed, c: int):
    """Plain version of K8's du: the input gradient of a 3x3 SAME conv of
    C -> Co channels at output gradient gy (B, H, W, Co), from the
    forward's packed weight: unpacked, then the fp32 transposed conv, one
    rounding to gy.dtype."""
    w = _dgrad_weight(w_packed, c, gy.shape[-1]).float()
    du = F.conv_transpose2d(gy.float().permute(0, 3, 1, 2), w, padding=1)
    return du.permute(0, 2, 3, 1).to(gy.dtype)


def conv3x3_input_grad_plain(gy, w_packed, c: int):
    """The du as the plain path computes it (autograd's conv input
    gradient, cuDNN's on the card): the transposed conv in gy.dtype on the
    unpacked weight."""
    w = _dgrad_weight(w_packed, c, gy.shape[-1]).to(gy.dtype)
    du = F.conv_transpose2d(gy.permute(0, 3, 1, 2), w, padding=1)
    return du.permute(0, 2, 3, 1)


def _check(name, t, shape, dtype, device):
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def _launch(x, w_packed, co, bias, a, b, extra_bias, residual, skip_x,
            skip_w_packed, emit_stats, up: bool):
    bsz, h, wd, c = x.shape
    ho, wo = (2 * h, 2 * wd) if up else (h, wd)
    dev, bf = x.device, torch.bfloat16
    csk = 0 if skip_x is None else skip_x.shape[-1]
    cop = -(-co // 8) * 8
    _check("x", x, x.shape, bf, dev)
    _check("w_packed", w_packed, (16 if up else 9, -(-c // 8), cop, 8), bf,
           dev)
    _check("bias", bias, (co,), torch.float32, dev)
    _check("a", a, (bsz, c), torch.float32, dev)
    _check("b", b, (bsz, c), torch.float32, dev)
    _check("extra_bias", extra_bias, (bsz, co), torch.float32, dev)
    _check("residual", residual, (bsz, ho, wo, co), bf, dev)
    _check("skip_x", skip_x, (bsz, ho, wo, csk), bf, dev)
    _check("skip_w_packed", skip_w_packed, (1, -(-csk // 8), cop, 8), bf,
           dev)
    if (a is None) != (b is None) or \
            (skip_x is None) != (skip_w_packed is None):
        raise ValueError("a/b and skip_x/skip_w_packed come in pairs")
    if csk % 8 or (csk and c % 8) or (up and c % 8):
        raise ValueError(f"x {tuple(x.shape)}, skip channels {csk}: the "
                         f"skip needs Csk and C multiples of 8, K4 C a "
                         f"multiple of 8")
    lib = _lib()
    dims = (bsz, h, wd, c, co, csk, int(up))
    y = torch.empty((bsz, ho, wo, co), device=dev, dtype=bf)
    stats = None
    if emit_stats:  # one partial sum per pixel tile of the call's form
        stats = torch.empty((bsz, lib.conv_stats_tiles(*dims), 2, co),
                            device=dev, dtype=torch.float32)
    # split-K scratch for grids below one wave (none for most calls)
    ws_bytes = lib.conv_workspace_bytes(*dims)
    ws = (torch.empty(ws_bytes, device=dev, dtype=torch.uint8)
          if ws_bytes else None)
    err = lib.conv3x3_bf16(
        _build.ptr(x), _build.ptr(w_packed), _build.ptr(bias), _build.ptr(a),
        _build.ptr(b), _build.ptr(extra_bias), _build.ptr(residual),
        _build.ptr(skip_x), _build.ptr(skip_w_packed), _build.ptr(y),
        _build.ptr(stats), _build.ptr(ws), bsz, h, wd, c, co, csk, int(up),
        _build.stream())
    _build.check(err, "conv3x3_bf16")
    return y, stats


def conv_plan(bsz, h, w, c, co, csk=0, up=False) -> dict:
    """The engine's launch form for a K1 (up False) or K4 call, as
    `conv3x3_bf16` takes it (`conv_form` in csrc/conv.cu)."""
    out = (ctypes.c_int * 9)()
    _lib().conv_plan(bsz, h, w, c, co, csk, int(up), out)
    keys = ("tile_rows", "channels_a_block", "channels_a_step",
            "skip_channels_a_step", "blocks_an_sm", "stages", "splits",
            "units_a_split", "blocks")
    return dict(zip(keys, out))


def fused_gn_silu_conv3x3(x, w, bias, a=None, b=None, extra_bias=None,
                          residual=None, skip_x=None, skip_w=None,
                          emit_stats: bool = False, w_packed=None,
                          skip_w_packed=None):
    """K1. y = conv3x3_same(silu(x*a + b)) + bias [+ extra_bias]
    [+ skip_x @ skip_w] [+ residual]; a=None gives the plain conv.

    x (B,H,W,C) bf16; w (3,3,C,Co) bf16; bias (Co,) fp32; a, b (B,C) fp32;
    extra_bias (B,Co) fp32; residual (B,H,W,Co) bf16; skip_x (B,H,W,Csk)
    bf16; skip_w (Csk,Co) bf16. The CUDA path reads w and skip_w only as
    `pack_weights` lays them out (w_packed, skip_w_packed, built at load),
    so there w and skip_w may be None.
    Returns (y, stats): stats are the (B, n_tiles, 2, Co) fp32 partial sums
    of the stored y, or None."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, bias, a, b, extra_bias, residual, skip_x,
                           skip_w, emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gn_silu_conv3x3: unsupported device "
                         f"{x.device}")
    if w_packed is None or (skip_x is not None and skip_w_packed is None):
        raise ValueError("fused_gn_silu_conv3x3: the CUDA path takes the "
                         "packed weights (pack_weights), built at load")
    out = _launch(x, w_packed, bias.shape[0], bias, a, b, extra_bias,
                  residual, skip_x, skip_w_packed, emit_stats, up=False)
    _build.launch_counts["fused_gn_silu_conv3x3"] += 1
    csk = 0 if skip_x is None else skip_x.shape[-1]
    _build.launch_shapes["fused_gn_silu_conv3x3", (
        *x.shape, bias.shape[0], a is not None, extra_bias is not None,
        residual is not None, csk, bool(emit_stats))] += 1
    return out


def upsample2x_conv3x3(x, w, bias, skip_x=None, skip_w=None,
                       emit_stats: bool = False, w_packed=None,
                       skip_w_packed=None):
    """K4. conv3x3_same(nearest_upsample_2x(x)) + bias [+ skip_x @ skip_w].

    x (B,H,W,C) bf16; w (3,3,C,Co); bias (Co,) fp32; skip_x (B,2H,2W,Csk)
    bf16; skip_w (Csk,Co) bf16. The CUDA path reads
    w_packed = pack_weights(fold_upsample_weights(w)) and
    skip_w_packed = pack_weights(skip_w), built once at load (w and skip_w
    may then be None)."""
    if x.device.type == "cpu":
        return upsample2x_conv3x3_ref(x, w, bias, skip_x, skip_w, emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x_conv3x3: unsupported device {x.device}")
    if w_packed is None or (skip_x is not None and skip_w_packed is None):
        raise ValueError("upsample2x_conv3x3: the CUDA path takes the packed "
                         "folded weights, built at load")
    out = _launch(x, w_packed, bias.shape[0], bias, None, None, None, None,
                  skip_x, skip_w_packed, emit_stats, up=True)
    _build.launch_counts["upsample2x_conv3x3"] += 1
    csk = 0 if skip_x is None else skip_x.shape[-1]
    _build.launch_shapes["upsample2x_conv3x3", (
        *x.shape, bias.shape[0], csk, bool(emit_stats))] += 1
    return out


def downsample2x_conv3x3(x, w, bias, pad_lo: int, emit_stats: bool = False,
                         w_packed=None):
    """K6. y = stride-2 conv3x3 of x with ((pad_lo, 1), (pad_lo, 1))
    padding, plus bias: pad_lo=0 is the VAE encoder's downsample, pad_lo=1
    the UNet's. x (B,H,W,C) bf16 with C a multiple of 8 and H, W >= 2;
    w (3,3,C,Co); bias (Co,) fp32. The CUDA path reads only w_packed =
    pack_weights(w), built at load. Returns (y (B, Ho, Wo, Co), stats):
    Ho = downsample_size(H, pad_lo), likewise Wo; stats are the
    (B, n_tiles, 2, Co) fp32 partial sums of the stored y over the true
    output, or None."""
    if pad_lo not in (0, 1):
        raise ValueError(f"downsample2x_conv3x3: pad_lo {pad_lo} not 0 or 1")
    if x.device.type == "cpu":
        return downsample2x_conv3x3_ref(x, w, bias, pad_lo, emit_stats)
    if x.device.type != "cuda":
        raise ValueError(f"downsample2x_conv3x3: unsupported device "
                         f"{x.device}")
    if w_packed is None:
        raise ValueError("downsample2x_conv3x3: the CUDA path takes the "
                         "packed weights (pack_weights), built at load")
    bsz, h, wd, c = x.shape
    if c % 8 or h < 2 or wd < 2:
        raise ValueError(f"downsample2x_conv3x3: x {tuple(x.shape)} needs C "
                         f"a multiple of 8 and H, W >= 2")
    co = bias.shape[0]
    dev, bf = x.device, torch.bfloat16
    _check("x", x, x.shape, bf, dev)
    _check("w_packed", w_packed, (9, c // 8, -(-co // 8) * 8, 8), bf, dev)
    _check("bias", bias, (co,), torch.float32, dev)
    lib = _lib()
    ho, wo = downsample_size(h, pad_lo), downsample_size(wd, pad_lo)
    y = torch.empty((bsz, ho, wo, co), device=dev, dtype=bf)
    dims = (bsz, h, wd, c, co, pad_lo)
    stats = None
    if emit_stats:  # one partial sum per pixel tile of the call's form
        stats = torch.empty((bsz, lib.downsample_stats_tiles(*dims), 2, co),
                            device=dev, dtype=torch.float32)
    # split-K scratch for grids below one wave
    ws_bytes = lib.downsample_workspace_bytes(*dims)
    ws = (torch.empty(ws_bytes, device=dev, dtype=torch.uint8)
          if ws_bytes else None)
    err = lib.downsample3x3_bf16(
        _build.ptr(x), _build.ptr(w_packed), _build.ptr(bias), _build.ptr(y),
        _build.ptr(stats), _build.ptr(ws), bsz, h, wd, c, co, pad_lo,
        _build.stream())
    _build.check(err, "downsample3x3_bf16")
    _build.launch_counts["downsample2x_conv3x3"] += 1
    _build.launch_shapes["downsample2x_conv3x3", dims] += 1
    return y, stats


def conv3x3_input_grad(gy, w_packed, c: int):
    """K8's du: the input gradient du (B, H, W, C) of a 3x3 SAME conv of
    C -> Co channels at output gradient gy (B, H, W, Co) bf16, i.e. the
    conv of gy with the spatially flipped, io-swapped weights and no bias.
    w_packed is the forward's `pack_weights` buffer (9, ceil(C/8),
    ceil(Co/8)*8, 8), which the kernel reads as it is (taps reversed, the
    B operand MN-major): no flip, transpose or repack per call. A CPU
    tensor takes `conv3x3_input_grad_ref`."""
    bsz, h, wd, co = gy.shape
    packed = (9, -(-c // 8), -(-co // 8) * 8, 8)
    if tuple(w_packed.shape) != packed:
        raise ValueError(f"conv3x3_input_grad: w_packed {tuple(w_packed.shape)}"
                         f" is not the forward's packed {packed}")
    if gy.device.type == "cpu":
        return conv3x3_input_grad_ref(gy, w_packed, c)
    if gy.device.type != "cuda":
        raise ValueError(f"conv3x3_input_grad: unsupported device "
                         f"{gy.device}")
    dev, bf = gy.device, torch.bfloat16
    _check("gy", gy, gy.shape, bf, dev)
    _check("w_packed", w_packed, packed, bf, dev)
    lib = _lib()
    du = torch.empty((bsz, h, wd, c), device=dev, dtype=bf)
    ws_bytes = lib.conv_dgrad_workspace_bytes(bsz, h, wd, c, co)
    ws = (torch.empty(ws_bytes, device=dev, dtype=torch.uint8)
          if ws_bytes else None)
    err = lib.conv3x3_dgrad_bf16(
        _build.ptr(gy), _build.ptr(w_packed), _build.ptr(du), _build.ptr(ws),
        bsz, h, wd, c, co, _build.stream())
    _build.check(err, "conv3x3_dgrad_bf16")
    _build.launch_counts["fused_gn_silu_conv3x3"] += 1
    _build.launch_shapes["conv3x3_input_grad", (bsz, h, wd, c, co)] += 1
    return du
