"""NHWC building blocks and the entry points that route to the kernels.

Counterpart of `img2img_turbo_tpu/models/layers.py`. Modules keep
diffusers' parameter names (so `state_dict()` keys are diffusers' keys) and
torch's weight layouts (conv OIHW, linear (out, in)); activations are NHWC.
`prepare_kernels(model)` builds the kernel-ready layouts once, after the
weights are loaded and cast: packed conv weights (folded for the upsample
convs), fp32 biases and norm affines; linear weights stay nn.Linear's own
(Co, C), which K3 reads as they are. HWIO conv weights are kept only on the
CPU, where the wrappers compute their plain versions from them.

Every entry point takes `kernels`: True routes through the kernel wrappers
of `ops/` (which launch the CUDA kernels on a CUDA tensor and run
their plain versions on a CPU tensor), with GroupNorm statistics chained
from the producing kernel exactly as the JAX package chains them on TPU;
False is the plain PyTorch composition, the counterpart of the JAX
package's XLA path (two-pass GroupNorm, no stats chaining), built from the
`*_plain` functions of `ops/` that chip_smoke.py times against each kernel.

Training: a module that `prepare_kernels` never saw has no kernel layouts,
and the kernel path then builds them from its live weights at every call,
inside a `torch.autograd.Function` (the counterparts of the JAX package's
custom VJPs): the trainer merges LoRA into new weight tensors at every
pass and puts them in place of the parameters (`lora.swap_params`), so a
layout taken once would train the wrong weights. The backward of the fused GN+SiLU+conv is `GnSiluConvFn`
(K8: the du kernel on the output gradient, reading the weight
the forward packed; 9 shifted GEMMs for dw; fp32 elementwise GN/SiLU); the
other kernels' backward is autograd through
their plain version, recomputed from the saved inputs (`KernelFn`), and
attention's is K7 (`ops.attention.FlashAttention`). The plain path needs
no Function: autograd runs through its PyTorch ops.

The model axis (serving and training): the entry points take `tp`, a
mesh (`parallel.mesh.DataMesh`) with n_model above 1, and act on the
modules that `parallel.tensor.shard_module` sharded (`tp_sharded`);
without `tp`, or on a whole module, they are the one-process code. A
sharded conv is column-parallel: each rank runs K1 / K4 / K6 on the whole
input with its slice of the output channels (its slices of the bias, the
time embedding's extra bias, the residual and the 1x1 skip weight: a
sharded resnet shortcut's own, a whole VAE skip conv's columns through
`model_scatter`), then
gathers the output and K1's per-channel statistics over the model ranks,
so that every rank computes the next GroupNorm's coefficients from the
whole channels. An attention block is head-parallel (K3's LN + q/k/v
columns and K2 on the rank's heads) and the GEGLU feed-forward
column-parallel; both end row-parallel (`RowParallelFn`: K3 on the rank's
input slice of `to_out` / `out`, the bias and residual on model rank 0
alone, then a sum over the ranks).

Under autograd the same code trains, every kernel running forward and
backward on the rank's shards (K1 / K8's du, K3, K2 / K7, K4, K6 on Co
slices and local heads), through the model axis's operators
(`parallel/mesh.py`): a column-parallel layer's replicated inputs (x, a
skip's x, the cross-attention context) enter through `model_copy`, whose
backward sums the ranks' partial input gradients; its whole residual and
extra bias through `model_scatter`; its output leaves through
`model_gather`, whose backward takes this rank's slice of the whole
gradient. K1's gathered statistics take no gradient. `RowParallelFn`'s
backward gives the residual and the bias the whole output gradient on
every rank. So every replicated activation and every replicated tensor
that trains gets a whole gradient, the same on every rank, and the ranks
run their collectives in one order (the same code in the same order,
each block's recompute under `remat` included). The norm affines that
feed a sharded layer are frozen (a sharded layer raises if one trains).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from img2img_turbo_tpu_torch.ops import attention as attn_ops
from img2img_turbo_tpu_torch.ops import fused_conv, fused_matmul
from img2img_turbo_tpu_torch.ops import groupnorm as gn_ops
from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
from img2img_turbo_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# Modules with kernel-ready weights
# ---------------------------------------------------------------------------


class Conv2d(nn.Conv2d):
    """nn.Conv2d (stride 1, no padding of its own: padding is explicit in
    `conv2d`) whose `prepare()` builds the kernel layouts."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, bias=bias)

    def prepare(self):
        w = self.weight.detach()
        kw = w.permute(2, 3, 1, 0)                            # HWIO
        kw = (kw[0, 0] if self.kernel_size == (1, 1) else kw).contiguous()
        self.kwp = self._pack(kw)                             # kernel layout
        # the CUDA kernels read kwp alone; HWIO serves the CPU plain versions
        self.kw = kw if w.device.type == "cpu" else None
        self.kb = (self.bias.detach().float() if self.bias is not None
                   else torch.zeros(w.shape[0], device=w.device))

    def _pack(self, kw):
        return fused_conv.pack_weights(kw)


class Upsample2xConv(Conv2d):
    """The conv of a diffusers Upsample2D; its kernel layout is the folded
    4-phase weights of the upsample kernel (K4), packed."""

    def _pack(self, kw):
        return fused_conv.pack_weights(fused_conv.fold_upsample_weights(kw))


class Linear(nn.Linear):
    """nn.Linear whose `prepare()` builds K3's fp32 bias; K3 reads the
    module's own (Co, C) weight as it is."""

    def prepare(self):
        w = self.weight
        self.kb = (self.bias.detach().float() if self.bias is not None
                   else torch.zeros(w.shape[0], device=w.device))


class LayerNorm(nn.LayerNorm):
    def prepare(self):
        self.kln = (self.weight.detach().float().contiguous(),
                    self.bias.detach().float().contiguous())


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm whose fp32 affine, for the GN-coefficient combine, is
    built once by `prepare()`."""

    def prepare(self):
        self.kaff = (self.weight.detach().float(), self.bias.detach().float())


def prepare_kernels(model: nn.Module) -> nn.Module:
    """Build every kernel-ready weight layout of `model`, once, after its
    weights are loaded, moved and cast."""
    for m in model.modules():
        if hasattr(m, "prepare"):
            m.prepare()
    return model


# ---------------------------------------------------------------------------
# Plain ops
# ---------------------------------------------------------------------------


def conv2d(conv: nn.Conv2d, x, stride: int = 1, padding="SAME", tp=None):
    """NHWC cross-correlation. padding: 'SAME', 'VALID' or explicit
    ((lo, hi), (lo, hi)) for the two spatial dims."""
    if _tp_on(tp, conv):
        return _gathered(tp, conv2d(conv, _copied(tp, x), stride, padding),
                         False)
    kh = conv.weight.shape[2]
    if padding == "SAME":
        padding = ((kh // 2, kh // 2), (kh // 2, kh // 2))
    elif padding == "VALID":
        padding = ((0, 0), (0, 0))
    (hlo, hhi), (wlo, whi) = padding
    xc = F.pad(x.permute(0, 3, 1, 2), (wlo, whi, hlo, hhi))
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(xc, conv.weight.to(x.dtype), bias, stride=stride)
    return y.permute(0, 2, 3, 1)


def _affine_shape(x):
    return (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)


def _apply_affine(x, a, b):
    """x * a + b with the (B, C) fp32 folded GroupNorm affine cast to x's
    dtype."""
    shape = _affine_shape(x)
    return x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)


def _gn_xla(x, scale, bias, num_groups: int, eps: float):
    """Plain GroupNorm: two-pass fp32 statistics, folded affine applied in
    the activation dtype (the counterpart of `_gn_xla`, layers.py:186)."""
    return _apply_affine(x, *gn_ops.group_norm_coeffs_plain(
        x, scale, bias, num_groups, eps))


def layer_norm(ln: nn.LayerNorm, x, eps: float = 1e-5):
    return fused_matmul.layer_norm(x, ln.weight, ln.bias, eps)


def silu(x):
    return F.silu(x)


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x)


def linear(lin: nn.Linear, x):
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: float = 10000.0):
    """Sinusoidal embedding (diffusers get_timestep_embedding). The
    frequency table is computed in float64, then cast to float32, so the
    t=999 arguments keep full fp32 accuracy. Returns (B, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float64)
                      / (half - freq_shift)).float().to(timesteps.device)
    emb = freqs[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


upsample_nearest_2x = fused_conv.upsample_nearest_2x


def upsample_nearest_to(x, size):
    """Nearest upsample of NHWC x to (H, W) with torch F.interpolate
    'nearest' indices: source index floor(i * in / out)."""
    th, tw = size
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(th, device=x.device) * h // th
    cols = torch.arange(tw, device=x.device) * w // tw
    return x[:, rows][:, :, cols]


# ---------------------------------------------------------------------------
# Entry points (kernel or plain)
# ---------------------------------------------------------------------------


def _tp_on(tp, module) -> bool:
    """True when `module` holds a model-axis shard and `tp` is the mesh."""
    return tp is not None and getattr(module, "tp_sharded", False)


def _channels(tp, t):
    """This model rank's slice of the last dim of a whole `t` (a residual
    or an extra bias of a column-parallel conv), or None."""
    return None if t is None else mesh_mod.model_scatter(t, tp)


def _copied(tp, x, *norms):
    """A column-parallel layer's replicated input `x` (or None) through
    `model_copy`; the frozen `norms` that feed the layer are checked."""
    for norm in norms:
        if torch.is_grad_enabled() and norm is not None and (
                norm.weight.requires_grad or norm.bias.requires_grad):
            raise NotImplementedError(
                "a norm affine that trains feeds a sharded layer: its "
                "gradient would be this rank's part alone")
    return None if x is None else mesh_mod.model_copy(x, tp)


def _gathered(tp, out, emit_stats: bool):
    """A column-parallel conv's output (and its per-channel statistics,
    when emitted) gathered over the model ranks on the channel axis."""
    if not emit_stats:
        return mesh_mod.model_gather(out, tp)
    y, stats = out
    return (mesh_mod.model_gather(y, tp),
            None if stats is None else mesh_mod.model_gather(stats, tp))


class RowParallelFn(torch.autograd.Function):
    """lin(x) + residual with lin's weight w (Co, C_r) sharded on its input
    dim and x (..., C_r) this rank's matching slice. Forward: this rank's
    partial product by `fwd` (K3, or the plain version), the bias b and the
    residual added on model rank 0 alone, then summed over the model ranks
    in fp32 and rounded once (`model_reduce`). Backward: x and w by
    autograd through `plain` (the partial product recomputed from the
    saved inputs, as `KernelFn`); the residual takes the output gradient
    and the bias its sum over rows, on every rank alike, since the whole
    output depends on them once."""

    @staticmethod
    def forward(ctx, fwd, plain, tp, x, w, b, res):
        first = tp.model_rank == 0
        with torch.no_grad():
            (y,) = fwd(x, w, b if first else None, res if first else None)
            y = mesh_mod.model_reduce(y, tp)
        ctx.plain = plain
        ctx.b_dtype = None if b is None else b.dtype
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        nx, nw, nb, nres = ctx.needs_input_grad[3:]
        gx = gw = gb = None
        if nx or nw:
            with torch.enable_grad():
                xi = x.detach().requires_grad_(nx)
                wi = w.detach().requires_grad_(nw)
                (p,) = ctx.plain(xi, wi, None, None)
            grads = iter(torch.autograd.grad(
                p, [t for t, n in ((xi, nx), (wi, nw)) if n], gy))
            gx = next(grads) if nx else None
            gw = next(grads) if nw else None
        if nb:
            gb = gy.float().reshape(-1, gy.shape[-1]).sum(0).to(ctx.b_dtype)
        return (None, None, None, gx, gw, gb, gy if nres else None)


def _rowpar_fns(kernels: bool):
    """(fwd, plain) of `RowParallelFn` over (x, w, b, residual): K3 and its
    exact plain version with kernels, else the plain engine's."""
    def kernel(x, w, b, res):
        return fused_matmul.fused(
            x.contiguous(), (w.contiguous(),), (_bias_f32(b, w.shape[0], x),),
            residual=None if res is None else res.contiguous())

    def ref(x, w, b, res):
        return fused_matmul.fused_ref(x, (w,), (_bias_f32(b, w.shape[0], x),),
                                      residual=res)

    def plain(x, w, b, res):
        return fused_matmul.fused_plain(x, (w,), (b,), residual=res)
    return (kernel, ref) if kernels else (plain, plain)


def _row_parallel(lin: Linear, x, residual, tp, *, kernels: bool):
    """lin(x) + residual with `lin`'s weight sharded on its input dim and x
    this rank's matching slice, summed over the model ranks
    (`RowParallelFn`), on the module's kernel layouts or its live weights
    (training)."""
    prepared = kernels and has_kernel_layouts(lin)
    w = lin.weight.detach() if prepared else lin.weight.to(x.dtype)
    return RowParallelFn.apply(*_rowpar_fns(kernels), tp, x, w,
                               lin.kb if prepared else lin.bias, residual)


class Skip(NamedTuple):
    """An epilogue 1x1 conv: y += conv1x1(x * gamma) (the resnet shortcut
    or a VAE skip zero-conv). gamma is a float or a 0-d tensor (the sketch
    path's runtime r)."""
    x: torch.Tensor
    conv: Conv2d
    gamma: object = 1.0


def _gn_coeffs(norm: GroupNorm, x, num_groups, eps, x_stats):
    scale, bias = norm.kaff
    if x_stats is not None:
        count = x.numel() // (x.shape[0] * x.shape[-1])
        return gn_ops.combine_stats(x_stats, scale, bias, num_groups, eps,
                                    count)
    return gn_ops.group_norm_coeffs(x.contiguous(), scale, bias, num_groups,
                                    eps)


def group_norm(norm: nn.GroupNorm, x, num_groups: int, eps: float,
               x_stats=None, *, kernels: bool):
    """GroupNorm over NHWC (or (B, S, C)). With kernels, statistics come
    from the producer's emitted partial sums (`x_stats`) or from K5."""
    if not kernels:
        return _gn_xla(x, norm.weight, norm.bias, num_groups, eps)
    if not has_kernel_layouts(norm):
        return KernelFn.apply(*_gn_fwd(num_groups, eps), 1, x, norm.weight,
                              norm.bias, x_stats)[0]
    return _apply_affine(x, *_gn_coeffs(norm, x, num_groups, eps, x_stats))


class _SkipSlice(NamedTuple):
    """This model rank's output columns of a whole 1x1 skip conv (the VAE's
    skip convs, departure (e) of `parallel/tensor.py`), standing in for the
    conv in a column-parallel conv's `Skip`: its weight (Co_r, Csk, 1, 1)
    and bias (or None) taken through `model_scatter`."""
    weight: torch.Tensor
    bias: Optional[torch.Tensor]


def _skip_part(tp, skip: Optional[Skip]) -> Optional[Skip]:
    """A column-parallel conv's epilogue skip on this model rank: its x
    through `model_copy`; its conv as it is when the rule sharded it (the
    resnet shortcut, whose Co slice matches the conv's), else this rank's
    output columns of the whole skip conv through `model_scatter`, so that
    a whole skip conv's gradient is whole on every rank."""
    if skip is None:
        return None
    conv = skip.conv
    if not getattr(conv, "tp_sharded", False):
        conv = _SkipSlice(
            mesh_mod.model_scatter(conv.weight, tp, 0),
            None if conv.bias is None else mesh_mod.model_scatter(
                conv.bias, tp, 0))
    return Skip(_copied(tp, skip.x), conv, skip.gamma)


def _skip_weights(skip: Skip):
    """(skip_w, skip_w_packed) with gamma folded in: per call unless gamma
    is the float 1.0 (a 0-d tensor gamma is folded without reading it back
    to the host)."""
    conv = skip.conv
    if not torch.is_tensor(skip.gamma) and skip.gamma == 1.0:
        return conv.kw, conv.kwp
    w = (conv.weight.detach()[:, :, 0, 0].t().float() * skip.gamma).to(
        conv.weight.dtype)
    return w, _packed(w)


def _plain_skip(skip: Optional[Skip]):
    """(skip_x, skip_w, skip_bias) of the plain engine's 1x1 skip conv."""
    if skip is None:
        return None, None, None
    return skip.x * skip.gamma, skip.conv.weight, skip.conv.bias


# ---------------------------------------------------------------------------
# Autograd Functions of the kernel path with live weights (training)
# ---------------------------------------------------------------------------


def has_kernel_layouts(module) -> bool:
    """True once `prepare_kernels` built the module's kernel layouts."""
    return any(hasattr(module, a) for a in ("kwp", "kaff", "kln", "kb"))


def _hwio(w):
    """nn.Conv2d's (Co, C, kh, kw) -> (kh, kw, C, Co), contiguous."""
    return w.permute(2, 3, 1, 0).contiguous()


def _packed(w_hwio, fold: bool = False):
    """The kernels' weight layout, built from a live weight; only CUDA
    tensors need it (the CPU plain versions read HWIO)."""
    if w_hwio is None or w_hwio.device.type == "cpu":
        return None
    if fold:
        w_hwio = fused_conv.fold_upsample_weights(w_hwio)
    profiling.count("weight_packs")
    return fused_conv.pack_weights(w_hwio)


def _bias_f32(b, co, like):
    """A conv or linear bias as fp32 (zeros for a bias-free module)."""
    return torch.zeros(co, device=like.device) if b is None else b.float()


class KernelFn(torch.autograd.Function):
    """Forward through a kernel entry, backward by autograd through its
    plain version recomputed from the saved inputs (the counterpart of the
    JAX package's `jax.vjp(xla_impl, *saved)` backward for K3, K4, the
    prologue-free conv and GroupNorm). `fwd` and `plain` take the same
    positional tensors (or None) and return tuples whose first `n_diff`
    outputs are differentiable; the rest (emitted stats) are not."""

    @staticmethod
    def forward(ctx, fwd, plain, n_diff: int, *args):
        ctx.plain, ctx.n_diff = plain, n_diff
        ctx.save_for_backward(*args)
        with torch.no_grad():
            outs = tuple(fwd(*args))
        if len(outs) > n_diff:
            ctx.mark_non_differentiable(*outs[n_diff:])
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        args = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        profiling.count("plain_recomputes")
        with torch.enable_grad():
            inp = [a.detach().requires_grad_(n) if a is not None else None
                   for a, n in zip(args, needs)]
            outs = ctx.plain(*inp)[:ctx.n_diff]
        wrt = [a for a, n in zip(inp, needs) if n]
        g = [torch.zeros_like(o) if go is None else go
             for o, go in zip(outs, gouts)]
        grads = iter(torch.autograd.grad(outs, wrt, g, allow_unused=True))
        return (None, None, None) + tuple(next(grads) if n else None
                                          for n in needs)


class GnSiluConvFn(torch.autograd.Function):
    """K1 forward, K8 backward: the counterpart of `_make_fused_gsc`
    (layers.py:294-455) with `pallas_bwd` (:351-433).

    Inputs: x (B,H,W,C); GN scale, bias (C,); w (Co,C,3,3) in x.dtype; the
    conv bias cb (Co,); optional extra_bias (B,Co), residual (B,H,W,Co),
    skip_x (B,H,W,Csk) with skip_w (Csk,Co), and x_stats (partial sums of x
    chained from its producer). The kernel layouts are packed here, from
    the weights this call was given, and the packed conv weight is what the
    Function saves (not w). Backward, with fp32 GN statistics recomputed
    two-pass: du is the du kernel (K8's) on the output gradient,
    reading that packed weight with its taps reversed and its channels
    swapped; dw is 9 shifted GEMMs against the recomputed activation; GN
    and SiLU backward are fp32 elementwise. x_stats gets a zero cotangent (it is a function of x, and
    dx is exact through the composition) and the emitted stats none."""

    @staticmethod
    def forward(ctx, x, scale, bias, w, cb, eb, res, skip_x, skip_w, x_stats,
                num_groups: int, eps: float, emit_stats: bool):
        with torch.no_grad():
            if x_stats is not None:
                count = x.numel() // (x.shape[0] * x.shape[-1])
                a, b = gn_ops.combine_stats(x_stats, scale, bias, num_groups,
                                            eps, count)
            else:
                a, b = gn_ops.group_norm_coeffs(x.contiguous(), scale, bias,
                                                num_groups, eps)
            w_hwio = _hwio(w)
            profiling.count("weight_packs")
            w_packed = fused_conv.pack_weights(w_hwio)
            y, stats = fused_conv.fused_gn_silu_conv3x3(
                x.contiguous(), w_hwio, cb.float(), a, b,
                extra_bias=None if eb is None else eb.float(),
                residual=None if res is None else res.contiguous(),
                skip_x=None if skip_x is None else skip_x.contiguous(),
                skip_w=skip_w, emit_stats=emit_stats,
                w_packed=w_packed, skip_w_packed=_packed(skip_w))
        ctx.num_groups, ctx.eps = num_groups, eps
        ctx.has = (eb is not None, res is not None, skip_x is not None)
        ctx.co, ctx.w_dtype = w.shape[0], w.dtype
        ctx.save_for_backward(x, scale, bias, w_packed, skip_x, skip_w)
        if not emit_stats:
            return y
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, gy, *_):
        x, scale, bias, w_packed, skip_x, skip_w = ctx.saved_tensors
        has_eb, has_res, has_skip = ctx.has
        g_n = ctx.num_groups
        bsz, h, wd, c = x.shape
        co = ctx.co
        cg = c // g_n
        f32 = torch.float32
        gy = gy.contiguous()

        # GN statistics, two-pass fp32 (as _gn_xla)
        xf = x.to(f32).reshape(bsz, h * wd, g_n, cg)
        mean = xf.mean(dim=(1, 3))
        var = (xf - mean[:, None, :, None]).square().mean(dim=(1, 3))
        inv = torch.rsqrt(var + ctx.eps)                      # (B, G)
        sg = scale.to(f32).reshape(g_n, cg)
        bg = bias.to(f32).reshape(g_n, cg)
        xhat = (xf - mean[:, None, :, None]) * inv[:, None, :, None]
        z = xhat * sg + bg
        sig = torch.sigmoid(z)
        uprime = sig * (1.0 + z * (1.0 - sig))                # silu'

        du = fused_conv.conv3x3_input_grad(gy, w_packed, c)
        dz = du.to(f32).reshape(bsz, h * wd, g_n, cg) * uprime

        # GN backward
        dxhat = dz * sg
        m1 = dxhat.mean(dim=(1, 3))
        m2 = (dxhat * xhat).mean(dim=(1, 3))
        dx = inv[:, None, :, None] * (dxhat - m1[:, None, :, None]
                                      - xhat * m2[:, None, :, None])
        dx = dx.reshape(bsz, h, wd, c).to(x.dtype)
        dscale = (dz * xhat).sum(dim=(0, 1)).reshape(c).to(scale.dtype)
        dbias = dz.sum(dim=(0, 1)).reshape(c).to(bias.dtype)

        # dw: 9 shifted GEMMs against the recomputed activation
        u = (z * sig).to(gy.dtype).reshape(bsz, h, wd, c)
        upad = F.pad(u, (0, 0, 1, 1, 1, 1))
        gy2 = gy.reshape(-1, co)
        taps = [upad[:, di:di + h, dj:dj + wd].reshape(-1, c).t() @ gy2
                for di in range(3) for dj in range(3)]
        dw = torch.stack(taps).reshape(3, 3, c, co).permute(3, 2, 0, 1)
        dw = dw.to(ctx.w_dtype)
        dcb = gy2.to(f32).sum(0)
        deb = gy.to(f32).sum(dim=(1, 2)) if has_eb else None
        dres = gy if has_res else None
        dskx = dskw = None
        if has_skip:
            dskx = (gy2 @ skip_w.t().to(gy.dtype)).reshape(
                skip_x.shape).to(skip_x.dtype)
            dskw = (skip_x.reshape(-1, skip_x.shape[-1]).t() @ gy2).to(
                skip_w.dtype)
        return (dx, dscale, dbias, dw, dcb, deb, dres, dskx, dskw, None,
                None, None, None)


def _gn_fwd(num_groups, eps):
    def fwd(x, scale, bias, x_stats):
        if x_stats is not None:
            count = x.numel() // (x.shape[0] * x.shape[-1])
            a, b = gn_ops.combine_stats(x_stats, scale, bias, num_groups,
                                        eps, count)
        else:
            a, b = gn_ops.group_norm_coeffs(x.contiguous(), scale, bias,
                                            num_groups, eps)
        return (_apply_affine(x, a, b),)

    def plain(x, scale, bias, x_stats):
        return (_gn_xla(x, scale, bias, num_groups, eps),)
    return fwd, plain


def _plainconv_fwd(emit_stats):
    def fwd(x, w, cb):
        w_hwio = _hwio(w)
        y, stats = fused_conv.fused_gn_silu_conv3x3(
            x.contiguous(), w_hwio, _bias_f32(cb, w.shape[0], x),
            emit_stats=emit_stats, w_packed=_packed(w_hwio))
        return (y, stats) if emit_stats else (y,)

    def plain(x, w, cb):
        return (fused_conv.gn_silu_conv3x3_plain(x, w, cb),)
    return fwd, plain


def _downconv_fwd(pad_lo, emit_stats):
    def fwd(x, w, cb):
        w_hwio = _hwio(w)
        y, stats = fused_conv.downsample2x_conv3x3(
            x.contiguous(), w_hwio, _bias_f32(cb, w.shape[0], x), pad_lo,
            emit_stats=emit_stats, w_packed=_packed(w_hwio))
        return (y, stats) if emit_stats else (y,)

    def plain(x, w, cb):
        return (fused_conv.downsample2x_conv3x3_plain(x, w, cb, pad_lo)[0],)
    return fwd, plain


def _upconv_fwd(emit_stats):
    def fwd(x, w, cb, skip_x, skip_w):
        w_hwio = _hwio(w)
        y, stats = fused_conv.upsample2x_conv3x3(
            x.contiguous(), w_hwio, _bias_f32(cb, w.shape[0], x),
            skip_x=None if skip_x is None else skip_x.contiguous(),
            skip_w=skip_w, emit_stats=emit_stats,
            w_packed=_packed(w_hwio, fold=True),
            skip_w_packed=_packed(skip_w))
        return (y, stats) if emit_stats else (y,)

    def plain(x, w, cb, skip_x, skip_w):
        skw = None if skip_w is None else skip_w.t()[:, :, None, None]
        return (fused_conv.upsample2x_conv3x3_plain(x, w, cb, skip_x, skw),)
    return fwd, plain


def _linears_fwd(n_w: int, has_ln: bool, gate: bool, eps: float):
    """fwd / plain over (x, residual, ln_scale, ln_bias, *ws, *bs) with
    nn.Linear's (Co, C) weights, which K3 reads as they are, and
    possibly-None biases."""
    def split(args):
        x, res, lns, lnb = args[:4]
        ws, bs = args[4:4 + n_w], args[4 + n_w:]
        bs = tuple(_bias_f32(b, w.shape[0], x) for b, w in zip(bs, ws))
        return x, res, (lns, lnb) if has_ln else None, ws, bs

    def fwd(*args):
        x, res, ln, ws, bs = split(args)
        return fused_matmul.fused(
            x.contiguous(), tuple(w.contiguous() for w in ws), bs,
            ln=None if ln is None else tuple(t.float() for t in ln),
            residual=None if res is None else res.contiguous(), gate=gate,
            eps=eps)

    def plain(*args):
        x, res, ln, ws, bs = split(args)
        return fused_matmul.fused_ref(x, ws, bs, ln=ln, residual=res,
                                      gate=gate, eps=eps)
    return fwd, plain


def gn_silu_conv(norm: nn.GroupNorm, conv: Conv2d, x, num_groups: int,
                 eps: float, *, kernels: bool, extra_bias=None,
                 residual=None, x_stats=None, emit_stats: bool = False,
                 skip: Optional[Skip] = None, bias=None, tp=None):
    """conv3x3(silu(GroupNorm(x))) + bias [+ extra_bias (B, Co)]
    [+ residual] [+ skip]. With kernels: one K1 launch (GN coefficients
    from `x_stats` or K5); emit_stats returns (y, partial sums) for the next
    GroupNorm. `bias` (fp32) overrides conv.kb on the kernel path: the
    resnet passes conv2 + shortcut bias, summed once at load. Plain path:
    stats are None. With `tp` and a sharded conv: column-parallel (module
    docstring), the output and stats gathered."""
    if _tp_on(tp, conv):
        return _gathered(tp, gn_silu_conv(
            norm, conv, _copied(tp, x, norm), num_groups, eps,
            kernels=kernels, extra_bias=_channels(tp, extra_bias),
            residual=_channels(tp, residual), x_stats=x_stats,
            emit_stats=emit_stats, skip=_skip_part(tp, skip), bias=bias),
            emit_stats)
    if not kernels:
        a, b = gn_ops.group_norm_coeffs_plain(x, norm.weight, norm.bias,
                                              num_groups, eps)
        y = fused_conv.gn_silu_conv3x3_plain(
            x, conv.weight, conv.bias, a, b, extra_bias, residual,
            *_plain_skip(skip))
        return (y, None) if emit_stats else y
    if not has_kernel_layouts(conv):
        cb = _bias_f32(conv.bias, conv.weight.shape[0], x)
        skx = skw = None
        if skip is not None:
            skx = skip.x
            skw = (skip.conv.weight[:, :, 0, 0].t() * skip.gamma).to(x.dtype)
            if skip.conv.bias is not None:
                cb = cb + skip.conv.bias.float()
        return GnSiluConvFn.apply(
            x, norm.weight, norm.bias, conv.weight.to(x.dtype), cb,
            extra_bias, residual, skx, skw, x_stats, num_groups, eps,
            emit_stats)
    a, b = _gn_coeffs(norm, x, num_groups, eps, x_stats)
    skw, skwp = _skip_weights(skip) if skip is not None else (None, None)
    y, stats = fused_conv.fused_gn_silu_conv3x3(
        x.contiguous(), conv.kw, conv.kb if bias is None else bias, a, b,
        extra_bias=None if extra_bias is None else extra_bias.float(),
        residual=None if residual is None else residual.contiguous(),
        skip_x=None if skip is None else skip.x.contiguous(), skip_w=skw,
        emit_stats=emit_stats, w_packed=conv.kwp, skip_w_packed=skwp)
    return (y, stats) if emit_stats else y


def plain_conv3x3(conv: Conv2d, x, emit_stats: bool = False, *,
                  kernels: bool, tp=None):
    """Stride-1 SAME conv3x3 with no norm prologue (conv_in)."""
    if _tp_on(tp, conv):
        return _gathered(tp, plain_conv3x3(conv, _copied(tp, x), emit_stats,
                                           kernels=kernels), emit_stats)
    if not kernels:
        y = fused_conv.gn_silu_conv3x3_plain(x, conv.weight, conv.bias)
        return (y, None) if emit_stats else y
    if not has_kernel_layouts(conv):
        out = KernelFn.apply(*_plainconv_fwd(emit_stats), 1, x,
                             conv.weight.to(x.dtype), conv.bias)
        return out if emit_stats else out[0]
    y, stats = fused_conv.fused_gn_silu_conv3x3(
        x.contiguous(), conv.kw, conv.kb, emit_stats=emit_stats,
        w_packed=conv.kwp)
    return (y, stats) if emit_stats else y


def upsample2x_conv(conv: Upsample2xConv, x, emit_stats: bool = False,
                    skip: Optional[Skip] = None, *, kernels: bool, tp=None):
    """conv3x3(nearest_upsample_2x(x)) [+ skip] (diffusers Upsample2D);
    K4 with kernels."""
    if _tp_on(tp, conv):
        return _gathered(tp, upsample2x_conv(conv, _copied(tp, x), emit_stats,
                                             _skip_part(tp, skip),
                                             kernels=kernels), emit_stats)
    if not kernels:
        y = fused_conv.upsample2x_conv3x3_plain(x, conv.weight, conv.bias,
                                                *_plain_skip(skip))
        return (y, None) if emit_stats else y
    if not has_kernel_layouts(conv):
        skx = skw = None
        if skip is not None:
            skx = skip.x
            skw = (skip.conv.weight[:, :, 0, 0].t() * skip.gamma).to(x.dtype)
        out = KernelFn.apply(*_upconv_fwd(emit_stats), 1, x,
                             conv.weight.to(x.dtype), conv.bias, skx, skw)
        return out if emit_stats else out[0]
    skw, skwp = _skip_weights(skip) if skip is not None else (None, None)
    y, stats = fused_conv.upsample2x_conv3x3(
        x.contiguous(), conv.kw, conv.kb,
        skip_x=None if skip is None else skip.x.contiguous(), skip_w=skw,
        emit_stats=emit_stats, w_packed=conv.kwp, skip_w_packed=skwp)
    return (y, stats) if emit_stats else y


def downsample2x_conv(conv: Conv2d, x, pad_lo: int, emit_stats: bool = False,
                      *, kernels: bool, tp=None):
    """Stride-2 conv3x3 with ((pad_lo, 1), (pad_lo, 1)) padding: pad_lo=0
    in the VAE encoder, 1 in the UNet (layers.py:605-633). With kernels:
    K6, whose emitted stats feed the next GroupNorm; a module with live
    weights goes through `KernelFn` (K6 forward, autograd through the plain
    strided conv backward, as `_make_fused_downconv`). Plain path: the
    strided conv, stats None."""
    if _tp_on(tp, conv):
        return _gathered(tp, downsample2x_conv(conv, _copied(tp, x), pad_lo,
                                               emit_stats, kernels=kernels),
                         emit_stats)
    if not kernels:
        y, _ = fused_conv.downsample2x_conv3x3_plain(x, conv.weight,
                                                     conv.bias, pad_lo)
        return (y, None) if emit_stats else y
    if not has_kernel_layouts(conv):
        out = KernelFn.apply(*_downconv_fwd(pad_lo, emit_stats), 1, x,
                             conv.weight.to(x.dtype), conv.bias)
        return out if emit_stats else out[0]
    y, stats = fused_conv.downsample2x_conv3x3(
        x.contiguous(), conv.kw, conv.kb, pad_lo, emit_stats=emit_stats,
        w_packed=conv.kwp)
    return (y, stats) if emit_stats else y


def fused_linears(lins, x, norm: Optional[LayerNorm] = None, *,
                  kernels: bool, residual=None, gate: bool = False,
                  eps: float = 1e-5):
    """[LayerNorm(x) ->] 1-3 linears sharing it [-> GEGLU gate]
    [+ residual], as a tuple of outputs: one K3 launch with kernels, else
    the plain composition."""
    if not kernels:
        return fused_matmul.fused_plain(
            x, tuple(m.weight for m in lins), tuple(m.bias for m in lins),
            ln=None if norm is None else (norm.weight, norm.bias),
            residual=residual, gate=gate, eps=eps)
    if not has_kernel_layouts(lins[0]):
        return KernelFn.apply(
            *_linears_fwd(len(lins), norm is not None, gate, eps),
            1 if gate else len(lins), x, residual,
            None if norm is None else norm.weight,
            None if norm is None else norm.bias,
            *(m.weight.to(x.dtype) for m in lins), *(m.bias for m in lins))
    return fused_matmul.fused(
        x.contiguous(), tuple(m.weight.detach() for m in lins),
        tuple(m.kb for m in lins),
        ln=None if norm is None else norm.kln,
        residual=None if residual is None else residual.contiguous(),
        gate=gate, eps=eps)


def linear_fused(lin: Linear, x, residual=None, *, kernels: bool):
    """linear [+ residual]; K3 with kernels."""
    return fused_linears((lin,), x, kernels=kernels, residual=residual)[0]


def multihead_attention(q, k, v, num_heads: int, *, kernels: bool):
    if not kernels:
        return attn_ops.mha_ref(q, k, v, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return attn_ops.FlashAttention.apply(
            q.contiguous(), k.contiguous(), v.contiguous(), num_heads)
    return attn_ops.flash_attention_folded(
        q.contiguous(), k.contiguous(), v.contiguous(), num_heads)


class Attention(nn.Module):
    """diffusers Attention: to_q/to_k/to_v (bias-free in the UNet, biased
    in the VAE mid block) and to_out.0 (biased)."""

    def __init__(self, query_dim: int, cross_dim: Optional[int] = None,
                 qkv_bias: bool = False):
        super().__init__()
        kdim = query_dim if cross_dim is None else cross_dim
        self.to_q = Linear(query_dim, query_dim, bias=qkv_bias)
        self.to_k = Linear(kdim, query_dim, bias=qkv_bias)
        self.to_v = Linear(kdim, query_dim, bias=qkv_bias)
        self.to_out = nn.ModuleList([Linear(query_dim, query_dim)])


def attention_block(attn: Attention, norm: LayerNorm, x, context=None, *,
                    num_heads: int, kernels: bool, eps: float = 1e-5,
                    tp=None):
    """x + attention(LN(x)): with kernels, LN + q/k/v as one 3-output K3
    launch (self) or LN-q plus a 2-output kv launch on the context
    (cross), K2, and the out projection with the residual fused (K3). With
    `tp` and sharded heads: this rank's heads, `to_out` row-parallel."""
    sharded = _tp_on(tp, attn.to_q)
    xin = x
    if sharded:
        num_heads //= tp.n_model
        xin, context = _copied(tp, x, norm), _copied(tp, context)
    if context is None:
        q, k, v = fused_linears((attn.to_q, attn.to_k, attn.to_v), xin, norm,
                                kernels=kernels, eps=eps)
    else:
        (q,) = fused_linears((attn.to_q,), xin, norm, kernels=kernels,
                             eps=eps)
        k, v = fused_linears((attn.to_k, attn.to_v), context,
                             kernels=kernels)
    o = multihead_attention(q, k, v, num_heads, kernels=kernels)
    if sharded:
        return _row_parallel(attn.to_out[0], o, x, tp, kernels=kernels)
    return linear_fused(attn.to_out[0], o, residual=x, kernels=kernels)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """diffusers FeedForward(activation_fn="geglu"): net.0.proj, net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])


def geglu_ff_block(ff: FeedForward, norm: LayerNorm, x, *, kernels: bool,
                   eps: float = 1e-5, tp=None):
    """x + geglu_ff(LN(x)); with kernels, LN + the packed GEGLU projection
    as one gated K3 launch, then the output projection + residual. With
    `tp` and a sharded `proj` (this rank's value and gate slices): `out`
    row-parallel."""
    proj, out = ff.net[0].proj, ff.net[2]
    sharded = _tp_on(tp, proj)
    (u,) = fused_linears((proj,), _copied(tp, x, norm) if sharded else x,
                         norm, kernels=kernels, gate=True, eps=eps)
    if sharded:
        return _row_parallel(out, u, x, tp, kernels=kernels)
    return linear_fused(out, u, residual=x, kernels=kernels)


# ---------------------------------------------------------------------------
# Blocks (shared by the VAE and the UNet)
# ---------------------------------------------------------------------------


class Resample(nn.Module):
    """diffusers Downsample2D / Upsample2D: only its `.conv` has weights."""

    def __init__(self, conv: Conv2d):
        super().__init__()
        self.conv = conv


class Block(nn.Module):
    """A diffusers down or up block: `resnets`, optional `attentions`, and
    an optional `{kind}samplers.0.conv`."""

    def __init__(self, resnets, attns=(), conv: Optional[Conv2d] = None,
                 kind: str = "down"):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attns:
            self.attentions = nn.ModuleList(attns)
        if conv is not None:
            setattr(self, f"{kind}samplers", nn.ModuleList([Resample(conv)]))



class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D: norm1, conv1, [time_emb_proj], norm2, conv2,
    [conv_shortcut (1x1)]."""

    def __init__(self, in_ch: int, out_ch: int, groups: int, eps: float,
                 temb_dim: Optional[int] = None):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1 = GroupNorm(groups, in_ch, eps)
        self.conv1 = Conv2d(in_ch, out_ch, 3)
        if temb_dim is not None:
            self.time_emb_proj = Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(groups, out_ch, eps)
        self.conv2 = Conv2d(out_ch, out_ch, 3)
        if in_ch != out_ch:
            self.conv_shortcut = Conv2d(in_ch, out_ch, 1)

    def prepare(self):
        # conv2's kernel bias with the shortcut's bias folded in (the
        # shortcut rides conv2's epilogue as a 1x1 skip)
        if hasattr(self, "conv_shortcut"):
            self.kb2 = (self.conv2.bias.detach().float()
                        + self.conv_shortcut.bias.detach().float())

    def forward(self, x, temb=None, *, kernels: bool, x_stats=None,
                emit_stats: bool = False, epilogue_skip: Optional[Skip] = None,
                tp=None):
        """x_stats / emit_stats chain GroupNorm partial sums between kernels:
        GN1 reads x_stats, conv1 emits for GN2, conv2 emits on request.
        epilogue_skip: a VAE skip zero-conv fused into conv2's epilogue.
        tp: the model axis's mesh, for a sharded block."""
        t = None
        if hasattr(self, "time_emb_proj"):
            t = linear(self.time_emb_proj, silu(temb))
        h, s1 = gn_silu_conv(self.norm1, self.conv1, x, self.groups,
                             self.eps, kernels=kernels, extra_bias=t,
                             x_stats=x_stats, emit_stats=True, tp=tp)
        bias = None
        if hasattr(self, "conv_shortcut") and epilogue_skip is None:
            residual, skip = None, Skip(x, self.conv_shortcut)
            bias = getattr(self, "kb2", None)
        else:
            residual = (conv2d(self.conv_shortcut, x, tp=tp)
                        if hasattr(self, "conv_shortcut") else x)
            skip = epilogue_skip
        return gn_silu_conv(self.norm2, self.conv2, h, self.groups, self.eps,
                            kernels=kernels, residual=residual, x_stats=s1,
                            emit_stats=emit_stats, skip=skip, bias=bias,
                            tp=tp)
