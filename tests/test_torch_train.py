"""The port's training path against the JAX package, on the CPU, in fp32.

- K7's plain version (`attention_bwd_ref`) and the K2/K7 autograd Function
  against `jax.vjp` of `_mha_xla` (ragged Sq, Skv = 77, several heads);
- the K8 Function (`GnSiluConvFn`) against `jax.grad` of the gn_silu_conv
  XLA composition, for each of extra bias, residual, 1x1 skip and chained
  stats; the K3, K4, K5 and prologue-free conv Functions likewise;
- one whole paired step at MICRO_UNET / MICRO_VAE / TINY_TEXT /
  TINY_CLIP_VIT: the losses of all four passes, the pass-1 gradients and
  the trainables and spectral-norm vectors after the step; the same step
  on two gloo ranks, data-parallel (tiled) and on a (1, 2) mesh with the
  UNet sharded over the model axis, on both ranks, the model axis's state
  bit-identical across its ranks;
- the per-step launch table of chip_smoke.py, by counting the kernel
  wrappers' calls in a step at the TINY configs (SD-Turbo's topology).

The JAX side runs its XLA path (never Pallas interpret mode). Inputs and
weights come from seeded numpy or the JAX init, converted by
`weights/from_jax.py`. Tolerances are stated beside each check: 1e-4 for
fp32 gradients of single ops, relative L2 2e-4 for whole-model gradients
(long fp32 sums in two orders), and 1e-4 relative on the trainables'
change where Adam's step is not dominated by gradient noise.
"""

import collections
import copy
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

import torch_dp

from img2img_turbo_tpu import configs as jcfg
from img2img_turbo_tpu.models import clip_text as jclip_text
from img2img_turbo_tpu.models import clip_vit as jclip_vit
from img2img_turbo_tpu.models import layers as JL
from img2img_turbo_tpu.models import vgg_lpips as jvgg
from img2img_turbo_tpu.ops import attention as jattn
from img2img_turbo_tpu.ops import fused_matmul as jfm
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.training import losses as jlosses
from img2img_turbo_tpu.training import optim as joptim
from img2img_turbo_tpu.training import paired as jpaired
from img2img_turbo_tpu_torch import configs as tcfg
from img2img_turbo_tpu_torch.models import clip_vit as tclip_vit
from img2img_turbo_tpu_torch.models import layers as TL
from img2img_turbo_tpu_torch.ops import attention as tattn
from img2img_turbo_tpu_torch.ops import (fused_conv, fused_matmul,
                                         groupnorm)
from img2img_turbo_tpu_torch.ops import groupnorm as tgn
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.training import losses as tlosses
from img2img_turbo_tpu_torch.training import optim as toptim
from img2img_turbo_tpu_torch.training import paired as tpaired
from img2img_turbo_tpu_torch.training import runner as trunner
from img2img_turbo_tpu_torch.utils import profiling
from img2img_turbo_tpu_torch.weights import from_jax

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4          # fp32 gradients of one op, abs and rel
MODEL_TOL = 2e-4    # relative L2 of whole-model fp32 gradients


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _np(a):
    return np.asarray(a.detach() if torch.is_tensor(a) else a, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# ---------------------------------------------------------------------------
# K2 lse and K7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,skv,heads,hd", [
    (1, 37, 37, 2, 16),      # ragged Sq
    (2, 50, 77, 3, 8),       # Skv = 77 (cross-attention), several heads
    (1, 64, 24, 1, 64),
    (1, 130, 77, 2, 64),     # hd 64, ragged Sq, cross-attention Skv = 77
    (1, 72, 100, 1, 512)])   # hd 512 (the VAE mid attention), ragged
def test_attention_backward_matches_jax_vjp(b, sq, skv, heads, hd):
    rng = np.random.RandomState(sq + skv)
    d = heads * hd
    q, do = (rng.randn(b, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, skv, d).astype(np.float32) for _ in range(2))
    o_j, vjp = jax.vjp(lambda q_, k_, v_: jattn._mha_xla(q_, k_, v_, heads),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    o, lse = tattn.mha_ref(_t(q), _t(k), _t(v), heads, return_lse=True)
    _close(o, o_j)
    s = np.einsum("bqhd,bkhd->bqhk", q.reshape(b, sq, heads, hd),
                  k.reshape(b, skv, heads, hd)) / np.sqrt(hd)
    _close(lse, np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1))
           + s.max(-1))
    got = tattn.attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(do), lse, heads)
    for g, w in zip(got, want):
        _close(g, w)
    # the autograd Function (K2 forward, K7 backward) gives the same
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tattn.FlashAttention.apply(tq, tk, tv, heads)
    out.backward(_t(do))
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(g, w)


# ---------------------------------------------------------------------------
# K8 and the recompute Functions
# ---------------------------------------------------------------------------


def _conv_params(rng, c, co, k=3, bias=True):
    p = {"kernel": (rng.randn(k, k, c, co) / np.sqrt(k * k * c)).astype(
        np.float32)}
    if bias:
        p["bias"] = (rng.randn(co) * 0.1).astype(np.float32)
    return p


def _conv_module(p, cls=TL.Conv2d):
    k, _, c, co = p["kernel"].shape
    m = cls(c, co, k, bias="bias" in p)
    sd = {}
    from_jax._inv_conv(sd, "", p)
    m.load_state_dict({k[1:]: torch.from_numpy(v) for k, v in sd.items()})
    return m


def _gn_module(c, groups, rng):
    m = TL.GroupNorm(groups, c, 1e-5)
    p = {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
         "bias": (0.2 * rng.randn(c)).astype(np.float32)}
    m.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                       "bias": torch.from_numpy(p["bias"])})
    return m, p


def _grads_port(params, loss):
    loss.backward()
    return [p.grad for p in params]


@pytest.mark.parametrize("variant", ["plain", "eb", "res", "skip",
                                     "stats_in", "all"])
def test_gn_silu_conv_function_matches_jax_grad(variant):
    """GnSiluConvFn (K1 forward, K8 backward) against jax.grad of the
    gn_silu_conv XLA composition (layers.py:687-699)."""
    rng = np.random.RandomState(len(variant))
    b, h, w, c, co, g, csk = 2, 6, 5, 16, 8, 4, 6
    has_eb = variant in ("eb", "all")
    has_res = variant in ("res", "all")
    has_skip = variant in ("skip", "all")
    x = rng.randn(b, h, w, c).astype(np.float32) * 1.5 + 0.3
    norm, gnp = _gn_module(c, g, rng)
    cp = _conv_params(rng, c, co)
    conv = _conv_module(cp)
    eb = rng.randn(b, co).astype(np.float32) if has_eb else None
    res = rng.randn(b, h, w, co).astype(np.float32) if has_res else None
    skx = rng.randn(b, h, w, csk).astype(np.float32) if has_skip else None
    skp = _conv_params(rng, csk, co, k=1) if has_skip else None
    ct = rng.randn(b, h, w, co).astype(np.float32)

    def jf(x_, s_, bi_, k_, cb_, eb_, res_, skx_, skk_, skb_):
        skip = None
        if skx_ is not None:
            skip = {"x": skx_, "kernel": skk_, "gamma": 1.0, "bias": skb_}
        y = JL.gn_silu_conv({"scale": s_, "bias": bi_},
                            {"kernel": k_, "bias": cb_}, x_, g, 1e-5,
                            extra_bias=eb_, residual=res_, skip=skip)
        return jnp.sum(y * ct)

    jargs = [x, gnp["scale"], gnp["bias"], cp["kernel"], cp["bias"], eb, res,
             skx, None if skp is None else skp["kernel"],
             None if skp is None else skp["bias"]]
    idx = [i for i, a in enumerate(jargs) if a is not None]
    want = jax.grad(lambda *a: jf(*[a[idx.index(i)] if i in idx else None
                                    for i in range(len(jargs))]),
                    argnums=tuple(range(len(idx))))(
        *[jnp.asarray(jargs[i]) for i in idx])

    tx = _t(x, True)
    teb = _t(eb, True) if has_eb else None
    tres = _t(res, True) if has_res else None
    skip = None
    if has_skip:
        skc = _conv_module(skp)
        skip = TL.Skip(_t(skx, True), skc)
    stats = tgn.partial_stats_ref(tx.detach()) if variant in (
        "stats_in", "all") else None
    y = TL.gn_silu_conv(norm, conv, tx, g, 1e-5, kernels=True,
                        extra_bias=teb, residual=tres, x_stats=stats,
                        skip=skip)
    y_plain = TL.gn_silu_conv(norm, conv, tx, g, 1e-5, kernels=False,
                              extra_bias=teb, residual=tres, skip=skip)
    _close(y, y_plain)
    params = [tx, norm.weight, norm.bias, conv.weight, conv.bias]
    params += [t for t in (teb, tres) if t is not None]
    if has_skip:
        params += [skip.x, skip.conv.weight, skip.conv.bias]
    got = _grads_port(params, (y * _t(ct)).sum())
    wmap = dict(zip(idx, want))
    order = [0, 1, 2, 3, 4] + [i for i in (5, 6) if i in wmap] \
        + ([7, 8, 9] if has_skip else [])
    for gt, i in zip(got, order):
        wt = np.asarray(wmap[i])
        if i == 3 or i == 8:  # HWIO -> OIHW
            wt = wt.transpose(3, 2, 0, 1)
        _close(gt, wt)


def test_gn_silu_conv_function_matches_jax_pallas_bwd(monkeypatch):
    """GnSiluConvFn's gradients, whose du the conv engine's du mode takes
    from the weight the forward packed, against JAX's own Pallas backward
    of the layer (`_make_fused_gsc` with FC_BWD=pallas: pallas_bwd,
    layers.py:351-433, its du K1 in interpret mode on gy with the flipped,
    io-swapped weights)."""
    rng = np.random.RandomState(7)
    b, h, w, c, co, g = 1, 6, 5, 16, 8, 4
    x = rng.randn(b, h, w, c).astype(np.float32) * 1.5 + 0.3
    norm, gnp = _gn_module(c, g, rng)
    cp = _conv_params(rng, c, co)
    conv = _conv_module(cp)
    ct = rng.randn(b, h, w, co).astype(np.float32)
    f = JL._make_fused_gsc(g, 1e-5, False, False, False, False)
    monkeypatch.setenv("FC_BWD", "pallas")
    with JL.force_fused_scope(), pltpu.force_tpu_interpret_mode():
        want = jax.grad(lambda *a: jnp.sum(f(*a) * ct),
                        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (
                            x, gnp["scale"], gnp["bias"], cp["kernel"],
                            cp["bias"])))
    tx = _t(x, True)
    y = TL.gn_silu_conv(norm, conv, tx, g, 1e-5, kernels=True)
    got = _grads_port([tx, norm.weight, norm.bias, conv.weight, conv.bias],
                      (y * _t(ct)).sum())
    for gt, wt, perm in zip(got, want, (None, None, None, (3, 2, 0, 1),
                                        None)):
        wt = np.asarray(wt)
        _close(gt, wt if perm is None else wt.transpose(perm))


@pytest.mark.parametrize("c,co", [(8, 16), (16, 3), (3, 8)])
def test_conv3x3_input_grad_matches_jax_vjp(c, co):
    """K8's du (the conv engine's du mode, reading the forward's packed
    weight) against jax.vjp of a 3x3 'same' conv, at a few channel counts
    (C or Co of 3, as the VAE's conv_in and conv_out have)."""
    rng = np.random.RandomState(c * co)
    b, h, w = 2, 6, 5
    x = rng.randn(b, h, w, c).astype(np.float32)
    cp = _conv_params(rng, c, co)
    gy = rng.randn(b, h, w, co).astype(np.float32)
    _, vjp = jax.vjp(lambda x_: JL.plain_conv3x3(
        {"kernel": jnp.asarray(cp["kernel"]), "bias": jnp.asarray(cp["bias"])},
        x_), jnp.asarray(x))
    want, = vjp(jnp.asarray(gy))
    # the du reads the weight as the forward packed it
    w_packed = fused_conv.pack_weights(_t(cp["kernel"]))
    _close(fused_conv.conv3x3_input_grad(_t(gy), w_packed, c), want)


def test_plain_conv_upsample_and_gn_functions_match_jax_grad():
    """The recompute Functions of the prologue-free conv (conv_in), K4
    (with a VAE skip, gamma 0.5) and GroupNorm (K5 stats, and chained
    stats) against jax.grad of the JAX package's XLA path."""
    rng = np.random.RandomState(3)
    b, h, w, c, co, csk = 1, 5, 4, 8, 16, 6
    x = rng.randn(b, h, w, c).astype(np.float32)
    # conv_in
    cp = _conv_params(rng, c, co)
    ct = rng.randn(b, h, w, co).astype(np.float32)
    want = jax.grad(lambda x_, k_, b_: jnp.sum(JL.plain_conv3x3(
        {"kernel": k_, "bias": b_}, x_) * ct), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(cp["kernel"]), jnp.asarray(cp["bias"]))
    conv, tx = _conv_module(cp), _t(x, True)
    y, _ = TL.plain_conv3x3(conv, tx, emit_stats=True, kernels=True)
    got = _grads_port([tx, conv.weight, conv.bias], (y * _t(ct)).sum())
    for gt, wt, perm in zip(got, want, (None, (3, 2, 0, 1), None)):
        wt = np.asarray(wt)
        _close(gt, wt if perm is None else wt.transpose(perm))
    # K4 with a skip
    up = _conv_params(rng, c, co)
    skx = rng.randn(b, 2 * h, 2 * w, csk).astype(np.float32)
    skk = _conv_params(rng, csk, co, k=1, bias=False)["kernel"]
    ct = rng.randn(b, 2 * h, 2 * w, co).astype(np.float32)
    want = jax.grad(lambda x_, k_, b_, s_, sk_: jnp.sum(JL.upsample2x_conv(
        {"kernel": k_, "bias": b_}, x_,
        skip={"x": s_, "kernel": sk_, "gamma": 0.5}) * ct),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, up["kernel"],
                                                     up["bias"], skx, skk)))
    conv = _conv_module(up, TL.Upsample2xConv)
    skc = _conv_module({"kernel": skk})
    tx, tsk = _t(x, True), _t(skx, True)
    y = TL.upsample2x_conv(conv, tx, skip=TL.Skip(tsk, skc, 0.5),
                           kernels=True)
    got = _grads_port([tx, conv.weight, conv.bias, tsk, skc.weight],
                      (y * _t(ct)).sum())
    for gt, wt, perm in zip(got, want, (None, (3, 2, 0, 1), None, None,
                                        (3, 2, 0, 1))):
        wt = np.asarray(wt)
        _close(gt, wt if perm is None else wt.transpose(perm))
    # GroupNorm, K5 stats and chained stats
    norm, gnp = _gn_module(c, 4, rng)
    ct = rng.randn(b, h, w, c).astype(np.float32)
    want = jax.grad(lambda x_, s_, b_: jnp.sum(JL.group_norm(
        {"scale": s_, "bias": b_}, x_, 4, 1e-5) * ct), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gnp["scale"]), jnp.asarray(gnp["bias"]))
    for chained in (False, True):
        norm.zero_grad()
        tx = _t(x, True)
        stats = tgn.partial_stats_ref(tx.detach()) if chained else None
        y = TL.group_norm(norm, tx, 4, 1e-5, stats, kernels=True)
        got = _grads_port([tx, norm.weight, norm.bias], (y * _t(ct)).sum())
        for gt, wt in zip(got, want):
            _close(gt, wt)


@pytest.mark.parametrize("case", ["ln_qkv", "gate", "residual"])
def test_fused_linears_function_matches_jax_ref_grad(case):
    """The K3 recompute Function against jax.vjp of fused_matmul._ref."""
    rng = np.random.RandomState(len(case))
    m, c, co = 10, 16, 8
    n_w = 3 if case == "ln_qkv" else 1
    gate = case == "gate"
    wcols = 2 * co if gate else co
    x = rng.randn(2, m, c).astype(np.float32)
    ws = [(rng.randn(c, wcols) / 4).astype(np.float32) for _ in range(n_w)]
    bs = [(rng.randn(wcols) * 0.1).astype(np.float32) for _ in range(n_w)]
    ln = None if case == "residual" else (
        (1 + 0.1 * rng.randn(c)).astype(np.float32),
        (0.1 * rng.randn(c)).astype(np.float32))
    res = rng.randn(2, m, co).astype(np.float32) if case == "residual" \
        else None
    cts = [rng.randn(2, m, co).astype(np.float32)
           for _ in range(1 if gate else n_w)]

    def jf(x_, ws_, bs_, ln_, res_):
        outs = jfm._ref(x_, tuple(ws_), tuple(bs_), ln_, res_, gate, gate,
                        1e-5)
        return sum(jnp.sum(o * t) for o, t in zip(outs, cts))

    want = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs],
        None if ln is None else tuple(map(jnp.asarray, ln)),
        None if res is None else jnp.asarray(res))
    lins = []
    for w, b in zip(ws, bs):
        lin = TL.Linear(c, wcols)
        lin.load_state_dict({"weight": torch.from_numpy(w.T.copy()),
                             "bias": torch.from_numpy(b)})
        lins.append(lin)
    norm = None
    if ln is not None:
        norm = TL.LayerNorm(c)
        norm.load_state_dict({"weight": torch.from_numpy(ln[0]),
                              "bias": torch.from_numpy(ln[1])})
    tx = _t(x, True)
    tres = None if res is None else _t(res, True)
    outs = TL.fused_linears(lins, tx, norm, kernels=True, residual=tres,
                            gate=gate)
    sum((o * _t(t)).sum() for o, t in zip(outs, cts)).backward()
    _close(tx.grad, want[0])
    for lin, gw, gb in zip(lins, want[1], want[2]):
        _close(lin.weight.grad.t(), gw)
        _close(lin.bias.grad, gb)
    if norm is not None:
        _close(norm.weight.grad, want[3][0])
        _close(norm.bias.grad, want[3][1])
    if tres is not None:
        _close(tres.grad, want[4])


# ---------------------------------------------------------------------------
# the paired step at MICRO configs
# ---------------------------------------------------------------------------

RES = 32  # the MICRO VAE and UNet have two levels: one downsample each


def _batch(b=1, seed=0):
    rng = np.random.RandomState(seed)
    return {"conditioning_pixel_values":
            rng.rand(b, RES, RES, 3).astype(np.float32),
            "output_pixel_values":
            (rng.rand(b, RES, RES, 3) * 2 - 1).astype(np.float32),
            "input_ids": rng.randint(0, 999, (b, 77)).astype(np.int32)}


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _sd(module, prefix=""):
    return {prefix + k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _jax_from_port(p):
    """The JAX package's trees for the port's seeded models (the JAX
    package's own converters; initialising the JAX models on this CPU
    would take longer than the whole test)."""
    from img2img_turbo_tpu.weights import torch_import as ti
    clip_sd = _sd(p["clip"])
    backbone_sd = {**{k: v for k, v in clip_sd.items()
                      if not k.startswith(("vision_model.",
                                           "visual_projection"))},
                   **_sd(p["backbone"])}
    vgg = _sd(p["lpips"])
    conv_idx = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
    vgg_sd = {f"features.{idx}.{leaf}": vgg[f"blocks.{i}.{j}.{leaf}"]
              for i, idxs in enumerate(conv_idx)
              for j, idx in enumerate(idxs) for leaf in ("weight", "bias")}
    lin_sd = {f"lin{i}.model.1.weight": vgg[f"lins.{i}.weight"]
              for i in range(5)}

    def lora(t):
        return {"rank": t["rank"], "alpha": t["alpha"],
                "modules": {n: {"a": jnp.asarray(e["a"].numpy()),
                                "b": jnp.asarray(e["b"].numpy())}
                            for n, e in t["modules"].items()}}

    heads = {k: v.numpy() for k, v in p["heads"].items()}
    hwio = (2, 3, 1, 0)
    jheads = {"spatial": [{c: {"kernel": jnp.asarray(heads[
        f"spatial.{i}.{c}.weight"].transpose(hwio)), "bias": jnp.asarray(
            heads[f"spatial.{i}.{c}.bias"])} for c in ("conv1", "conv2")}
        for i in range(2)],
        "final": {c: {"kernel": jnp.asarray(heads[f"final.{c}.weight"].T),
                      "bias": jnp.asarray(heads[f"final.{c}.bias"])}
                  for c in ("lin1", "lin2")}}
    sn = {k: jnp.asarray(v.numpy()) for k, v in p["sn"].items()}
    jsn = {"spatial": [{c: sn[f"spatial.{i}.{c}"] for c in ("conv1",
                                                            "conv2")}
                       for i in range(2)],
           "final": {c: sn[f"final.{c}"] for c in ("lin1", "lin2")}}
    # the converter's skip-conv list assumes SD-Turbo's four levels
    vae_sd = _sd(p["vae"])
    vae = ti.convert_vae_state_dict(vae_sd, jcfg.MICRO_VAE,
                                    with_skip_convs=False)
    vae["decoder"]["skip_convs"] = [
        {"kernel": jnp.asarray(vae_sd[f"decoder.skip_conv_{i + 1}.weight"]
                               .transpose(hwio))}
        for i in range(jcfg.MICRO_VAE.num_levels)]
    return {
        "unet": ti.convert_unet_state_dict(_sd(p["unet"]), jcfg.MICRO_UNET),
        "vae": vae,
        "text": ti.convert_clip_text_state_dict(
            _sd(p["text"], "text_model."), jcfg.TINY_TEXT),
        "clip": jclip_vit.convert_clip_state_dict(clip_sd,
                                                  jclip_vit.TINY_CLIP_VIT),
        "backbone": jclip_vit.convert_clip_state_dict(
            backbone_sd, jclip_vit.TINY_CLIP_VIT)["vision"],
        "lpips": jvgg.convert_lpips_state_dict(vgg_sd, lin_sd),
        "unet_lora": lora(p["unet_lora"]), "vae_lora": lora(p["vae_lora"]),
        "heads": jheads, "sn": jsn}


@pytest.fixture(scope="module")
def paired_setup():
    g = torch.Generator().manual_seed(0)
    cfgs = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)
    clip_cfg = tclip_vit.TINY_CLIP_VIT
    unet, vae, text, _ = trunner.load_base_models(cfgs, g)
    lpips, backbone, clip, heads, sn = trunner.init_aux_models(clip_cfg, g)
    unet_lora, vae_lora = trunner.init_loras(unet, vae, g)
    # B = 0 at init would leave pass 1 blind to A's gradients; give B
    # values so the test sees every factor's gradient
    for lo in (unet_lora, vae_lora):
        for e in lo["modules"].values():
            e["b"] = torch.randn(e["b"].shape, generator=g) * 0.05
    p = dict(unet=unet, vae=vae, text=text, lpips=lpips, backbone=backbone,
             clip=clip, heads=heads, sn=sn, unet_lora=unet_lora,
             vae_lora=vae_lora)
    j = _jax_from_port(p)

    jcfgs = jp2p.GeneratorConfigs(jcfg.MICRO_UNET, jcfg.MICRO_VAE,
                                  jcfg.TINY_TEXT)
    jclip = jclip_vit.TINY_CLIP_VIT
    gen, frozen, meta = jpaired.split_trainable(j["unet"], j["vae"],
                                                j["unet_lora"], j["vae_lora"])
    aux = {"text": j["text"], "lpips": j["lpips"], "clip": j["clip"],
           "disc_backbone": j["backbone"]}
    loss_cfg = jlosses.PairedLossConfig()
    sched = joptim.make_lr_schedule("constant", 5e-4, 0, 100)
    tx = joptim.make_adamw(sched, max_grad_norm=1.0)
    state = {"gen": gen, "gen_opt": tx.init(gen), "disc": j["heads"],
             "disc_sn": j["sn"], "disc_opt": tx.init(j["heads"]),
             "step": jnp.zeros((), jnp.int32)}
    step = jpaired.make_paired_train_step(jcfgs, jclip, loss_cfg, meta, tx,
                                          tx, remat=False)
    alphas = jp2p.scheduler.make_alphas_cumprod()
    batch = _batch()
    key = jax.random.PRNGKey(7)
    r1, r2 = jax.random.split(key)

    def step_and_grads(state, batch):
        # pass-1 gradients as the step's recon_loss takes them
        caption = jclip_text.clip_text_forward(aux["text"], jcfgs.text,
                                               batch["input_ids"])

        def recon(g_):
            params = jpaired.build_gen_params(g_, frozen, meta)
            pred = jp2p.generate_deterministic(
                params, jcfgs, alphas, batch["conditioning_pixel_values"],
                caption, r1)
            x_tgt = batch["output_pixel_values"]
            return (loss_cfg.lambda_l2 * jlosses.l2_loss(pred, x_tgt)
                    + loss_cfg.lambda_lpips * jlosses.lpips_loss(
                        aux["lpips"], pred, x_tgt)
                    + loss_cfg.lambda_clipsim * jlosses.clipsim_loss(
                        aux["clip"], jclip, pred, batch["input_ids"]))

        new_state, metrics = step(state, frozen, aux, batch, key)
        return new_state, metrics, jax.grad(recon)(state["gen"])

    lat = (1, RES // 2, RES // 2, 4)
    noise = tuple(np.asarray(jax.random.normal(r, lat, jnp.float32))
                  for r in (r1, r2))
    sched_t = toptim.make_lr_schedule("constant", 5e-4, 0, 100)
    gen_t, meta_t = tpaired.split_trainable(unet, vae, unet_lora, vae_lora)
    text.requires_grad_(False)
    init = ({k: v.detach().clone() for k, v in gen_t.items()}, heads,
            dict(sn))
    port_state = tpaired.make_state(gen_t, heads, sn, sched_t, sched_t)
    models = tpaired.PairedModels(unet, vae, text, lpips, backbone, clip)
    # the two-rank steps start now, beside the JAX step's compile, and
    # their tests collect them (dp_port_step, tp_port_step). They take
    # copies: torch moves a tensor it sends to the ranks into shared
    # memory, under the numpy views the JAX trees were made from, and
    # port_step updates the trainables in place
    ranks = torch_dp.shared(2)
    given = copy.deepcopy((models, cfgs, meta_t, init,
                           *_rank_inputs(batch, noise)))
    tickets = {"dp": ranks.submit(torch_dp.given_step, *given),
               "tp": ranks.submit(torch_dp.given_step, *given, "paired",
                                  True)}
    new_state, metrics, grads1 = jax.jit(step_and_grads)(
        state, jax.tree_util.tree_map(jnp.asarray, batch))
    return dict(init=init, tickets=tickets,
                gen0=from_jax.gen_trainables(_np_tree(gen)),
                gen1=from_jax.gen_trainables(_np_tree(new_state["gen"])),
                grads1=from_jax.gen_trainables(_np_tree(grads1)),
                disc1=from_jax.disc_heads(_np_tree(new_state["disc"]),
                                          _np_tree(new_state["disc_sn"])),
                metrics={k: float(v) for k, v in metrics.items()},
                batch=batch, noise=noise, cfgs=cfgs, models=models,
                state=port_state, meta=meta_t)


@pytest.fixture(scope="module")
def port_step(paired_setup):
    s = paired_setup
    step = tpaired.make_paired_train_step(
        s["models"], s["cfgs"], tlosses.PairedLossConfig(), s["meta"],
        kernels=True, remat=True, dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    batch["input_ids"] = batch["input_ids"].long()
    noise = tuple(torch.from_numpy(n) for n in s["noise"])
    state = s["state"]
    gen0 = {k: v.detach().clone() for k, v in state.gen.items()}
    with profiling.recording() as rec:
        metrics, grads1 = step(state, batch, noise, keep_grads=True)
    return dict(state=state, metrics=metrics, grads1=grads1, gen0=gen0,
                spans=rec)


def _assert_losses(paired_setup, metrics):
    want = paired_setup["metrics"]
    got = {k: float(v) for k, v in metrics.items()}
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-3), \
            (k, got[k], want[k])


def _assert_grads(paired_setup, got):
    want = paired_setup["grads1"]
    assert set(got) == set(want)
    errs = {k: _rel_l2(_np(got[k]), want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MODEL_TOL, (worst, errs[worst])


def _assert_trainables(paired_setup, gen0, gen, disc, disc_sn):
    want0, want1 = paired_setup["gen0"], paired_setup["gen1"]
    g1 = paired_setup["grads1"]
    for k in want1:
        np.testing.assert_array_equal(_np(gen0[k]), want0[k])
        d_want = want1[k] - want0[k]
        d_got = _np(gen[k]) - _np(gen0[k])
        diff = np.abs(d_got - d_want)
        assert diff.max() <= 5e-4, (k, diff.max())
        strong = np.abs(g1[k]) >= 1e-2 * np.abs(g1[k]).max()
        err = _rel_l2(d_got[strong], d_want[strong])
        assert err <= 1e-4, (k, err, strong.mean())
    heads, sn = paired_setup["disc1"]
    for k, v in heads.items():
        _close(disc[k], v, tol=1e-5)
    for k, v in sn.items():
        _close(disc_sn[k], v, tol=1e-5)


def test_paired_step_losses_match_jax(paired_setup, port_step):
    """All four passes' losses within 1e-4 relative (fp32, same weights,
    same posterior noise)."""
    _assert_losses(paired_setup, port_step["metrics"])


def test_paired_step_pass1_gradients_match_jax(paired_setup, port_step):
    """Every trainable's pass-1 gradient within relative L2 2e-4 of
    jax.grad of the step's recon loss."""
    _assert_grads(paired_setup, port_step["grads1"])


def test_paired_step_trainables_match_jax(paired_setup, port_step):
    """After the step (two AdamW updates of the generator, lr 5e-4): each
    trainable's change within relative L2 1e-4 of the JAX step's, on the
    elements whose pass-1 gradient is at least 1e-2 of the tensor's
    largest (where Adam's near-sign step does not amplify the gradients'
    last-digit noise: with a 1e-3 cut the error reads 6.6e-5 to 1.2e-4
    as the CPU thread count changes the sums' order, with 1e-2 at most
    4.4e-5); every element within one update, 5e-4, of the JAX value. The
    discriminator heads and spectral-norm vectors within 1e-5."""
    state = port_step["state"]
    _assert_trainables(paired_setup, port_step["gen0"], state.gen,
                       state.disc, state.disc_sn)


def test_paired_step_records_its_passes(port_step):
    """The step's spans: the caption encode, then the four passes in order
    with the spectral-norm steps; a LoRA merge in each generator pass, an
    optimizer update in every pass, and each pass's backward under it,
    with the generator's stages under the forward."""
    rec = port_step["spans"]
    by = {s.seq: s for s in rec.spans}

    def pass_of(s):
        while by[s.parent].name != "i2i.train.step":
            s = by[s.parent]
        return s.name

    root = [s for s in by.values() if s.name == "i2i.train.step"]
    assert len(root) == 1 and root[0].parent is None
    top = [s.name for s in sorted(by.values(), key=lambda s: s.seq)
           if s.parent == root[0].seq]
    passes = ["i2i.train.gen_pass1", "i2i.train.gen_pass2",
              "i2i.train.disc_real", "i2i.train.disc_fake"]
    assert top == ["i2i.train.text", passes[0], passes[1],
                   "i2i.train.sn_step", passes[2], passes[3]]
    table = rec.table("i2i.train.step")
    n = {k: v["count"] for k, v in table["spans"].items()}
    assert n["i2i.train.lora_merge"] == 2 and n["i2i.train.optim"] == 4
    assert n["i2i.train.sn_step"] == 3 and n["i2i.gen.unet"] == 2
    for name, want in (("i2i.train.backward", passes),
                       ("i2i.train.optim", passes),
                       ("i2i.train.lora_merge", passes[:2])):
        assert [pass_of(s) for s in sorted(by.values(),
                                           key=lambda s: s.seq)
                if s.name == name] == want, name
    assert {by[s.parent].name for s in by.values()
            if s.name.startswith("i2i.gen.")} == {"i2i.train.forward"}
    counters = table["counters"]
    assert counters["lora_merged_weights"] > 0
    assert counters["weight_packs"] > 0 and counters["plain_recomputes"] > 0


# ---------------------------------------------------------------------------
# the step data-parallel over two gloo ranks, and under a model axis of two,
# against the JAX step
# ---------------------------------------------------------------------------


def _rank_inputs(batch, noise):
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    batch["input_ids"] = batch["input_ids"].long()
    return batch, tuple(torch.from_numpy(n) for n in noise)


@pytest.fixture(scope="module")
def dp_port_step(paired_setup):
    """The port's paired step under two gloo ranks (`torch_dp.shared`, one
    intra-op thread each), tiled: both ranks take paired_setup's row and
    noise (started by paired_setup). JAX's
    TestShardMapDP::test_exact_vs_single_device pins its own tiled DP step
    to the single step these tests hold the port to."""
    s = paired_setup
    out = torch_dp.shared(2).collect(s["tickets"]["dp"])
    return dict(out=out, gen0=s["init"][0])


@pytest.fixture(scope="module")
def tp_port_step(paired_setup):
    """The port's paired step on a (1, 2) mesh of the two ranks: the UNet
    and the VAE sharded over the model axis (`runner.shard_for_training`),
    both ranks
    paired_setup's row and noise, the UNet blocks recomputed (remat), so
    the recompute's collectives run in the backward."""
    s = paired_setup
    out = torch_dp.shared(2).collect(s["tickets"]["tp"])
    return dict(out=out, gen0=s["init"][0])


@pytest.mark.parametrize("check", ["losses", "pass1_gradients",
                                   "trainables"])
def test_paired_dp_step_tiled_matches_jax(paired_setup, dp_port_step,
                                          check):
    """On both ranks, at the tolerances of test_paired_step_*_match_jax."""
    for res in dp_port_step["out"]:
        if check == "losses":
            _assert_losses(paired_setup, res["metrics"])
        elif check == "pass1_gradients":
            _assert_grads(paired_setup, res["grads"])
        else:
            _assert_trainables(paired_setup, dp_port_step["gen0"],
                               res["gen"], res["disc"], res["disc_sn"])


@pytest.mark.parametrize("check", ["losses", "pass1_gradients",
                                   "trainables", "replicated"])
def test_paired_tp_step_matches_jax(paired_setup, tp_port_step, check):
    """Under the model axis, on both ranks, at the tolerances of
    test_paired_step_*_match_jax; "replicated": every trainable, head,
    spectral-norm vector and AdamW moment bit-identical on the two model
    ranks, each rank holding only its shards of the UNet and of the VAE
    (below 0.6 of each whole's parameters)."""
    out = tp_port_step["out"]
    for res in out:
        if check == "losses":
            _assert_losses(paired_setup, res["metrics"])
        elif check == "pass1_gradients":
            _assert_grads(paired_setup, res["grads"])
        elif check == "trainables":
            _assert_trainables(paired_setup, tp_port_step["gen0"],
                               res["gen"], res["disc"], res["disc_sn"])
        else:
            assert res["differ"] == []
            models = paired_setup["models"]
            for name in ("unet", "vae"):
                whole = sum(p.numel() for p in
                            getattr(models, name).parameters())
                assert res["numel"][name] < 0.6 * whole, name
    if check == "replicated":
        a, b = out[0]["state"], out[1]["state"]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the launch table of a full-topology step
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_launch_table_matches_call_sites(monkeypatch):
    """chip_smoke.py's per-step launch counts, checked by counting the
    kernel wrappers' calls in one paired step at the TINY configs (the
    SD-Turbo topology: 4 levels, 2 layers per block), UNet per-block
    recompute included."""
    smoke = _chip_smoke()
    calls = collections.Counter()

    def spy(mod, fn, key):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)

    spy(fused_conv, "fused_gn_silu_conv3x3", "fused_gn_silu_conv3x3")
    # K8's du is the conv engine's du mode, counted as K1
    spy(fused_conv, "conv3x3_input_grad", "fused_gn_silu_conv3x3")
    spy(fused_conv, "upsample2x_conv3x3", "upsample2x_conv3x3")
    spy(fused_conv, "downsample2x_conv3x3", "downsample2x_conv3x3")
    spy(fused_matmul, "fused", "fused_matmul")
    spy(tattn, "flash_attention_folded", "flash_attention_folded")
    spy(tattn, "flash_attention_folded_bwd", "flash_attention_folded_bwd")
    spy(groupnorm, "partial_stats", "group_norm_stats")
    spy(groupnorm, "combine_stats", "group_norm_combine")
    g = torch.Generator().manual_seed(1)
    cfgs = GeneratorConfigs(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_TEXT)
    models, state, meta = trunner.build_paired_run(
        cfgs, tclip_vit.TINY_CLIP_VIT, device="cpu")
    step = tpaired.make_paired_train_step(
        models, cfgs, tlosses.PairedLossConfig(), meta, kernels=True,
        remat=True, dtype=torch.float32)
    h = w = 64
    batch = {"conditioning_pixel_values": torch.rand(1, h, w, 3,
                                                     generator=g),
             "output_pixel_values": torch.rand(1, h, w, 3, generator=g),
             "input_ids": torch.randint(0, 999, (1, 77), generator=g)}
    noise = tuple(tpaired.draw_noise(g, 1, h, w, cfgs, torch.float32)
                  for _ in range(2))
    step(state, batch, noise)
    assert dict(calls) == smoke.EXPECTED_TRAIN_LAUNCHES
    calls.clear()
    plain = tpaired.make_paired_train_step(
        models, cfgs, tlosses.PairedLossConfig(), meta, kernels=False,
        remat=True, dtype=torch.float32)
    plain(state, batch, noise)
    assert not calls  # the plain path reaches no kernel wrapper


def test_trainer_refuses_to_pick_the_cpu_by_itself(monkeypatch):
    """With no device given the run is built on the card; with no card it
    raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfgs = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)
    with pytest.raises(RuntimeError, match="device"):
        trunner.build_paired_run(cfgs, tclip_vit.TINY_CLIP_VIT)
