"""Parity of the PyTorch port's ops (img2img_turbo_tpu_torch.ops, scheduler)
with the JAX package, on the CPU.

Each kernel module's CPU path (its plain PyTorch version) is held against
the JAX function as the JAX tests run it: the Pallas kernels in interpret
mode under `pltpu.force_tpu_interpret_mode()`, attention also against the
XLA reference `_mha_xla`. Inputs come from seeded numpy. Tolerances: 1e-4
abs/rel in fp32 for kernel outputs, 2e-5 for GroupNorm coefficients,
bit-exact for canny and the uint8 conversions. The CUDA and Triton kernels
themselves run only on a GPU, where chip_smoke.py holds each against its
plain version.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from img2img_turbo_tpu import scheduler as jsched
from img2img_turbo_tpu.ops import attention as jattn
from img2img_turbo_tpu.ops import canny as jcanny
from img2img_turbo_tpu.ops import fused_conv as jfc
from img2img_turbo_tpu.ops import fused_matmul as jfm
from img2img_turbo_tpu.ops import groupnorm as jgn
from img2img_turbo_tpu.ops import image as jimage
from img2img_turbo_tpu_torch import scheduler as tsched
from img2img_turbo_tpu_torch.ops import _build
from img2img_turbo_tpu_torch.ops import attention as tattn
from img2img_turbo_tpu_torch.ops import canny as tcanny
from img2img_turbo_tpu_torch.ops import fused_conv as tfc
from img2img_turbo_tpu_torch.ops import fused_matmul as tfm
from img2img_turbo_tpu_torch.ops import groupnorm as tgn
from img2img_turbo_tpu_torch.ops import image as timage

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4      # fp32 kernel outputs, abs and rel
GN_TOL = 2e-5   # folded GroupNorm coefficients


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def synth_u8(h, w, seed, c=3):
    """Seeded uint8 image with real edges: filled rectangles on noise."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 40, (1, h, w, c)).astype(np.int32)
    for _ in range(6):
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        img[0, y0:y0 + rng.randint(3, h // 2), x0:x0 + rng.randint(3, w // 2)] \
            += rng.randint(60, 200, c)
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# scheduler and image conversions
# ---------------------------------------------------------------------------


class TestScheduler:
    def test_alphas_cumprod_matches_jax(self):
        # fp32 linspace and a 1000-term fp32 cumprod: the two frameworks
        # order the products differently (~1e-6 relative at the tail)
        np.testing.assert_allclose(tsched.make_alphas_cumprod().numpy(),
                                   np.asarray(jsched.make_alphas_cumprod()),
                                   rtol=3e-6, atol=0)

    def test_x0_step_matches_jax(self):
        rng = np.random.RandomState(0)
        eps, x = _rand(rng, 2, 8, 8, 4), _rand(rng, 2, 8, 8, 4)
        t = np.array([999, 500], np.int32)
        want = jsched.ddpm_x0_step(jnp.asarray(eps), jnp.asarray(x),
                                   jnp.asarray(t),
                                   jsched.make_alphas_cumprod())
        got = tsched.ddpm_x0_step(torch.from_numpy(eps), torch.from_numpy(x),
                                  torch.from_numpy(t).long(),
                                  tsched.make_alphas_cumprod())
        _close(got, want, 1e-6)
        assert tsched.ONE_STEP_T == jsched.ONE_STEP_T == 999


class TestImageOps:
    def test_uint8_conversions_exact(self):
        u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
        np.testing.assert_array_equal(
            timage.uint8_to_unit(torch.from_numpy(u8)).numpy(),
            np.asarray(jimage.uint8_to_unit(jnp.asarray(u8))))
        np.testing.assert_array_equal(
            timage.uint8_to_signed(torch.from_numpy(u8)).numpy(),
            np.asarray(jimage.uint8_to_signed(jnp.asarray(u8))))

    def test_signed_to_uint8_rounds_half_to_even(self):
        # values landing exactly on k + 0.5 exercise the tie rule
        y = (np.arange(0, 256, 0.5) / 255.0 * 2.0 - 1.0).astype(np.float32)
        x = np.concatenate([y, [-2.0, 2.0, np.float32(0.0)]]).astype(
            np.float32)
        np.testing.assert_array_equal(
            timage.signed_to_uint8(torch.from_numpy(x)).numpy(),
            np.asarray(jimage.signed_to_uint8(jnp.asarray(x))))


class TestCanny:
    @pytest.mark.parametrize("low,high", [(100.0, 200.0), (20.0, 60.0)])
    def test_bit_exact_with_jax(self, low, high):
        img = synth_u8(48, 64, seed=3)
        want = np.asarray(jcanny.canny(jnp.asarray(img), low, high))
        got = tcanny.canny(torch.from_numpy(img), low, high).numpy()
        assert want.any(), "the synthetic image must produce edges"
        np.testing.assert_array_equal(got, want)

    def test_3ch_unit_matches_jax(self):
        img = synth_u8(32, 40, seed=5)
        want = np.asarray(jcanny.canny_3ch_unit(jnp.asarray(img)))
        got = tcanny.canny_3ch_unit(torch.from_numpy(img)).numpy()
        assert got.shape == (1, 32, 40, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)

    def test_channel_ties_keep_lower_channel(self):
        # identical channels: every magnitude ties, so channel 0 must win,
        # which gives the single-channel result
        img = synth_u8(24, 24, seed=7, c=1)
        img3 = np.repeat(img, 3, axis=-1)
        np.testing.assert_array_equal(
            tcanny.canny(torch.from_numpy(img3)).numpy(),
            tcanny.canny(torch.from_numpy(img)).numpy())


# ---------------------------------------------------------------------------
# K5 GroupNorm stats + combine
# ---------------------------------------------------------------------------


class TestGroupNormStats:
    @pytest.mark.parametrize("shape,ng", [((2, 8, 16, 32), 8),
                                          ((1, 40, 20, 64), 32),
                                          ((2, 7, 9, 32), 4),
                                          ((2, 48, 16), 4)])
    def test_coeffs_match_jax_kernel(self, shape, ng):
        rng = np.random.RandomState(0)
        x = _rand(rng, *shape, scale=3.0) + 1.0
        c = shape[-1]
        scale = 1 + 0.2 * _rand(rng, c)
        bias = 0.2 * _rand(rng, c)
        with pltpu.force_tpu_interpret_mode():
            wa, wb = jgn.group_norm_coeffs(jnp.asarray(x), jnp.asarray(scale),
                                           jnp.asarray(bias), ng, 1e-6,
                                           interpret=True)
        ga, gb = tgn.group_norm_coeffs(torch.from_numpy(x),
                                       torch.from_numpy(scale),
                                       torch.from_numpy(bias), ng, 1e-6)
        _close(ga, wa, GN_TOL)
        _close(gb, wb, GN_TOL)

    def test_partials_cover_every_row_once(self):
        rng = np.random.RandomState(1)
        x = _rand(rng, 2, 23, 31, 16)   # 713 rows: a ragged last tile
        p = tgn.partial_stats(torch.from_numpy(x)).numpy()
        assert p.shape == (2, -(-713 // tgn.TILE_ROWS), 2, 16)
        np.testing.assert_allclose(p.sum(1)[:, 0], x.sum((1, 2)), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(p.sum(1)[:, 1], (x * x).sum((1, 2)),
                                   rtol=1e-5, atol=1e-4)

    def test_combine_stats_matches_jax(self):
        # (channels, groups): 32 in 8, and the UNet's widest concat, 2560
        # channels in 32 groups of 80
        rng = np.random.RandomState(2)
        for c, groups in ((32, 8), (2560, 32)):
            y = _rand(rng, 2, 8, 8, c, scale=2.0) + 0.5
            parts = np.stack([
                np.stack([y[:, :4].sum((1, 2)), (y[:, :4] ** 2).sum((1, 2))],
                         1),
                np.stack([y[:, 4:].sum((1, 2)), (y[:, 4:] ** 2).sum((1, 2))],
                         1),
            ], axis=1)
            scale, bias = 1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c)
            want = jfc.combine_stats(jnp.asarray(parts), jnp.asarray(scale),
                                     jnp.asarray(bias), groups, 1e-6, 64)
            got = tgn.combine_stats(torch.from_numpy(parts),
                                    torch.from_numpy(scale),
                                    torch.from_numpy(bias), groups, 1e-6, 64)
            for g, w in zip(got, want):
                _close(g, w, GN_TOL)


# ---------------------------------------------------------------------------
# K1 / K4 conv engine
# ---------------------------------------------------------------------------


def _gn_affine(x, ng, rng):
    """Folded GroupNorm affine (a, b) of x, (B, C) each, in numpy."""
    b, c = x.shape[0], x.shape[-1]
    scale, bias = 1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c)
    xg = x.reshape(b, -1, ng, c // ng).astype(np.float64)
    mean, var = xg.mean((1, 3)), xg.var((1, 3))
    a = (1 / np.sqrt(var + 1e-6))[..., None] * scale.reshape(ng, -1)
    bt = bias.reshape(ng, -1) - mean[..., None] * a
    return (a.reshape(b, c).astype(np.float32),
            bt.reshape(b, c).astype(np.float32))


def _combined(stats, co, count):
    one, zero = np.ones(co, np.float32), np.zeros(co, np.float32)
    return jfc.combine_stats(jnp.asarray(np.asarray(stats)),
                             jnp.asarray(one), jnp.asarray(zero),
                             8 if co % 8 == 0 else 1, 1e-6, count)


class TestConvEngine:
    @pytest.mark.parametrize("feat", ["plain", "norm", "eb", "res", "skip",
                                      "all", "ragged"])
    def test_k1_matches_jax_kernel(self, feat):
        rng = np.random.RandomState(["plain", "norm", "eb", "res", "skip",
                                     "all", "ragged"].index(feat))
        b, h, w, c, co, csk = 2, 8, 8, 16, 24, 40
        if feat == "ragged":
            h, w = 6, 10
        x = _rand(rng, b, h, w, c)
        wt = _rand(rng, 3, 3, c, co, scale=0.1)
        cb = _rand(rng, co, scale=0.1)
        a = bb = eb = res = skx = skw = None
        if feat != "plain":
            a, bb = _gn_affine(x, 8, rng)
        if feat in ("eb", "all", "ragged"):
            eb = _rand(rng, b, co)
        if feat in ("res", "all", "ragged"):
            res = _rand(rng, b, h, w, co)
        if feat in ("skip", "all", "ragged"):
            skx, skw = _rand(rng, b, h, w, csk), _rand(rng, csk, co, scale=0.1)
        j = lambda t: None if t is None else jnp.asarray(t)  # noqa: E731
        t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
        with pltpu.force_tpu_interpret_mode():
            wy, ws = jfc.fused_gn_silu_conv3x3(
                j(x), j(wt), j(cb), a=j(a), b=j(bb), extra_bias=j(eb),
                residual=j(res), skip_x=j(skx), skip_w=j(skw),
                emit_stats=True, interpret=True)
        gy, gs = tfc.fused_gn_silu_conv3x3(
            t(x), t(wt), t(cb), t(a), t(bb), t(eb), t(res), t(skx), t(skw),
            emit_stats=True)
        _close(gy, wy)
        for g, w_ in zip(_combined(gs, co, h * w), _combined(ws, co, h * w)):
            _close(g, w_, GN_TOL)

    @pytest.mark.parametrize("skip,hw", [(False, (4, 4)), (True, (4, 6)),
                                         (True, (5, 3))])
    def test_k4_matches_jax_kernel(self, skip, hw):
        rng = np.random.RandomState(11)
        b, c, co, csk = 1, 128, 128, 16
        h, w = hw
        x = _rand(rng, b, h, w, c)
        wt = _rand(rng, 3, 3, c, co, scale=0.05)
        cb = _rand(rng, co, scale=0.1)
        skx = _rand(rng, b, 2 * h, 2 * w, csk) if skip else None
        skw = _rand(rng, csk, co, scale=0.1) if skip else None
        with pltpu.force_tpu_interpret_mode():
            wy, ws = jfc.upsample2x_conv3x3(
                jnp.asarray(x), jnp.asarray(wt), jnp.asarray(cb),
                skip_x=None if skx is None else jnp.asarray(skx),
                skip_w=None if skw is None else jnp.asarray(skw),
                emit_stats=True, interpret=True)
        gy, gs = tfc.upsample2x_conv3x3(
            torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(cb),
            None if skx is None else torch.from_numpy(skx),
            None if skw is None else torch.from_numpy(skw), emit_stats=True)
        _close(gy, wy)
        n = 4 * h * w
        for g, w_ in zip(_combined(gs, co, n), _combined(ws, co, n)):
            _close(g, w_, GN_TOL)

    def test_fold_upsample_weights_matches_jax(self):
        rng = np.random.RandomState(3)
        wt = _rand(rng, 3, 3, 8, 12)
        _close(tfc.fold_upsample_weights(torch.from_numpy(wt)),
               jfc._fold_upsample_weights(jnp.asarray(wt)), 1e-6)

    @pytest.mark.parametrize("shape", [(3, 3, 20, 12), (16, 8, 3),
                                       (2, 2, 2, 2, 8, 128)])
    def test_pack_weights_layout(self, shape):
        """pack_weights: (..., C, Co) -> (taps, C/8, Co8, 8) with
        packed[t, c // 8, n, c % 8] == w[t, c, n], zero padding."""
        w = torch.from_numpy(_rand(np.random.RandomState(5), *shape))
        c, co = shape[-2:]
        pk = tfc.pack_weights(w)
        taps = int(np.prod(shape[:-2]))
        assert pk.shape == (taps, -(-c // 8), -(-co // 8) * 8, 8)
        flat = w.reshape(taps, c, co)
        unpacked = pk.permute(0, 1, 3, 2).reshape(taps, -1, pk.shape[2])
        assert torch.equal(unpacked[:, :c, :co], flat)
        assert not unpacked[:, c:].any() and not unpacked[:, :, co:].any()

    @pytest.mark.parametrize("c,co,h,w", [
        pytest.param(16, 24, 6, 5, id="16-24"),
        pytest.param(3, 8, 6, 5, id="3-8"),
        pytest.param(12, 4, 6, 5, id="12-4"),
        pytest.param(8, 16, 19, 11, id="ragged-19x11"),
        pytest.param(16, 72, 6, 5, id="co72"),
        pytest.param(24, 3, 19, 11, id="co3-ragged")])
    def test_input_grad_matches_jax_pallas_du(self, c, co, h, w):
        """K8's du on the forward's packed buffer (the wrapper's CPU path,
        `conv3x3_input_grad_ref`, and `conv3x3_input_grad_plain`) against the
        du of JAX's pallas_bwd (layers.py:351-433: K1 in interpret mode on
        gy with the flipped, io-swapped weights and a zero bias) and against
        F.conv_transpose2d; C and Co of 3, 4 and 12 exercise the packed
        buffer's zero padding, and the du kernel's edges are crossed by H, W
        off its 16 x 8 pixel tile (19 x 11), a K (= Co) of 72 (past one
        64-channel step, not a multiple of it) and Co = 3 (gy rows not
        16-byte aligned)."""
        rng = np.random.RandomState(c * co + 1)
        b = 2
        gy = _rand(rng, b, h, w, co)
        wt = _rand(rng, 3, 3, c, co, scale=0.1)              # HWIO
        with pltpu.force_tpu_interpret_mode():
            want, _ = jfc.fused_gn_silu_conv3x3(
                jnp.asarray(gy), jnp.asarray(wt[::-1, ::-1].swapaxes(2, 3)),
                jnp.zeros((c,), jnp.float32), interpret=True)
        wp = tfc.pack_weights(torch.from_numpy(wt))
        tgy = torch.from_numpy(gy)
        got = tfc.conv3x3_input_grad(tgy, wp, c)
        assert got.shape == (b, h, w, c)
        _close(got, want)
        _close(tfc.conv3x3_input_grad_plain(tgy, wp, c), want)
        conv_t = torch.nn.functional.conv_transpose2d(
            tgy.permute(0, 3, 1, 2), torch.from_numpy(wt).permute(3, 2, 0, 1),
            padding=1).permute(0, 2, 3, 1)
        _close(got, conv_t)
        assert torch.equal(tfc.unpack_weights(wp, c, co),
                           torch.from_numpy(wt).reshape(9, c, co))

    def test_folded_phases_reproduce_upsample_conv(self):
        """The 4-phase algebra the CUDA kernel runs, on the CPU: output
        (2i+a, 2j+b) = sum_{p,q} x[i+a+p-1, j+b+q-1] @ wf[a,b,p,q]."""
        rng = np.random.RandomState(4)
        x = torch.from_numpy(_rand(rng, 1, 5, 6, 8))
        wt = torch.from_numpy(_rand(rng, 3, 3, 8, 4))
        wf = tfc.fold_upsample_weights(wt)
        want, _ = tfc.upsample2x_conv3x3_ref(x, wt, torch.zeros(4))
        xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
        got = torch.zeros(1, 10, 12, 4)
        for a in range(2):
            for b in range(2):
                acc = 0
                for p in range(2):
                    for q in range(2):
                        acc = acc + xp[:, a + p:a + p + 5, b + q:b + q + 6] \
                            @ wf[a, b, p, q]
                got[:, a::2, b::2] = acc
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# K3 LN-matmul engine
# ---------------------------------------------------------------------------


class TestFusedMatmul:
    @pytest.mark.parametrize("mode", ["plain", "ln_res", "qkv", "kv",
                                      "gate"])
    def test_matches_jax_kernel(self, mode):
        rng = np.random.RandomState(["plain", "ln_res", "qkv", "kv",
                                     "gate"].index(mode))
        m, c, co = 77, 64, 128
        x = _rand(rng, 1, m, c)
        n_w = {"qkv": 3, "kv": 2}.get(mode, 1)
        wc = 2 * co if mode == "gate" else co
        ws = [_rand(rng, c, wc, scale=0.1) for _ in range(n_w)]
        bs = [_rand(rng, wc, scale=0.1) for _ in range(n_w)]
        ln = ((1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c))
              if mode in ("ln_res", "qkv", "gate") else None)
        res = _rand(rng, 1, m, co) if mode == "ln_res" else None
        gate = mode == "gate"
        want = jfm.fused(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                         tuple(map(jnp.asarray, bs)),
                         ln=None if ln is None else tuple(map(jnp.asarray, ln)),
                         residual=None if res is None else jnp.asarray(res),
                         gate=gate, interpret=True)
        assert want is not None
        # the port's weights are nn.Linear's (Co, C): the JAX ones transposed
        got = tfm.fused(torch.from_numpy(x),
                        tuple(torch.from_numpy(w.T.copy()) for w in ws),
                        tuple(map(torch.from_numpy, bs)),
                        ln=None if ln is None else tuple(
                            map(torch.from_numpy, ln)),
                        residual=None if res is None else torch.from_numpy(res),
                        gate=gate)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            _close(g, w)

    def test_rejects_bad_arguments(self):
        x = torch.zeros(4, 8)
        w = torch.zeros(8, 8)
        with pytest.raises(ValueError):
            tfm.fused(x, (w, w), (torch.zeros(8),) * 2,
                      residual=torch.zeros(4, 8))
        with pytest.raises(ValueError):
            tfm.fused(x, (w, w), (torch.zeros(8),) * 2, gate=True)

    def test_rejects_the_jax_layout(self):
        """Weights are nn.Linear's (Co, C) on every device: a JAX-layout
        (C, Co) weight raises rather than computing something else."""
        x = torch.zeros(4, 16)
        w = torch.zeros(8, 16)                       # (Co, C)
        assert tfm.fused(x, (w,), (torch.zeros(8),))[0].shape == (4, 8)
        with pytest.raises(ValueError):
            tfm.fused(x, (w.t(),), (torch.zeros(8),))
        with pytest.raises(ValueError):              # gate: (2Co, C)
            tfm.fused(x, (torch.zeros(16, 16).t()[:, :8],),
                      (torch.zeros(16),), gate=True)


# ---------------------------------------------------------------------------
# K2 attention
# ---------------------------------------------------------------------------


class TestAttention:
    @pytest.mark.parametrize("sq,skv,heads,hd,lse", [
        pytest.param(128, 128, 2, 64, False, id="128-128-2"),
        pytest.param(200, 77, 2, 64, False, id="200-77-2"),
        pytest.param(64, 64, 1, 64, False, id="64-64-1"),
        # the VAE mid attention's head (one head of 512), ragged Sq and Skv
        pytest.param(72, 100, 1, 512, False, id="72-100-1-hd512"),
        # the VAE mid attention's logsumexp, which the train step's K7 reads
        pytest.param(72, 100, 1, 512, True, id="72-100-1-hd512-lse"),
        # the logsumexp K7 reads, at a ragged Sq and the text context's 77
        pytest.param(200, 77, 2, 64, True, id="200-77-2-lse")])
    def test_matches_jax_flash_and_xla(self, sq, skv, heads, hd, lse):
        rng = np.random.RandomState(sq + skv + hd)
        d = heads * hd
        q, k, v = (_rand(rng, 2, s, d) for s in (sq, skv, skv))
        want_xla = jattn._mha_xla(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), heads)
        with pltpu.force_tpu_interpret_mode():
            want_flash = jattn.flash_attention_folded(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                block_q=64, block_k=128, return_lse=lse)
        got = tattn.flash_attention_folded(torch.from_numpy(q),
                                           torch.from_numpy(k),
                                           torch.from_numpy(v), heads,
                                           return_lse=lse)
        if lse:
            (got, got_lse), (want_flash, want_lse) = got, want_flash
            assert got_lse.shape == (2, sq, heads)
            _close(got_lse, want_lse)
        _close(got, want_xla)
        _close(got, want_flash)


# ---------------------------------------------------------------------------
# The plain engine's compositions (`*_plain`)
# ---------------------------------------------------------------------------


class TestPlainCompositions:
    """What the plain engine runs op by op, and chip_smoke.py times against
    each kernel, agrees with the kernel's exact plain version (`*_ref`) in
    fp32. Weights go in as nn.Conv2d / nn.Linear hold them."""

    @pytest.mark.parametrize("feat", ["plain", "norm", "all"])
    def test_k1_plain_matches_ref(self, feat):
        rng = np.random.RandomState(20 + ["plain", "norm", "all"].index(feat))
        b, h, w, c, co, csk = 2, 6, 10, 16, 24, 8
        t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
            _rand(rng, *s, scale=scale))
        x, wt, cb = t(b, h, w, c), t(3, 3, c, co, scale=0.1), t(co)
        a = bb = eb = res = skx = skw = skb = None
        if feat != "plain":
            a, bb = map(torch.from_numpy, _gn_affine(x.numpy(), 8, rng))
        if feat == "all":
            eb, res = t(b, co), t(b, h, w, co)
            skx, skw, skb = t(b, h, w, csk), t(csk, co, scale=0.1), t(co)
        want, _ = tfc.conv3x3_ref(x, wt, cb if skb is None else cb + skb, a,
                                  bb, eb, res, skx, skw)
        got = tfc.gn_silu_conv3x3_plain(
            x, wt.permute(3, 2, 0, 1), cb, a, bb, eb, res, skx,
            None if skw is None else skw.t()[:, :, None, None], skb)
        _close(got, want)

    @pytest.mark.parametrize("skip", [False, True])
    def test_k4_plain_matches_ref(self, skip):
        rng = np.random.RandomState(30 + skip)
        x = torch.from_numpy(_rand(rng, 1, 5, 3, 16))
        wt = torch.from_numpy(_rand(rng, 3, 3, 16, 8, scale=0.1))
        cb = torch.from_numpy(_rand(rng, 8))
        skx = torch.from_numpy(_rand(rng, 1, 10, 6, 4)) if skip else None
        skw = torch.from_numpy(_rand(rng, 4, 8)) if skip else None
        want, _ = tfc.upsample2x_conv3x3_ref(x, wt, cb, skx, skw)
        got = tfc.upsample2x_conv3x3_plain(
            x, wt.permute(3, 2, 0, 1), cb, skx,
            None if skw is None else skw.t()[:, :, None, None])
        _close(got, want)

    @pytest.mark.parametrize("shape,ng", [((2, 7, 9, 32), 4),
                                          ((1, 48, 64), 32)])
    def test_gn_coeffs_plain_matches_float64(self, shape, ng):
        rng = np.random.RandomState(40)
        x = _rand(rng, *shape, scale=3.0) + 1.0
        c = shape[-1]
        scale, bias = 1 + 0.2 * _rand(rng, c), 0.2 * _rand(rng, c)
        xg = x.reshape(shape[0], -1, ng, c // ng).astype(np.float64)
        mean, var = xg.mean((1, 3)), xg.var((1, 3))
        wa = (1 / np.sqrt(var + 1e-6))[..., None] * scale.reshape(ng, -1)
        wb = bias.reshape(ng, -1) - mean[..., None] * wa
        ga, gb = tgn.group_norm_coeffs_plain(
            torch.from_numpy(x), torch.from_numpy(scale),
            torch.from_numpy(bias), ng, 1e-6)
        _close(ga, wa.reshape(shape[0], c), GN_TOL)
        _close(gb, wb.reshape(shape[0], c), GN_TOL)

    @pytest.mark.parametrize("mode", ["plain", "ln_res", "qkv", "gate"])
    def test_k3_plain_matches_ref(self, mode):
        rng = np.random.RandomState(50 + ["plain", "ln_res", "qkv",
                                          "gate"].index(mode))
        m, c, co = 33, 64, 48
        t = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
            _rand(rng, *s, scale=scale))
        n_w = 3 if mode == "qkv" else 1
        wc = 2 * co if mode == "gate" else co
        x = t(1, m, c)
        ws = tuple(t(wc, c, scale=0.1) for _ in range(n_w))   # (Co, C)
        bs = tuple(t(wc, scale=0.1) for _ in range(n_w))
        ln = ((1 + t(c, scale=0.1), t(c, scale=0.1))
              if mode != "plain" else None)
        res = t(1, m, co) if mode == "ln_res" else None
        gate = mode == "gate"
        want = tfm.fused_ref(x, ws, bs, ln=ln, residual=res, gate=gate)
        got = tfm.fused_plain(x, ws, bs, ln=ln, residual=res, gate=gate)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)


# ---------------------------------------------------------------------------
# Wrapper rules and build
# ---------------------------------------------------------------------------


class TestWrapperRules:
    """CPU tensors take the plain version; any other non-CUDA device is
    refused (no silent fallback), and no CPU call counts as a launch."""

    def test_other_devices_raise(self):
        meta = torch.device("meta")
        x = torch.empty(1, 4, 4, 8, device=meta)
        w = torch.empty(3, 3, 8, 8, device=meta)
        b = torch.empty(8, device=meta)
        with pytest.raises(ValueError):
            tfc.fused_gn_silu_conv3x3(x, w, b)
        with pytest.raises(ValueError):
            tfc.upsample2x_conv3x3(x, w, b)
        with pytest.raises(ValueError):
            tgn.partial_stats(x)
        with pytest.raises(ValueError):
            tgn.group_norm_coeffs(x, b, b, 2, 1e-5)
        with pytest.raises(ValueError):
            tgn.combine_stats(torch.empty(1, 1, 2, 8, device=meta), b, b, 2,
                              1e-5, 16)
        with pytest.raises(ValueError):
            tattn.flash_attention_folded(x[0], x[0], x[0], 1)
        with pytest.raises(ValueError):
            tfm.fused(x, (w[0, 0],), (b,))

    def test_input_grad_rejects_an_unpacked_weight(self):
        """K8's du takes only the forward's packed buffer: an nn.Conv2d
        (Co, C, 3, 3) weight or a buffer packed for other channel counts
        raises on every device."""
        gy = torch.randn(1, 4, 4, 8)
        w = torch.randn(8, 16, 3, 3)                         # (Co, C, 3, 3)
        with pytest.raises(ValueError):
            tfc.conv3x3_input_grad(gy, w, 16)
        with pytest.raises(ValueError):
            tfc.conv3x3_input_grad(gy, tfc.pack_weights(
                w.permute(2, 3, 1, 0)), 8)
        with pytest.raises(ValueError):
            tfc.conv3x3_input_grad(gy.to("meta"), tfc.pack_weights(
                w.permute(2, 3, 1, 0)).to("meta"), 16)

    def test_cpu_calls_are_not_launches(self):
        _build.reset_launch_counts()
        x = torch.randn(1, 4, 4, 8)
        tfc.fused_gn_silu_conv3x3(x, torch.randn(3, 3, 8, 8), torch.zeros(8))
        tgn.partial_stats(x)
        tgn.group_norm_coeffs(x, torch.ones(8), torch.zeros(8), 2, 1e-5)
        q = torch.randn(1, 8, 64).bfloat16()
        tattn.flash_attention_folded(q, q, q, 1)
        tattn.flash_attention_folded_bwd(q, q, q, q, q,
                                         torch.zeros(1, 8, 1), 1)
        tfm.fused(x, (torch.randn(16, 8),), (torch.zeros(16),))
        tfc.conv3x3_input_grad(x, tfc.pack_weights(torch.randn(3, 3, 16, 8)),
                               16)
        assert sum(_build.launch_counts.values()) == 0
        assert not _build.launch_shapes

    def test_library_name_tracks_headers(self, tmp_path, monkeypatch):
        """Editing any header of csrc/ changes every library's path, so a
        stale build is never loaded."""
        import shutil
        csrc = tmp_path / "csrc"
        shutil.copytree(_build.CSRC, csrc)
        monkeypatch.setattr(_build, "CSRC", csrc)
        headers = sorted(csrc.glob("*.cuh"))
        assert {h.name for h in headers} >= {"common.cuh", "hopper.cuh"}
        for header in headers:
            before = {n: _build._lib_path(n) for n in _build.SOURCES}
            header.write_text(header.read_text() + "\n// edited\n")
            after = {n: _build._lib_path(n) for n in _build.SOURCES}
            assert all(before[n] != after[n] for n in _build.SOURCES), header

    def test_library_name_tracks_source(self):
        p = _build._lib_path("conv")
        assert p.parent == _build.BUILD_DIR and p.suffix == ".so"
        assert p == _build._lib_path("conv")
        assert p != _build._lib_path("attention")
        for name in _build.SOURCES:
            assert (_build.CSRC / f"{name}.cu").exists()


# the modules of the port's data parallelism, tools, demos and parity and
# conversion CLIs, which both import tests must see imported
PORT_MODULES = [
    "img2img_turbo_tpu_torch.parallel.mesh",
    "img2img_turbo_tpu_torch.parallel.tensor",
    "img2img_turbo_tpu_torch.utils.profiling",
    "img2img_turbo_tpu_torch.serving.demo",
    "img2img_turbo_tpu_torch.serving.web_demo",
    "img2img_turbo_tpu_torch.cli.accept_parity",
    "img2img_turbo_tpu_torch.cli.convert_weights",
    "img2img_turbo_tpu_torch.weights.native",
]


def test_port_never_imports_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        f"NEW = {PORT_MODULES}\n"
        "import img2img_turbo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k.startswith('jaxlib') or "
        "k == 'img2img_turbo_tpu' or k.startswith('img2img_turbo_tpu.'))\n"
        "assert not bad, bad\n"
        "missing = [m for m in NEW if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25  # every module was imported


@pytest.mark.parametrize("name", [
    "SD_TURBO_UNET", "SD_TURBO_VAE", "SD_TURBO_TEXT", "TINY_UNET",
    "TINY_VAE", "TINY_TEXT", "MICRO_UNET", "MICRO_VAE"])
def test_port_configs_equal_jax_presets(name):
    """The port's own copy of each preset equals the JAX package's, field by
    field, derived properties included."""
    import dataclasses
    from img2img_turbo_tpu import configs as jcfg
    from img2img_turbo_tpu_torch import configs as tcfg
    want, got = getattr(jcfg, name), getattr(tcfg, name)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in ("time_embed_dim", "num_levels", "skip_conv_channels"):
        if hasattr(want, prop):
            assert getattr(got, prop) == getattr(want, prop)
