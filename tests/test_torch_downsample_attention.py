"""Parity of the port's K6 and K9 modules with the JAX package, on the CPU.

- K6 (`ops.fused_conv.downsample2x_conv3x3`): its exact plain version
  against the JAX entry point `layers.downsample2x_conv` (the strided XLA
  conv on the CPU) for both paddings at even and odd sizes, the plain
  engine's composition against it, its stats against the output's sums, and
  one small case against the Pallas kernel itself in interpret mode with
  its emitted stats;
- K9 (`ops.attention.default_attention`): against the JAX Pallas
  `flash_attention` under `pltpu.force_tpu_interpret_mode()` (as
  tests/test_ops.py runs it) and the XLA `scaled_dot_product_attention`,
  ragged Sq and masked Skv included, and its exact reference
  `flash_attention_ref` against the same XLA function.

Inputs come from seeded numpy, in fp32. Tolerances: 1e-4 abs/rel against
the XLA functions (one fp32 conv or softmax in two orders), the JAX test's
2e-3 against interpret mode, 1e-3 relative for stats against the output's
own sums. The CUDA kernels run only on a GPU, where chip_smoke.py holds each
against its plain version.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from img2img_turbo_tpu.models import layers as JL
from img2img_turbo_tpu.ops import attention as jattn
from img2img_turbo_tpu.ops import fused_conv as jfc
from img2img_turbo_tpu_torch.ops import _build
from img2img_turbo_tpu_torch.ops import attention as tattn
from img2img_turbo_tpu_torch.ops import fused_conv as tfc

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

TOL = 1e-4
INTERPRET_TOL = 2e-3
STATS_TOL = 1e-3


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _stats_match(stats, y):
    """Summed over tiles, (B, 2, C) equals the sum / sum of squares of y."""
    got = stats.sum(1).double()
    yf = y.double()
    want = torch.stack([yf.sum((1, 2)), (yf * yf).sum((1, 2))], dim=1)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= STATS_TOL, err


@pytest.mark.parametrize("hw", [(14, 106), (53, 27), (105, 70)])
@pytest.mark.parametrize("pad_lo", [0, 1])
def test_k6_matches_jax_downsample(hw, pad_lo):
    rng = np.random.RandomState(hw[0] + 7 * pad_lo)
    c, co = 8, 16
    x = _rand(rng, 2, *hw, c)
    w = _rand(rng, 3, 3, c, co, scale=0.2)
    b = _rand(rng, co)
    want, _ = JL.downsample2x_conv({"kernel": jnp.asarray(w),
                                    "bias": jnp.asarray(b)},
                                   jnp.asarray(x), pad_lo=pad_lo,
                                   emit_stats=True)
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got, stats = tfc.downsample2x_conv3x3(xt, wt, bt, pad_lo,
                                          emit_stats=True)
    assert got.shape == want.shape == (2, tfc.downsample_size(hw[0], pad_lo),
                                       tfc.downsample_size(hw[1], pad_lo), co)
    _close(got, want)
    _stats_match(stats, got)
    plain, _ = tfc.downsample2x_conv3x3_plain(xt, wt.permute(3, 2, 0, 1), bt,
                                              pad_lo)
    _close(plain, got)


def test_k6_matches_jax_kernel_in_interpret_mode():
    """One small forward case against the Pallas kernel, stats included
    (C = Co = 128 at 14x22, the JAX package's own test style)."""
    rng = np.random.RandomState(3)
    x = _rand(rng, 1, 14, 22, 128)
    w = _rand(rng, 3, 3, 128, 128, scale=0.05)
    b = _rand(rng, 128)
    with pltpu.force_tpu_interpret_mode():
        want, want_stats = jfc.downsample2x_conv3x3(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad_lo=0,
            emit_stats=True, interpret=True)
    got, stats = tfc.downsample2x_conv3x3(*map(torch.from_numpy, (x, w, b)),
                                          0, emit_stats=True)
    _close(got, want, INTERPRET_TOL)
    _close(stats.sum(1), np.asarray(want_stats).sum(1),
           INTERPRET_TOL * float(np.abs(np.asarray(want_stats)).max()))
    _stats_match(stats, got)


def test_k6_wrapper_rules():
    _build.reset_launch_counts()
    x = torch.randn(1, 6, 6, 8)
    w, b = torch.randn(3, 3, 8, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        tfc.downsample2x_conv3x3(x, w, b, 2)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        tfc.downsample2x_conv3x3(x.to(meta), w.to(meta), b.to(meta), 0)
    tfc.downsample2x_conv3x3(x, w, b, 1)
    assert sum(_build.launch_counts.values()) == 0  # CPU calls: no launch


@pytest.mark.parametrize("sq,skv", [(260, 256), (256, 77), (1089, 1089)])
def test_k9_matches_jax_flash_and_xla(sq, skv):
    rng = np.random.RandomState(sq + skv)
    q = _rand(rng, 1, 2, sq, 64)
    k, v = _rand(rng, 1, 2, skv, 64), _rand(rng, 1, 2, skv, 64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_xla = jattn.scaled_dot_product_attention(jq, jk, jv)
    with pltpu.force_tpu_interpret_mode():
        want_flash = jattn.flash_attention(jq, jk, jv)
    got = tattn.default_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (1, 2, sq, 64)
    _close(got, want_xla)
    _close(got, want_flash, INTERPRET_TOL)
    _close(tattn.flash_attention_ref(*map(torch.from_numpy, (q, k, v))),
           want_xla)


def test_k9_ref_rounds_once():
    """In bf16 the exact reference rounds only its output; the plain version
    also rounds P before the PV product."""
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 2, 40, 64)).bfloat16()
               for _ in range(3))
    exact = tattn.flash_attention_ref(q.float(), k.float(), v.float())
    assert torch.equal(tattn.flash_attention_ref(q, k, v),
                       exact.bfloat16())
    assert not torch.equal(tattn.scaled_dot_product_attention(q, k, v),
                           exact.bfloat16())


def test_k9_wrapper_rules():
    _build.reset_launch_counts()
    meta = torch.device("meta")
    t = torch.empty(1, 2, 8, 64, device=meta)
    with pytest.raises(ValueError):
        tattn.flash_attention(t, t, t)
    x = torch.randn(1, 2, 8, 32)     # the CPU plain version takes any d
    out = tattn.default_attention(x, x, x)
    assert out.shape == x.shape and sum(_build.launch_counts.values()) == 0
