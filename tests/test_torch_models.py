"""Parity of the PyTorch port's models and weight converter with the JAX
package, on the CPU, in fp32, at configs.TINY_UNET / TINY_VAE widths.

The JAX side runs its default (XLA) path. The port runs both of its paths:
`kernels=False` (plain PyTorch, the counterpart of that XLA path) and
`kernels=True` (the kernel entry points with GroupNorm statistics chained
as on the accelerator; on the CPU each kernel wrapper computes its plain
version). Tolerance: relative L2 <= 1e-4 for every model output. The
one-pass statistics of the kernel path differ from the two-pass ones by
~1e-5 relative, inside that bound.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from img2img_turbo_tpu import configs
from img2img_turbo_tpu.models import layers as JL
from img2img_turbo_tpu.models import unet as junet
from img2img_turbo_tpu.models import vae as jvae
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tconfigs
from img2img_turbo_tpu_torch.models import layers as TL
from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
from img2img_turbo_tpu_torch.ops import fused_conv as tfc
from img2img_turbo_tpu_torch.weights import from_jax

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

REL_L2 = 1e-4
UCFG, VCFG = configs.TINY_UNET, configs.TINY_VAE
# the port's own copies of the same presets, for the port's modules
TUCFG, TVCFG = tconfigs.TINY_UNET, tconfigs.TINY_VAE


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    vae = _np_tree(jvae.init_vae(k2, VCFG))
    # give the zero-convs real weight so the skip paths count in the checks
    rng = np.random.RandomState(0)
    for conv in vae["decoder"]["skip_convs"]:
        conv["kernel"] = (rng.randn(*conv["kernel"].shape) * 0.1).astype(
            np.float32)
    return {"unet": _np_tree(junet.init_unet(k1, UCFG)), "vae": vae}


@pytest.fixture(scope="module")
def port(jax_params):
    unet = from_jax.load(UNet2DConditionModel(TUCFG),
                         from_jax.unet_state_dict(jax_params["unet"]))
    vae = from_jax.load(AutoencoderKL(TVCFG),
                        from_jax.vae_state_dict(jax_params["vae"]))
    TL.prepare_kernels(unet)
    TL.prepare_kernels(vae)
    return {"unet": unet.eval(), "vae": vae.eval()}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


class TestFromJax:
    @pytest.mark.parametrize("model", ["unet", "vae"])
    def test_matches_export_exactly(self, jax_params, model):
        conv = {"unet": (from_jax.unet_state_dict, ti.export_unet_state_dict),
                "vae": (from_jax.vae_state_dict, ti.export_vae_state_dict)}
        ours, theirs = conv[model]
        got, want = ours(jax_params[model]), theirs(jax_params[model])
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    @pytest.mark.parametrize("model", ["unet", "vae"])
    def test_loaded_module_holds_the_tree(self, jax_params, port, model):
        sd = (from_jax.unet_state_dict if model == "unet"
              else from_jax.vae_state_dict)(jax_params[model])
        msd = port[model].state_dict()
        assert sorted(msd) == sorted(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(msd[k].numpy(), v, err_msg=k)

    @pytest.mark.parametrize("cfg", [TUCFG, TVCFG])
    def test_random_params_follow_jax_init(self, cfg):
        g = torch.Generator().manual_seed(3)
        sd = from_jax.random_params(cfg, g)
        model = from_jax._build(cfg)
        assert sorted(sd) == sorted(model.state_dict())
        mods = dict(model.named_modules())
        for name, t in sd.items():
            mod_name, leaf = name.rsplit(".", 1)
            mod = mods[mod_name]
            if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
                assert torch.all(t == (1.0 if leaf == "weight" else 0.0))
            elif "skip_conv_" in mod_name:
                assert torch.all(t == 1e-5)
            else:
                bound = 1 / math.sqrt(math.prod(mod.weight.shape[1:]))
                assert t.abs().max() <= bound and t.std() > bound / 4, name
        again = from_jax.random_params(cfg, torch.Generator().manual_seed(3))
        assert all(torch.equal(sd[k], again[k]) for k in sd)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


class TestLayers:
    def test_timestep_embedding(self):
        t = np.array([999, 0, 417], np.int32)
        want = JL.timestep_embedding(jnp.asarray(t), 320)
        got = TL.timestep_embedding(torch.from_numpy(t), 320)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    @pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)),
                                         ((14, 9), (27, 18)),
                                         ((3, 4), (7, 9))])
    def test_upsample_nearest_to(self, src, dst):
        x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
        want = JL.upsample_nearest_to(jnp.asarray(x), dst)
        got = TL.upsample_nearest_to(torch.from_numpy(x), dst)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("stride,padding", [
        (1, "SAME"), (2, ((0, 1), (0, 1))), (2, ((1, 1), (1, 1)))])
    def test_conv2d_padding(self, stride, padding):
        rng = np.random.RandomState(1)
        x = rng.randn(1, 9, 10, 4).astype(np.float32)
        w = rng.randn(3, 3, 4, 6).astype(np.float32)
        b = rng.randn(6).astype(np.float32)
        want = JL.conv2d({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)},
                         jnp.asarray(x), stride=stride,
                         padding=padding if padding == "SAME" else
                         list(padding))
        conv = TL.Conv2d(4, 6, 3)
        from_jax.load(conv, {"weight": w.transpose(3, 2, 0, 1),
                             "bias": b})
        got = TL.conv2d(conv, torch.from_numpy(x), stride, padding)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def test_prepare_keeps_hwio_only_on_the_cpu(self):
        """The CUDA kernels read the packed weights alone; the HWIO copy
        serves only the plain versions the wrappers compute on the CPU."""
        conv, up = TL.Conv2d(8, 16, 3), TL.Upsample2xConv(8, 8, 3)
        skip = TL.Conv2d(8, 16, 1, bias=False)
        for m in (conv, up, skip):
            m.prepare()
        assert conv.kw.shape == (3, 3, 8, 16) and skip.kw.shape == (8, 16)
        assert conv.kwp.shape == (9, 1, 16, 8)
        assert up.kwp.shape == (16, 1, 8, 8)      # folded 4-phase 2x2 taps
        assert torch.equal(up.kwp, tfc.pack_weights(
            tfc.fold_upsample_weights(up.kw)))
        off_cpu = TL.Conv2d(8, 16, 3).to("meta")
        off_cpu.prepare()
        assert off_cpu.kw is None and off_cpu.kwp.shape == (9, 1, 16, 8)

    def test_group_norm_and_layer_norm(self):
        rng = np.random.RandomState(2)
        x = (rng.randn(2, 6, 5, 32) * 3 + 1).astype(np.float32)
        s, b = (1 + 0.1 * rng.randn(32)).astype(np.float32), \
            (0.1 * rng.randn(32)).astype(np.float32)
        want = JL._gn_xla(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 8,
                          1e-6)
        got = TL._gn_xla(torch.from_numpy(x), torch.from_numpy(s),
                         torch.from_numpy(b), 8, 1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        ln = TL.LayerNorm(32)
        from_jax.load(ln, {"weight": s, "bias": b})
        want = JL.layer_norm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                             jnp.asarray(x))
        np.testing.assert_allclose(
            TL.layer_norm(ln, torch.from_numpy(x)).detach().numpy(),
            np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def _image(h, w, seed):
    return np.random.RandomState(seed).uniform(
        -1, 1, (1, h, w, 3)).astype(np.float32)


_jit_encode = jax.jit(lambda p, x, k: jvae.encode(p, VCFG, x, k))
_jit_decode = jax.jit(lambda p, z, s: jvae.decode(p, VCFG, z, s, gamma=1.0))
_jit_unet = jax.jit(lambda p, x, t, c: junet.unet_forward(p, UCFG, x, t, c))


@pytest.mark.parametrize("hw", [(64, 64), (40, 56)])
def test_vae_encode_decode(jax_params, port, hw):
    """Encode (posterior noise recomputed from the same key) and decode with
    the skip zero-convs; 40x56 gives odd 5x7 latents."""
    x = _image(*hw, seed=hw[0])
    key = jax.random.PRNGKey(7)
    jp = jax_params["vae"]
    z_j, skips_j = _jit_encode(jp, jnp.asarray(x), key)
    noise = np.asarray(jax.random.normal(key, z_j.shape, z_j.dtype))
    img_j = _jit_decode(jp, z_j, skips_j)
    for kernels in (False, True):
        with torch.no_grad():
            z_t, skips_t = port["vae"].encode(
                torch.from_numpy(x), kernels=kernels,
                noise=torch.from_numpy(noise.copy()))
            img_t = port["vae"].decode(z_t, skips_t, kernels=kernels)
        assert rel_l2(z_t, z_j) <= REL_L2, kernels
        for a, b in zip(skips_t, skips_j):
            assert rel_l2(a, b) <= REL_L2, kernels
        assert img_t.shape == (1, *hw, 3)
        assert rel_l2(img_t, img_j) <= REL_L2, kernels


@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_unet_forward(jax_params, port, hw):
    rng = np.random.RandomState(sum(hw))
    x = rng.randn(1, *hw, 4).astype(np.float32)
    ctx = rng.randn(1, 77, UCFG.cross_attention_dim).astype(np.float32)
    t = np.array([999], np.int32)
    want = _jit_unet(jax_params["unet"], jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(ctx))
    for kernels in (False, True):
        with torch.no_grad():
            got = port["unet"](torch.from_numpy(x), torch.from_numpy(t).long(),
                               torch.from_numpy(ctx), kernels=kernels)
        assert got.shape == (1, *hw, 4)
        assert rel_l2(got, want) <= REL_L2, kernels
