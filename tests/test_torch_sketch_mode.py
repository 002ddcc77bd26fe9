"""The port's stochastic sketch path against the JAX package, on the CPU, in
fp32: the VAE encoder with K6's stats chained into the next GroupNorm, the
UNet with a TwinConv conv_in at r in {0.4, 1.0}, LoRA merged at a 0-d
tensor r, `generate_stochastic` with the same factored weights, noise map
and posterior noise, and `ServingEngine(mode="sketch", r=0.4)` uint8 ->
uint8 against the JAX engine (its noise recomputed from the JAX key).

Configs: MICRO_UNET (2 levels) with TINY_VAE (4 levels: the JAX sketch
engine draws its noise map at H/8), so that each JAX program compiles in
seconds. Weights are drawn by the port (`from_jax.random_params`) and
converted for JAX by the JAX package's own `torch_import`; the LoRA factors
come from seeded numpy, with random B. The JAX side runs its XLA path.
Tolerances: relative L2 <= 1e-4 for model and generator outputs (fp32 sums
in two orders; the kernel path's one-pass GroupNorm statistics differ from
the two-pass ones by ~1e-5), and for the engine at most 1 uint8 level on at
most 0.1% of the values.
"""

import collections
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from img2img_turbo_tpu import configs
from img2img_turbo_tpu import lora as jlora
from img2img_turbo_tpu.models import unet as junet
from img2img_turbo_tpu.models import vae as jvae
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.serving import engine as jengine
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tconfigs
from img2img_turbo_tpu_torch import lora as tlora
from img2img_turbo_tpu_torch import scheduler as tsched
from img2img_turbo_tpu_torch.models import layers as TL
from img2img_turbo_tpu_torch.models.unet import (UNet2DConditionModel,
                                                 make_twin_conv_in)
from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
from img2img_turbo_tpu_torch.ops import fused_conv, groupnorm
from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                       generate_stochastic)
from img2img_turbo_tpu_torch.serving import engine as tengine
from img2img_turbo_tpu_torch.weights import from_jax

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_L2 = 1e-4
MAX_LEVELS, MAX_FRACTION = 1, 1e-3
UCFG, VCFG = configs.MICRO_UNET, configs.TINY_VAE
JCFGS = jp2p.GeneratorConfigs(UCFG, VCFG)
CFGS = GeneratorConfigs(tconfigs.MICRO_UNET, tconfigs.TINY_VAE)
CTX = UCFG.cross_attention_dim


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def synth_image(h, w, seed):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synth_image(h, w, seed)


def lora_np(tree, model, targets, rank, seed, alpha=8.0, b_std=0.05):
    """A JAX-layout adapter over the modules `targets` match, from seeded
    numpy (A with std 1/rank as init_lora draws it, B random)."""
    rng = np.random.RandomState(seed)
    mods = {}
    for n, path in sorted(jlora.module_names(tree, model).items()):
        if jlora.matches_target(n, targets):
            kern = jlora._get(tree, path)["kernel"]
            mods[n] = {"a": (rng.randn(*kern.shape[:-1], rank) / rank).astype(
                np.float32), "b": (rng.randn(rank, kern.shape[-1])
                                   * b_std).astype(np.float32)}
    return {"rank": rank, "alpha": alpha, "modules": mods}


@pytest.fixture(scope="module")
def model():
    """A factored sketch model as JAX trees (TwinConv whose two convs
    differ, real skip zero-convs, pix2pix LoRA) and the port's copy."""
    g = torch.Generator().manual_seed(21)
    rng = np.random.RandomState(21)
    usd = {k: v.numpy() for k, v in from_jax.random_params(
        tconfigs.MICRO_UNET, g).items()}
    vsd = {k: v.numpy() for k, v in from_jax.random_params(
        tconfigs.TINY_VAE, g).items()}
    for k, v in vsd.items():
        if "skip_conv_" in k:
            vsd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    unet = _np_tree(ti.convert_unet_state_dict(usd, UCFG))
    vae = _np_tree(ti.convert_vae_state_dict(vsd, VCFG))
    cur = unet["conv_in"]
    unet["conv_in"] = {"pretrained": cur, "current": {
        k: (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
        for k, v in cur.items()}}
    lora = {"unet": lora_np(unet, "unet", jlora.PIX2PIX_UNET_TARGETS, 8, 1),
            "vae": lora_np(vae, "vae", jlora.PIX2PIX_VAE_TARGETS, 4, 2)}
    tunet = make_twin_conv_in(UNet2DConditionModel(tconfigs.MICRO_UNET))
    port = {"unet": from_jax.load(tunet, from_jax.unet_state_dict(unet)),
            "vae": from_jax.load(AutoencoderKL(tconfigs.TINY_VAE),
                                 from_jax.vae_state_dict(vae)),
            "lora": {k: from_jax.lora_tree(v) for k, v in lora.items()}}
    return {"unet": unet, "vae": vae}, lora, port


def _prepared(module):
    import copy
    return TL.prepare_kernels(copy.deepcopy(module).eval())


def test_twin_conv_weights_carry_across(model):
    jbase, _, port = model
    sd = port["unet"].state_dict()
    assert "conv_in.weight" not in sd
    for tag, sub in (("conv_in_pretrained", "pretrained"),
                     ("conv_in_curr", "current")):
        np.testing.assert_array_equal(
            sd[f"conv_in.{tag}.weight"].numpy(),
            jbase["unet"]["conv_in"][sub]["kernel"].transpose(3, 2, 0, 1))


def test_vae_encoder_chains_downsample_stats(model, monkeypatch):
    """With kernels, each of the encoder's three downsamples emits stats
    and the next GroupNorm reads them: only the mid block's second resnet
    takes K5 statistics of its own. Both paths match the JAX encoder."""
    jbase, _, port = model
    x = np.random.RandomState(0).uniform(-1, 1, (1, 40, 56, 3)).astype(
        np.float32)
    want, want_skips = jax.jit(lambda p, x: jvae.encoder_forward(
        p, VCFG, x))(jbase["vae"]["encoder"], jnp.asarray(x))
    vae = _prepared(port["vae"])
    calls = collections.Counter()
    stats_out = []
    for mod, fn in ((groupnorm, "partial_stats"),
                    (fused_conv, "downsample2x_conv3x3")):
        def wrapped(*a, _orig=getattr(mod, fn), _fn=fn, **k):
            calls[_fn] += 1
            out = _orig(*a, **k)
            if _fn == "downsample2x_conv3x3":
                stats_out.append(out[1])
            return out
        monkeypatch.setattr(mod, fn, wrapped)
    for kernels in (True, False):
        calls.clear()
        with torch.no_grad():
            got, skips = vae.encoder(torch.from_numpy(x), kernels=kernels)
        assert rel_l2(got, want) <= REL_L2, kernels
        for a, b in zip(skips, want_skips):
            assert rel_l2(a, b) <= REL_L2, kernels
        assert dict(calls) == ({"partial_stats": 1,
                                "downsample2x_conv3x3": 3} if kernels else {})
    assert len(stats_out) == 3 and all(s is not None for s in stats_out)


@pytest.mark.parametrize("r", [0.4, 1.0])
def test_unet_twin_conv_matches_jax(model, r):
    jbase, _, port = model
    rng = np.random.RandomState(5)
    x = rng.randn(1, 5, 7, 4).astype(np.float32)
    ctx = rng.randn(1, 77, CTX).astype(np.float32)
    t = np.array([999], np.int32)
    want = _jit_unet(jbase["unet"], jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(ctx), jnp.float32(r))
    unet = _prepared(port["unet"])
    for kernels in (True, False):
        with torch.no_grad():
            got = unet(torch.from_numpy(x), torch.from_numpy(t).long(),
                       torch.from_numpy(ctx), kernels=kernels,
                       r=torch.tensor(r))
        assert rel_l2(got, want) <= REL_L2, kernels
    with pytest.raises(ValueError, match="blend factor"):
        unet(torch.from_numpy(x), torch.from_numpy(t).long(),
             torch.from_numpy(ctx), kernels=True)


_jit_unet = jax.jit(lambda p, x, t, c, r: junet.unet_forward(p, UCFG, x, t, c,
                                                             r=r))


def test_merge_lora_at_tensor_r_matches_jax(model):
    jbase, jl, port = model
    r = 0.4
    want = jax.jit(lambda b, l, r: jlora.merge_lora(b, l, r, "vae"))(
        jbase["vae"], jl["vae"], jnp.float32(r))
    got = tlora.merge_lora(dict(port["vae"].named_parameters()),
                           port["lora"]["vae"], scale=torch.tensor(r))
    assert set(got) == {n + ".weight" for n in jl["vae"]["modules"]}
    sd = from_jax.vae_state_dict(_np_tree(want))
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), sd[k], rtol=1e-5,
                                   atol=1e-6)


_jit_sto = jax.jit(lambda b, l, x, c, key, r, nm: jp2p.generate_stochastic(
    b, l, JCFGS, jnp.asarray(jp2p.scheduler.make_alphas_cumprod()), x, c,
    key, r, nm))


def test_generate_stochastic_matches_jax(model):
    jbase, jl, port = model
    rng = np.random.RandomState(6)
    c_t = (rng.rand(1, 64, 64, 3) < 0.3).astype(np.float32)
    ctx = rng.randn(1, 77, CTX).astype(np.float32)
    noise_map = rng.randn(1, 8, 8, 4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    r = 0.4
    want = _jit_sto(jbase, jl, jnp.asarray(c_t), jnp.asarray(ctx), key,
                    jnp.float32(r), jnp.asarray(noise_map))
    # vae.encode draws the posterior noise as normal(key, mean.shape)
    noise = np.asarray(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    alphas = tsched.make_alphas_cumprod()
    w0 = port["unet"].conv_out.weight.detach().clone()
    for kernels in (True, False):
        with torch.no_grad():
            got = generate_stochastic(
                port["unet"], port["vae"], port["lora"], CFGS, alphas,
                torch.from_numpy(c_t), torch.from_numpy(ctx),
                torch.tensor(r), torch.from_numpy(noise_map),
                kernels=kernels, noise=torch.from_numpy(noise))
        assert rel_l2(got, want) <= REL_L2, kernels
    # the base weights are back in place after the call
    assert torch.equal(port["unet"].conv_out.weight, w0)


@pytest.fixture(scope="module")
def engines(model):
    jbase, jl, port = model
    jeng = jengine.ServingEngine(cfgs=JCFGS, mode="sketch", dtype=jnp.float32,
                                 donate_input=False, base=jbase, lora=jl)
    ours = {k: tengine.ServingEngine(
        cfgs=CFGS, mode="sketch", dtype=torch.float32, device="cpu",
        use_kernels=k, base={"unet": port["unet"], "vae": port["vae"]},
        lora=port["lora"]) for k in (True, False)}
    return jeng, ours


@pytest.mark.parametrize("kernels", [True, False])
def test_sketch_engine_matches_jax_on_uint8(engines, kernels):
    """r = 0.4; the JAX engine draws the noise map from the first half of
    its key and the posterior noise from the second."""
    jeng, ours = engines
    img = synth_image(64, 64, 9)
    ctx = np.random.RandomState(9).randn(1, 77, CTX).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(jeng(jnp.asarray(img), jnp.asarray(ctx), rng=key,
                           r=0.4))
    nkey, vkey = jax.random.split(key)
    noise_map, noise = (torch.from_numpy(np.array(jax.random.normal(
        k, (1, 8, 8, 4), jnp.float32))) for k in (nkey, vkey))
    got = ours[kernels](img, torch.from_numpy(ctx), noise=noise, r=0.4,
                        noise_map=noise_map).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_LEVELS, diff.max()
    assert (diff > 0).mean() <= MAX_FRACTION, (diff > 0).mean()
    assert want.std() > 0


def test_sketch_r1_ignores_the_noise_map(engines):
    eng = engines[1][True]
    img = synth_image(32, 32, 10)
    ctx = torch.from_numpy(np.random.RandomState(10).randn(1, 77, CTX).astype(
        np.float32))
    g = torch.Generator().manual_seed(0)
    noise, m1, m2 = (torch.randn(1, 4, 4, 4, generator=g) for _ in range(3))
    out = {(r, i): eng(img, ctx, noise=noise, r=r, noise_map=m)
           for r in (0.4, 1.0) for i, m in enumerate((m1, m2))}
    assert torch.equal(out[1.0, 0], out[1.0, 1])
    assert not torch.equal(out[0.4, 0], out[0.4, 1])
    assert not torch.equal(out[0.4, 0], out[1.0, 0])
    # drawn from the generator when not given: the seed decides
    a, b = (eng(img, ctx, torch.Generator().manual_seed(3)) for _ in "ab")
    assert torch.equal(a, b)


def test_sketch_mode_refuses_stale_layouts(model, engines):
    _, _, port = model
    eng = engines[1][True]
    assert not any(TL.has_kernel_layouts(m) for m in eng.unet.modules())
    with pytest.raises(ValueError):
        tengine.ServingEngine(cfgs=CFGS, mode="sketch", device="cpu")
    # the stochastic path merges per call: prepared layouts would be stale
    with pytest.raises(ValueError, match="kernel layouts"):
        generate_stochastic(_prepared(port["unet"]), port["vae"],
                            port["lora"], CFGS, eng.alphas,
                            torch.zeros(1, 64, 64, 3), torch.zeros(1, 77, CTX),
                            0.5, torch.zeros(1, 8, 8, 4))
