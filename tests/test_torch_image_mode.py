"""The port's image mode and CycleGAN-Turbo against the JAX package, on the
CPU, in fp32: the UNet adapter trio partitioned as the JAX package does,
`lora.merge_multi`, `CycleGANTurbo` in both directions against
`forward_with_params`, `ServingEngine(mode="image")` uint8 -> uint8 against
the JAX engine, bucketing; and, on the port alone at the TINY configs
(SD-Turbo's topology), chip_smoke.py's launch tables of one image and one
sketch request and the random full-width models it serves.

Configs for the JAX comparisons: MICRO_UNET with TINY_VAE, so that each JAX
program compiles in seconds. Weights are drawn by the port
(`from_jax.random_params`) and converted for JAX by the JAX package's own
`torch_import`; LoRA factors come from seeded numpy with random B. The JAX
side runs its XLA path. Tolerances: relative L2 <= 1e-4 for generator
outputs, 1e-5 relative for merged weights (one fp32 product and add), and
for the engine at most 1 uint8 level on at most 0.1% of the values.
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
from img2img_turbo_tpu.pipelines import cyclegan as jcg
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.serving import engine as jengine
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tconfigs
from img2img_turbo_tpu_torch import lora as tlora
from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
from img2img_turbo_tpu_torch.ops import (attention, fused_conv, fused_matmul,
                                         groupnorm)
from img2img_turbo_tpu_torch.pipelines import cyclegan as tcg
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
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


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lora_np(tree, model, targets, rank, seed, alpha, b_std=0.05):
    """A JAX-layout adapter over the modules named in `targets`, from
    seeded numpy (A with std 1/rank as init_lora draws it, B random)."""
    rng = np.random.RandomState(seed)
    mods = {}
    for n, path in sorted(jlora.module_names(tree, model).items()):
        if jlora.matches_target(n, targets):
            kern = jlora._get(tree, path)["kernel"]
            mods[n] = {"a": (rng.randn(*kern.shape[:-1], rank) / rank).astype(
                np.float32), "b": (rng.randn(rank, kern.shape[-1])
                                   * b_std).astype(np.float32)}
    return {"rank": rank, "alpha": alpha, "modules": mods}


def _jax_partition(unet_tree, monkeypatch):
    """The JAX package's adapter trio's targets (its init_lora stubbed:
    only the partition and alpha are read)."""
    monkeypatch.setattr(jlora, "init_lora", lambda key, base, spec, model: {
        "targets": spec.target_modules, "alpha": spec.alpha})
    return jcg.cyclegan_unet_adapters(unet_tree, 4, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model():
    """A CycleGAN model as JAX trees: base weights, the rank-4 UNet trio
    partitioned as `cyclegan_unet_adapters` does and one adapter per VAE,
    merged dense by the JAX package; and the port's copy of the merged
    model."""
    g = torch.Generator().manual_seed(31)
    rng = np.random.RandomState(31)
    usd = {k: v.numpy() for k, v in from_jax.random_params(
        tconfigs.MICRO_UNET, g).items()}
    unet = _np_tree(ti.convert_unet_state_dict(usd, UCFG))
    vaes = {}
    for d in ("vae_a2b", "vae_b2a"):
        vsd = {k: v.numpy() for k, v in from_jax.random_params(
            tconfigs.TINY_VAE, g).items()}
        for k, v in vsd.items():
            if "skip_conv_" in k:
                vsd[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        vaes[d] = _np_tree(ti.convert_vae_state_dict(vsd, VCFG))
    port_unet = from_jax.load(UNet2DConditionModel(tconfigs.MICRO_UNET), usd)
    trio = tcg.cyclegan_unet_adapters(port_unet, 4, g)
    loras = {"unet": {a: lora_np(unet, "unet", tuple(l["modules"]), 4, 40 + i,
                                 alpha=4.0)
                      for i, (a, l) in enumerate(trio.items())}}
    for i, d in enumerate(("vae_a2b", "vae_b2a")):
        loras[d] = lora_np(vaes[d], "vae", jlora.CYCLEGAN_VAE_TARGETS, 4,
                           50 + i, alpha=8.0)
    merged = {"unet": _np_tree(jax.jit(
        lambda b, ls: jlora.merge_multi(b, ls, model="unet"))(
            unet, list(loras["unet"].values())))}
    merge_vae = jax.jit(lambda b, l: jlora.merge_lora(b, l, model="vae"))
    for d in ("vae_a2b", "vae_b2a"):
        merged[d] = _np_tree(merge_vae(vaes[d], loras[d]))
    port = {"unet": from_jax.load(UNet2DConditionModel(tconfigs.MICRO_UNET),
                                  from_jax.unet_state_dict(merged["unet"]))}
    for d in ("vae_a2b", "vae_b2a"):
        port[d] = from_jax.load(AutoencoderKL(tconfigs.TINY_VAE),
                                from_jax.vae_state_dict(merged[d]))
    return {"unet": unet, **vaes}, loras, merged, port, trio


def test_adapter_trio_partitions_as_jax(model, monkeypatch):
    base, _, _, _, trio = model
    want = _jax_partition(base["unet"], monkeypatch)
    assert list(trio) == list(want) == list(tcg.ADAPTERS)
    for a in trio:
        assert sorted(trio[a]["modules"]) == sorted(want[a]["targets"])
        assert trio[a]["alpha"] == want[a]["alpha"] == 4.0
    sets = [set(t["modules"]) for t in trio.values()]
    assert all(sets) and not (sets[0] & sets[1] or sets[0] & sets[2]
                              or sets[1] & sets[2])


def test_merge_multi_matches_jax(model):
    base, loras, merged, _, _ = model
    unet = from_jax.load(UNet2DConditionModel(tconfigs.MICRO_UNET),
                         from_jax.unet_state_dict(base["unet"]))
    got = tlora.merge_multi(dict(unet.named_parameters()),
                            [from_jax.lora_tree(l)
                             for l in loras["unet"].values()])
    sd = from_jax.unet_state_dict(merged["unet"])
    assert len(got) == sum(len(l["modules"]) for l in loras["unet"].values())
    for k, v in got.items():
        np.testing.assert_allclose(v.detach().numpy(), sd[k], rtol=1e-5,
                                   atol=1e-6)


_jit_a2b = jax.jit(lambda p, x, c, key: jcg.forward_with_params(
    p, JCFGS, jnp.asarray(jp2p.scheduler.make_alphas_cumprod()), x, c, key,
    "a2b"))


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_cyclegan_matches_jax(model, direction):
    """JAX's b2a is its a2b program on params whose vae_a2b is vae_b2a
    (forward_with_params only picks the VAE by direction): one compile."""
    _, _, merged, port, _ = model
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (1, 40, 56, 3)).astype(np.float32)
    ctx = rng.randn(1, 77, CTX).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = _jit_a2b(dict(merged, vae_a2b=merged["vae_" + direction]),
                    jnp.asarray(x), jnp.asarray(ctx), key)
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (1, 5, 7, 4), jnp.float32)))
    for kernels in (True, False):
        pipe = tcg.CycleGANTurbo(port, CFGS, torch.from_numpy(ctx),
                                 direction, dtype=torch.float32, device="cpu",
                                 use_kernels=kernels)
        got = pipe(torch.from_numpy(x), noise=noise)
        assert rel_l2(got, want) <= REL_L2, kernels
    other = "b2a" if direction == "a2b" else "a2b"
    assert not torch.equal(pipe(torch.from_numpy(x), other, noise=noise), got)


def test_from_random_is_the_training_init():
    """B = 0 at init, so the merged pipeline serves the base model, and
    vae_b2a, a copy of vae_a2b, gives b2a the same image as a2b."""
    pipe = tcg.CycleGANTurbo.from_random(torch.Generator().manual_seed(2),
                                         CFGS)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (1, 32, 32, 3)).astype(np.float32))
    ctx = torch.from_numpy(np.random.RandomState(3).randn(1, 77, CTX).astype(
        np.float32))
    a2b = pipe(x, "a2b", ctx)
    assert a2b.shape == (1, 32, 32, 3) and a2b.dtype == torch.bfloat16
    assert torch.isfinite(a2b).all() and a2b.abs().max() <= 1
    assert torch.equal(pipe(x, "b2a", ctx), a2b)


@pytest.fixture(scope="module")
def engines(model):
    _, _, merged, port, _ = model
    jeng = jengine.ServingEngine({"unet": merged["unet"],
                                  "vae": merged["vae_a2b"]}, JCFGS,
                                 mode="image", dtype=jnp.float32,
                                 donate_input=False)
    ours = {k: tengine.ServingEngine(
        {"unet": port["unet"], "vae": port["vae_a2b"]}, CFGS, mode="image",
        dtype=torch.float32, device="cpu", use_kernels=k)
        for k in (True, False)}
    return jeng, ours


@pytest.mark.parametrize("kernels", [True, False])
def test_image_engine_matches_jax_on_uint8(engines, kernels):
    jeng, ours = engines
    img = _chip_smoke().synth_image(64, 64, 8)
    ctx = np.random.RandomState(8).randn(1, 77, CTX).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jeng(jnp.asarray(img), jnp.asarray(ctx), rng=key))
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    got = ours[kernels](img, torch.from_numpy(ctx),
                        noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_LEVELS, diff.max()
    assert (diff > 0).mean() <= MAX_FRACTION, (diff > 0).mean()
    assert want.std() > 0


def test_bucketing_matches_jax():
    """bucket_size as the JAX package's; BucketedEngine hands the engine
    the image edge-padded to its bucket and crops the answer back."""
    for n in (1, 200, 256, 300, 1024, 1025, 1300):
        assert tengine.bucket_size(n) == jengine.bucket_size(n)
    seen = []

    def engine(arr, caption_enc, generator):
        seen.append(arr)
        return torch.from_numpy(arr) // 2
    img = _chip_smoke().synth_image(60, 300, 12)
    out = tengine.BucketedEngine(engine)(torch.from_numpy(img), None)
    np.testing.assert_array_equal(seen[0], np.pad(
        img, ((0, 0), (0, 196), (0, 84), (0, 0)), mode="edge"))
    assert torch.equal(out, torch.from_numpy(img) // 2)


def test_image_mode_refuses_what_it_does_not_take(engines):
    eng = engines[1][True]
    with pytest.raises(ValueError):
        tengine.ServingEngine(cfgs=CFGS, mode="image", device="cpu")
    with pytest.raises(ValueError):
        tengine.ServingEngine({"unet": eng.unet, "vae": eng.vae}, CFGS,
                              mode="canny", device="cpu")
    with pytest.raises(ValueError):
        eng(np.zeros((1, 64, 64, 3), np.uint8), torch.zeros(1, 77, CTX),
            noise_map=torch.zeros(1, 8, 8, 4))


# ---------------------------------------------------------------------------
# the port alone at the SD-Turbo topology (TINY widths)
# ---------------------------------------------------------------------------


def test_launch_tables_of_image_and_sketch_requests(monkeypatch):
    """chip_smoke.py's per-request launch counts of the two modes, checked
    by counting the kernel wrappers' calls on the random models it serves
    (`from_jax.random_cyclegan_model`, `random_sketch_model`; the TINY
    configs share SD-Turbo's topology)."""
    smoke = _chip_smoke()
    cfgs = GeneratorConfigs(tconfigs.TINY_UNET, tconfigs.TINY_VAE)
    g = torch.Generator().manual_seed(1)
    cyc = from_jax.random_cyclegan_model(cfgs, g)
    unet, vae, lora = from_jax.random_sketch_model(cfgs, g)
    image = {k: tengine.ServingEngine(
        {"unet": cyc["unet"], "vae": cyc["vae_a2b"]}, cfgs, mode="image",
        dtype=torch.float32, device="cpu", use_kernels=k)
        for k in (True, False)}
    sketch = {k: tengine.ServingEngine(
        cfgs=cfgs, mode="sketch", dtype=torch.float32, device="cpu",
        use_kernels=k, base={"unet": unet, "vae": vae}, lora=lora)
        for k in (True, False)}
    calls = collections.Counter()

    def spy(mod, fn, key):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)

    for name in ("fused_gn_silu_conv3x3", "upsample2x_conv3x3",
                 "downsample2x_conv3x3"):
        spy(fused_conv, name, name)
    spy(fused_matmul, "fused", "fused_matmul")
    spy(attention, "flash_attention_folded", "flash_attention_folded")
    spy(groupnorm, "partial_stats", "group_norm_stats")
    spy(groupnorm, "combine_stats", "group_norm_combine")
    ctx = torch.zeros(1, 77, 32)
    img = smoke.synth_image(64, 64, 11)
    outs = {}
    for name, engs, want in (("image", image, smoke.EXPECTED_LAUNCHES_IMAGE),
                             ("sketch", sketch,
                              smoke.EXPECTED_LAUNCHES_SKETCH)):
        calls.clear()
        outs[name] = engs[True](img, ctx)
        assert dict(calls) == want, name
        calls.clear()
        engs[False](img, ctx)
        assert not calls, name  # the plain path reaches no kernel wrapper
    # the random model's two directions differ
    b2a = tengine.ServingEngine({"unet": cyc["unet"], "vae": cyc["vae_b2a"]},
                                cfgs, mode="image", dtype=torch.float32,
                                device="cpu")
    assert not torch.equal(b2a(img, ctx), outs["image"])
