"""The port's training building blocks against the JAX package, on the
CPU, in fp32: the CLIP text encoder, the CLIP ViT towers and CLIP-sim,
VGG16 LPIPS, the discriminator (logits, loss, spectral norm and
`sn_step`), the torch-parity resize, the losses, AdamW with clipping and
the LR schedules against optax, and LoRA (targeted modules and the merge).

Weights come from the JAX init (jitted) or from the port's seeded init
converted by the JAX package's own converters; inputs from seeded numpy.
Tolerance 1e-4 abs/rel unless stated; the resize is also held to torch's
own F.interpolate.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
import torch.nn.functional as F

from img2img_turbo_tpu import configs as jcfg
from img2img_turbo_tpu import lora as jlora
from img2img_turbo_tpu.models import clip_text as jclip_text
from img2img_turbo_tpu.models import clip_vit as jclip_vit
from img2img_turbo_tpu.models import discriminator as jdisc
from img2img_turbo_tpu.models import vgg_lpips as jvgg
from img2img_turbo_tpu.ops import image as jimage
from img2img_turbo_tpu.training import losses as jlosses
from img2img_turbo_tpu.training import optim as joptim
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tcfg
from img2img_turbo_tpu_torch import lora as tlora
from img2img_turbo_tpu_torch.models import clip_vit as tclip_vit
from img2img_turbo_tpu_torch.models import discriminator as tdisc
from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
from img2img_turbo_tpu_torch.models.vgg_lpips import VGGLPIPS
from img2img_turbo_tpu_torch.ops import image as timage
from img2img_turbo_tpu_torch.training import losses as tlosses
from img2img_turbo_tpu_torch.training import optim as toptim
from img2img_turbo_tpu_torch.training import runner as trunner
from img2img_turbo_tpu_torch.weights import from_jax

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

TOL = 1e-4
JCLIP, TCLIP = jclip_vit.TINY_CLIP_VIT, tclip_vit.TINY_CLIP_VIT


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _ids(rng, b=2, vocab=1000):
    return rng.randint(1, vocab - 1, (b, 77)).astype(np.int32)


@pytest.fixture(scope="module")
def clip_pair():
    """A JAX CLIP (both towers) and the port's, same weights."""
    params = _np_tree(jax.jit(jclip_vit.init_clip, static_argnums=1)(
        jax.random.PRNGKey(3), JCLIP))
    model = from_jax.load(tclip_vit.CLIPModel(TCLIP),
                          from_jax.clip_state_dict(params))
    return params, model


@pytest.fixture(scope="module")
def disc_pair():
    full = _np_tree(jax.jit(jdisc.init_discriminator, static_argnums=1)(
        jax.random.PRNGKey(4), JCLIP))
    backbone = from_jax.load(tclip_vit.CLIPVision(TCLIP),
                             from_jax.clip_vision_state_dict(
                                 full["backbone"]))
    heads, sn = from_jax.disc_heads(full["heads"], full["sn"])
    return full, backbone, ({k: torch.from_numpy(v) for k, v in heads.items()},
                            {k: torch.from_numpy(v) for k, v in sn.items()})


@pytest.fixture(scope="module")
def lpips_pair():
    params = _np_tree(jax.jit(jvgg.init_vgg_lpips)(jax.random.PRNGKey(5)))
    return params, from_jax.load(VGGLPIPS(), from_jax.lpips_state_dict(params))


def test_clip_text_matches_jax():
    cfg = jcfg.TINY_TEXT
    params = _np_tree(jax.jit(jclip_text.init_clip_text, static_argnums=1)(
        jax.random.PRNGKey(2), cfg))
    model = from_jax.load(CLIPTextModel(tcfg.TINY_TEXT),
                          from_jax.clip_text_state_dict(params))
    ids = _ids(np.random.RandomState(0))
    want = jclip_text.clip_text_forward(params, cfg, jnp.asarray(ids))
    _close(model(torch.from_numpy(ids).long()), want)


def test_clip_vit_towers_and_similarity_match_jax(clip_pair):
    params, model = clip_pair
    rng = np.random.RandomState(1)
    x = rng.randn(2, 64, 64, 3).astype(np.float32) * 0.5
    emb, blocks = jclip_vit.vision_forward(params["vision"], JCLIP,
                                           jnp.asarray(x), return_blocks=True)
    temb, tblocks = model(torch.from_numpy(x), return_blocks=True)
    _close(temb, emb)
    assert len(tblocks) == len(blocks)
    for a, b in zip(tblocks, blocks):
        _close(a, b)
    ids = _ids(rng)
    _close(model.text_forward(torch.from_numpy(ids).long()),
           jclip_vit.text_forward(params["text"], JCLIP, jnp.asarray(ids)))
    img = np.tanh(rng.randn(2, 64, 64, 3)).astype(np.float32)
    _close(tclip_vit.clip_similarity(model, torch.from_numpy(img),
                                     torch.from_numpy(ids).long()),
           jclip_vit.clip_similarity(params, JCLIP, jnp.asarray(img),
                                     jnp.asarray(ids)), tol=1e-3)


def test_vgg_lpips_matches_jax(lpips_pair):
    params, model = lpips_pair
    rng = np.random.RandomState(2)
    x, y = (np.tanh(rng.randn(2, 40, 48, 3)).astype(np.float32)
            for _ in range(2))
    _close(model(torch.from_numpy(x), torch.from_numpy(y)),
           jvgg.lpips(params, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        assert float(model(torch.from_numpy(x),
                           torch.from_numpy(x)).abs().max()) == 0.0


def test_discriminator_logits_loss_and_sn_step_match_jax(disc_pair):
    full, backbone, (heads, sn) = disc_pair
    rng = np.random.RandomState(3)
    img = np.tanh(rng.randn(2, 32, 32, 3)).astype(np.float32)
    want = jdisc.discriminator_logits(full, JCLIP, jnp.asarray(img))
    got = tdisc.discriminator_logits(backbone, heads, sn,
                                     torch.from_numpy(img))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w)
    for kw in ({"for_G": True}, {"for_real": True, "smooth": True},
               {"for_real": True, "smooth": False}, {"for_real": False}):
        _close(tdisc.disc_loss(backbone, heads, sn, torch.from_numpy(img),
                               **kw),
               jdisc.disc_loss(full, JCLIP, jnp.asarray(img), **kw))
    # one power iteration, twice
    jsn, tsn = full["sn"], sn
    for _ in range(2):
        jsn = jdisc.sn_step(full["heads"], jsn)
        tsn = tdisc.sn_step(heads, tsn)
    _, flat = from_jax.disc_heads(full["heads"], _np_tree(jsn))
    for k, v in flat.items():
        _close(tsn[k], v)
    # spectral norm: sigma of the normalised weight is ~1 after iterating
    w = heads["spatial.0.conv1.weight"]
    u = tsn["spatial.0.conv1"]
    for _ in range(500):
        u = tdisc.power_iteration(w, u)
    sigma = torch.linalg.matrix_norm(
        tdisc.spectral_normalize(w, u).reshape(w.shape[0], -1), ord=2)
    assert abs(float(sigma) - 1.0) < 1e-3, float(sigma)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("hw,out", [((40, 56), 64), ((512, 512), 224)])
def test_resize_torch_matches_jax_and_interpolate(mode, hw, out):
    rng = np.random.RandomState(4)
    x = rng.rand(1, *hw, 3).astype(np.float32)
    got = timage.resize_torch(torch.from_numpy(x), out, out, mode)
    _close(got, jimage.resize_torch(jnp.asarray(x), out, out, mode))
    ref = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        size=(out, out), mode=mode, align_corners=False,
                        antialias=False).permute(0, 2, 3, 1)
    # torch computes the source coordinates in fp32, the matrices in fp64
    _close(got, ref, tol=1e-4)


def test_losses_match_jax(clip_pair, disc_pair, lpips_pair):
    params, model = clip_pair
    full, backbone, (heads, sn) = disc_pair
    lp_params, lp_model = lpips_pair
    rng = np.random.RandomState(5)
    pred, tgt = (np.tanh(rng.randn(1, 32, 32, 3)).astype(np.float32)
                 for _ in range(2))
    tp, tt = torch.from_numpy(pred), torch.from_numpy(tgt)
    jp, jt = jnp.asarray(pred), jnp.asarray(tgt)
    ids = _ids(rng, b=1)
    _close(tlosses.l2_loss(tp, tt), jlosses.l2_loss(jp, jt))
    _close(tlosses.lpips_loss(lp_model, tp, tt),
           jlosses.lpips_loss(lp_params, jp, jt))
    _close(tlosses.clipsim_loss(model, tp, torch.from_numpy(ids).long()),
           jlosses.clipsim_loss(params, JCLIP, jp, jnp.asarray(ids)))
    for tf, jf in ((tlosses.gan_gen_loss, jlosses.gan_gen_loss),
                   (tlosses.gan_disc_real_loss, jlosses.gan_disc_real_loss),
                   (tlosses.gan_disc_fake_loss, jlosses.gan_disc_fake_loss)):
        _close(tf(backbone, heads, sn, tp, True),
               jf(full, JCLIP, jp, True))


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup",
                                  "linear", "cosine", "cosine_with_restarts",
                                  "polynomial"])
def test_lr_schedules_match_optax(name):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=40, num_cycles=2,
              power=2.0)
    j = joptim.make_lr_schedule(name, **kw)
    t = toptim.make_lr_schedule(name, **kw)
    for count in (0, 1, 4, 5, 6, 17, 22, 39, 40, 55):
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("max_norm", [1.0, 1e-3])  # clipping off / on
def test_adamw_steps_match_optax(max_norm):
    """Five steps of the port's AdamW against optax.chain(clip, adamw) on
    the same gradients, with warm-up in the schedule."""
    rng = np.random.RandomState(6)
    params = {"w": rng.randn(7, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    sched = joptim.make_lr_schedule("linear", 1e-2, 2, 10)
    tx = joptim.make_adamw(sched, max_grad_norm=max_norm)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = toptim.AdamW(list(tp.values()),
                       toptim.make_lr_schedule("linear", 1e-2, 2, 10),
                       max_grad_norm=max_norm)
    for _ in range(5):
        grads = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
                 for k, v in params.items()}
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), st,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for k in params:
        _close(tp[k], jp[k], tol=1e-6)


def test_lora_targets_and_merge_match_jax():
    """The port's targeted modules are the JAX package's, by diffusers
    name, for both pix2pix target lists; the differentiable merge equals
    JAX's merge_lora."""
    g = torch.Generator().manual_seed(0)
    cfgs = trunner.GeneratorConfigs(tcfg.TINY_UNET, tcfg.TINY_VAE,
                                    tcfg.TINY_TEXT)
    unet, vae, _, _ = trunner.load_base_models(cfgs, g)
    sds = {m: {k: v.numpy() for k, v in mod.state_dict().items()}
           for m, mod in (("unet", unet), ("vae", vae))}
    jparams = {"unet": ti.convert_unet_state_dict(sds["unet"],
                                                  jcfg.TINY_UNET),
               "vae": ti.convert_vae_state_dict(sds["vae"], jcfg.TINY_VAE)}
    targets = {"unet": tlora.PIX2PIX_UNET_TARGETS,
               "vae": tlora.PIX2PIX_VAE_TARGETS}
    assert targets["unet"] == jlora.PIX2PIX_UNET_TARGETS
    assert targets["vae"] == jlora.PIX2PIX_VAE_TARGETS
    for model, module in (("unet", unet), ("vae", vae)):
        jnames = sorted(n for n in jlora.module_names(jparams[model], model)
                        if jlora.matches_target(n, targets[model]))
        assert tlora.targeted(module, targets[model]) == jnames
        lora = tlora.init_lora(module, 4, targets[model], g)
        for e in lora["modules"].values():
            e["b"] = torch.randn(e["b"].shape, generator=g) * 0.1
        jl = {"rank": 4, "alpha": 8.0,
              "modules": {n: {"a": jnp.asarray(e["a"].numpy()),
                              "b": jnp.asarray(e["b"].numpy())}
                          for n, e in lora["modules"].items()}}
        jmerged = jlora.merge_lora(jparams[model], jl, model=model)
        names = jlora.module_names(jmerged, model)
        merged = tlora.merge_lora(dict(module.named_parameters()), lora)
        assert sorted(merged) == [n + ".weight" for n in jnames]
        for n in jnames:
            node = jmerged
            for k in names[n]:
                node = node[k]
            w = np.asarray(node["kernel"])
            w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
            _close(merged[n + ".weight"], w, tol=1e-6)
        # differentiable in the factors
        a = lora["modules"][jnames[0]]["a"].requires_grad_(True)
        tlora.merge_lora(dict(module.named_parameters()), lora)[
            jnames[0] + ".weight"].sum().backward()
        assert a.grad is not None and float(a.grad.abs().sum()) > 0
