"""The port's unpaired (CycleGAN-Turbo) training step and the training
modules it shares with the paired step, against the JAX package, on the
CPU, in fp32.

- one whole unpaired step at MICRO_UNET / MICRO_VAE / TINY_CLIP_VIT with
  the unpaired trainer's ranks (UNet trio 128, VAEs 4) and random B factors
  (B = 0 at init would hide the A factors' gradients): the eight losses,
  every trainable's cycle-pass gradient, the trainables after the step and
  both discriminators' heads and spectral-norm vectors; the same step on
  a (1, 2) mesh of two gloo ranks with the UNet sharded over the model
  axis, on both ranks, its state bit-identical across them; the converters
  `from_jax.cycle_trainables` and `disc_heads_pair` pinned to the port's
  own layout;
- gradient accumulation: accum_steps=2 on a batch of 2 against
  accum_steps=1 on the same batch and noise, unpaired and paired;
- the per-step launch table of chip_smoke.py, by counting the kernel
  wrappers' calls in one unpaired step at the TINY configs (SD-Turbo's
  topology), and none on the plain path;
- `training/data.py` against the JAX module on PNGs written here, for every
  transform name;
- a checkpoint saved, restored into another state and stepped, against a
  step from the live state, bit for bit.

The JAX step runs its XLA path. One jit of the whole step takes minutes to
compile on a CPU, so for this fixture only the JAX step's generator
forward, LoRA merge, LPIPS, discriminator losses and optimizer are each put
under jax.jit (patched in for the fixture and taken out after it): the
same functions, compiled once each and reused by the step's eight
forwards. The JAX cycle-pass gradients are the ones the step hands its
optimizer first. Weights are the port's seeded ones, converted by the JAX
package's `torch_import`. Tolerances are the paired test's
(tests/test_torch_train.py): losses 1e-4 relative, gradients relative L2
2e-4, trainables 1e-4 relative L2 on strong-gradient elements and 5e-4
absolute, discriminator state 1e-5.
"""

import collections
import copy
import importlib.util
import itertools
import json
import os

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

import torch_dp

from img2img_turbo_tpu import configs as jcfg
from img2img_turbo_tpu.models import clip_vit as jclip_vit
from img2img_turbo_tpu.models import vgg_lpips as jvgg
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.training import data as jdata
from img2img_turbo_tpu.training import losses as jlosses
from img2img_turbo_tpu.training import optim as joptim
from img2img_turbo_tpu.training import unpaired as junpaired
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tcfg
from img2img_turbo_tpu_torch.models import clip_vit as tclip_vit
from img2img_turbo_tpu_torch.ops import (attention as tattn, fused_conv,
                                         fused_matmul, groupnorm)
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.training import checkpoint as tckpt
from img2img_turbo_tpu_torch.training import data as tdata
from img2img_turbo_tpu_torch.training import losses as tlosses
from img2img_turbo_tpu_torch.training import optim as toptim
from img2img_turbo_tpu_torch.training import paired as tpaired
from img2img_turbo_tpu_torch.training import runner as trunner
from img2img_turbo_tpu_torch.training import unpaired as tunpaired
from img2img_turbo_tpu_torch.weights import from_jax

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32            # the MICRO VAE and UNet have two levels
LR = 5e-4           # large enough that Adam's steps stand above fp32 noise
# Adam's eps for both packages here: at the default 1e-8 an element whose
# gradient is fp32 noise (1e-6 of its tensor's largest and less) takes a
# full +-lr step of random sign in either package, and a head element whose
# gradients in the two discriminator passes are of unlike sizes moves by
# their noisy ratio; with eps above those gradients they move by it alone
EPS = 1e-5
MODEL_TOL = 2e-4    # relative L2 of whole-model fp32 gradients
HWIO = (2, 3, 1, 0)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _sd(module, prefix=""):
    return {prefix + k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _batch(b=1, seed=0, d=tcfg.MICRO_UNET.cross_attention_dim):
    rng = np.random.RandomState(seed)
    return {"pixel_values_src":
            (rng.rand(b, RES, RES, 3) * 2 - 1).astype(np.float32),
            "pixel_values_tgt":
            (rng.rand(b, RES, RES, 3) * 2 - 1).astype(np.float32),
            "emb_a2b": (rng.randn(b, 77, d) * 0.1).astype(np.float32),
            "emb_b2a": (rng.randn(b, 77, d) * 0.1).astype(np.float32)}


def _vae_jax(vae):
    # the converter's skip-conv list assumes SD-Turbo's four levels
    sd = _sd(vae)
    tree = ti.convert_vae_state_dict(sd, jcfg.MICRO_VAE,
                                     with_skip_convs=False)
    tree["decoder"]["skip_convs"] = [
        {"kernel": jnp.asarray(sd[f"decoder.skip_conv_{i + 1}.weight"]
                               .transpose(HWIO))}
        for i in range(jcfg.MICRO_VAE.num_levels)]
    return tree


def _heads_jax(heads, sn):
    # copies: jnp.asarray may share a numpy array's memory, and the port's
    # step updates its tensors in place
    h = {k: v.detach().numpy().copy() for k, v in heads.items()}
    u = {k: jnp.asarray(v.numpy().copy()) for k, v in sn.items()}
    jheads = {"spatial": [{c: {"kernel": jnp.asarray(h[
        f"spatial.{i}.{c}.weight"].transpose(HWIO)), "bias": jnp.asarray(
            h[f"spatial.{i}.{c}.bias"])} for c in ("conv1", "conv2")}
        for i in range(2)],
        "final": {c: {"kernel": jnp.asarray(h[f"final.{c}.weight"].T),
                      "bias": jnp.asarray(h[f"final.{c}.bias"])}
                  for c in ("lin1", "lin2")}}
    jsn = {"spatial": [{c: u[f"spatial.{i}.{c}"] for c in ("conv1",
                                                           "conv2")}
                       for i in range(2)],
           "final": {c: u[f"final.{c}"] for c in ("lin1", "lin2")}}
    return jheads, jsn


def _lora_jax(gen, part, rank, alpha):
    modules = {}
    for k, v in gen.items():
        if k.startswith(part + ":"):
            name, ab = k[len(part) + 1:].rsplit(".", 1)
            modules.setdefault(name, {})[ab] = jnp.asarray(
                v.detach().numpy().copy())
    return {"rank": rank, "alpha": alpha, "modules": modules}


def _jax_from_port(models, state, meta, clip_cfg, g):
    """The JAX package's trees for the port's seeded run."""
    clip = trunner.random_init(lambda: tclip_vit.CLIPModel(clip_cfg), g)
    backbone_sd = {**{k: v for k, v in _sd(clip).items()
                      if not k.startswith(("vision_model.",
                                           "visual_projection"))},
                   **_sd(models.disc_backbone)}
    vgg = _sd(models.lpips)
    conv_idx = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]
    vgg_sd = {f"features.{idx}.{leaf}": vgg[f"blocks.{i}.{j}.{leaf}"]
              for i, idxs in enumerate(conv_idx)
              for j, idx in enumerate(idxs) for leaf in ("weight", "bias")}
    lin_sd = {f"lin{i}.model.1.weight": vgg[f"lins.{i}.weight"]
              for i in range(5)}
    adapters = {a: _lora_jax(state.gen, f"unet_lora:{a}", meta.rank_unet,
                             float(meta.rank_unet))
                for a in ("default_encoder", "default_decoder",
                          "default_others")}
    vae_loras = [_lora_jax(state.gen, f"{v}_lora", meta.rank_vae,
                           meta.alpha_vae) for v in ("vae_a2b", "vae_b2a")]
    gen, frozen, jmeta = junpaired.split_trainable(
        ti.convert_unet_state_dict(_sd(models.unet), jcfg.MICRO_UNET),
        _vae_jax(models.vae_a2b), _vae_jax(models.vae_b2a), adapters,
        *vae_loras)
    disc = {d: _heads_jax(tunpaired.side(state.disc, d),
                          tunpaired.side(state.disc_sn, d)) for d in "ab"}
    aux = {"lpips": jvgg.convert_lpips_state_dict(vgg_sd, lin_sd),
           "disc_backbone": jclip_vit.convert_clip_state_dict(
               backbone_sd, jclip_vit.TINY_CLIP_VIT)["vision"]}
    return gen, frozen, jmeta, aux, {d: v[0] for d, v in disc.items()}, \
        {d: v[1] for d, v in disc.items()}


def _jit_pieces(mp, jcfgs):
    """Put the JAX step's generator forward (one program: the two
    directions differ only in which VAE's weights they take), LoRA merge,
    LPIPS and discriminator losses under jax.jit for the length of the `mp`
    context."""
    fwd = junpaired.forward_with_params
    prog = jax.jit(lambda unet, vae, a, x, e, r: fwd(
        {"unet": unet, "vae_a2b": vae}, jcfgs, a, x, e, r, "a2b"))

    def forward(params, cfgs, alphas, x, emb, rng, direction, remat=False):
        assert cfgs is jcfgs and not remat
        return prog(params["unet"], params["vae_" + direction], alphas, x,
                    emb, rng)
    mp.setattr(junpaired, "forward_with_params", forward)
    mp.setattr(junpaired, "build_gen_params",
               jax.jit(junpaired.build_gen_params, static_argnums=2))
    mp.setattr(jlosses, "lpips_loss", jax.jit(jlosses.lpips_loss))
    for name in ("gan_gen_loss", "gan_disc_real_loss", "gan_disc_fake_loss"):
        mp.setattr(jlosses, name, jax.jit(getattr(jlosses, name),
                                          static_argnums=(1, 3)))
    mp.setattr(optax, "apply_updates", jax.jit(optax.apply_updates))


def _recording(adamw):
    """`adamw` with its init and update under jax.jit, the gradients of
    every update kept in order: the step's first is the cycle pass's."""
    grads, update = [], jax.jit(adamw.update)

    def record(g, opt_state, params):
        grads.append(g)
        return update(g, opt_state, params)
    return optax.GradientTransformation(jax.jit(adamw.init), record), grads


@pytest.fixture(scope="module")
def unpaired_setup():
    cfgs = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)
    clip_cfg = tclip_vit.TINY_CLIP_VIT
    models, state, meta = trunner.build_unpaired_run(cfgs, clip_cfg,
                                                     device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, v in state.gen.items():
            if k.endswith(".b"):
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)
    sched_t = toptim.make_lr_schedule("constant", LR, 0, 100)
    state = tunpaired.make_state(state.gen, state.disc, state.disc_sn,
                                 sched_t, sched_t, eps=EPS)
    gen_j, frozen, jmeta, aux, disc, disc_sn = _jax_from_port(
        models, state, meta, clip_cfg, g)
    assert jmeta == junpaired.CycleLoraMeta(meta.rank_unet, meta.rank_vae,
                                            meta.alpha_vae)

    jcfgs = jp2p.GeneratorConfigs(jcfg.MICRO_UNET, jcfg.MICRO_VAE,
                                  jcfg.TINY_TEXT)
    loss_cfg = jlosses.UnpairedLossConfig()
    adamw = joptim.make_adamw(joptim.make_lr_schedule("constant", LR, 0,
                                                      100),
                              eps=EPS, max_grad_norm=tunpaired.MAX_GRAD_NORM)
    tx, updates = _recording(adamw)
    jstate = {"gen": gen_j, "gen_opt": tx.init(gen_j), "disc": disc,
              "disc_sn": disc_sn, "disc_opt": tx.init(disc),
              "step": jnp.zeros((), jnp.int32)}
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    # the posterior noise of the step's eight forwards, drawn as the JAX
    # step draws it (unpaired.py:144, 161, 185, 207; vae.py:305)
    rngs = jax.random.split(key, 8)
    keys = [*jax.random.split(rngs[0], 4), *jax.random.split(rngs[1]),
            *jax.random.split(rngs[2])]
    lat = (1, RES // 2, RES // 2, jcfg.MICRO_VAE.latent_channels)
    noise = tuple(np.asarray(jax.random.normal(k, lat, jnp.float32))
                  for k in keys)
    # the two-rank step under the model axis starts now, beside the JAX
    # step's compile, from the state port_step starts from; tp_port_step
    # collects it. It takes copies: torch moves a tensor it sends to the
    # ranks into shared memory, under the numpy views the JAX trees were
    # made from, and port_step updates the trainables in place
    init = ({k: v.detach() for k, v in state.gen.items()}, state.disc,
            state.disc_sn)
    tp_ticket = torch_dp.shared(2).submit(
        torch_dp.given_step, *copy.deepcopy((
            models, cfgs, meta, init,
            {k: torch.from_numpy(v) for k, v in batch.items()},
            tuple(torch.from_numpy(n) for n in noise))),
        "unpaired", True, {"eps": EPS})
    with pytest.MonkeyPatch.context() as mp:
        _jit_pieces(mp, jcfgs)
        step = junpaired.make_unpaired_train_step(
            jcfgs, jclip_vit.TINY_CLIP_VIT, loss_cfg, jmeta, tx, tx,
            remat=False)
        new_state, metrics = step(jstate, frozen, aux, jbatch, key)
    grads_c = updates[0]   # the cycle pass's, as the step took them

    return dict(
        gen0=from_jax.cycle_trainables(_np_tree(gen_j)),
        disc0=from_jax.disc_heads_pair(_np_tree(disc), _np_tree(disc_sn)),
        gen1=from_jax.cycle_trainables(_np_tree(new_state["gen"])),
        grads_c=from_jax.cycle_trainables(_np_tree(grads_c)),
        disc1=from_jax.disc_heads_pair(_np_tree(new_state["disc"]),
                                       _np_tree(new_state["disc_sn"])),
        metrics={k: float(v) for k, v in metrics.items()},
        batch=batch, noise=noise, cfgs=cfgs, models=models, state=state,
        meta=meta, tp_ticket=tp_ticket)


@pytest.fixture(scope="module")
def port_step(unpaired_setup):
    s = unpaired_setup
    step = tunpaired.make_unpaired_train_step(
        s["models"], s["cfgs"], tlosses.UnpairedLossConfig(), s["meta"],
        kernels=True, remat=True, dtype=torch.float32)
    batch = {k: torch.from_numpy(v) for k, v in s["batch"].items()}
    noise = tuple(torch.from_numpy(n.copy()) for n in s["noise"])
    state = s["state"]
    gen0 = {k: v.detach().clone() for k, v in state.gen.items()}
    disc0 = ({k: v.detach().clone() for k, v in state.disc.items()},
             dict(state.disc_sn))
    metrics, grads = step(state, batch, noise, keep_grads=True)
    return dict(state=state, metrics=metrics, grads=grads, gen0=gen0,
                disc0=disc0, step=step, batch=batch, noise=noise)


def test_converters_pin_the_port_layout(unpaired_setup, port_step):
    """cycle_trainables and disc_heads_pair give the port's keys, shapes
    and values for the JAX trees built from the same weights."""
    s = unpaired_setup
    got0, (disc0, sn0) = port_step["gen0"], port_step["disc0"]
    assert set(s["gen0"]) == set(got0)
    for k, v in s["gen0"].items():
        np.testing.assert_array_equal(v, got0[k].numpy(), err_msg=k)
    heads, sn = s["disc0"]
    assert set(heads) == set(disc0) and set(sn) == set(sn0)
    for k, v in heads.items():
        np.testing.assert_array_equal(v, disc0[k].numpy(), err_msg=k)
    for k, v in sn.items():
        np.testing.assert_array_equal(v, sn0[k].numpy(), err_msg=k)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_losses(s, metrics):
    want = s["metrics"]
    got = {k: float(v) for k, v in metrics.items()}
    assert set(got) == set(want) == {
        "cycle_a", "cycle_b", "gan_a", "gan_b", "idt_a", "idt_b",
        "disc_fake", "disc_real"}
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-3), \
            (k, got[k], want[k])


def _assert_grads(s, got):
    want = s["grads_c"]
    assert set(got) == set(want)
    errs = {k: _rel_l2(_np(got[k]), want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= MODEL_TOL, (worst, errs[worst])


def _assert_trainables(s, got0, gen):
    want0, want1 = s["gen0"], s["gen1"]
    g = s["grads_c"]
    for k in want1:
        d_want = want1[k] - want0[k]
        d_got = _np(gen[k]) - _np(got0[k])
        diff = np.abs(d_got - d_want)
        assert diff.max() <= 5e-4, (k, diff.max())
        strong = np.abs(g[k]) >= 1e-2 * np.abs(g[k]).max()
        err = _rel_l2(d_got[strong], d_want[strong])
        assert err <= 1e-4, (k, err, strong.mean())


def _assert_discriminators(s, disc, disc_sn):
    heads, sn = s["disc1"]
    assert set(heads) == set(disc) and set(sn) == set(disc_sn)
    for got, want in ((disc, heads), (disc_sn, sn)):
        for k, v in want.items():
            np.testing.assert_allclose(_np(got[k]), v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_unpaired_step_losses_match_jax(unpaired_setup, port_step):
    """All eight losses within 1e-4 relative (fp32, same weights, same
    posterior noise)."""
    _assert_losses(unpaired_setup, port_step["metrics"])


def test_unpaired_step_cycle_gradients_match_jax(unpaired_setup, port_step):
    """Every trainable's cycle-pass gradient (through both hops of each
    cycle, into both VAEs, the three UNet adapters, conv_in and the skip
    convs) within relative L2 2e-4 of jax.grad of the step's cycle loss."""
    _assert_grads(unpaired_setup, port_step["grads"])


def test_unpaired_step_trainables_match_jax(unpaired_setup, port_step):
    """After the step (three AdamW updates of the generator, lr 5e-4):
    each trainable's change within relative L2 1e-4 of the JAX step's on
    the elements whose cycle-pass gradient is at least 1e-2 of the
    tensor's largest, and every element within one update, 5e-4, of the
    JAX value (the paired test's rule)."""
    _assert_trainables(unpaired_setup, port_step["gen0"],
                       port_step["state"].gen)


def test_unpaired_step_discriminators_match_jax(unpaired_setup, port_step):
    """Both discriminators' heads after the two updates, and their
    spectral-norm vectors after the three advances, within 1e-5."""
    state = port_step["state"]
    _assert_discriminators(unpaired_setup, state.disc, state.disc_sn)


@pytest.fixture(scope="module")
def tp_port_step(unpaired_setup):
    """The port's unpaired step on a (1, 2) mesh of two gloo ranks
    (`torch_dp.shared`, one intra-op thread each), started by
    unpaired_setup: the UNet and both VAEs sharded over the model axis
    (`runner.shard_for_training`), both ranks the fixture's row and noise,
    from the state `port_step` starts from (Adam's eps EPS), the UNet
    blocks recomputed (remat)."""
    return torch_dp.shared(2).collect(unpaired_setup["tp_ticket"])


@pytest.mark.parametrize("check", ["losses", "cycle_gradients",
                                   "trainables", "discriminators",
                                   "replicated"])
def test_unpaired_tp_step_matches_jax(unpaired_setup, port_step,
                                      tp_port_step, check):
    """Under the model axis, on both ranks, at the tolerances of
    test_unpaired_step_*_match_jax; "replicated": every trainable, head,
    spectral-norm vector and AdamW moment bit-identical on the two model
    ranks, each rank holding only its shards of the UNet and of both VAEs
    (below 0.6 of each whole's parameters)."""
    s = unpaired_setup
    for res in tp_port_step:
        if check == "losses":
            _assert_losses(s, res["metrics"])
        elif check == "cycle_gradients":
            _assert_grads(s, res["grads"])
        elif check == "trainables":
            _assert_trainables(s, port_step["gen0"], res["gen"])
        elif check == "discriminators":
            _assert_discriminators(s, res["disc"], res["disc_sn"])
        else:
            assert res["differ"] == []
            for name in ("unet", "vae_a2b", "vae_b2a"):
                whole = sum(p.numel() for p in
                            getattr(s["models"], name).parameters())
                assert res["numel"][name] < 0.6 * whole, name
    if check == "replicated":
        a, b = tp_port_step[0]["state"], tp_port_step[1]["state"]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_checkpoint_restore_then_step_is_bit_identical(port_step, tmp_path):
    """A state saved, restored into a state of other values and stepped
    gives, bit for bit, what a step from the live state gives: the
    trainables, both AdamW states, heads, spectral-norm vectors and step."""
    state, step = port_step["state"], port_step["step"]
    directory = str(tmp_path / "ckpt")
    tckpt.save_train_state(directory, state.step, state)
    assert tckpt.latest_step(directory) == state.step
    live = copy.deepcopy(state)
    sched = toptim.make_lr_schedule("constant", LR, 0, 100)

    def zeros(d):
        return {k: torch.zeros_like(v).requires_grad_(v.requires_grad)
                for k, v in d.items()}
    other = tunpaired.make_state(zeros(state.gen), zeros(state.disc),
                                 zeros(state.disc_sn), sched, sched)
    assert tckpt.restore_train_state(directory, other) is other
    results = [step(s, port_step["batch"], port_step["noise"])[0]
               for s in (live, other)]
    assert {k: float(v) for k, v in results[0].items()} == \
        {k: float(v) for k, v in results[1].items()}
    assert live.step == other.step == state.step + 1
    for part in ("gen", "disc", "disc_sn"):
        a, b = getattr(live, part), getattr(other, part)
        for k in a:
            assert torch.equal(a[k], b[k]), (part, k)
    for opt_a, opt_b in ((live.gen_opt, other.gen_opt),
                         (live.disc_opt, other.disc_opt)):
        sa, sb = opt_a.state_dict(), opt_b.state_dict()
        assert sa["count"] == sb["count"]
        for i, st in sa["state"].items():
            for n in ("mu", "nu"):
                assert torch.equal(st[n], sb["state"][i][n]), (i, n)


def test_checkpoints_keep_the_newest_three(port_step, tmp_path):
    state = port_step["state"]
    for s in (5, 10, 15, 20):
        tckpt.save_train_state(str(tmp_path), s, state)
    assert sorted(os.listdir(tmp_path)) == ["10.pt", "15.pt", "20.pt"]
    assert tckpt.latest_step(str(tmp_path)) == 20
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(str(tmp_path / "none"), state)


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------


def _paired_run(b, seed=0):
    cfgs = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)
    models, state, meta = trunner.build_paired_run(
        cfgs, tclip_vit.TINY_CLIP_VIT, device="cpu")
    g = torch.Generator().manual_seed(seed)
    batch = {"conditioning_pixel_values": torch.rand(b, RES, RES, 3,
                                                     generator=g),
             "output_pixel_values": torch.rand(b, RES, RES, 3, generator=g)
             * 2 - 1,
             "input_ids": torch.randint(0, 999, (b, 77), generator=g)}
    noise = tuple(tpaired.draw_noise(g, b, RES, RES, cfgs, torch.float32)
                  for _ in range(2))

    def make(k):
        return tpaired.make_paired_train_step(
            models, cfgs, tlosses.PairedLossConfig(), meta, kernels=True,
            remat=True, dtype=torch.float32, accum_steps=k)
    return state, batch, noise, make


def _unpaired_run(b, seed=0):
    cfgs = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)
    models, state, meta = trunner.build_unpaired_run(
        cfgs, tclip_vit.TINY_CLIP_VIT, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(b, seed).items()}
    g = torch.Generator().manual_seed(seed)
    noise = tuple(tpaired.draw_noise(g, b, RES, RES, cfgs, torch.float32)
                  for _ in range(tunpaired.NUM_NOISE))

    def make(k):
        return tunpaired.make_unpaired_train_step(
            models, cfgs, tlosses.UnpairedLossConfig(), meta, kernels=True,
            remat=True, dtype=torch.float32, accum_steps=k)
    return state, batch, noise, make


@pytest.mark.parametrize("run", [_unpaired_run, _paired_run],
                         ids=["unpaired", "paired"])
def test_accum_steps_match_one_step(run):
    """accum_steps=2 on a batch of 2 (two micro-batches, one update a
    pass) gives the losses and the state of accum_steps=1 on the same
    batch and noise within 1e-5: every loss is a batch mean."""
    state, batch, noise, make = run(2)
    states = {k: copy.deepcopy(state) for k in (1, 2)}
    metrics = {k: make(k)(states[k], batch, noise)[0] for k in (1, 2)}
    assert set(metrics[1]) == set(metrics[2])
    for n in metrics[1]:
        assert abs(float(metrics[1][n]) - float(metrics[2][n])) <= 1e-5 \
            * max(1.0, abs(float(metrics[1][n]))), n
    for part in ("gen", "disc", "disc_sn"):
        a, b = getattr(states[1], part), getattr(states[2], part)
        for n in a:
            np.testing.assert_allclose(a[n].detach().numpy(),
                                       b[n].detach().numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{part} {n}")
    with pytest.raises(ValueError, match="divisible"):
        make(3)(copy.deepcopy(state), batch, noise)


# ---------------------------------------------------------------------------
# the launch table of a full-topology step
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_unpaired_launch_table_matches_call_sites(monkeypatch):
    """chip_smoke.py's launch counts for one unpaired step, checked by
    counting the kernel wrappers' calls in one step at the TINY configs
    (the SD-Turbo topology: 4 levels, 2 layers per block), the UNet's
    per-block recompute included; the plain path reaches no wrapper."""
    smoke = _chip_smoke()
    calls = collections.Counter()

    def spy(mod, fn, key):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)

    spy(fused_conv, "fused_gn_silu_conv3x3", "fused_gn_silu_conv3x3")
    spy(fused_conv, "conv3x3_input_grad", "fused_gn_silu_conv3x3")
    spy(fused_conv, "upsample2x_conv3x3", "upsample2x_conv3x3")
    spy(fused_conv, "downsample2x_conv3x3", "downsample2x_conv3x3")
    spy(fused_matmul, "fused", "fused_matmul")
    spy(tattn, "flash_attention_folded", "flash_attention_folded")
    spy(tattn, "flash_attention_folded_bwd", "flash_attention_folded_bwd")
    spy(groupnorm, "partial_stats", "group_norm_stats")
    spy(groupnorm, "combine_stats", "group_norm_combine")
    cfgs = GeneratorConfigs(tcfg.TINY_UNET, tcfg.TINY_VAE, tcfg.TINY_TEXT)
    models, state, meta = trunner.build_unpaired_run(
        cfgs, tclip_vit.TINY_CLIP_VIT, device="cpu")
    h = w = 64
    g = torch.Generator().manual_seed(1)
    d = cfgs.unet.cross_attention_dim
    batch = {"pixel_values_src": torch.rand(1, h, w, 3, generator=g) * 2 - 1,
             "pixel_values_tgt": torch.rand(1, h, w, 3, generator=g) * 2 - 1,
             "emb_a2b": torch.randn(1, 77, d, generator=g),
             "emb_b2a": torch.randn(1, 77, d, generator=g)}
    noise = tuple(tpaired.draw_noise(g, 1, h, w, cfgs, torch.float32)
                  for _ in range(tunpaired.NUM_NOISE))
    for kernels in (True, False):
        step = tunpaired.make_unpaired_train_step(
            models, cfgs, tlosses.UnpairedLossConfig(), meta,
            kernels=kernels, remat=True, dtype=torch.float32)
        calls.clear()
        step(state, batch, noise)
        assert dict(calls) == (smoke.EXPECTED_UNPAIRED_LAUNCHES if kernels
                               else {})


def test_unpaired_tables_add_up_to_the_launch_table():
    """tools/time_kernels.py's unpaired tables, by which chip_smoke.py
    weights each kernel per unpaired step and checks the step's launches
    by shape, list each shape once and add up to chip_smoke.py's launch
    table (the du's launches counted as K1's)."""
    from img2img_turbo_tpu_torch.tools import time_kernels as tk
    want = _chip_smoke().EXPECTED_UNPAIRED_LAUNCHES
    tables = {"fused_gn_silu_conv3x3": tk.K1_UNPAIRED + tk.DU_UNPAIRED,
              "upsample2x_conv3x3": tk.K4_UNPAIRED,
              "downsample2x_conv3x3": tk.K6_UNPAIRED,
              "flash_attention_folded_bwd": tk.K7_UNPAIRED}
    for name, rows in tables.items():
        assert sum(c[-1] for c in rows) == want[name], name
    for rows in (tk.K1_UNPAIRED, tk.DU_UNPAIRED, tk.K4_UNPAIRED,
                 tk.K6_UNPAIRED, tk.K7_UNPAIRED):
        assert len({tuple(c[1:-1]) for c in rows}) == len(rows)


def test_unpaired_run_refuses_to_pick_the_cpu_by_itself(monkeypatch):
    """With no device given the run is built on the card; with no card it
    raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfgs = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)
    with pytest.raises(RuntimeError, match="device"):
        trunner.build_unpaired_run(cfgs, tclip_vit.TINY_CLIP_VIT)


# ---------------------------------------------------------------------------
# training/data.py against the JAX module
# ---------------------------------------------------------------------------


class _Tok:
    def __call__(self, text):
        ids = np.zeros((1, 77), np.int32)
        ids[0, :len(text)] = [ord(c) for c in text[:77]]
        return ids


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """A paired and an unpaired dataset in the reference's layouts, of
    seeded PNGs of two sizes."""
    root = str(tmp_path_factory.mktemp("data"))
    rng = np.random.RandomState(0)
    prompts = {}
    for sub in ("train_A", "train_B"):
        os.makedirs(os.path.join(root, sub))
    for i in range(5):
        name = f"x{i}.png"
        h, w = (40, 56) if i % 2 else (48, 36)
        for sub in ("train_A", "train_B"):
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                os.path.join(root, sub, name))
        prompts[name] = f"caption {i}"
    with open(os.path.join(root, "train_prompts.json"), "w") as f:
        json.dump(prompts, f)
    for name, text in (("fixed_prompt_a.txt", "horse\n"),
                       ("fixed_prompt_b.txt", "zebra\n")):
        with open(os.path.join(root, name), "w") as f:
            f.write(text)
    return root


@pytest.mark.parametrize("prep", [
    "resized_crop_512", "resize_286_randomcrop_256x256_hflip", "resize_256",
    "resize_256x256", "resize_512", "resize_512x512", "no_resize"])
def test_data_matches_jax(data_root, prep):
    """The port's datasets, loader, batch accumulation and prefetch give
    the JAX module's items and batches bit for bit, for each transform
    (the same files, tokenizer and seed)."""
    # images of two sizes: batches of one, unaccumulated, when unresized
    bs = acc = 1 if prep == "no_resize" else 2
    for cls in ("PairedDataset", "UnpairedDataset"):
        ds = [getattr(m, cls)(data_root, "train", prep, _Tok())
              for m in (jdata, tdata)]
        assert len(ds[0]) == len(ds[1])
        # two epochs, to their end through the port's prefetch thread
        got = list(tdata.prefetch(tdata.accumulate_batches(
            tdata.data_loader(ds[1], bs, seed=3, epochs=2), acc)))
        assert len(got) == 2 * (len(ds[1]) // bs) // acc
        want = itertools.islice(jdata.accumulate_batches(
            jdata.data_loader(ds[0], bs, seed=3), acc), len(got))
        for w, g in zip(want, got):
            assert set(w) == set(g)
            for k, v in w.items():
                if isinstance(v, list):
                    assert v == g[k], (cls, k)
                else:
                    assert v.dtype == g[k].dtype, (cls, k)
                    np.testing.assert_array_equal(v, g[k],
                                                  err_msg=f"{cls} {k}")
