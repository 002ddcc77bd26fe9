"""Unpaired (CycleGAN-Turbo) training: the six-objective step (counterpart
of `img2img_turbo_tpu/training/unpaired.py`).

One step is five optimize passes, each its own forwards, gradient and AdamW
update, in the reference's order (train_cyclegan_turbo.py:165-256):
  1. cycle: a -> fake_b -> rec_a and b -> fake_a -> rec_b,
     L1*lambda_cycle + LPIPS*lambda_cycle_lpips (four generator forwards,
     the gradient through both hops of each cycle);
  2. GAN-G: fresh fake_a and fake_b; disc_a(fake_b) + disc_b(fake_a), each
     *lambda_gan;
  3. identity: b through a2b against b, a through b2a against a,
     L1*lambda_idt + LPIPS*lambda_idt_lpips;
  4. discriminators on pass 2's fakes, detached, (..)*lambda_gan*0.5;
  5. discriminators on the real images, (..)*lambda_gan*0.5.
disc_a judges domain-B images, as the reference names them. The text
encoder never runs in the step: the fixed caption embeddings are inputs.
The spectral-norm vectors advance after pass 2 and pass 4 on the heads
before any update, and after pass 5 on the heads pass 4 left.

Trainable (reference get_traininable_params, cyclegan_turbo.py:210-236):
the UNet conv_in, the UNet's three LoRA adapters and each VAE's LoRA and
skip convs, in one flat dictionary of fp32 leaf tensors keyed as the
paired step's: "unet_lora:<adapter>:<module>.a" / ".b",
"unet:conv_in.weight", "vae_a2b_lora:<module>.a", "vae_a2b:decoder.
skip_conv_1.weight", ... The two discriminators' heads and spectral-norm
vectors are one dictionary each, keyed "a:<name>" and "b:<name>", over one
frozen CLIP backbone. Each generator pass merges LoRA once (on top of the
trainable conv_in and skip convs) and swaps the merged weights into the
UNet and both VAEs around that pass's forwards and backward; the posterior
noise of the eight generator forwards is an input of the step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from img2img_turbo_tpu_torch import lora as lora_mod, scheduler
from img2img_turbo_tpu_torch.models import discriminator as disc_mod
from img2img_turbo_tpu_torch.models.layers import has_kernel_layouts
from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
from img2img_turbo_tpu_torch.pipelines.cyclegan import (ADAPTERS,
                                                        forward_with_params)
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.training import accum, paired
from img2img_turbo_tpu_torch.training import losses as losses_mod
from img2img_turbo_tpu_torch.training.paired import (TrainState, _apply,
                                                     _lora_of)

VAES = ("vae_a2b", "vae_b2a")
# the posterior noise of the step's eight generator forwards, in the JAX
# step's draw order: cycle a2b(img_a), b2a(fake_b), b2a(img_b), a2b(fake_a);
# GAN b2a(img_b), a2b(img_a); identity a2b(img_b), b2a(img_a)
NUM_NOISE = 8
# the unpaired trainer's global-norm clip (JAX utils/config_args.py:132)
MAX_GRAD_NORM = 10.0


@dataclasses.dataclass(frozen=True)
class CycleLoraMeta:
    rank_unet: int = 128
    rank_vae: int = 4
    alpha_vae: float = 8.0  # peft's default; the UNet's take alpha = rank


@dataclasses.dataclass
class UnpairedModels:
    """The frozen modules of an unpaired run (fp32 parameters): the UNet,
    both VAEs, LPIPS and the discriminators' shared CLIP backbone."""
    unet: torch.nn.Module
    vae_a2b: torch.nn.Module
    vae_b2a: torch.nn.Module
    lpips: torch.nn.Module
    disc_backbone: torch.nn.Module


def split_trainable(unet, vae_a2b, vae_b2a, unet_adapters: Dict,
                    vae_a2b_lora: Dict, vae_b2a_lora: Dict
                    ) -> Tuple[Dict[str, torch.Tensor], CycleLoraMeta]:
    """-> (gen, meta): fresh fp32 leaf tensors for the trainables
    (unpaired.py:42-69). The modules' own parameters are frozen."""
    gen = {}
    for adapter in ADAPTERS:
        for name, entry in sorted(unet_adapters[adapter]["modules"].items()):
            for ab in ("a", "b"):
                gen[f"unet_lora:{adapter}:{name}.{ab}"] = entry[ab]
    gen["unet:conv_in.weight"] = unet.conv_in.weight
    gen["unet:conv_in.bias"] = unet.conv_in.bias
    for part, vae, lora in (("vae_a2b", vae_a2b, vae_a2b_lora),
                            ("vae_b2a", vae_b2a, vae_b2a_lora)):
        for name, entry in sorted(lora["modules"].items()):
            for ab in ("a", "b"):
                gen[f"{part}_lora:{name}.{ab}"] = entry[ab]
        for key, p in vae.named_parameters():
            if key.startswith("decoder.skip_conv_"):
                gen[f"{part}:{key}"] = p
    gen = {k: v.detach().float().clone().requires_grad_(True)
           for k, v in gen.items()}
    for m in (unet, vae_a2b, vae_b2a):
        m.requires_grad_(False)
    meta = CycleLoraMeta(unet_adapters[ADAPTERS[0]]["rank"],
                         vae_a2b_lora["rank"], vae_a2b_lora["alpha"])
    return gen, meta


def build_gen_params(gen, models: UnpairedModels, meta: CycleLoraMeta,
                     dtype=None, tp=None
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae_a2b", "vae_b2a"}: {param name: tensor}, the trainables
    in place of their base weights, then LoRA merged on top of them
    (unpaired.py:72-90: the UNet trio at alpha = rank, one after the other,
    each VAE's adapter at its own alpha); merged weights cast to `dtype`
    when given. Differentiable in `gen`. tp: the model axis's mesh of a
    sharded UNet and VAEs, whose adapters are merged on their shards
    (each rank its slice of each delta; the skip convs' whole)."""
    out = {}
    for model in ("unet",) + VAES:
        module = getattr(models, model)
        over = {k.split(":", 1)[1]: v for k, v in gen.items()
                if k.startswith(model + ":")}
        base = {**dict(module.named_parameters()), **over}
        if model == "unet":
            merged = lora_mod.merge_multi(
                base, [_lora_of(gen, f"unet_lora:{a}", meta.rank_unet,
                                float(meta.rank_unet)) for a in ADAPTERS],
                dtype=dtype, specs=paired.shard_specs(module, tp), tp=tp)
        else:
            merged = lora_mod.merge_lora(
                base, _lora_of(gen, model + "_lora", meta.rank_vae,
                               meta.alpha_vae), dtype=dtype,
                specs=paired.shard_specs(module, tp), tp=tp)
        out[model] = {**over, **merged}
    return out


def make_state(gen, disc, disc_sn, gen_schedule, disc_schedule,
               max_grad_norm: float = MAX_GRAD_NORM,
               **adam_kwargs) -> TrainState:
    """The unpaired run's state: `paired.make_state` over the generator
    trainables and both discriminators' heads, clipped at `max_grad_norm`
    (the unpaired trainer's by default)."""
    return paired.make_state(gen, disc, disc_sn, gen_schedule, disc_schedule,
                             max_grad_norm=max_grad_norm, **adam_kwargs)


def side(tensors: Dict[str, torch.Tensor], name: str):
    """One discriminator's entries ("a" or "b") of a two-discriminator
    dictionary, without the prefix."""
    return {k[2:]: v for k, v in tensors.items() if k.startswith(name + ":")}


def sn_advance(disc, sn):
    """One power iteration for both discriminators, on the heads `disc`."""
    return {f"{d}:{k}": u for d in ("a", "b")
            for k, u in disc_mod.sn_step(side(disc, d), side(sn, d)).items()}


def make_unpaired_train_step(models: UnpairedModels, cfgs: GeneratorConfigs,
                             loss_cfg: losses_mod.UnpairedLossConfig,
                             meta: CycleLoraMeta, *, kernels: bool = True,
                             remat: bool = True, dtype=torch.bfloat16,
                             accum_steps: int = 1, mesh=None):
    """Returns train_step(state, batch, noise, keep_grads=False) ->
    (metrics, cycle-pass gradients or None); it updates `state` (a
    `TrainState`) in place. batch: pixel_values_src / pixel_values_tgt
    (B, H, W, 3) in [-1, 1], emb_a2b / emb_b2a (B, 77, D) fixed caption
    embeddings; noise: the posterior noise of the eight generator forwards
    (`NUM_NOISE` tensors, `paired.draw_noise`, in the order above).
    kernels=False runs the plain PyTorch path on the same weights.
    accum_steps > 1 runs each pass over that many micro-batches, one
    optimizer update a pass (B must be divisible by it). mesh: as in
    `paired.make_paired_train_step` (JAX unpaired.py:128-135): the five
    passes' losses, scalar metrics and gradients are averaged over the
    ranks before each optimizer update; pass 2's fakes stay on their rank
    for the discriminator passes. With a model axis, the UNet and both
    VAEs run on this rank's shards (`runner.shard_for_training`), with the
    invariants of `training/paired.py`'s docstring."""
    tp = paired.model_axis(mesh, models)
    for m in (models.unet, models.vae_a2b, models.vae_b2a):
        if any(has_kernel_layouts(sub) for sub in m.modules()):
            raise ValueError("train the modules unprepared: kernel layouts "
                             "taken by prepare_kernels would be stale")
    dev = next(models.unet.parameters()).device
    alphas = scheduler.make_alphas_cumprod(device=dev)
    smooth = loss_cfg.gan_loss_type.endswith("_s")
    mods = {"unet": models.unet, "vae_a2b": models.vae_a2b,
            "vae_b2a": models.vae_b2a}
    lam = loss_cfg

    def fwd(x, emb, noise, direction):
        return forward_with_params(mods, cfgs, alphas, x, emb, direction,
                                   kernels=kernels, noise=noise, remat=remat,
                                   tp=tp)

    def rec_loss(pred, target, w_l1, w_lpips):
        return (w_l1 * losses_mod.l1_loss(pred, target) + w_lpips
                * losses_mod.lpips_loss(models.lpips, pred, target))

    def gen_pass(gen, data, loss_fn):
        """loss_fn(micro data) -> (loss, aux) on the merged generators;
        returns (loss, the auxes, grads over gen), LoRA merged once."""
        params = build_gen_params(gen, models, meta, dtype, tp)
        with lora_mod.swap_params(models.unet, params["unet"]), \
                lora_mod.swap_params(models.vae_a2b, params["vae_a2b"]), \
                lora_mod.swap_params(models.vae_b2a, params["vae_b2a"]):
            out = accum.accumulated_grads(loss_fn, gen, data, accum_steps)
        return mesh_mod.pmean_pass(*out, mesh)

    def disc_pass(disc, data, loss_fn):
        return mesh_mod.pmean_pass(*accum.accumulated_grads(
            lambda mb: (loss_fn(mb), None), disc, data, accum_steps), mesh)

    def gan(loss, disc, sn, name, images):
        """lambda_gan * `loss` (one of losses_mod's GAN losses) of
        discriminator `name` ("a" or "b") on `images`."""
        return lam.lambda_gan * loss(models.disc_backbone, side(disc, name),
                                     side(sn, name), images, smooth)

    def train_step(state: TrainState, batch, noise, keep_grads=False):
        if len(noise) != NUM_NOISE:
            raise ValueError(f"noise: {NUM_NOISE} tensors, got {len(noise)}")
        data = {"img_a": batch["pixel_values_src"].to(dtype),
                "img_b": batch["pixel_values_tgt"].to(dtype),
                "emb_a2b": batch["emb_a2b"].to(dtype),
                "emb_b2a": batch["emb_b2a"].to(dtype),
                **{f"noise{i}": n for i, n in enumerate(noise)}}
        metrics = {}

        # ---- 1. cycle -------------------------------------------------
        def cycle(mb):
            fake_b = fwd(mb["img_a"], mb["emb_a2b"], mb["noise0"], "a2b")
            rec_a = fwd(fake_b, mb["emb_b2a"], mb["noise1"], "b2a")
            la = rec_loss(rec_a, mb["img_a"], lam.lambda_cycle,
                          lam.lambda_cycle_lpips)
            fake_a = fwd(mb["img_b"], mb["emb_b2a"], mb["noise2"], "b2a")
            rec_b = fwd(fake_a, mb["emb_a2b"], mb["noise3"], "a2b")
            lb = rec_loss(rec_b, mb["img_b"], lam.lambda_cycle,
                          lam.lambda_cycle_lpips)
            return la + lb, {"cycle_a": la.detach(), "cycle_b": lb.detach()}

        _, parts, grads_c = gen_pass(state.gen, data, cycle)
        _apply(state.gen_opt, state.gen, grads_c)
        metrics.update(accum.mean_aux(parts))

        # ---- 2. generator GAN -----------------------------------------
        sn = state.disc_sn

        def gan_g(mb):
            fake_a = fwd(mb["img_b"], mb["emb_b2a"], mb["noise4"], "b2a")
            fake_b = fwd(mb["img_a"], mb["emb_a2b"], mb["noise5"], "a2b")
            ga = gan(losses_mod.gan_gen_loss, state.disc, sn, "a", fake_b)
            gb = gan(losses_mod.gan_gen_loss, state.disc, sn, "b", fake_a)
            return ga + gb, {"gan_a": ga.detach(), "gan_b": gb.detach(),
                             "fake_a": fake_a.detach(),
                             "fake_b": fake_b.detach()}

        _, parts, grads = gen_pass(state.gen, data, gan_g)
        fakes = {k: accum.merge_micro([p.pop(k) for p in parts])
                 for k in ("fake_a", "fake_b")}
        _apply(state.gen_opt, state.gen, grads)
        metrics.update(accum.mean_aux(parts))
        sn = sn_advance(state.disc, sn)

        # ---- 3. identity ----------------------------------------------
        def idt(mb):
            idt_a = fwd(mb["img_b"], mb["emb_a2b"], mb["noise6"], "a2b")
            li_a = rec_loss(idt_a, mb["img_b"], lam.lambda_idt,
                            lam.lambda_idt_lpips)
            idt_b = fwd(mb["img_a"], mb["emb_b2a"], mb["noise7"], "b2a")
            li_b = rec_loss(idt_b, mb["img_a"], lam.lambda_idt,
                            lam.lambda_idt_lpips)
            return li_a + li_b, {"idt_a": li_a.detach(),
                                 "idt_b": li_b.detach()}

        _, parts, grads = gen_pass(state.gen, data, idt)
        _apply(state.gen_opt, state.gen, grads)
        metrics.update(accum.mean_aux(parts))

        # ---- 4. discriminators on pass 2's fakes, detached --------------
        fake_loss = losses_mod.gan_disc_fake_loss
        loss_df, _, grads = disc_pass(
            state.disc, fakes,
            lambda mb: (gan(fake_loss, state.disc, sn, "a", mb["fake_b"])
                        + gan(fake_loss, state.disc, sn, "b", mb["fake_a"]))
            * 0.5)
        sn = sn_advance(state.disc, sn)   # the heads before the update
        _apply(state.disc_opt, state.disc, grads)
        metrics["disc_fake"] = loss_df

        # ---- 5. discriminators on the real images -----------------------
        real_loss = losses_mod.gan_disc_real_loss
        loss_dr, _, grads = disc_pass(
            state.disc, {"img_a": data["img_a"], "img_b": data["img_b"]},
            lambda mb: (gan(real_loss, state.disc, sn, "a", mb["img_b"])
                        + gan(real_loss, state.disc, sn, "b", mb["img_a"]))
            * 0.5)
        sn = sn_advance(state.disc, sn)   # the heads pass 4 left
        _apply(state.disc_opt, state.disc, grads)
        metrics["disc_real"] = loss_dr

        state.disc_sn = sn
        state.step += 1
        return metrics, (grads_c if keep_grads else None)

    return train_step
