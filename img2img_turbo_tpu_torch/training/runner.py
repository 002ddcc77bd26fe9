"""Random-init model assembly for a paired or an unpaired run (counterpart
of the offline branch of `img2img_turbo_tpu/training/runner.py:85-125`,
`load_base_models` and `init_aux_models`, and of the model set-up of
`cli/train_cyclegan_turbo.py:45-70`). Pretrained SD-Turbo, CLIP, LPIPS
and VGG weights are not in the repository, so every model is drawn from a
seeded torch.Generator on the device it will run on, following the JAX
package's init scheme: convs and linears U(+-1/sqrt(fan_in)) (weight and
bias), norms 1 and 0, embeddings and CLIP's class / position embeddings
N(0, 0.02), projections N(0, 1/width), the LPIPS heads |N(0, 0.01)|, the
VAE skip zero-convs 1e-5. The training CLIs are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from img2img_turbo_tpu_torch import lora as lora_mod
from img2img_turbo_tpu_torch.models import clip_vit, discriminator
from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
from img2img_turbo_tpu_torch.models.vgg_lpips import VGGLPIPS
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.weights import from_jax


LEARNING_RATE = 5e-6   # the reference trainers' --learning_rate default


@torch.no_grad()
def random_init(build, generator: torch.Generator) -> nn.Module:
    """`build()` allocated on the generator's device (never on the host
    first) and filled in parameter order."""
    with torch.device("meta"):
        model = build()
    model = model.to_empty(device=generator.device)
    mods = dict(model.named_modules())
    for name, p in model.named_parameters():
        mod_name, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = mods[mod_name]
        if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif isinstance(mod, nn.Embedding) or leaf == "class_embedding":
            p.normal_(0.0, 0.02, generator=generator)
        elif mod_name.startswith("lins."):
            p.normal_(0.0, 0.1, generator=generator).abs_()
        elif mod_name.endswith("_projection"):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
        elif leaf == "logit_scale":
            p.fill_(math.log(1 / 0.07))
        else:
            bound = 1.0 / math.sqrt(math.prod(mod.weight.shape[1:]))
            p.uniform_(-bound, bound, generator=generator)
    return model


def load_base_models(cfgs: GeneratorConfigs, generator: torch.Generator):
    """(unet, vae, text encoder), seeded random, fp32, on the generator's
    device; the VAE skip convs start at 1e-5 (the reference's zero-convs)."""
    unet = from_jax.random_model(cfgs.unet, generator)
    vae = from_jax.random_model(cfgs.vae, generator)
    text = random_init(lambda: CLIPTextModel(cfgs.text), generator)
    return unet, vae, text


def init_aux_models(clip_cfg: clip_vit.CLIPViTConfig,
                    generator: torch.Generator):
    """(lpips, disc_backbone, clip, disc heads, disc sn): VGG16 +
    LPIPS heads, the discriminator's frozen CLIP vision tower, the CLIP
    model of the CLIP-sim loss (separate weights, as the JAX runner draws
    them), and the discriminator heads with their spectral-norm vectors."""
    lpips = random_init(VGGLPIPS, generator)
    backbone = random_init(lambda: clip_vit.CLIPVision(clip_cfg), generator)
    heads, sn = discriminator.init_heads(clip_cfg, generator)
    clip = random_init(lambda: clip_vit.CLIPModel(clip_cfg), generator)
    for m in (lpips, backbone, clip):
        m.requires_grad_(False)
    return lpips, backbone, clip, heads, sn


def init_loras(unet, vae, generator: torch.Generator):
    """Gaussian LoRA on the pix2pix targets, rank 8 on the UNet and 4 on
    the VAE (reference pix2pix_turbo.py:131-155; peft's default alpha 8)."""
    return (lora_mod.init_lora(unet, 8, lora_mod.PIX2PIX_UNET_TARGETS,
                               generator),
            lora_mod.init_lora(vae, 4, lora_mod.PIX2PIX_VAE_TARGETS,
                               generator))


def build_paired_run(cfgs: GeneratorConfigs,
                     clip_cfg: clip_vit.CLIPViTConfig, seed: int = 0,
                     device=None):
    """Everything a paired run starts from, drawn from `seed` on `device`
    (the CUDA card unless the caller names another; without a card the
    caller must pass device="cpu"): (PairedModels, a TrainState with the
    reference's constant learning rate, LoraMeta); UNet LoRA rank 8 and VAE
    rank 4 (pix2pix_turbo.py:131-155)."""
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.training import optim, paired
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    unet, vae, text = load_base_models(cfgs, generator)
    text.requires_grad_(False)
    lpips, backbone, clip, heads, sn = init_aux_models(clip_cfg, generator)
    gen, meta = paired.split_trainable(unet, vae,
                                       *init_loras(unet, vae, generator))
    sched = optim.make_lr_schedule("constant", LEARNING_RATE, 0, 1)
    state = paired.make_state(gen, heads, sn, sched, sched)
    return paired.PairedModels(unet, vae, text, lpips, backbone, clip), \
        state, meta


def build_unpaired_run(cfgs: GeneratorConfigs,
                       clip_cfg: clip_vit.CLIPViTConfig, seed: int = 0,
                       device=None):
    """Everything an unpaired (CycleGAN-Turbo) run starts from, drawn from
    `seed` on `device` (the CUDA card unless the caller names another;
    without a card the caller must pass device="cpu"): (UnpairedModels, a
    TrainState with the reference's constant learning rate and the unpaired
    clip norm, CycleLoraMeta). The UNet, vae_a2b and its copy vae_b2a, the
    UNet adapter trio at rank 128 and a rank-4 adapter on each VAE
    (`cyclegan.init_factored`); LPIPS; one frozen CLIP vision backbone
    shared by two sets of discriminator heads and spectral-norm vectors.
    No text encoder or CLIP-sim model: the step takes fixed caption
    embeddings (cli/train_cyclegan_turbo.py:45-52)."""
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.pipelines import cyclegan
    from img2img_turbo_tpu_torch.training import optim, unpaired
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    base, loras = cyclegan.init_factored(cfgs, generator)
    lpips = random_init(VGGLPIPS, generator)
    backbone = random_init(lambda: clip_vit.CLIPVision(clip_cfg), generator)
    for m in (lpips, backbone):
        m.requires_grad_(False)
    disc, sn = {}, {}
    for name in ("a", "b"):
        heads, u = discriminator.init_heads(clip_cfg, generator)
        disc.update({f"{name}:{k}": v for k, v in heads.items()})
        sn.update({f"{name}:{k}": v for k, v in u.items()})
    gen, meta = unpaired.split_trainable(
        base["unet"], base["vae_a2b"], base["vae_b2a"], loras["unet"],
        loras["vae_a2b"], loras["vae_b2a"])
    sched = optim.make_lr_schedule("constant", LEARNING_RATE, 0, 1)
    state = unpaired.make_state(gen, disc, sn, sched, sched)
    models = unpaired.UnpairedModels(base["unet"], base["vae_a2b"],
                                     base["vae_b2a"], lpips, backbone)
    return models, state, meta
