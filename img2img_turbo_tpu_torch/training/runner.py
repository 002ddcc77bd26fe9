"""Shared training-run machinery (counterpart of
`img2img_turbo_tpu/training/runner.py` and of the model set-up of the two
training CLIs): the metrics tracker, the configs a CLI's flags select, and
the model assembly of a paired or an unpaired run.

Tracker: a JSON line per logged step in `<output_dir>/metrics.jsonl`,
always, and wandb as well when it is installed and asked for (the
reference logs through accelerate's trackers, train_pix2pix_turbo.py:
140-142, 232-241).

Weights: a local SD-Turbo snapshot (`load_base_models`, with its BPE
tokenizer), a CLIP file (`init_aux_models`: one file feeds the
discriminator backbone and the CLIP-sim model), an LPIPS file and an
Inception file (`init_inception`) are read when a CLI names them
(--sd_turbo_path, --clip_weights, --lpips_weights, --inception_weights).
Whatever is not named is drawn from a seeded torch.Generator on the device
it will run on, following the JAX package's init scheme: convs and linears
U(+-1/sqrt(fan_in)) (weight and bias), norms 1 and 0, embeddings and
CLIP's class / position embeddings N(0, 0.02), projections N(0, 1/width),
the LPIPS heads |N(0, 0.01)|, the VAE skip zero-convs 1e-5.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from img2img_turbo_tpu_torch import configs
from img2img_turbo_tpu_torch import lora as lora_mod
from img2img_turbo_tpu_torch.models import clip_vit, discriminator
from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
from img2img_turbo_tpu_torch.models.vgg_lpips import (VGGLPIPS,
                                                      load_lpips_weights)
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.weights import from_jax
from img2img_turbo_tpu_torch.weights import torch_import as ti


LEARNING_RATE = 5e-6   # the reference trainers' --learning_rate default


def make_tracker(report_to: str, project: str, output_dir: str,
                 config: Dict) -> Callable[[Dict, int], None]:
    """log(metrics, step): appends {metrics..., "step", "time"} as one JSON
    line to <output_dir>/metrics.jsonl, and logs to wandb too when
    report_to == "wandb" and wandb starts (runner.py:26-49). On a rank
    other than 0 of a data-parallel run it writes nothing and logs
    nothing."""
    from img2img_turbo_tpu_torch.parallel.mesh import is_main_process
    if not is_main_process():
        return lambda metrics, step: None
    os.makedirs(output_dir, exist_ok=True)
    jsonl_path = os.path.join(output_dir, "metrics.jsonl")
    wandb_run = None
    if report_to == "wandb":
        try:
            import wandb
            wandb_run = wandb.init(project=project, config=config,
                                   dir=output_dir)
        except Exception as err:   # not installed, or no network
            print(f"wandb not used ({type(err).__name__}: {err}); metrics "
                  f"go to {jsonl_path} only", flush=True)

    def log(metrics: Dict, step: int) -> None:
        row = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()}
        row["step"] = step
        row["time"] = time.time()
        with open(jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if wandb_run is not None:
            wandb_run.log(metrics, step=step)

    return log


def generator_configs(args) -> GeneratorConfigs:
    """SD-Turbo's configs, or the TINY ones under --tiny_model."""
    if getattr(args, "tiny_model", False):
        return GeneratorConfigs(unet=configs.TINY_UNET, vae=configs.TINY_VAE,
                                text=configs.TINY_TEXT)
    return GeneratorConfigs()


def clip_config(args) -> clip_vit.CLIPViTConfig:
    """CLIP ViT-B/32, or TINY_CLIP_VIT under --tiny_model."""
    if getattr(args, "tiny_model", False):
        return clip_vit.TINY_CLIP_VIT
    return clip_vit.CLIP_VIT_B32


# the VAE modules of a paired run (`vae`) and of an unpaired one
VAE_MODULES = ("vae", "vae_a2b", "vae_b2a")


def shard_for_training(models, mesh, state=None):
    """Shard `models.unet` and every VAE of the run (`models.vae`, or
    `models.vae_a2b` and `models.vae_b2a`) over the model axis of `mesh`
    in place (`parallel.tensor.shard_module`, JAX's rule with departures
    (a)-(e): the trainable conv_in and skip convs and the VAE's one-head
    mid attentions whole), as the JAX dry run shards its frozen UNet and
    VAE, once every rank of the model group is checked to hold the same
    frozen modules and train state (the CLIs check the data group before).
    Call it before building a step under that mesh; without a model axis
    it does nothing. Returns `models`."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
    if mesh is None or mesh.n_model == 1:
        return models
    whole = {k: v for k, v in vars(models).items()
             if isinstance(v, nn.Module)}
    mesh_mod.assert_replicated({**whole, "train state": state}, mesh,
                               "the frozen modules or the train state",
                               axis="model")
    tensor_mod.shard_module(models.unet, mesh,
                            tensor_mod.head_dim(models.unet.cfg))
    for name in VAE_MODULES:
        vae = getattr(models, name, None)
        if vae is not None:
            tensor_mod.shard_module(vae, mesh,
                                    tensor_mod.vae_head_dim(vae.cfg))
    return models


def activation_dtype(mixed_precision: Optional[str], device) -> torch.dtype:
    """bf16 under --mixed_precision bf16, else fp32, as the JAX CLI casts
    its batch (cli/train_pix2pix_turbo.py:145-149). The port's kernels take
    bf16 only, so on a CUDA device any other dtype stops the run here
    rather than fall back to the plain path."""
    dtype = torch.bfloat16 if mixed_precision == "bf16" else torch.float32
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(
            f"--mixed_precision {mixed_precision}: on a CUDA device the "
            f"port trains through its Hopper kernels, which take bf16 "
            f"activations only; pass --mixed_precision bf16 (fp32 "
            f"activations run only on the CPU, device='cpu')")
    return dtype


def init_inception(args, generator: torch.Generator):
    """The FID feature extractor on generator.device: a torchvision
    inception_v3 state dict from --inception_weights, folded
    (`metrics.inception.convert_inception_state_dict`), or seeded random
    (the JAX init)."""
    from img2img_turbo_tpu_torch.metrics import inception
    path = getattr(args, "inception_weights", "")
    if not path:
        return inception.random_inception(generator)
    sd = _state_dict_of(ti.load_torch_pickle(path))
    return ti.load_into(ti.build_on(inception.InceptionV3, generator.device),
                        inception.convert_inception_state_dict(sd)
                        ).requires_grad_(False).eval()


def _state_dict_of(obj):
    return obj["state_dict"] if isinstance(obj, dict) and "state_dict" in obj \
        else obj


class SmokeTokenizer:
    """Word-hash ids for runs with no CLIP vocabulary on disk, i.e. without
    --sd_turbo_path (smoke runs and tests; runner.py:141-156). Not a
    tokenizer: ids come from Python's hash() of each word, as in the JAX
    package, so they change with PYTHONHASHSEED unless it is fixed."""

    model_max_length = 77

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, text):
        words = (text if isinstance(text, str) else " ".join(text)).split()
        ids = [(abs(hash(w)) % (self.vocab_size - 3)) + 1
               for w in words][:75]
        return np.asarray([[49406 % self.vocab_size] + ids
                           + [0] * (76 - len(ids))], np.int32)


def check_tokenizer(tok, mesh) -> None:
    """Over several ranks, stop unless every rank's tokenizer gives the
    same ids: `SmokeTokenizer`'s come from hash(), which differs between
    processes unless PYTHONHASHSEED is fixed for all of them."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    ids = torch.as_tensor(np.asarray(tok("a photo of a red bird")))
    for axis in ("data", "model"):
        mesh_mod.assert_replicated(
            {"prompt ids": ids}, mesh,
            "the tokenizer's ids (without --sd_turbo_path the word-hash "
            "SmokeTokenizer needs the same PYTHONHASHSEED on every rank)",
            axis)


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


def load_base_models(cfgs: GeneratorConfigs, generator: torch.Generator,
                     sd_turbo_path: Optional[str] = None):
    """(unet, vae, text encoder, tokenizer), fp32 on the generator's
    device: from a local SD-Turbo snapshot with its BPE tokenizer
    (runner.py:65-88), or seeded random with tokenizer None (the VAE skip
    convs at 1e-5, the reference's zero-convs)."""
    if sd_turbo_path:
        snap = ti.load_snapshot(sd_turbo_path, cfgs, generator.device)
        return snap["unet"], snap["vae"], snap["text"], snap["tokenizer"]
    unet = from_jax.random_model(cfgs.unet, generator)
    vae = from_jax.random_model(cfgs.vae, generator)
    text = random_init(lambda: CLIPTextModel(cfgs.text), generator)
    return unet, vae, text, None


def init_aux_models(clip_cfg: clip_vit.CLIPViTConfig,
                    generator: torch.Generator, with_clipsim: bool = True,
                    clip_weights: Optional[str] = None,
                    lpips_weights: Optional[str] = None):
    """(lpips, disc_backbone, clip, disc heads, disc sn): VGG16 +
    LPIPS heads, the discriminator's frozen CLIP vision tower, the CLIP
    model of the CLIP-sim loss (None without `with_clipsim`, runner.py:91),
    and the discriminator heads with their spectral-norm vectors. A
    `clip_weights` file feeds both the backbone and the CLIP-sim model,
    an `lpips_weights` file the LPIPS network (runner.py:91-125); what no
    file names is seeded random (separate weights for the two CLIPs, as
    the JAX runner draws them)."""
    dev = generator.device
    if lpips_weights:
        lpips = ti.load_into(ti.build_on(VGGLPIPS, dev),
                             load_lpips_weights(lpips_weights))
    else:
        lpips = random_init(VGGLPIPS, generator)
    clip_sd = None
    if clip_weights:   # an OpenAI or transformers CLIP file
        clip_sd = clip_vit.convert_clip_state_dict(
            _state_dict_of(ti.load_torch_pickle(clip_weights)), clip_cfg)
    if clip_sd is not None:
        backbone = ti.load_into(
            ti.build_on(lambda: clip_vit.CLIPVision(clip_cfg), dev),
            {k: v for k, v in clip_sd.items()
             if k.startswith(("vision_model.", "visual_projection."))})
    else:
        backbone = random_init(lambda: clip_vit.CLIPVision(clip_cfg),
                               generator)
    heads, sn = discriminator.init_heads(clip_cfg, generator)
    clip = None
    if with_clipsim:
        clip = (ti.load_into(ti.build_on(
            lambda: clip_vit.CLIPModel(clip_cfg), dev), clip_sd)
            if clip_sd is not None else
            random_init(lambda: clip_vit.CLIPModel(clip_cfg), generator))
    for m in (lpips, backbone, clip):
        if m is not None:
            m.requires_grad_(False)
    return lpips, backbone, clip, heads, sn


def init_loras(unet, vae, generator: torch.Generator, rank_unet: int = 8,
               rank_vae: int = 4):
    """Gaussian LoRA on the pix2pix targets, rank 8 on the UNet and 4 on
    the VAE by default (reference pix2pix_turbo.py:131-155; peft's default
    alpha 8)."""
    return (lora_mod.init_lora(unet, rank_unet, lora_mod.PIX2PIX_UNET_TARGETS,
                               generator),
            lora_mod.init_lora(vae, rank_vae, lora_mod.PIX2PIX_VAE_TARGETS,
                               generator))


def _schedule(lr_schedule):
    if lr_schedule is not None:
        return lr_schedule
    from img2img_turbo_tpu_torch.training import optim
    return optim.make_lr_schedule("constant", LEARNING_RATE, 0, 1)


def build_paired_run(cfgs: GeneratorConfigs,
                     clip_cfg: clip_vit.CLIPViTConfig, seed: int = 0,
                     device=None, *, lr_schedule: Optional[Callable] = None,
                     adam_kwargs: Optional[Dict] = None, rank_unet: int = 8,
                     rank_vae: int = 4, with_clipsim: bool = True,
                     base: Optional[tuple] = None,
                     clip_weights: Optional[str] = None,
                     lpips_weights: Optional[str] = None):
    """Everything a paired run starts from, drawn from `seed` on `device`
    (the CUDA card unless the caller names another; without a card the
    caller must pass device="cpu"): (PairedModels, a TrainState, LoraMeta).
    The state's AdamWs follow `lr_schedule` (count -> learning rate; the
    reference's constant LEARNING_RATE when None) and `adam_kwargs`
    (beta1, beta2, eps, weight_decay, max_grad_norm; AdamW's defaults when
    None); LoRA at `rank_unet` and `rank_vae` (pix2pix_turbo.py:131-155);
    no CLIP-sim model without `with_clipsim`. `base`: (unet, vae, text)
    already loaded (`load_base_models` from a snapshot) in place of random
    ones; `clip_weights` / `lpips_weights` as in `init_aux_models`."""
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.training import paired
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    unet, vae, text = base if base is not None \
        else load_base_models(cfgs, generator)[:3]
    text.requires_grad_(False)
    lpips, backbone, clip, heads, sn = init_aux_models(
        clip_cfg, generator, with_clipsim, clip_weights, lpips_weights)
    gen, meta = paired.split_trainable(
        unet, vae, *init_loras(unet, vae, generator, rank_unet, rank_vae))
    sched = _schedule(lr_schedule)
    state = paired.make_state(gen, heads, sn, sched, sched,
                              **(adam_kwargs or {}))
    return paired.PairedModels(unet, vae, text, lpips, backbone, clip), \
        state, meta


def build_unpaired_run(cfgs: GeneratorConfigs,
                       clip_cfg: clip_vit.CLIPViTConfig, seed: int = 0,
                       device=None, *, lr_schedule: Optional[Callable] = None,
                       adam_kwargs: Optional[Dict] = None,
                       rank_unet: Optional[int] = None,
                       rank_vae: Optional[int] = None,
                       base: Optional[tuple] = None,
                       clip_weights: Optional[str] = None,
                       lpips_weights: Optional[str] = None):
    """Everything an unpaired (CycleGAN-Turbo) run starts from, drawn from
    `seed` on `device` (the CUDA card unless the caller names another;
    without a card the caller must pass device="cpu"): (UnpairedModels, a
    TrainState, CycleLoraMeta). The UNet, vae_a2b and its copy vae_b2a, the
    UNet adapter trio at `rank_unet` and an adapter at `rank_vae` on each
    VAE (`cyclegan.init_factored`; the unpaired trainer's 128 and 4 when
    None); LPIPS; one frozen CLIP vision backbone shared by two sets of
    discriminator heads and spectral-norm vectors. The AdamWs follow
    `lr_schedule` and `adam_kwargs` as in `build_paired_run` (the clip
    norm defaults to the unpaired trainer's). No text encoder or CLIP-sim
    model: the step takes fixed caption embeddings
    (cli/train_cyclegan_turbo.py:45-52). `base`: (unet, vae) already
    loaded, in place of random ones; `clip_weights` (the backbone) and
    `lpips_weights` as in `init_aux_models`."""
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.pipelines import cyclegan
    from img2img_turbo_tpu_torch.training import unpaired
    generator = torch.Generator(device=resolve_device(device))
    generator.manual_seed(seed)
    base, loras = cyclegan.init_factored(
        cfgs, generator, rank_unet or cyclegan.LORA_RANK_UNET,
        rank_vae or cyclegan.LORA_RANK_VAE, base=base)
    lpips, backbone, _, heads, u = init_aux_models(
        clip_cfg, generator, False, clip_weights, lpips_weights)
    disc = {f"a:{k}": v for k, v in heads.items()}
    sn = {f"a:{k}": v for k, v in u.items()}
    heads, u = discriminator.init_heads(clip_cfg, generator)
    disc.update({f"b:{k}": v for k, v in heads.items()})
    sn.update({f"b:{k}": v for k, v in u.items()})
    gen, meta = unpaired.split_trainable(
        base["unet"], base["vae_a2b"], base["vae_b2a"], loras["unet"],
        loras["vae_a2b"], loras["vae_b2a"])
    sched = _schedule(lr_schedule)
    state = unpaired.make_state(gen, disc, sn, sched, sched,
                                **(adam_kwargs or {}))
    models = unpaired.UnpairedModels(base["unet"], base["vae_a2b"],
                                     base["vae_b2a"], lpips, backbone)
    return models, state, meta
