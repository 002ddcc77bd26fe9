"""CycleGAN-Turbo: one-step unpaired translation (counterpart of
`img2img_turbo_tpu/pipelines/cyclegan.py`).

One UNet serves both directions (direction enters through the caption
embedding and the VAE: `vae_a2b` or its copy `vae_b2a`). The three UNet LoRA
adapters (encoder / decoder / others) partition the targeted modules by
name, with alpha = rank; for serving they are merged into dense weights
(`lora.merge_multi`). `CycleGANTurbo.from_pretrained` loads a local
SD-Turbo snapshot with a published or trained CycleGAN-Turbo pkl, and
tokenizes and encodes the caption.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from img2img_turbo_tpu_torch import lora as lora_mod
from img2img_turbo_tpu_torch import resolve_device, scheduler
from img2img_turbo_tpu_torch.models.layers import prepare_kernels
from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                       generate_unclamped,
                                                       lora_to, merge_into)

# named pretrained checkpoints: fixed caption + direction
# (reference cyclegan_turbo.py:126-149)
NAMED_MODELS = {
    "day_to_night": ("day2night.pkl", "driving in the night", "a2b"),
    "night_to_day": ("night2day.pkl", "driving in the day", "b2a"),
    "clear_to_rainy": ("clear2rainy.pkl", "driving in heavy rain", "a2b"),
    "rainy_to_clear": ("rainy2clear.pkl", "driving in the day", "b2a"),
}
ADAPTERS = ("default_encoder", "default_decoder", "default_others")
# the unpaired trainer's default ranks (JAX utils/config_args.py:123-124)
LORA_RANK_UNET, LORA_RANK_VAE = 128, 4


def cyclegan_unet_adapters(unet, rank: int,
                           generator: torch.Generator) -> Dict[str, Dict]:
    """The encoder / decoder / others adapter trio over the modules that
    `lora.CYCLEGAN_UNET_GREP` matches, partitioned by name (reference
    initialize_unet, cyclegan_turbo.py:48-72), alpha = rank, drawn in that
    order from `generator`."""
    parts = {a: [] for a in ADAPTERS}
    for n in lora_mod.targeted(unet, lora_mod.CYCLEGAN_UNET_GREP):
        if "down_blocks" in n or "conv_in" in n:
            parts["default_encoder"].append(n)
        elif "up_blocks" in n:
            parts["default_decoder"].append(n)
        else:
            parts["default_others"].append(n)
    return {a: lora_mod.init_lora(unet, rank, tuple(names), generator,
                                  alpha=float(rank))
            for a, names in parts.items()}


def forward_with_params(params: Dict, cfgs: GeneratorConfigs, alphas_cumprod,
                        x, caption_enc, direction: str, *, kernels: bool,
                        noise=None,
                        generator: Optional[torch.Generator] = None,
                        remat: bool = False, tp=None):
    """One translation (cyclegan.py:68-83): params {"unet", "vae_a2b",
    "vae_b2a"} modules; x (B, H, W, 3) in [-1, 1]; direction "a2b" routes
    through vae_a2b, "b2a" through vae_b2a; remat recomputes each UNet
    block in the backward (training); tp: the model axis's mesh of a UNet
    sharded over it (`generate_unclamped`). Returns (B, H, W, 3) in
    [-1, 1]."""
    if direction not in ("a2b", "b2a"):
        raise ValueError(f"direction {direction!r} is not 'a2b' or 'b2a'")
    img = generate_unclamped(params["unet"], params["vae_" + direction], cfgs,
                             alphas_cumprod, x, caption_enc, kernels=kernels,
                             noise=noise, generator=generator,
                             remat=remat, tp=tp)["img"]
    return torch.clamp(img, -1.0, 1.0)


def init_factored(cfgs: GeneratorConfigs, generator: torch.Generator,
                  rank_unet: int = LORA_RANK_UNET,
                  rank_vae: int = LORA_RANK_VAE, base=None):
    """Training init (cyclegan.py:108-133): seeded random SD-Turbo modules
    on generator.device (or `base`, a loaded (unet, vae)), vae_b2a a copy
    of vae_a2b, the UNet adapter trio at `rank_unet` and one `rank_vae`
    adapter per VAE. Returns (base {"unet", "vae_a2b", "vae_b2a"}, loras
    {"unet": {adapter: lora}, "vae_a2b", "vae_b2a"})."""
    from img2img_turbo_tpu_torch.weights import from_jax
    if base is not None:
        unet, vae = base
    else:
        unet = from_jax.random_model(cfgs.unet, generator)
        vae = from_jax.random_model(cfgs.vae, generator)
    base = {"unet": unet, "vae_a2b": vae, "vae_b2a": copy.deepcopy(vae)}
    loras = {"unet": cyclegan_unet_adapters(unet, rank_unet, generator)}
    for name in ("vae_a2b", "vae_b2a"):
        loras[name] = lora_mod.init_lora(base[name], rank_vae,
                                         lora_mod.CYCLEGAN_VAE_TARGETS,
                                         generator)
    return base, loras


def merge(base: Dict, loras: Dict) -> Dict:
    """`base`'s modules with their adapters merged in place (the UNet's
    trio by `lora.merge_multi`, each VAE's by `lora.merge_lora`): the
    dense {"unet", "vae_a2b", "vae_b2a"} that the pipeline serves."""
    for name, module in base.items():
        adapters = (list(loras["unet"].values()) if name == "unet"
                    else [loras[name]])
        with torch.no_grad():
            module.load_state_dict(lora_mod.merge_multi(
                dict(module.named_parameters()), adapters), strict=False)
    return base


class CycleGANTurbo:
    """The serving pipeline on dense (merged) modules {"unet", "vae_a2b",
    "vae_b2a"}, moved to `device` (the CUDA card unless the caller names
    another), cast to `dtype` and given their kernel layouts once, here.
    The caption goes in as an embedding (`caption_enc`) or as a string
    (`caption`) that `tokenizer` and the fp32 text tower `text` encode;
    both default to the pipeline's own, as does the direction."""

    def __init__(self, params: Optional[Dict] = None,
                 cfgs: Optional[GeneratorConfigs] = None, caption_enc=None,
                 direction: Optional[str] = None, dtype=torch.bfloat16,
                 device=None, use_kernels: bool = True,
                 caption: Optional[str] = None, text=None, tokenizer=None):
        self.cfgs = cfgs or GeneratorConfigs()
        self.caption_enc, self.direction = caption_enc, direction
        self.caption = caption
        self.dtype, self.use_kernels = dtype, use_kernels
        self.device = resolve_device(device)
        self.alphas_cumprod = scheduler.make_alphas_cumprod(device=self.device)
        self.params = None
        if params is not None:
            self.params = {k: prepare_kernels(
                m.to(device=self.device, dtype=dtype).eval())
                for k, m in params.items()}
        self.text = None if text is None else \
            text.to(device=self.device).eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self._prompt_cache: Dict[str, torch.Tensor] = {}

    @classmethod
    def from_random(cls, generator: torch.Generator,
                    cfgs: Optional[GeneratorConfigs] = None
                    ) -> "CycleGANTurbo":
        """The pipeline on `init_factored`'s weights, merged (B = 0 at
        init, so both directions start as the base model), on
        generator.device."""
        cfgs = cfgs or GeneratorConfigs()
        return cls(merge(*init_factored(cfgs, generator)), cfgs,
                   device=generator.device)

    @staticmethod
    def load_pretrained(sd_turbo_dir: str, ckpt_path: str,
                        caption: Optional[str] = None,
                        direction: Optional[str] = None,
                        cfgs: Optional[GeneratorConfigs] = None,
                        ckpt_folder: str = "checkpoints",
                        device=None) -> Dict:
        """The constructor's keyword arguments (fp32 modules on `device`);
        see `from_pretrained`."""
        from img2img_turbo_tpu_torch.utils.download import get_checkpoint
        from img2img_turbo_tpu_torch.weights import torch_import as ti
        if ckpt_path in NAMED_MODELS:
            _, caption, direction = NAMED_MODELS[ckpt_path]
            ckpt_path = get_checkpoint(ckpt_path, ckpt_folder)
        cfgs = cfgs or GeneratorConfigs()
        dev = resolve_device(device)
        snap = ti.load_snapshot(sd_turbo_dir, cfgs, dev,
                                parts=("unet", "text", "tokenizer"))
        ckpt = ti.load_torch_pickle(ckpt_path)
        rank_unet = ckpt["rank_unet"]
        # three adapters, alpha = rank (cyclegan_turbo.py:163-165)
        unet = merge_into(snap["unet"], [
            lora_to(lora_mod.lora_from_torch_state_dict(
                ckpt[k], rank=rank_unet, alpha=float(rank_unet)), dev)
            for k in ("sd_encoder", "sd_decoder", "sd_other")])
        # both VAEs whole (base weights, skip convs and LoRA) in sd_vae_enc
        # and sd_vae_dec, under "vae." and "vae_b2a."
        vaes = {}
        for prefix, name in (("vae.", "vae_a2b"), ("vae_b2a.", "vae_b2a")):
            sd = {k[len(prefix):]: v for src in ("sd_vae_enc", "sd_vae_dec")
                  for k, v in ckpt[src].items() if k.startswith(prefix)}
            vae = ti.vae_from_state_dict(
                {k.replace(".base_layer", ""): v for k, v in sd.items()
                 if ".lora_" not in k}, cfgs.vae, dev)
            vae_lora = lora_mod.lora_from_torch_state_dict(
                sd, rank=ckpt["rank_vae"])
            vaes[name] = merge_into(vae, [lora_to(vae_lora, dev)])
        return dict(params={"unet": unet, **vaes}, cfgs=cfgs,
                    caption=caption, direction=direction, text=snap["text"],
                    tokenizer=snap["tokenizer"])

    @classmethod
    def from_pretrained(cls, sd_turbo_dir: str, ckpt_path: str,
                        caption: Optional[str] = None,
                        direction: Optional[str] = None,
                        cfgs: Optional[GeneratorConfigs] = None,
                        dtype=torch.bfloat16,
                        ckpt_folder: str = "checkpoints", device=None,
                        use_kernels: bool = True) -> "CycleGANTurbo":
        """A local stabilityai/sd-turbo snapshot (its UNet, text encoder
        and tokenizer) with a CycleGAN-Turbo pkl (schema:
        train_cyclegan_turbo.py:293-307, loader cyclegan_turbo.py:162-190):
        the UNet's three adapters merged at alpha = rank, both VAEs built
        from the pkl's sd_vae_enc / sd_vae_dec with their LoRA merged.
        ckpt_path may be a published model name (NAMED_MODELS), which then
        fixes the caption and direction, found in `ckpt_folder`."""
        return cls(**cls.load_pretrained(sd_turbo_dir, ckpt_path, caption,
                                         direction, cfgs, ckpt_folder,
                                         device),
                   dtype=dtype, device=device, use_kernels=use_kernels)

    @torch.no_grad()
    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """(1, 77, cross_dim) caption embedding in the pipeline's dtype,
        cached per prompt string."""
        if prompt not in self._prompt_cache:
            if self.tokenizer is None or self.text is None:
                raise ValueError("no tokenizer and text encoder: give "
                                 "caption_enc")
            ids = torch.as_tensor(self.tokenizer(prompt),
                                  device=self.device).long()
            self._prompt_cache[prompt] = self.text(ids).to(self.dtype)
        return self._prompt_cache[prompt]

    @torch.no_grad()
    def __call__(self, x, direction: Optional[str] = None, caption_enc=None,
                 noise=None, generator: Optional[torch.Generator] = None,
                 caption: Optional[str] = None):
        """x: (B, H, W, 3) in [-1, 1]. Returns the translated batch in
        [-1, 1]. direction and the caption default to the pipeline's own
        (cyclegan.py:207-222): a given caption_enc, else `caption` or the
        pipeline's caption encoded, else the pipeline's caption_enc; the
        posterior noise is `noise`, or drawn from `generator` (seed 0 when
        None)."""
        if self.params is None:
            raise ValueError("no merged weights: build the pipeline with "
                             "params")
        direction = direction or self.direction
        if caption_enc is None:
            text = caption or self.caption
            caption_enc = self.encode_prompt(text) if text is not None \
                else self.caption_enc
        if caption_enc is None:
            raise ValueError("give caption_enc or a caption")
        x = x.to(device=self.device, dtype=self.dtype)
        caption_enc = caption_enc.to(device=self.device, dtype=self.dtype)
        if caption_enc.shape[0] != x.shape[0]:
            caption_enc = caption_enc.expand(x.shape[0],
                                             *caption_enc.shape[1:])
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return forward_with_params(
            self.params, self.cfgs, self.alphas_cumprod, x,
            caption_enc.contiguous(), direction, kernels=self.use_kernels,
            noise=noise, generator=generator)
