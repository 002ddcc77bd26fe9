"""Pix2Pix-Turbo (counterpart of `img2img_turbo_tpu/pipelines/pix2pix.py`):
the generators, VAE encode (posterior sample) -> UNet at t=999 ->
closed-form x0 -> skip-fused VAE decode, on LoRA-merged weights
(deterministic) or with LoRA merged at a runtime scale r, the TwinConv
blend and decoder gamma = r (stochastic, the sketch path); and
`Pix2PixTurbo`, the user-facing pipeline that loads an SD-Turbo snapshot
and a reference pkl, tokenizes and encodes prompts and runs either path.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional

import torch

from img2img_turbo_tpu_torch import configs
from img2img_turbo_tpu_torch import lora as lora_mod
from img2img_turbo_tpu_torch import resolve_device, scheduler
from img2img_turbo_tpu_torch.models.layers import (has_kernel_layouts,
                                                   prepare_kernels)
from img2img_turbo_tpu_torch.models.unet import make_twin_conv_in
from img2img_turbo_tpu_torch.utils import profiling


class GeneratorConfigs:
    def __init__(self, unet=configs.SD_TURBO_UNET, vae=configs.SD_TURBO_VAE,
                 text=configs.SD_TURBO_TEXT):
        self.unet, self.vae, self.text = unet, vae, text


def generate_unclamped(unet, vae, cfgs: GeneratorConfigs, alphas_cumprod, c_t,
                       caption_enc, *, kernels: bool, noise=None,
                       generator: Optional[torch.Generator] = None,
                       remat: bool = False, r=None, noise_map=None,
                       tp=None):
    """The generator core on (B, H, W, 3) input. Returns {"z": the scaled
    latent, "x0": the denoised latent, "img": the decoded image before the
    clamp} (the serving engine rounds "img" to uint8). remat recomputes
    each UNet block in the backward (training). With r (a float or 0-d
    tensor) the stochastic path's blends: unet_in = z*r + noise_map*(1-r),
    the UNet's TwinConv at r and decoder gamma = r (pix2pix.py:72-81); the
    caller has merged LoRA at r. tp: the model axis's mesh of a UNet
    sharded over it (`UNet2DConditionModel.forward`), and of the VAE when
    that is sharded too (training; a whole VAE ignores it)."""
    s = cfgs.vae.scaling_factor
    with profiling.span("i2i.gen.encode"):
        z, skips = vae.encode(c_t, kernels=kernels, noise=noise,
                              generator=generator, tp=tp)
        z = z * s
    with profiling.span("i2i.gen.unet"):
        unet_in, gamma = z, 1.0
        if r is not None:
            r_ = torch.as_tensor(r, dtype=z.dtype, device=z.device)
            unet_in = z * r_ + noise_map.to(z.dtype) * (1.0 - r_)
            gamma = r
        t = torch.full((c_t.shape[0],), scheduler.ONE_STEP_T,
                       dtype=torch.long, device=c_t.device)
        eps = unet(unet_in, t, caption_enc, kernels=kernels, remat=remat,
                   r=r, tp=tp)
        x0 = scheduler.ddpm_x0_step(eps, unet_in, t, alphas_cumprod)
    with profiling.span("i2i.gen.decode"):
        img = vae.decode(x0 / s, skips, gamma=gamma, kernels=kernels, tp=tp)
    return {"z": z, "x0": x0, "img": img}


def generate_deterministic(unet, vae, cfgs: GeneratorConfigs, alphas_cumprod,
                           c_t, caption_enc, *, kernels: bool = True,
                           noise=None,
                           generator: Optional[torch.Generator] = None,
                           remat: bool = False, tp=None):
    """unet / vae: the LoRA-merged modules. c_t: (B, H, W, 3) in [0, 1]
    (edge map) or [-1, 1]; caption_enc: (B, 77, cross_dim). Returns
    (B, H, W, 3) in [-1, 1]. remat and tp: as in `generate_unclamped`
    (pix2pix.py:31-57)."""
    img = generate_unclamped(unet, vae, cfgs, alphas_cumprod, c_t,
                             caption_enc, kernels=kernels, noise=noise,
                             generator=generator, remat=remat, tp=tp)["img"]
    return torch.clamp(img, -1.0, 1.0)


@contextlib.contextmanager
def lora_merged_at(unet, vae, lora: Dict, r):
    """Within the block, `unet` and `vae` hold their base weights with the
    factored adapters lora["unet"] / lora["vae"] merged at scale r (a
    float or 0-d tensor), through `lora.swap_params`: the modules run their
    live-weight path, so they must not hold kernel layouts
    (`prepare_kernels`), which would be stale."""
    for m in (unet, vae):
        if any(has_kernel_layouts(sub) for sub in m.modules()):
            raise ValueError("the stochastic path merges LoRA per call: run "
                             "it on modules without kernel layouts")
    merged = {name: lora_mod.merge_lora(dict(m.named_parameters()),
                                        lora[name], scale=r)
              for name, m in (("unet", unet), ("vae", vae))}
    with lora_mod.swap_params(unet, merged["unet"]), \
            lora_mod.swap_params(vae, merged["vae"]):
        yield


def generate_stochastic(unet, vae, lora: Dict, cfgs: GeneratorConfigs,
                        alphas_cumprod, c_t, caption_enc, r, noise_map, *,
                        kernels: bool = True, noise=None,
                        generator: Optional[torch.Generator] = None):
    """The stochastic sketch path (pix2pix.py:60-82). unet: with a TwinConv
    conv_in (`models.unet.make_twin_conv_in`); unet / vae hold the base
    weights and no kernel layouts; lora: {"unet", "vae"} factored adapters,
    merged at r; r: a float or 0-d tensor in [0, 1]; noise_map:
    (B, H/8, W/8, 4); the posterior noise is `noise`, or drawn from
    `generator`. Returns (B, H, W, 3) in [-1, 1]."""
    with lora_merged_at(unet, vae, lora, r):
        img = generate_unclamped(unet, vae, cfgs, alphas_cumprod, c_t,
                                 caption_enc, kernels=kernels, noise=noise,
                                 generator=generator, r=r,
                                 noise_map=noise_map)["img"]
    return torch.clamp(img, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def lora_to(lora: Dict, device) -> Dict:
    """An adapter with its factors moved to `device` (fp32 kept)."""
    return dict(lora, modules={n: {k: t.to(device) for k, t in e.items()}
                               for n, e in lora["modules"].items()})


def merge_into(module: torch.nn.Module, loras, scale=1.0) -> torch.nn.Module:
    """`module` with `loras` merged into its weights, in place
    (`lora.merge_multi`, one adapter after the other)."""
    with torch.no_grad():
        module.load_state_dict(lora_mod.merge_multi(
            dict(module.named_parameters()), list(loras), scale),
            strict=False)
    return module


class Pix2PixTurbo:
    """The pix2pix-turbo pipeline (pix2pix.py:90-351) on one device (the
    CUDA card unless the caller names another), modules cast to `dtype`:
    - params {"unet", "vae"}: LoRA-merged modules for the deterministic
      path, given their kernel layouts once, here;
    - base {"unet" (TwinConv conv_in on the sketch model), "vae"} and lora
      {"unet", "vae"} (factored, fp32): the stochastic path, which merges
      LoRA at r per call and so runs the live-weight path (no kernel
      layouts);
    - text (CLIP text tower, kept fp32) and tokenizer for prompts.
    `use_kernels=False` runs the plain PyTorch path on the same weights."""

    def __init__(self, cfgs: Optional[GeneratorConfigs] = None,
                 params: Optional[Dict] = None, base: Optional[Dict] = None,
                 lora: Optional[Dict] = None, text=None, tokenizer=None,
                 dtype=torch.bfloat16, device=None, use_kernels: bool = True):
        self.cfgs = cfgs or GeneratorConfigs()
        self.dtype, self.use_kernels = dtype, use_kernels
        self.device = resolve_device(device)
        self.alphas_cumprod = scheduler.make_alphas_cumprod(device=self.device)
        self.params = None if params is None else {
            k: prepare_kernels(m.to(device=self.device, dtype=dtype).eval())
            for k, m in params.items()}
        self.base = None if base is None else {
            k: m.to(device=self.device, dtype=dtype).eval()
            for k, m in base.items()}
        self.lora = None if lora is None else {
            k: lora_to(v, self.device) for k, v in lora.items()}
        self.text = None if text is None else \
            text.to(device=self.device).eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self._prompt_cache: Dict[str, torch.Tensor] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def from_random(cls, generator: torch.Generator,
                    cfgs: Optional[GeneratorConfigs] = None,
                    lora_rank_unet: int = 8, lora_rank_vae: int = 4,
                    dtype=torch.bfloat16) -> "Pix2PixTurbo":
        """The training init (pix2pix.py:126-149) on generator.device:
        seeded random modules (skip convs at 1e-5), Gaussian LoRA with B =
        0 on the pix2pix targets, a random text tower; base + lora, no
        merged params (`merge()` makes them)."""
        from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
        from img2img_turbo_tpu_torch.training.runner import random_init
        from img2img_turbo_tpu_torch.weights import from_jax
        cfgs = cfgs or GeneratorConfigs()
        unet = from_jax.random_model(cfgs.unet, generator)
        vae = from_jax.random_model(cfgs.vae, generator)
        lora = {"unet": lora_mod.init_lora(unet, lora_rank_unet,
                                           lora_mod.PIX2PIX_UNET_TARGETS,
                                           generator),
                "vae": lora_mod.init_lora(vae, lora_rank_vae,
                                          lora_mod.PIX2PIX_VAE_TARGETS,
                                          generator)}
        text = random_init(lambda: CLIPTextModel(cfgs.text), generator)
        return cls(cfgs, base={"unet": unet, "vae": vae}, lora=lora,
                   text=text, dtype=dtype, device=generator.device)

    @staticmethod
    def load_pretrained(sd_turbo_dir: str, ckpt_path: Optional[str],
                        stochastic: bool = False,
                        cfgs: Optional[GeneratorConfigs] = None,
                        ckpt_folder: str = "checkpoints",
                        device=None) -> Dict:
        """The constructor's keyword arguments (fp32 modules on `device`)
        from a local SD-Turbo snapshot and a reference pkl (schema:
        pix2pix_turbo.py:221-229); see `from_pretrained`."""
        from img2img_turbo_tpu_torch.utils.download import (MODEL_FILES,
                                                            get_checkpoint)
        from img2img_turbo_tpu_torch.weights import torch_import as ti
        if ckpt_path in MODEL_FILES:
            stochastic = stochastic or \
                ckpt_path == "sketch_to_image_stochastic"
            ckpt_path = get_checkpoint(ckpt_path, ckpt_folder)
        cfgs = cfgs or GeneratorConfigs()
        dev = resolve_device(device)
        snap = ti.load_snapshot(sd_turbo_dir, cfgs, dev)
        unet, vae = snap["unet"], snap["vae"]
        out = dict(cfgs=cfgs, text=snap["text"], tokenizer=snap["tokenizer"])
        if ckpt_path is None:
            return dict(out, params={"unet": unet, "vae": vae})

        ckpt = ti.load_torch_pickle(ckpt_path)
        sd_unet, sd_vae = ckpt["state_dict_unet"], ckpt["state_dict_vae"]
        lora = {"unet": lora_mod.lora_from_torch_state_dict(
                    sd_unet, rank=ckpt["rank_unet"]),
                "vae": lora_mod.lora_from_torch_state_dict(
                    sd_vae, rank=ckpt["rank_vae"])}
        lora = {k: lora_to(v, dev) for k, v in lora.items()}
        # the retrained plain weights: conv_in and the skip convs
        lora_mod.overlay_base_weights(unet, sd_unet)
        lora_mod.overlay_base_weights(vae, sd_vae)
        if stochastic:
            make_twin_conv_in(unet)
            twin = {k: v for k, v in sd_unet.items()
                    if k.startswith(("conv_in.conv_in_pretrained.",
                                     "conv_in.conv_in_curr."))}
            with torch.no_grad():
                unet.load_state_dict(twin, strict=False)
            return dict(out, base={"unet": unet, "vae": vae}, lora=lora)
        merge_into(unet, [lora["unet"]])
        merge_into(vae, [lora["vae"]])
        return dict(out, params={"unet": unet, "vae": vae})

    @classmethod
    def from_pretrained(cls, sd_turbo_dir: str, ckpt_path: Optional[str],
                        stochastic: bool = False,
                        cfgs: Optional[GeneratorConfigs] = None,
                        dtype=torch.bfloat16,
                        ckpt_folder: str = "checkpoints",
                        device=None, use_kernels: bool = True
                        ) -> "Pix2PixTurbo":
        """A local stabilityai/sd-turbo snapshot (`unet/`, `vae/`,
        `text_encoder/` safetensors and `tokenizer/`) with an
        img2img-turbo pkl. ckpt_path may be a published model name
        ("edge_to_image", "sketch_to_image_stochastic", the second implying
        `stochastic`), found in `ckpt_folder` (`utils.download`). The pkl's
        LoRA is merged into the modules (deterministic) or kept factored
        beside a TwinConv conv_in (stochastic); its retrained conv_in and
        skip convs replace the snapshot's."""
        return cls(**cls.load_pretrained(sd_turbo_dir, ckpt_path, stochastic,
                                         cfgs, ckpt_folder, device),
                   dtype=dtype, device=device, use_kernels=use_kernels)

    @classmethod
    def from_native(cls, path: str, cfgs: Optional[GeneratorConfigs] = None,
                    dtype=torch.bfloat16, device=None,
                    use_kernels: bool = True) -> "Pix2PixTurbo":
        """The pipeline of a native checkpoint written by
        `cli/convert_weights.py` (`weights/native.py`): merged params, or
        base + factored LoRA, the text tower and the tokenizer."""
        from img2img_turbo_tpu_torch.weights.native import load_native
        return cls(**load_native(path, cfgs, device), dtype=dtype,
                   device=device, use_kernels=use_kernels)

    # -- prompts -----------------------------------------------------------

    @torch.no_grad()
    def encode_prompt_tokens(self, tokens) -> torch.Tensor:
        """(B, 77) token ids -> (B, 77, cross_dim) in the pipeline's
        dtype, through the fp32 text tower."""
        if self.text is None:
            raise ValueError("no text encoder: give caption_enc")
        ids = torch.as_tensor(tokens, device=self.device).long()
        return self.text(ids).to(self.dtype)

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """(1, 77, cross_dim) caption embedding, cached per prompt string."""
        if prompt not in self._prompt_cache:
            if self.tokenizer is None:
                raise ValueError("no tokenizer: give caption_enc")
            self._prompt_cache[prompt] = self.encode_prompt_tokens(
                self.tokenizer(prompt))
        return self._prompt_cache[prompt]

    # -- generation --------------------------------------------------------

    @torch.no_grad()
    def __call__(self, c_t, prompt: Optional[str] = None, caption_enc=None,
                 deterministic: bool = True, r: float = 1.0, noise_map=None,
                 noise=None, generator: Optional[torch.Generator] = None):
        """c_t: (B, H, W, 3) (an edge map in [0, 1], an image in [-1, 1]).
        Returns (B, H, W, 3) in [-1, 1]. The posterior noise is `noise`, or
        drawn from `generator` (seeded 0 when neither is given); the
        stochastic path takes r and a (B, H/8, W/8, 4) noise map."""
        if c_t.shape[1] % 8 or c_t.shape[2] % 8:
            raise ValueError(
                f"input H/W must be multiples of 8, got "
                f"{tuple(c_t.shape[1:3])}; crop first (reference "
                "inference_paired.py:39-41)")
        if caption_enc is None:
            if prompt is None:
                raise ValueError("provide either `prompt` or `caption_enc`")
            caption_enc = self.encode_prompt(prompt)
        b = c_t.shape[0]
        caption_enc = caption_enc.to(device=self.device, dtype=self.dtype)
        if caption_enc.shape[0] != b:
            caption_enc = caption_enc.expand(b, *caption_enc.shape[1:])
        caption_enc = caption_enc.contiguous()
        c_t = torch.as_tensor(c_t).to(device=self.device, dtype=self.dtype)
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        common = dict(kernels=self.use_kernels, noise=noise,
                      generator=generator)
        if deterministic:
            if self.params is None:
                raise ValueError("deterministic path needs merged params; "
                                 "call merge() first")
            return generate_deterministic(
                self.params["unet"], self.params["vae"], self.cfgs,
                self.alphas_cumprod, c_t, caption_enc, **common)
        if self.base is None or self.lora is None:
            raise ValueError("stochastic path needs unmerged base+lora "
                             "params")
        lat = (c_t.shape[1] // 8, c_t.shape[2] // 8)
        if noise_map is None:
            raise ValueError(
                "stochastic path requires noise_map of shape "
                f"(B, H/8, W/8, 4) = (.., {lat[0]}, {lat[1]}, 4)")
        if tuple(noise_map.shape[1:3]) != lat:
            raise ValueError(f"noise_map spatial dims "
                             f"{tuple(noise_map.shape[1:3])} != latent dims "
                             f"{lat}")
        r = torch.as_tensor(r, dtype=torch.float32, device=self.device)
        return generate_stochastic(
            self.base["unet"], self.base["vae"], self.lora, self.cfgs,
            self.alphas_cumprod, c_t, caption_enc, r,
            noise_map.to(self.device), **common)

    def merge(self, scale: float = 1.0) -> "Pix2PixTurbo":
        """Dense serving modules: copies of the base with the factored LoRA
        merged at `scale`, given their kernel layouts."""
        if self.base is None or self.lora is None:
            raise ValueError("merge needs base+lora params")
        self.params = {k: prepare_kernels(merge_into(
            copy.deepcopy(self.base[k]), [self.lora[k]], scale))
            for k in ("unet", "vae")}
        return self

    # -- checkpoint IO (reference pkl schema) ------------------------------

    def save_model(self, outf: str) -> None:
        """The reference pix2pix pkl (pix2pix_turbo.py:221-229) through
        `training.checkpoint.export_pix2pix_pkl`: the adapters, the UNet's
        conv_in (both TwinConv branches on the sketch model) and the skip
        convs."""
        from img2img_turbo_tpu_torch.training.checkpoint import \
            export_pix2pix_pkl
        from img2img_turbo_tpu_torch.training.paired import LoraMeta
        if self.base is None or self.lora is None:
            raise ValueError("save_model needs base+lora params")
        gen: Dict[str, torch.Tensor] = {}
        for part in ("unet", "vae"):
            for name, e in self.lora[part]["modules"].items():
                for ab in ("a", "b"):
                    gen[f"{part}_lora:{name}.{ab}"] = e[ab]
        for k, v in self.base["unet"].named_parameters():
            if k.startswith("conv_in."):
                gen["unet:" + k] = v
        for k, v in self.base["vae"].named_parameters():
            if ".skip_conv_" in k:
                gen["vae:" + k] = v
        export_pix2pix_pkl(outf, gen, LoraMeta(
            rank_unet=self.lora["unet"]["rank"],
            rank_vae=self.lora["vae"]["rank"]))
