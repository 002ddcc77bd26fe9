"""Paired (pix2pix-turbo) training: the 4-pass adversarial step (counterpart
of `img2img_turbo_tpu/training/paired.py`).

One step is four optimize passes, each its own forward, gradient and
AdamW update (reference train_pix2pix_turbo.py:168-225):
  1. generator: L2*lambda_l2 + LPIPS*lambda_lpips (+ CLIP-sim*lambda_clipsim);
  2. generator, a fresh forward with the updated weights: GAN-G*lambda_gan;
  3. discriminator heads on the real images;
  4. discriminator heads on pass 2's images, detached.
The spectral-norm vectors advance after each discriminator forward of
passes 2-4, as in the JAX step.

Trainable (reference set_train, pix2pix_turbo.py:176-184): the UNet and VAE
LoRA factors, the UNet conv_in and the VAE skip convs (four at SD-Turbo's
four levels). They live in
one flat dictionary of fp32 leaf tensors, `gen`, keyed "<part>:<name>":
"unet_lora:<module>.a" / ".b", "vae_lora:<module>.a" / ".b",
"unet:conv_in.weight", "vae:decoder.skip_conv_1.weight", ... Everything
else is frozen in the modules (fp32). Each generator pass merges LoRA into
new weight tensors (`build_gen_params`, cast to the compute dtype) and
runs the forward and its backward inside `lora.swap_params`, so the
kernels pack those live weights and the UNet's per-block recompute reads
the same ones. The posterior noise of the two generator forwards is an
input of the step: a recompute never redraws it.

Under a model axis (a mesh with n_model above 1; both steps here and in
`training/unpaired.py`) the UNet's and the VAE's frozen base weights are
this rank's shards (`runner.shard_for_training`: `parallel.tensor`'s rule,
which keeps the trainable conv_in and skip convs whole, departures (d) and
(e), and the VAE's one-head mid attentions whole, (b)); every other module
stays whole. The steps keep four invariants, which the tests check:
- replicated state: every trainable (the LoRA factors, conv_in, the skip
  convs, the discriminator heads) and every AdamW state is whole and
  bit-identical on every model rank after each update;
- gradients: the gradient that reaches every replicated tensor is whole
  and the same on every model rank, by the model axis's operators alone
  (`models/layers.py`; the LoRA factors through `parallel.tensor.
  shard_lora`, the skip convs through the column-parallel conv's
  `model_scatter` of their columns); there is no separate gradient
  reduction over the model
  group, and the data axis's `pmean_pass` reduces over the data group
  only;
- collective order: every rank runs the same collectives in the same
  order, the UNet blocks' recompute under remat included (the same code
  on the same graph);
- no fallback: on a CUDA tensor a sharded layer runs its kernel or
  raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from img2img_turbo_tpu_torch import lora as lora_mod, scheduler
from img2img_turbo_tpu_torch.models import discriminator as disc_mod
from img2img_turbo_tpu_torch.models.layers import has_kernel_layouts
from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                       generate_deterministic)
from img2img_turbo_tpu_torch.training import accum
from img2img_turbo_tpu_torch.training import losses as losses_mod
from img2img_turbo_tpu_torch.training.optim import AdamW
from img2img_turbo_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class LoraMeta:
    rank_unet: int = 8
    alpha_unet: float = 8.0
    rank_vae: int = 4
    alpha_vae: float = 8.0


@dataclasses.dataclass
class PairedModels:
    """The frozen modules of a paired run (fp32 parameters); `clip`, the
    CLIP-sim model, is None in a run with lambda_clipsim = 0."""
    unet: torch.nn.Module
    vae: torch.nn.Module
    text: torch.nn.Module
    lpips: torch.nn.Module
    disc_backbone: torch.nn.Module
    clip: torch.nn.Module


@dataclasses.dataclass
class TrainState:
    """The state of a paired or an unpaired run: the generator trainables,
    the discriminator heads and spectral-norm vectors (for the unpaired run
    both discriminators', keyed "a:<name>" and "b:<name>"), one AdamW over
    each of the first two, and the step count."""
    gen: Dict[str, torch.Tensor]
    disc: Dict[str, torch.Tensor]
    disc_sn: Dict[str, torch.Tensor]
    gen_opt: AdamW
    disc_opt: AdamW
    step: int = 0


def split_trainable(unet, vae, unet_lora, vae_lora
                    ) -> Tuple[Dict[str, torch.Tensor], LoraMeta]:
    """-> (gen, meta): fresh fp32 leaf tensors for the trainables
    (training/paired.py:43-66). The modules' own parameters are frozen."""
    gen = {}
    for part, lora in (("unet_lora", unet_lora), ("vae_lora", vae_lora)):
        for name, entry in sorted(lora["modules"].items()):
            for ab in ("a", "b"):
                gen[f"{part}:{name}.{ab}"] = entry[ab]
    gen["unet:conv_in.weight"] = unet.conv_in.weight
    gen["unet:conv_in.bias"] = unet.conv_in.bias
    for key, p in vae.named_parameters():
        if key.startswith("decoder.skip_conv_"):
            gen["vae:" + key] = p
    gen = {k: v.detach().float().clone().requires_grad_(True)
           for k, v in gen.items()}
    for m in (unet, vae):
        m.requires_grad_(False)
    meta = LoraMeta(unet_lora["rank"], unet_lora["alpha"], vae_lora["rank"],
                    vae_lora["alpha"])
    return gen, meta


def lora_modules(gen, part: str) -> Dict:
    """{module name: {"a", "b"}} of the adapter keyed "<part>:" in `gen`."""
    modules: Dict = {}
    for k, v in gen.items():
        if k.startswith(part + ":"):
            name, ab = k[len(part) + 1:].rsplit(".", 1)
            modules.setdefault(name, {})[ab] = v
    return modules


def _lora_of(gen, part: str, rank: int, alpha: float) -> Dict:
    return {"rank": rank, "alpha": alpha, "modules": lora_modules(gen, part)}


def shard_specs(module, tp):
    """The sharded dims by parameter name of a module that
    `parallel.tensor.shard_module` sharded over the model axis of `tp`
    (None without a model axis, or for a whole module)."""
    return None if tp is None else getattr(module, "tp_specs", None)


def build_gen_params(gen, unet, vae, meta: LoraMeta, dtype=None,
                     tp=None) -> Dict:
    """{"unet": {param name: tensor}, "vae": {...}}: the trainables in
    place of their base weights, then LoRA merged (training/paired.py:
    69-79); merged weights are cast to `dtype` when given. Differentiable
    in `gen`. tp: the model axis's mesh of a sharded UNet and VAE, whose
    LoRA is merged on their shards (`lora.merge_lora`)."""
    out = {}
    for model, module, rank, alpha in (
            ("unet", unet, meta.rank_unet, meta.alpha_unet),
            ("vae", vae, meta.rank_vae, meta.alpha_vae)):
        over = {k.split(":", 1)[1]: v for k, v in gen.items()
                if k.startswith(model + ":")}
        base = {**dict(module.named_parameters()), **over}
        merged = lora_mod.merge_lora(
            base, _lora_of(gen, model + "_lora", rank, alpha), dtype=dtype,
            specs=shard_specs(module, tp), tp=tp)
        out[model] = {**over, **merged}
    return out


def model_axis(mesh, models):
    """The step's `tp`: `mesh` when it has a model axis, else None. A
    model axis needs the run's UNet and VAE(s) (`models`, a
    `PairedModels` or an `UnpairedModels`) sharded
    (`runner.shard_for_training`)."""
    from img2img_turbo_tpu_torch.training.runner import VAE_MODULES
    if mesh is None or mesh.n_model == 1:
        return None
    names = ("unet",) + tuple(n for n in VAE_MODULES if hasattr(models, n))
    whole = [n for n in names
             if getattr(getattr(models, n), "tp_specs", None) is None]
    if whole:
        raise ValueError(
            f"a model axis of {mesh.n_model} ranks trains a UNet and VAE "
            f"sharded for training, and {whole} are whole: call "
            f"runner.shard_for_training(models, mesh) before building the "
            f"step")
    return mesh


def draw_noise(generator: torch.Generator, batch: int, height: int,
               width: int, cfgs: GeneratorConfigs, dtype):
    """Posterior noise (B, H/f, W/f, latent) for one generator forward,
    f = 2^(VAE levels - 1)."""
    f = 2 ** (cfgs.vae.num_levels - 1)
    return torch.randn(batch, height // f, width // f,
                       cfgs.vae.latent_channels, generator=generator,
                       device=generator.device).to(dtype)


def make_state(gen, disc, disc_sn, gen_schedule, disc_schedule,
               **adam_kwargs) -> TrainState:
    """The training state, with one AdamW (clip + decoupled decay, optax's
    update) over the generator trainables and one over the heads."""
    disc = {k: v.detach().float().clone().requires_grad_(True)
            for k, v in disc.items()}
    return TrainState(gen, disc, dict(disc_sn),
                      AdamW(list(gen.values()), gen_schedule, **adam_kwargs),
                      AdamW(list(disc.values()), disc_schedule,
                            **adam_kwargs))


@profiling.spanned("i2i.train.optim")
def _apply(opt: AdamW, params: Dict, grads: Dict) -> None:
    for k, p in params.items():
        p.grad = grads[k]
    opt.step()
    for p in params.values():
        p.grad = None


def make_paired_train_step(models: PairedModels, cfgs: GeneratorConfigs,
                           loss_cfg: losses_mod.PairedLossConfig,
                           meta: LoraMeta, *, kernels: bool = True,
                           remat: bool = True, dtype=torch.bfloat16,
                           accum_steps: int = 1, mesh=None):
    """Returns train_step(state, batch, noise, keep_grads=False) ->
    (metrics, pass-1 gradients or None); it updates `state` in place.
    batch: conditioning_pixel_values (B,H,W,3) [0,1], output_pixel_values
    [-1,1], input_ids (B,77); noise: the posterior noise of passes 1 and 2
    (`draw_noise`). kernels=False runs the plain PyTorch path on the same
    weights. accum_steps > 1 runs each pass over that many micro-batches
    of the batch, one optimizer update a pass (`accum.accumulated_grads`;
    B must be divisible by it).

    mesh: a `parallel.mesh.DataMesh` when the step runs on every rank of a
    data axis, each on its rows of the global batch (the counterpart of
    JAX's `axis_name`): each pass's loss, scalar metrics and gradients are
    averaged over the ranks after the local accumulation and before the
    optimizer update (`mesh.pmean_pass`), so the state stays the same on
    every rank. Pass 2's images stay on their rank for its discriminator
    passes; the spectral-norm vectors advance on each rank from the same
    heads and are not reduced. The returned pass-1 gradients are the
    averaged ones. With a model axis (the module docstring's invariants)
    the ranks of a model group take the same rows and run the UNet and
    the VAE on their shards, which `runner.shard_for_training` made."""
    tp = model_axis(mesh, models)
    for m in (models.unet, models.vae):
        if any(has_kernel_layouts(sub) for sub in m.modules()):
            raise ValueError("train the modules unprepared: kernel layouts "
                             "taken by prepare_kernels would be stale")
    dev = next(models.unet.parameters()).device
    alphas = scheduler.make_alphas_cumprod(device=dev)
    smooth = loss_cfg.gan_loss_type.endswith("_s")

    def gen_pass(gen, data, loss_fn):
        """loss_fn(micro data, pred) -> (loss, aux); returns (loss, the
        auxes, grads over gen), LoRA merged once for the pass."""
        with profiling.span("i2i.train.lora_merge"):
            params = build_gen_params(gen, models.unet, models.vae, meta,
                                      dtype, tp)

        def micro_loss(mb):
            pred = generate_deterministic(
                models.unet, models.vae, cfgs, alphas, mb["c_t"],
                mb["caption_enc"], kernels=kernels, noise=mb["noise"],
                remat=remat, tp=tp)
            return loss_fn(mb, pred)
        with lora_mod.swap_params(models.unet, params["unet"]), \
                lora_mod.swap_params(models.vae, params["vae"]):
            out = accum.accumulated_grads(micro_loss, gen, data, accum_steps)
        return mesh_mod.pmean_pass(*out, mesh)

    def disc_pass(heads, data, loss_fn):
        return mesh_mod.pmean_pass(*accum.accumulated_grads(
            lambda mb: (loss_fn(mb), None), heads, data, accum_steps), mesh)

    @profiling.spanned("i2i.train.step", unit=True)
    def train_step(state: TrainState, batch, noise, keep_grads=False):
        with profiling.span("i2i.train.text"):
            c_t = batch["conditioning_pixel_values"].to(dtype)
            x_tgt = batch["output_pixel_values"].to(dtype)
            ids = batch["input_ids"]
            with torch.no_grad():
                caption_enc = models.text(ids).to(dtype)
        metrics = {}
        data = {"c_t": c_t, "x_tgt": x_tgt, "ids": ids,
                "caption_enc": caption_enc}

        # ---- pass 1: reconstruction -----------------------------------
        def recon(mb, pred):
            l2 = loss_cfg.lambda_l2 * losses_mod.l2_loss(pred, mb["x_tgt"])
            lp = loss_cfg.lambda_lpips * losses_mod.lpips_loss(
                models.lpips, pred, mb["x_tgt"])
            parts = {"loss_l2": l2.detach(), "loss_lpips": lp.detach()}
            total = l2 + lp
            if loss_cfg.lambda_clipsim > 0:
                cs = loss_cfg.lambda_clipsim * losses_mod.clipsim_loss(
                    models.clip, pred, mb["ids"])
                parts["loss_clipsim"] = cs.detach()
                total = total + cs
            return total, parts

        with profiling.span("i2i.train.gen_pass1"):
            _, parts, grads1 = gen_pass(state.gen,
                                        {**data, "noise": noise[0]}, recon)
            _apply(state.gen_opt, state.gen, grads1)
            metrics.update(accum.mean_aux(parts))

        # ---- pass 2: generator GAN (fresh forward, updated gen) --------
        sn = state.disc_sn

        def gan_g(mb, pred):
            return loss_cfg.lambda_gan * losses_mod.gan_gen_loss(
                models.disc_backbone, state.disc, sn, pred, smooth), \
                pred.detach()

        with profiling.span("i2i.train.gen_pass2"):
            loss_g, preds, grads = gen_pass(
                state.gen, {**data, "noise": noise[1]}, gan_g)
            pred2 = accum.merge_micro(preds)
            _apply(state.gen_opt, state.gen, grads)
            metrics["loss_gan_g"] = loss_g
        with profiling.span("i2i.train.sn_step"):
            sn = disc_mod.sn_step(state.disc, sn)

        # ---- pass 3: discriminator on the real images ------------------
        def d_real(mb):
            return loss_cfg.lambda_gan * losses_mod.gan_disc_real_loss(
                models.disc_backbone, state.disc, sn, mb["x_tgt"], smooth)

        with profiling.span("i2i.train.disc_real"):
            loss_dr, _, grads = disc_pass(state.disc, {"x_tgt": x_tgt},
                                          d_real)
            with profiling.span("i2i.train.sn_step"):
                # the heads before the update
                sn = disc_mod.sn_step(state.disc, sn)
            _apply(state.disc_opt, state.disc, grads)
            metrics["loss_d_real"] = loss_dr

        # ---- pass 4: discriminator on pass 2's images, detached --------
        def d_fake(mb):
            return loss_cfg.lambda_gan * losses_mod.gan_disc_fake_loss(
                models.disc_backbone, state.disc, sn, mb["pred"], smooth)

        with profiling.span("i2i.train.disc_fake"):
            loss_df, _, grads = disc_pass(state.disc, {"pred": pred2},
                                          d_fake)
            with profiling.span("i2i.train.sn_step"):
                sn = disc_mod.sn_step(state.disc, sn)
            _apply(state.disc_opt, state.disc, grads)
            metrics["loss_d_fake"] = loss_df

        state.disc_sn = sn
        state.step += 1
        return metrics, (grads1 if keep_grads else None)

    return train_step


def make_eval_step(models: PairedModels, cfgs: GeneratorConfigs,
                   meta: LoraMeta, *, kernels: bool = True,
                   dtype=torch.bfloat16, mesh=None):
    """Validation metrics L2, LPIPS and, when the run has a CLIP-sim model
    (`models.clip`, None when lambda_clipsim is 0), CLIP-sim of the current
    generator (reference train_pix2pix_turbo.py:259-301). Returns
    eval_step(gen, batch, noise) -> (pred, metrics). With a model axis in
    `mesh`, every rank of the model group calls it alike on a sharded
    UNet and VAE (`make_paired_train_step`) and gets the whole result."""
    tp = model_axis(mesh, models)
    dev = next(models.unet.parameters()).device
    alphas = scheduler.make_alphas_cumprod(device=dev)

    @torch.no_grad()
    def eval_step(gen, batch, noise):
        c_t = batch["conditioning_pixel_values"].to(dtype)
        x_tgt = batch["output_pixel_values"].to(dtype)
        ids = batch["input_ids"]
        caption_enc = models.text(ids).to(dtype)
        params = build_gen_params(gen, models.unet, models.vae, meta, dtype,
                                  tp)
        with lora_mod.swap_params(models.unet, params["unet"]), \
                lora_mod.swap_params(models.vae, params["vae"]):
            pred = generate_deterministic(models.unet, models.vae, cfgs,
                                          alphas, c_t, caption_enc,
                                          kernels=kernels, noise=noise, tp=tp)
        out = {"val_l2": losses_mod.l2_loss(pred, x_tgt),
               "val_lpips": losses_mod.lpips_loss(models.lpips, pred, x_tgt)}
        if models.clip is not None:
            out["val_clipsim"] = 1.0 - losses_mod.clipsim_loss(
                models.clip, pred, ids)
        return pred, out

    return eval_step
