"""The paired (pix2pix-turbo) training step in plain fp32 PyTorch: four
optimize passes, each its own forward, gradient and AdamW update
(reference train_pix2pix_turbo.py:168-225):
  1. generator: L2 * lambda_l2 + LPIPS * lambda_lpips + CLIP-sim *
     lambda_clipsim;
  2. generator, a fresh forward with the updated weights: GAN-G *
     lambda_gan;
  3. the discriminator heads on the real images;
  4. the heads on pass 2's images, detached;
the spectral-norm vectors advancing after the discriminator forwards of
passes 2, 3 and 4. The generator's trainables are the LoRA factors, the
UNet's conv_in and the VAE's skip convs; each generator pass merges LoRA
from them anew. The generator passes run sample by sample (their losses
are batch means, so the weighted per-sample gradients add up to the
batch's) so that the fp32 activations fit. AdamW is optax's
chain(clip_by_global_norm, adamw). `q` rounds operands (the control).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from port_bench.reference import aux_models as aux
from port_bench.reference import generator as gen_ref
from port_bench.reference import sd_turbo


def nchw(t):
    return t.permute(0, 3, 1, 2)


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay)) over a dict of fp32 leaves, constant lr."""

    def __init__(self, params: Dict[str, torch.Tensor], t):
        self.p, self.t = params, t
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]):
        t = self.t
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clip = min(1.0, t["max_grad_norm"] / norm.item()) \
            if norm.item() > 0 else 1.0
        self.count += 1
        b1, b2 = t["adam_beta1"], t["adam_beta2"]
        for k, p in self.p.items():
            g = grads[k] * clip
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.mu[k] / (1 - b1 ** self.count)
            vhat = self.nu[k] / (1 - b2 ** self.count)
            upd = mhat / (vhat.sqrt() + t["adam_epsilon"]) \
                + t["adam_weight_decay"] * p
            p.sub_(t["learning_rate"] * upd)


def trainables(w) -> Dict[str, torch.Tensor]:
    """The generator's trainables, fp32 leaves, keyed as the port keys
    them ("unet_lora:<module>.a" / ".b", "unet:conv_in.weight",
    "vae:decoder.skip_conv_<i>.weight"); a LoRA factor keeps peft's
    layout here (lora_A (r, in[, k, k]) as "a", lora_B (out, r[, 1, 1]) as
    "b"), which changes no norm."""
    out = {}
    for ad in w.gen.adapters:
        for mod, (a, b) in ad.factors.items():
            out[f"{ad.model}_lora:{mod}.a"] = a.float()
            out[f"{ad.model}_lora:{mod}.b"] = b.float()
    for k in ("conv_in.weight", "conv_in.bias"):
        out["unet:" + k] = w.gen.unet[k].float()
    for k, v in w.gen.vae.items():
        if k.startswith("decoder.skip_conv_"):
            out["vae:" + k] = v.float()
    return {k: v.detach().clone() for k, v in out.items()}


def merged(w, gen: Dict[str, torch.Tensor]):
    """(UNet, VAE) parameter dicts with the trainables in place and LoRA
    merged from them, differentiable in `gen`."""
    out = []
    for model, base in (("unet", w.gen.unet), ("vae", w.gen.vae)):
        p = {k: v.float() for k, v in base.items()}
        for k, v in gen.items():
            if k.startswith(model + ":"):
                p[k.split(":", 1)[1]] = v
        for ad in w.gen.adapters:
            if ad.model != model:
                continue
            s = ad.alpha / ad.rank
            for mod in ad.factors:
                a = gen[f"{model}_lora:{mod}.a"]
                b = gen[f"{model}_lora:{mod}.b"]
                wt = p[mod + ".weight"]
                delta = (b.reshape(b.shape[0], -1) @ a.reshape(a.shape[0], -1))
                p[mod + ".weight"] = wt + s * delta.reshape(wt.shape)
        out.append(p)
    return out


def generate(cfg, p_unet, p_vae, c_t, caption, noise, q):
    """The training generator: c_t (B, 3, H, W) -> the clamped image."""
    ucfg, vcfg, sched = cfg["unet"], cfg["vae"], cfg["scheduler"]
    mean, logvar, skips = sd_turbo.vae_encode(p_vae, vcfg, c_t, q)
    std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
    s = vcfg["scaling_factor"]
    z = (mean + std * nchw(noise.float())) * s
    t = torch.full((z.shape[0],), sched["timestep"], dtype=torch.long,
                   device=z.device)
    eps = sd_turbo.unet(p_unet, ucfg, z, t, caption, q)
    abar = gen_ref.alphas_cumprod(sched)[sched["timestep"]].item()
    x0 = (z - (1.0 - abar) ** 0.5 * eps) / abar ** 0.5
    return sd_turbo.vae_decode(p_vae, vcfg, x0 / s, skips, 1.0, q) \
        .clamp(-1.0, 1.0)


def _gen_pass(w, cfg, gen, batch, caption, noise, loss_fn, q, rows):
    """Weighted per-chunk losses and gradients of one generator pass:
    (batch loss, its parts, grads, predictions)."""
    c_t = batch["conditioning_pixel_values"]
    b = c_t.shape[0]
    grads = {k: torch.zeros_like(v) for k, v in gen.items()}
    total, parts, preds = 0.0, {}, []
    for i in range(0, b, rows):
        sl = slice(i, i + rows)
        leaves = {k: v.detach().requires_grad_(True) for k, v in gen.items()}
        p_unet, p_vae = merged(w, leaves)
        pred = generate(cfg, p_unet, p_vae, nchw(c_t[sl].float()),
                        caption[sl], noise[sl], q)
        loss, aux_parts = loss_fn(pred, sl)
        frac = pred.shape[0] / b
        g = torch.autograd.grad(loss * frac, list(leaves.values()),
                                allow_unused=True)
        for k, gi in zip(leaves, g):
            if gi is not None:
                grads[k] += gi
        total += loss.item() * frac
        for k, v in aux_parts.items():
            parts[k] = parts.get(k, 0.0) + v * frac
        preds.append(pred.detach())
        del p_unet, p_vae, pred, loss
    return total, parts, grads, torch.cat(preds)


def run(w, cfg, batches: List[dict], noises: List[tuple], q=sd_turbo.ident,
        rows: int = 1):
    """The first len(batches) steps from the weights `w`
    (`weights.TrainWeights`). batches: {"conditioning_pixel_values"
    (B, H, W, 3) [0, 1], "output_pixel_values" [-1, 1], "input_ids"
    (B, 77)}; noises: per step the two
    generator passes' posterior noise (B, H/8, W/8, 4). Returns {"losses":
    per step {metric: value}, "mu1": each trainable's AdamW first moment
    after the first step, "gen", "heads": the trainables after the steps,
    "gen0", "heads0": before}."""
    t = cfg["train"]
    gen = trainables(w)
    heads = {k: v.detach().clone().float() for k, v in w.heads.items()}
    sn = {k: v.float().clone() for k, v in w.sn.items()}
    out = {"gen0": {k: v.clone() for k, v in gen.items()},
           "heads0": {k: v.clone() for k, v in heads.items()}, "losses": []}
    gen_opt, disc_opt = AdamW(gen, t), AdamW(heads, t)
    p_text, p_clip, p_lpips = w.text, w.clip, w.lpips
    for step, (batch, noise) in enumerate(zip(batches, noises)):
        ids = batch["input_ids"]
        x_tgt = nchw(batch["output_pixel_values"].float())
        with torch.no_grad():
            caption = aux.text_tower(p_text, cfg["text_encoder"], ids, q)
        losses = {}

        def recon(pred, sl):
            l2 = t["lambda_l2"] * (pred - x_tgt[sl]).square().mean()
            lp = t["lambda_lpips"] * aux.lpips(p_lpips, pred, x_tgt[sl],
                                               q).mean()
            cs = t["lambda_clipsim"] * aux.clipsim_loss(p_clip, cfg["clip"],
                                                        pred, ids[sl], q)
            return l2 + lp + cs, {"loss_l2": l2.item(),
                                  "loss_lpips": lp.item(),
                                  "loss_clipsim": cs.item()}

        _, parts, grads, _ = _gen_pass(w, cfg, gen, batch, caption,
                                       noise[0], recon, q, rows)
        gen_opt.update(grads)
        losses.update(parts)

        def gan_g(pred, sl):
            return t["lambda_gan"] * aux.gan_loss(
                p_clip, cfg["clip"], heads, sn, pred, "gen", q), {}

        loss_g, _, grads, pred2 = _gen_pass(w, cfg, gen, batch, caption,
                                            noise[1], gan_g, q, rows)
        gen_opt.update(grads)
        losses["loss_gan_g"] = loss_g
        sn = aux.sn_step(heads, sn)

        for kind, images, key in (("real", x_tgt, "loss_d_real"),
                                  ("fake", pred2, "loss_d_fake")):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in heads.items()}
            loss = t["lambda_gan"] * aux.gan_loss(p_clip, cfg["clip"],
                                                  leaves, sn, images, kind,
                                                  q)
            g = torch.autograd.grad(loss, list(leaves.values()))
            sn = aux.sn_step(heads, sn)
            disc_opt.update(dict(zip(leaves, g)))
            losses[key] = loss.item()
        out["losses"].append(losses)
        if step == 0:
            out["mu1"] = {k: v.clone()
                          for k, v in {**gen_opt.mu, **disc_opt.mu}.items()}
    out["gen"], out["heads"] = gen, heads
    return out
