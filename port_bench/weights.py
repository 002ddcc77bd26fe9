"""Weights from the seed, on the device, in the published layouts: the
SD-Turbo UNet and VAE under diffusers names, and the LoRA factors of an
img2img-turbo checkpoint as peft stores them (lora_A (r, in[, k, k]),
lora_B (out, r[, 1, 1])). Each model's values come from one draw of the
generator, scaled per tensor by one broadcast multiply; nothing is written
to disk. The same tensors go to the program and to the reference."""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Tuple

import torch

from port_bench.reference import sd_turbo


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for one purpose, derived from the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).hexdigest()
    return int(h[:15], 16)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def _fan_in(shape) -> int:
    return math.prod(shape[1:]) if len(shape) > 1 else 0


def sd_rule(shapes, init):
    """The init of a diffusers model: a conv or linear weight and bias at
    U(-1, 1) / sqrt(fan_in of its weight) (PyTorch's default), a norm's
    weight at 1 + norm_jitter * U and its bias at norm_jitter * U."""
    fan = {n[:-len(".weight")]: _fan_in(s) for n, s in shapes
           if n.endswith(".weight") and len(s) > 1}

    def rule(name, shape):
        mod = name.rsplit(".", 1)[0]
        if mod in fan:
            return 1.0 / math.sqrt(fan[mod]), 0.0
        return init["norm_jitter"], 1.0 if name.endswith(".weight") else 0.0
    return rule


def draw(shapes: List[Tuple[str, tuple]], gen: torch.Generator, dtype,
         rule) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `shapes`, all from one uniform draw U(-1, 1):
    each tensor scale * U + offset, (scale, offset) = rule(name, shape),
    applied by one broadcast multiply-add over the whole draw."""
    scale, offset, sizes = [], [], []
    for name, shape in shapes:
        sc, off = rule(name, shape)
        scale.append(sc)
        offset.append(off)
        sizes.append(math.prod(shape))
    dev = gen.device
    counts = torch.tensor(sizes, device=dev)
    total = int(sum(sizes))

    def per_element(values):
        return torch.repeat_interleave(
            torch.tensor(values, dtype=dtype, device=dev), counts,
            output_size=total)
    u = torch.rand(total, generator=gen, device=dev, dtype=dtype) * 2 - 1
    flat = torch.addcmul(per_element(offset), u, per_element(scale))
    del u
    out, pos = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        out[name] = flat[pos:pos + n].view(shape)
        pos += n
    return out


def matches_target(name: str, targets) -> bool:
    """peft: the module name equals a target or ends with '.<target>'."""
    return any(name == t or name.endswith("." + t) for t in targets)


@dataclasses.dataclass
class Adapter:
    """One LoRA adapter: its factors {module: (lora_A, lora_B)} in peft's
    layout, rank and alpha (the merge adds alpha/rank * B A)."""
    model: str
    name: str
    rank: int
    alpha: float
    factors: Dict[str, Tuple[torch.Tensor, torch.Tensor]]

    def peft_state_dict(self) -> Dict[str, torch.Tensor]:
        """The keys a checkpoint's state dict holds for it."""
        sd = {}
        for mod, (a, b) in self.factors.items():
            sd[f"{mod}.lora_A.{self.name}.weight"] = a
            sd[f"{mod}.lora_B.{self.name}.weight"] = b
        return sd


def adapter_modules(shapes, spec) -> List[str]:
    """Sorted names of the conv and linear modules an adapter spec adapts:
    its peft targets, kept where a name contains one of `include` (when
    given) and none of `exclude`."""
    mods = sorted(n[:-len(".weight")] for n, s in shapes
                  if n.endswith(".weight") and len(s) > 1)
    out = []
    for m in mods:
        if not matches_target(m, spec["targets"]):
            continue
        if spec.get("include") and not any(s in m for s in spec["include"]):
            continue
        if any(s in m for s in spec.get("exclude", ())):
            continue
        out.append(m)
    return out


def draw_adapter(shapes, spec, gen, dtype, init) -> Adapter:
    """A trained-looking adapter: A ~ N(0, 1/rank^2) (peft's gaussian
    init) and B ~ N(0, lora_b_std^2), each from one draw."""
    shape_of = dict(shapes)
    mods = adapter_modules(shapes, spec)
    r = spec["rank"]
    a_shapes, b_shapes = [], []
    for m in mods:
        w = shape_of[m + ".weight"]
        a_shapes.append((r, *w[1:]))
        b_shapes.append((w[0], r) + ((1, 1) if len(w) == 4 else ()))
    dev = gen.device
    a_all = torch.randn(sum(math.prod(s) for s in a_shapes), generator=gen,
                        device=dev, dtype=dtype) / r
    b_all = torch.randn(sum(math.prod(s) for s in b_shapes), generator=gen,
                        device=dev, dtype=dtype) * init["lora_b_std"]
    factors, pa, pb = {}, 0, 0
    for m, sa, sb in zip(mods, a_shapes, b_shapes):
        na, nb = math.prod(sa), math.prod(sb)
        factors[m] = (a_all[pa:pa + na].view(sa), b_all[pb:pb + nb].view(sb))
        pa, pb = pa + na, pb + nb
    return Adapter(spec["model"], spec["name"], r, float(spec["alpha"]),
                   factors)


@dataclasses.dataclass
class Weights:
    unet: Dict[str, torch.Tensor]
    vae: Dict[str, torch.Tensor]
    adapters: List[Adapter]
    caption: torch.Tensor          # (1, 77, cross_dim)


def make(cfg, seed: int, device, dtype=torch.bfloat16) -> Weights:
    """The configuration's weights and caption embedding from `seed`."""
    init = cfg["assumed"]["init"]
    ushapes = sd_turbo.unet_shapes(cfg["unet"])
    vshapes = sd_turbo.vae_shapes(cfg["vae"])
    unet = draw(ushapes, generator(seed, "unet", device), dtype,
                sd_rule(ushapes, init))
    vae = draw(vshapes, generator(seed, "vae", device), dtype,
               sd_rule(vshapes, init))
    shapes = {"unet": ushapes, "vae": vshapes}
    adapters = [draw_adapter(shapes[spec["model"]], spec,
                             generator(seed, "lora." + spec["name"] + "."
                                       + spec["model"], device),
                             dtype, init)
                for spec in cfg["adapters"]]
    cap = torch.randn((1, 77, cfg["unet"]["cross_attention_dim"]),
                      generator=generator(seed, "caption", device),
                      device=device, dtype=torch.float32).to(dtype)
    return Weights(unet, vae, adapters, cap)


def aux_rule(shapes, init):
    """The auxiliary models' init: embeddings at std 0.02, the logit scale
    at log(1/0.07), norms as `sd_rule`, VGG convs He-uniform
    (U(-1, 1) * sqrt(6 / fan_in), so that 13 ReLU layers keep their
    scale), the LPIPS heads non-negative U(0, 0.2), every other weight and
    bias U(-1, 1) / sqrt(fan_in)."""
    fan = {n[:-len(".weight")]: _fan_in(s) for n, s in shapes
           if n.endswith(".weight") and len(s) > 1}

    def rule(name, shape):
        mod = name.rsplit(".", 1)[0]
        if name.endswith("embedding.weight") or name.endswith(
                "class_embedding"):
            return 0.02 * math.sqrt(3.0), 0.0
        if name == "logit_scale":
            return 0.0, math.log(1 / 0.07)
        if name.startswith("lin") and ".model." in name:
            return 0.1, 0.1
        if mod in fan:
            if name.startswith("features.") and name.endswith(".weight"):
                return math.sqrt(6.0 / fan[mod]), 0.0
            return 1.0 / math.sqrt(fan[mod]), 0.0
        return init["norm_jitter"], 1.0 if name.endswith(".weight") else 0.0
    return rule


@dataclasses.dataclass
class TrainWeights:
    """The paired step's weights: the generator's (`Weights`, caption
    unused), the text tower, the CLIP model (discriminator backbone and
    CLIP-sim), LPIPS-VGG, and the discriminator heads with their
    spectral-norm vectors, all in fp32."""
    gen: Weights
    text: Dict[str, torch.Tensor]
    clip: Dict[str, torch.Tensor]
    lpips: Dict[str, torch.Tensor]
    heads: Dict[str, torch.Tensor]
    sn: Dict[str, torch.Tensor]


def make_train(cfg, seed: int, device) -> TrainWeights:
    """Everything the paired step starts from, drawn from `seed` in fp32
    (the trainer's masters)."""
    from port_bench.reference import aux_models
    f32, init = torch.float32, cfg["assumed"]["init"]
    parts = {}
    for name, shapes in (("text", aux_models.text_shapes(cfg["text_encoder"])),
                         ("clip", aux_models.clip_shapes(cfg["clip"])),
                         ("lpips", aux_models.lpips_shapes())):
        parts[name] = draw(shapes, generator(seed, name, device), f32,
                           aux_rule(shapes, init))
    hshapes = []
    for name, shape in aux_models.head_shapes(cfg["clip"]):
        hshapes += [(name + ".weight", shape), (name + ".bias", shape[:1])]
    heads = draw(hshapes, generator(seed, "heads", device), f32,
                 sd_rule(hshapes, init))
    g = generator(seed, "sn", device)
    sn = {}
    for name, shape in aux_models.head_shapes(cfg["clip"]):
        u = torch.randn(shape[0], generator=g, device=device)
        sn[name] = u / u.norm()
    return TrainWeights(make(cfg, seed, device, f32), parts["text"],
                        parts["clip"], parts["lpips"], heads, sn)
