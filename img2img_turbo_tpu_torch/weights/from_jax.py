"""JAX parameter trees -> the port's modules, and seeded random weights.

`unet_state_dict` / `vae_state_dict` are a numpy-only copy of the inverse
converters of `img2img_turbo_tpu/weights/torch_import.py:223-352`: they take
the JAX tree (leaves as numpy arrays) and give diffusers-named state dicts
in torch layouts (conv HWIO -> OIHW, linear (in, out) -> (out, in)), which
`load` feeds to `load_state_dict(strict=True)`. No JAX is imported.

`clip_text_state_dict`, `clip_vision_state_dict`, `clip_state_dict`,
`lpips_state_dict`, `disc_heads` and `gen_trainables` (the LoRA factors,
the UNet conv_in and the skip convs) do the same for the trees of the
paired training step, `disc_heads_pair` and `cycle_trainables` for
the unpaired step's, and `inception_state_dict` and `dino_state_dict` for
the metrics' networks, so that the tests feed both packages the same
numbers.

`unet_state_dict` also takes a UNet whose conv_in is a TwinConv pair
(`{"pretrained", "current"}`, the sketch model), under the reference's
names `conv_in.conv_in_pretrained` / `conv_in.conv_in_curr`
(pipelines/pix2pix.py:205-216). `lora_tree` carries a factored adapter
across (a pix2pix LoRA, one of the three CycleGAN UNet adapters, a CycleGAN
VAE's); the adapters keep the JAX layout, so only the arrays change type.

`random_params` draws a state dict with the JAX package's init scheme
(`models/layers.py:37-68`, `models/vae.py:225-231`): U(+-1/sqrt(fan_in)) for
every conv/linear weight and bias, GroupNorm/LayerNorm scale 1 and bias 0,
the VAE skip zero-convs constant 1e-5. SD-Turbo's pretrained weights are not
in the repository, so the chip smoke runs on these: `random_model` for the
edge_to_image model, `random_sketch_model` and `random_cyclegan_model` for
the other two serving modes.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from img2img_turbo_tpu_torch.configs import UNetConfig, VAEConfig


def _inv_lin(out, prefix, mod):
    out[prefix + ".weight"] = np.ascontiguousarray(np.asarray(mod["kernel"]).T)
    if "bias" in mod:
        out[prefix + ".bias"] = np.asarray(mod["bias"]).copy()


def _inv_conv(out, prefix, mod):
    out[prefix + ".weight"] = np.ascontiguousarray(
        np.asarray(mod["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in mod:
        out[prefix + ".bias"] = np.asarray(mod["bias"]).copy()


def _inv_norm(out, prefix, mod):
    out[prefix + ".weight"] = np.asarray(mod["scale"]).copy()
    out[prefix + ".bias"] = np.asarray(mod["bias"]).copy()


def _inv_resnet(out, prefix, p):
    _inv_norm(out, prefix + ".norm1", p["norm1"])
    _inv_conv(out, prefix + ".conv1", p["conv1"])
    _inv_norm(out, prefix + ".norm2", p["norm2"])
    _inv_conv(out, prefix + ".conv2", p["conv2"])
    if "time_emb_proj" in p:
        _inv_lin(out, prefix + ".time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _inv_conv(out, prefix + ".conv_shortcut", p["conv_shortcut"])


def _inv_vae_mid(out, prefix, p):
    ap = prefix + ".attentions.0"
    _inv_resnet(out, prefix + ".resnets.0", p["res1"])
    _inv_norm(out, ap + ".group_norm", p["attn"]["norm"])
    for name in ("to_q", "to_k", "to_v"):
        _inv_lin(out, f"{ap}.{name}", p["attn"][name])
    _inv_lin(out, ap + ".to_out.0", p["attn"]["to_out"])
    _inv_resnet(out, prefix + ".resnets.1", p["res2"])


def _inv_attention(out, prefix, p):
    for name in ("to_q", "to_k", "to_v"):
        _inv_lin(out, f"{prefix}.{name}", p[name])
    _inv_lin(out, prefix + ".to_out.0", p["to_out"])


def _inv_transformer(out, prefix, p):
    _inv_norm(out, prefix + ".norm", p["norm"])
    _inv_lin(out, prefix + ".proj_in", p["proj_in"])
    tb = prefix + ".transformer_blocks.0"
    _inv_norm(out, tb + ".norm1", p["norm1"])
    _inv_attention(out, tb + ".attn1", p["attn1"])
    _inv_norm(out, tb + ".norm2", p["norm2"])
    _inv_attention(out, tb + ".attn2", p["attn2"])
    _inv_norm(out, tb + ".norm3", p["norm3"])
    _inv_lin(out, tb + ".ff.net.0.proj", p["ff"]["proj"])
    _inv_lin(out, tb + ".ff.net.2", p["ff"]["out"])
    _inv_lin(out, prefix + ".proj_out", p["proj_out"])


def unet_state_dict(params) -> Dict[str, np.ndarray]:
    """diffusers UNet2DConditionModel state dict from a JAX UNet tree."""
    out: Dict[str, np.ndarray] = {}
    conv_in = params["conv_in"]
    if "pretrained" in conv_in:     # TwinConv (unet.py:261-272)
        _inv_conv(out, "conv_in.conv_in_pretrained", conv_in["pretrained"])
        _inv_conv(out, "conv_in.conv_in_curr", conv_in["current"])
    else:
        _inv_conv(out, "conv_in", conv_in)
    _inv_lin(out, "time_embedding.linear_1", params["time_mlp"]["lin1"])
    _inv_lin(out, "time_embedding.linear_2", params["time_mlp"]["lin2"])
    for i, block in enumerate(params["down"]):
        for j, r in enumerate(block["resnets"]):
            _inv_resnet(out, f"down_blocks.{i}.resnets.{j}", r)
        for j, a in enumerate(block.get("attns", ())):
            _inv_transformer(out, f"down_blocks.{i}.attentions.{j}", a)
        if "downsample" in block:
            _inv_conv(out, f"down_blocks.{i}.downsamplers.0.conv",
                      block["downsample"])
    _inv_resnet(out, "mid_block.resnets.0", params["mid"]["res1"])
    _inv_transformer(out, "mid_block.attentions.0", params["mid"]["attn"])
    _inv_resnet(out, "mid_block.resnets.1", params["mid"]["res2"])
    for i, block in enumerate(params["up"]):
        for j, r in enumerate(block["resnets"]):
            _inv_resnet(out, f"up_blocks.{i}.resnets.{j}", r)
        for j, a in enumerate(block.get("attns", ())):
            _inv_transformer(out, f"up_blocks.{i}.attentions.{j}", a)
        if "upsample" in block:
            _inv_conv(out, f"up_blocks.{i}.upsamplers.0.conv",
                      block["upsample"])
    _inv_norm(out, "conv_norm_out", params["norm_out"])
    _inv_conv(out, "conv_out", params["conv_out"])
    return out


def vae_state_dict(params) -> Dict[str, np.ndarray]:
    """diffusers AutoencoderKL state dict (with the skip convs) from a JAX
    VAE tree."""
    out: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    _inv_conv(out, "encoder.conv_in", enc["conv_in"])
    for i, block in enumerate(enc["down"]):
        for j, r in enumerate(block["resnets"]):
            _inv_resnet(out, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsample" in block:
            _inv_conv(out, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      block["downsample"])
    _inv_vae_mid(out, "encoder.mid_block", enc["mid"])
    _inv_norm(out, "encoder.conv_norm_out", enc["norm_out"])
    _inv_conv(out, "encoder.conv_out", enc["conv_out"])

    dec = params["decoder"]
    _inv_conv(out, "decoder.conv_in", dec["conv_in"])
    _inv_vae_mid(out, "decoder.mid_block", dec["mid"])
    for i, block in enumerate(dec["up"]):
        for j, r in enumerate(block["resnets"]):
            _inv_resnet(out, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsample" in block:
            _inv_conv(out, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      block["upsample"])
    _inv_norm(out, "decoder.conv_norm_out", dec["norm_out"])
    _inv_conv(out, "decoder.conv_out", dec["conv_out"])
    if "skip_convs" in dec:
        for i, conv in enumerate(dec["skip_convs"]):
            _inv_conv(out, f"decoder.skip_conv_{i + 1}", conv)
    _inv_conv(out, "quant_conv", params["quant_conv"])
    _inv_conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def _inv_block(out, prefix, p):
    """A pre-LN CLIP block (ln1, attn {q, k, v, out}, ln2, fc1, fc2) ->
    transformers' CLIPEncoderLayer names."""
    _inv_norm(out, prefix + ".layer_norm1", p["ln1"])
    for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                     ("out", "out_proj")):
        _inv_lin(out, f"{prefix}.self_attn.{dst}", p["attn"][src])
    _inv_norm(out, prefix + ".layer_norm2", p["ln2"])
    _inv_lin(out, prefix + ".mlp.fc1", p["fc1"])
    _inv_lin(out, prefix + ".mlp.fc2", p["fc2"])


def clip_text_state_dict(params) -> Dict[str, np.ndarray]:
    """models/clip_text.CLIPTextModel state dict from a JAX clip_text
    tree."""
    out = {"embeddings.token_embedding.weight":
           np.asarray(params["token_embedding"]).copy(),
           "embeddings.position_embedding.weight":
           np.asarray(params["position_embedding"]).copy()}
    for i, layer in enumerate(params["layers"]):
        _inv_block(out, f"encoder.layers.{i}", {
            "ln1": layer["ln1"], "ln2": layer["ln2"], "fc1": layer["fc1"],
            "fc2": layer["fc2"],
            "attn": {k: layer["attn"][k] for k in ("q", "k", "v", "out")}})
    _inv_norm(out, "final_layer_norm", params["final_ln"])
    return out


def clip_vision_state_dict(params) -> Dict[str, np.ndarray]:
    """models/clip_vit.CLIPVision state dict from a JAX vision tower."""
    out: Dict[str, np.ndarray] = {}
    vm = "vision_model."
    _inv_conv(out, vm + "embeddings.patch_embedding", params["patch_embed"])
    out[vm + "embeddings.class_embedding"] = np.asarray(
        params["class_embed"]).copy()
    out[vm + "embeddings.position_embedding.weight"] = np.asarray(
        params["pos_embed"]).copy()
    _inv_norm(out, vm + "pre_layrnorm", params["ln_pre"])
    for i, blk in enumerate(params["blocks"]):
        _inv_block(out, f"{vm}encoder.layers.{i}", blk)
    _inv_norm(out, vm + "post_layernorm", params["ln_post"])
    out["visual_projection.weight"] = np.ascontiguousarray(
        np.asarray(params["proj"]).T)
    return out


def clip_state_dict(params) -> Dict[str, np.ndarray]:
    """models/clip_vit.CLIPModel state dict from a JAX {"vision", "text",
    "logit_scale"} tree."""
    out = clip_vision_state_dict(params["vision"])
    t = params["text"]
    tm = "text_model."
    out[tm + "embeddings.token_embedding.weight"] = np.asarray(
        t["token_embedding"]).copy()
    out[tm + "embeddings.position_embedding.weight"] = np.asarray(
        t["pos_embed"]).copy()
    for i, blk in enumerate(t["blocks"]):
        _inv_block(out, f"{tm}encoder.layers.{i}", blk)
    _inv_norm(out, tm + "final_layer_norm", t["ln_final"])
    out["text_projection.weight"] = np.ascontiguousarray(
        np.asarray(t["proj"]).T)
    out["logit_scale"] = np.asarray(params["logit_scale"], np.float32)
    return out


def lpips_state_dict(params) -> Dict[str, np.ndarray]:
    """models/vgg_lpips.VGGLPIPS state dict from a JAX {"vgg", "lins"}
    tree."""
    out: Dict[str, np.ndarray] = {}
    for i, convs in enumerate(params["vgg"]["blocks"]):
        for j, conv in enumerate(convs):
            _inv_conv(out, f"blocks.{i}.{j}", conv)
    for i, lin in enumerate(params["lins"]):
        _inv_conv(out, f"lins.{i}", lin)
    return out


def disc_heads(heads, sn):
    """(heads, sn) flat dictionaries of models/discriminator from the JAX
    heads and spectral-norm trees."""
    out: Dict[str, np.ndarray] = {}
    flat_sn: Dict[str, np.ndarray] = {}
    for i, (hp, up) in enumerate(zip(heads["spatial"], sn["spatial"])):
        for k in ("conv1", "conv2"):
            _inv_conv(out, f"spatial.{i}.{k}", hp[k])
            flat_sn[f"spatial.{i}.{k}"] = np.asarray(up[k]).copy()
    for k in ("lin1", "lin2"):
        _inv_lin(out, f"final.{k}", heads["final"][k])
        flat_sn[f"final.{k}"] = np.asarray(sn["final"][k]).copy()
    return out, flat_sn


def gen_trainables(gen) -> Dict[str, np.ndarray]:
    """The JAX paired step's trainable tree ({"unet_lora", "vae_lora",
    "conv_in", "skip_convs"}) -> the port's flat `gen` keys
    (training/paired.py)."""
    out: Dict[str, np.ndarray] = {}
    for part in ("unet_lora", "vae_lora"):
        for name, e in gen[part].items():
            for ab in ("a", "b"):
                out[f"{part}:{name}.{ab}"] = np.asarray(e[ab]).copy()
    conv: Dict[str, np.ndarray] = {}
    _inv_conv(conv, "conv_in", gen["conv_in"])
    out.update({"unet:" + k: v for k, v in conv.items()})
    for i, sk in enumerate(gen["skip_convs"]):
        conv = {}
        _inv_conv(conv, f"decoder.skip_conv_{i + 1}", sk)
        out.update({"vae:" + k: v for k, v in conv.items()})
    return out


def disc_heads_pair(heads, sn):
    """(heads, sn) of the unpaired step's two discriminators: the JAX
    {"a": heads, "b": heads} and {"a": sn, "b": sn} trees -> flat
    dictionaries keyed "a:<name>" and "b:<name>" (training/unpaired.py)."""
    out: Dict[str, np.ndarray] = {}
    flat_sn: Dict[str, np.ndarray] = {}
    for d in ("a", "b"):
        h, u = disc_heads(heads[d], sn[d])
        out.update({f"{d}:{k}": v for k, v in h.items()})
        flat_sn.update({f"{d}:{k}": v for k, v in u.items()})
    return out, flat_sn


def cycle_trainables(gen) -> Dict[str, np.ndarray]:
    """The JAX unpaired step's trainable tree ({"unet_lora": {adapter:
    modules}, "conv_in", "vae_a2b_lora", "vae_a2b_skip", "vae_b2a_lora",
    "vae_b2a_skip"}) -> the port's flat `gen` keys (training/unpaired.py)."""
    out: Dict[str, np.ndarray] = {}
    for adapter, modules in gen["unet_lora"].items():
        for name, e in modules.items():
            for ab in ("a", "b"):
                out[f"unet_lora:{adapter}:{name}.{ab}"] = \
                    np.asarray(e[ab]).copy()
    conv: Dict[str, np.ndarray] = {}
    _inv_conv(conv, "conv_in", gen["conv_in"])
    out.update({"unet:" + k: v for k, v in conv.items()})
    for vae in ("vae_a2b", "vae_b2a"):
        for name, e in gen[vae + "_lora"].items():
            for ab in ("a", "b"):
                out[f"{vae}_lora:{name}.{ab}"] = np.asarray(e[ab]).copy()
        for i, sk in enumerate(gen[vae + "_skip"]):
            conv = {}
            _inv_conv(conv, f"decoder.skip_conv_{i + 1}", sk)
            out.update({f"{vae}:" + k: v for k, v in conv.items()})
    return out


def inception_state_dict(params) -> Dict[str, np.ndarray]:
    """metrics/inception.InceptionV3 state dict from the JAX folded-BN tree
    (`metrics/inception.py:init_inception`): each BasicConv2d's HWIO
    kernel as an OIHW `weight`, its `scale` and `bias`; the trees' stride
    and padding entries are structure, not weights."""
    out: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        if "kernel" in tree:
            _inv_conv(out, prefix, {"kernel": tree["kernel"]})
            out[prefix + ".scale"] = np.asarray(tree["scale"]).copy()
            out[prefix + ".bias"] = np.asarray(tree["bias"]).copy()
            return
        for k, v in tree.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(params, "")
    return out


def dino_state_dict(params) -> Dict[str, np.ndarray]:
    """models/dino.DINO state dict (torch.hub DINO names) from the JAX
    tree (`models/dino.py:init_dino`): the 28x28 position grid and the
    class position joined into `pos_embed` (1, 1 + 784, D) as the hub
    model stores them."""
    out: Dict[str, np.ndarray] = {}
    _inv_conv(out, "patch_embed.proj", params["patch_embed"])
    d = np.asarray(params["cls_token"]).shape[-1]
    out["cls_token"] = np.asarray(params["cls_token"]).reshape(1, 1, d).copy()
    grid = np.asarray(params["pos_embed_grid"]).reshape(-1, d)
    out["pos_embed"] = np.concatenate(
        [np.asarray(params["pos_embed_cls"]).reshape(1, d), grid])[None]
    for i, blk in enumerate(params["blocks"]):
        pre = f"blocks.{i}."
        _inv_norm(out, pre + "norm1", blk["ln1"])
        _inv_lin(out, pre + "attn.qkv", blk["qkv"])
        _inv_lin(out, pre + "attn.proj", blk["proj"])
        _inv_norm(out, pre + "norm2", blk["ln2"])
        _inv_lin(out, pre + "mlp.fc1", blk["fc1"])
        _inv_lin(out, pre + "mlp.fc2", blk["fc2"])
    _inv_norm(out, "norm", params["ln_final"])
    return out


def lora_tree(lora) -> Dict:
    """A JAX adapter ({"rank", "alpha", "modules": {name: {"a", "b"}}}) as
    the port's (lora.py): the same layout, with torch tensors."""
    return {"rank": int(lora["rank"]), "alpha": float(lora["alpha"]),
            "modules": {n: {k: torch.as_tensor(np.asarray(e[k]))
                            for k in ("a", "b")}
                        for n, e in lora["modules"].items()}}


def load(module: torch.nn.Module, state_dict) -> torch.nn.Module:
    """Strictly load a {name: numpy array or tensor} dict into `module`."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=True)
    return module


def _build(cfg):
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
    if isinstance(cfg, UNetConfig):
        return UNet2DConditionModel(cfg)
    if isinstance(cfg, VAEConfig):
        return AutoencoderKL(cfg)
    raise TypeError(f"no model for config {type(cfg).__name__}")


def random_params(cfg, generator: torch.Generator,
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Seeded random state dict for a UNetConfig or VAEConfig, on
    generator.device, following the JAX init scheme."""
    with torch.device("meta"):
        model = _build(cfg)
    dev = generator.device
    modules = dict(model.named_modules())
    out: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        mod = modules[mod_name]
        if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
            t = (torch.ones if leaf == "weight" else torch.zeros)(
                p.shape, device=dev, dtype=dtype)
        elif mod_name.rsplit(".", 1)[-1].startswith("skip_conv_"):
            t = torch.full(p.shape, 1e-5, device=dev, dtype=dtype)
        else:
            # fan_in = in_features, or in_ch * kh * kw for a conv
            bound = 1.0 / math.sqrt(math.prod(mod.weight.shape[1:]))
            t = (torch.rand(p.shape, generator=generator, device=dev,
                            dtype=torch.float32) * 2 - 1) * bound
            t = t.to(dtype)
        out[name] = t
    return out


def random_model(cfg, generator: torch.Generator) -> torch.nn.Module:
    """The model for `cfg`, allocated on generator.device (never built on
    the host first) and loaded with `random_params`."""
    with torch.device("meta"):
        model = _build(cfg)
    model = model.to_empty(device=generator.device)
    return load(model, random_params(cfg, generator))


# the paired trainer's default ranks (JAX utils/config_args.py:80-81)
PIX2PIX_RANK_UNET, PIX2PIX_RANK_VAE = 8, 4
# std of the random B factors of the random adapters: B = 0 at init would
# make the merge, and so r's effect through it, vanish
B_STD = 0.01


def _randomize_b(loras, generator: torch.Generator) -> None:
    """Give every adapter's B factor N(0, B_STD^2) entries, in place."""
    for lora in loras:
        for e in lora["modules"].values():
            e["b"] = torch.randn(e["b"].shape, generator=generator,
                                 device=generator.device) * B_STD


def random_sketch_model(cfgs, generator: torch.Generator):
    """(unet, vae, lora) of a seeded random sketch model on
    generator.device (pix2pix.py:126-149 with the TwinConv of
    :201-217): random SD-Turbo-layout modules with the base weights, the
    UNet's conv_in a TwinConv whose current branch is drawn anew (so that r
    blends two different convs), and factored pix2pix LoRA {"unet", "vae"}
    at the paired trainer's ranks with random B factors."""
    from img2img_turbo_tpu_torch import lora as lora_mod
    from img2img_turbo_tpu_torch.models.unet import make_twin_conv_in
    unet = random_model(cfgs.unet, generator)
    vae = random_model(cfgs.vae, generator)
    lora = {"unet": lora_mod.init_lora(unet, PIX2PIX_RANK_UNET,
                                       lora_mod.PIX2PIX_UNET_TARGETS,
                                       generator),
            "vae": lora_mod.init_lora(vae, PIX2PIX_RANK_VAE,
                                      lora_mod.PIX2PIX_VAE_TARGETS,
                                      generator)}
    _randomize_b(lora.values(), generator)
    make_twin_conv_in(unet)
    curr = unet.conv_in.conv_in_curr
    with torch.no_grad():
        for p in (curr.weight, curr.bias):
            bound = 1.0 / math.sqrt(math.prod(curr.weight.shape[1:]))
            p.copy_((torch.rand(p.shape, generator=generator,
                                device=generator.device) * 2 - 1) * bound)
    return unet, vae, lora


def random_cyclegan_model(cfgs, generator: torch.Generator
                          ) -> Dict[str, torch.nn.Module]:
    """{"unet", "vae_a2b", "vae_b2a"} of a seeded random CycleGAN model on
    generator.device, dense: `cyclegan.init_factored`'s modules and
    adapters, with random B factors, merged by `cyclegan.merge`, so the two
    directions' VAEs differ."""
    from img2img_turbo_tpu_torch.pipelines import cyclegan
    base, loras = cyclegan.init_factored(cfgs, generator)
    _randomize_b([*loras["unet"].values(), loras["vae_a2b"],
                  loras["vae_b2a"]], generator)
    return cyclegan.merge(base, loras)
