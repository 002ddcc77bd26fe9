"""JAX parameter trees -> the port's modules, and seeded random weights.

`unet_state_dict` / `vae_state_dict` are a numpy-only copy of the inverse
converters of `img2img_turbo_tpu/weights/torch_import.py:223-352`: they take
the JAX tree (leaves as numpy arrays) and give diffusers-named state dicts
in torch layouts (conv HWIO -> OIHW, linear (in, out) -> (out, in)), which
`load` feeds to `load_state_dict(strict=True)`. No JAX is imported.

`random_params` draws a state dict with the JAX package's init scheme
(`models/layers.py:37-68`, `models/vae.py:225-231`): U(+-1/sqrt(fan_in)) for
every conv/linear weight and bias, GroupNorm/LayerNorm scale 1 and bias 0,
the VAE skip zero-convs constant 1e-5. SD-Turbo's pretrained weights are not
in the repository, so the chip smoke runs on these.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from img2img_turbo_tpu.configs import UNetConfig, VAEConfig


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
    _inv_conv(out, "conv_in", params["conv_in"])
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
