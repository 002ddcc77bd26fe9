"""The port's native serving checkpoint: one safetensors file holding what
`Pix2PixTurbo.load_pretrained` builds from an SD-Turbo snapshot and a
reference pkl (counterpart of the orbax checkpoint `cli/convert_weights.py`
writes: `params`, or `base` + `lora`, and `text`).

Layout of `<dir>/model.safetensors` (written by the port's own safetensors
writer, `torch_import.save_safetensors`; fp32 as loaded):
- "params.unet.<name>", "params.vae.<name>": LoRA-merged modules
  (deterministic models such as edge_to_image);
- or "base.unet.<name>" (a TwinConv conv_in), "base.vae.<name>" and
  "lora.unet.<module>.a" / ".b", "lora.vae.<module>.a" / ".b": the
  stochastic (sketch) model, LoRA kept factored for the runtime r;
- "text.<name>": the CLIP text tower.
The header's metadata holds {"format", "kind": "deterministic" or
"stochastic", "lora": JSON {model: {"rank", "alpha"}}}. The snapshot's BPE
tokenizer is copied beside it (`<dir>/tokenizer/`), so the directory is a
serving artifact on its own: `Pix2PixTurbo.from_native`,
`ServingEngine.from_native`.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
from typing import Dict, Optional

import torch

from img2img_turbo_tpu_torch.weights import torch_import as ti

FORMAT = "img2img-turbo-native/1"
FILE = "model.safetensors"


def _tensors(loaded: Dict) -> Dict[str, torch.Tensor]:
    """{file name: tensor} of `load_pretrained`'s keyword arguments."""
    out: Dict[str, torch.Tensor] = {}
    for part in ("params", "base"):
        for model, module in (loaded.get(part) or {}).items():
            out.update({f"{part}.{model}.{k}": v
                        for k, v in module.state_dict().items()})
    for model, lora in (loaded.get("lora") or {}).items():
        for name, e in sorted(lora["modules"].items()):
            for ab in ("a", "b"):
                out[f"lora.{model}.{name}.{ab}"] = e[ab]
    out.update({f"text.{k}": v
                for k, v in loaded["text"].state_dict().items()})
    return out


def save_native(out_dir: str, loaded: Dict,
                tokenizer_dir: Optional[str] = None) -> Dict:
    """Write `loaded` (`Pix2PixTurbo.load_pretrained`'s result) into
    `out_dir`, with the tokenizer directory copied when given. Returns
    {"path", "bytes", "tensors", "values"}."""
    os.makedirs(out_dir, exist_ok=True)
    tensors = _tensors(loaded)
    lora = loaded.get("lora") or {}
    meta = {"format": FORMAT,
            "kind": "stochastic" if loaded.get("base") else "deterministic",
            "lora": json.dumps({m: {"rank": v["rank"], "alpha": v["alpha"]}
                                for m, v in lora.items()})}
    path = os.path.join(out_dir, FILE)
    nbytes = ti.save_safetensors(tensors, path, metadata=meta)
    if tokenizer_dir:
        shutil.copytree(tokenizer_dir, os.path.join(out_dir, "tokenizer"),
                        dirs_exist_ok=True)
    return {"path": path, "bytes": nbytes, "tensors": len(tensors),
            "values": sum(t.numel() for t in tensors.values())}


def _metadata(path: str) -> Dict[str, str]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)).get("__metadata__", {})


def load_native(path: str, cfgs=None, device=None) -> Dict:
    """`Pix2PixTurbo`'s keyword arguments (fp32 modules on `device`) from a
    native checkpoint directory (or its model.safetensors)."""
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    from img2img_turbo_tpu_torch.models.tokenizer import CLIPTokenizer
    from img2img_turbo_tpu_torch.models.unet import (UNet2DConditionModel,
                                                     make_twin_conv_in)
    from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    root = path if os.path.isdir(path) else os.path.dirname(path)
    file = os.path.join(path, FILE) if os.path.isdir(path) else path
    meta = _metadata(file)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{file}: not a native checkpoint ({FORMAT})")
    cfgs = cfgs or GeneratorConfigs()
    dev = resolve_device(device)
    sd = ti.load_safetensors(file, dev)

    def part(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    stochastic = meta["kind"] == "stochastic"
    group = "base" if stochastic else "params"

    def unet():
        m = UNet2DConditionModel(cfgs.unet)
        return make_twin_conv_in(m) if stochastic else m
    modules = {
        "unet": ti.load_into(ti.build_on(unet, dev), part(f"{group}.unet.")),
        "vae": ti.load_into(ti.build_on(lambda: AutoencoderKL(cfgs.vae),
                                        dev), part(f"{group}.vae."))}
    text = ti.load_into(ti.build_on(lambda: CLIPTextModel(cfgs.text), dev),
                        part("text."))
    tok_dir = os.path.join(root, "tokenizer")
    out = dict(cfgs=cfgs, text=text,
               tokenizer=CLIPTokenizer.from_dir(tok_dir)
               if os.path.isdir(tok_dir) else None)
    if not stochastic:
        return dict(out, params=modules)
    lora = {}
    for model, rank_alpha in json.loads(meta["lora"]).items():
        mods: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, v in part(f"lora.{model}.").items():
            name, ab = k.rsplit(".", 1)
            mods.setdefault(name, {})[ab] = v
        lora[model] = dict(rank_alpha, modules=mods)
    return dict(out, base=modules, lora=lora)
