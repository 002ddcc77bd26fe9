"""Pretrained files -> the port's modules (counterpart of
`img2img_turbo_tpu/weights/torch_import.py`).

`load_safetensors` is the port's own reader of the safetensors format (an
8-byte little-endian header length, a JSON header of {name: {"dtype",
"shape", "data_offsets"}} plus an optional "__metadata__", then the raw
little-endian tensor bytes), read through `mmap` and numpy, one tensor at a
time, each moved to its device as it is read, so that no second copy of a
whole model is held on the host. `save_safetensors` writes the same format
(test and smoke tooling: the repository holds no pretrained file, so the
tests and chip_smoke.py write snapshots in the published layout).
`load_torch_pickle` reads the reference's pkl checkpoints.

The port's UNet, VAE and CLIP text tower use diffusers / transformers
parameter names, so a published state dict mostly loads as it is
(`load_state_dict(strict=True)`; the UNet's entirely); the maps below
handle the rest:
- the VAE mid-block attention of older diffusers exports (`query`, `key`,
  `value`, `proj_attn`, `norm` for `group_norm`, conv-shaped (C, C, 1, 1)
  weights; torch_import.py:395-424);
- a VAE file without the img2img-turbo skip convs: they start at 1e-5
  (torch_import.py:459-466);
- the text encoder's `text_model.` prefix and its `position_ids` buffer
  (convert_clip_text_state_dict, torch_import.py:89-115).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from img2img_turbo_tpu_torch.configs import CLIPTextConfig, UNetConfig, VAEConfig

# safetensors dtype tag -> (numpy dtype the bytes are read as, torch dtype)
_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<i2"), torch.bfloat16),   # no numpy bf16: raw bits
    "I64": (np.dtype("<i8"), torch.int64),
}
_TAGS = {t: tag for tag, (_, t) in _DTYPES.items()}


def load_safetensors(path: str, device=None) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a .safetensors file, in the file's dtypes (F32,
    F16, BF16, I64), each tensor on `device` (the CPU when None)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — expected a local HF stabilityai/sd-turbo "
            "snapshot with unet/vae/text_encoder subfolders (fetch with "
            "`huggingface-cli download stabilityai/sd-turbo` on a networked "
            "machine and point --sd_turbo_path at it)")
    device = torch.device(device or "cpu")
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        (n,) = struct.unpack("<Q", mm[:8])
        header = json.loads(mm[8:8 + n].decode("utf-8"))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                                 f"the reader takes {sorted(_DTYPES)}")
            np_dtype, dtype = _DTYPES[info["dtype"]]
            start, end = info["data_offsets"]
            shape = tuple(info["shape"])
            if end - start != np_dtype.itemsize * int(np.prod(shape)):
                raise ValueError(f"{path}: {name}'s byte range does not fit "
                                 f"its shape {shape}")
            # copied out of the map (offsets need not be aligned), so the
            # tensor outlives the map; one tensor at a time on the host
            arr = np.frombuffer(mm, np.uint8, end - start, base + start
                                ).copy().view(np_dtype) if end > start \
                else np.zeros(0, np_dtype)
            t = torch.from_numpy(arr).reshape(shape)
            if dtype is torch.bfloat16:
                t = t.view(torch.bfloat16)
            out[name] = t.to(device)
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> int:
    """Write `tensors` (torch tensors on any device, in a dtype the reader
    takes) as a .safetensors file, in the given order, one tensor at a time
    through the host. Returns the bytes written."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of "
                             f"{sorted(_DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)   # the format pads its header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            if t.dtype is torch.bfloat16:
                t = t.view(torch.int16)
            f.write(t.numpy().tobytes())
    return 8 + len(blob) + offset


def load_torch_pickle(path: str):
    """A reference pkl checkpoint with every tensor made fp32 on the CPU.
    Read with `weights_only=True`: the published pkls hold only dicts,
    lists, strings, numbers and tensors, and a file that needs arbitrary
    unpickling raises here rather than run its code."""
    obj = torch.load(path, map_location="cpu", weights_only=True)

    def to_f32(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float()
        if isinstance(x, dict):
            return {k: to_f32(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to_f32(v) for v in x)
        return x

    return to_f32(obj)


# ---------------------------------------------------------------------------
# Key maps: published state dicts -> the port's module names
# ---------------------------------------------------------------------------


def _vae_mid(sd, out, prefix):
    """The mid-block attention under the current diffusers names, from the
    current or the legacy ones (torch_import.py:395-424)."""
    ap = prefix + ".attentions.0"
    legacy = {"to_q": "query", "to_k": "key", "to_v": "value",
              "to_out.0": "proj_attn", "group_norm": "norm"}
    for new, old in legacy.items():
        src = new if f"{ap}.{new}.weight" in sd else old
        for field in ("weight", "bias"):
            k = f"{ap}.{src}.{field}"
            if k not in sd:
                continue
            w = out.pop(k)
            if field == "weight" and w.ndim == 4:   # (C, C, 1, 1)
                w = w[:, :, 0, 0]
            out[f"{ap}.{new}.{field}"] = w


def vae_state_dict(sd: Mapping[str, torch.Tensor], cfg: VAEConfig
                   ) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict (current or legacy attention
    names) -> the port's AutoencoderKL names; without the skip convs in the
    file they start at 1e-5 (the reference's zero-convs)."""
    out = dict(sd)
    for side in ("encoder", "decoder"):
        _vae_mid(sd, out, f"{side}.mid_block")
    if "decoder.skip_conv_1.weight" not in sd:
        for i, (ic, oc) in enumerate(cfg.skip_conv_channels):
            out[f"decoder.skip_conv_{i + 1}.weight"] = torch.full(
                (oc, ic, 1, 1), 1e-5)
    return out


def clip_text_state_dict(sd: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A transformers CLIPTextModel state dict -> models/clip_text names:
    the `text_model.` prefix stripped, the position_ids buffer dropped."""
    pre = "text_model."
    out = {}
    for k, v in sd.items():
        name = k[len(pre):] if k.startswith(pre) else k
        if name != "embeddings.position_ids":
            out[name] = v
    return out


# ---------------------------------------------------------------------------
# Whole modules
# ---------------------------------------------------------------------------


def build_on(make, device) -> torch.nn.Module:
    """`make()`'s module allocated on `device` without a host copy first
    (its parameters uninitialised until loaded)."""
    with torch.device("meta"):
        model = make()
    return model.to_empty(device=torch.device(device))


def load_into(model: torch.nn.Module, sd: Mapping[str, torch.Tensor]
              ) -> torch.nn.Module:
    """Strictly load `sd` into `model`, each tensor cast to the parameter's
    dtype (a fp16 file into fp32 masters)."""
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return model


def load_unet(path: str, cfg: UNetConfig, device=None) -> torch.nn.Module:
    """The UNet of a diffusers safetensors file, fp32, on `device`."""
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    return load_into(build_on(lambda: UNet2DConditionModel(cfg), device),
                     load_safetensors(path, device))


def load_vae(path: str, cfg: VAEConfig, device=None) -> torch.nn.Module:
    """The VAE of a diffusers safetensors file, fp32, on `device`."""
    return vae_from_state_dict(load_safetensors(path, device), cfg, device)


def vae_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: VAEConfig,
                        device=None) -> torch.nn.Module:
    """The VAE of a diffusers state dict (`vae_state_dict`), fp32, on
    `device`."""
    from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
    return load_into(build_on(lambda: AutoencoderKL(cfg), device),
                     vae_state_dict(sd, cfg))


def load_clip_text(path: str, cfg: CLIPTextConfig,
                   device=None) -> torch.nn.Module:
    """The text encoder of a transformers safetensors file, fp32, on
    `device`."""
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    sd = clip_text_state_dict(load_safetensors(path, device))
    return load_into(build_on(lambda: CLIPTextModel(cfg), device), sd)


SNAPSHOT_FILES = {"unet": os.path.join("unet",
                                       "diffusion_pytorch_model.safetensors"),
                  "vae": os.path.join("vae",
                                      "diffusion_pytorch_model.safetensors"),
                  "text": os.path.join("text_encoder", "model.safetensors"),
                  "tokenizer": "tokenizer"}


def load_snapshot(sd_turbo_dir: str, cfgs, device=None,
                  parts=("unet", "vae", "text", "tokenizer")) -> Dict:
    """{part: module or tokenizer} of a local stabilityai/sd-turbo
    snapshot (the HF layout, SNAPSHOT_FILES): fp32 modules on `device`,
    the BPE tokenizer from `tokenizer/`."""
    from img2img_turbo_tpu_torch.models.tokenizer import CLIPTokenizer
    loaders = {"unet": lambda p: load_unet(p, cfgs.unet, device),
               "vae": lambda p: load_vae(p, cfgs.vae, device),
               "text": lambda p: load_clip_text(p, cfgs.text, device),
               "tokenizer": CLIPTokenizer.from_dir}
    return {part: loaders[part](os.path.join(sd_turbo_dir,
                                             SNAPSHOT_FILES[part]))
            for part in parts}
