"""Serving engine: the uint8-in / uint8-out paths (counterpart of
`img2img_turbo_tpu/serving/engine.py`).

Three modes, all on one device with parameters and the prompt embedding in
the engine's dtype:
- "edge_to_image": uint8 RGB -> on-device canny -> VAE encode (posterior
  sample) -> UNet at t=999 -> closed-form x0 -> skip-fused VAE decode ->
  uint8, on LoRA-merged weights (engine.py:26-38);
- "image": the same generator on uint8 RGB mapped to [-1, 1] (the
  CycleGAN-Turbo input, engine.py:41-52);
- "sketch": the stochastic path (engine.py:55-70): the sketch thresholded
  at < 0.5, LoRA merged per request at the runtime scale r, the TwinConv
  blend, unet_in = z*r + noise*(1-r) and decoder gamma = r. Its modules
  hold weights that change per request, so they run the live-weight path
  (`lora.swap_params`, as the trainer does) and are never given kernel
  layouts that would go stale.
`use_kernels=False` runs the plain PyTorch path on the same weights (the
reference the kernel path is checked against); there is no other way to
reach it.

With `mesh` (a `parallel.mesh.DataMesh`) the engine serves one global
batch across the ranks of a data axis (engine.py:88-106): every rank calls
`run` with the same global batch, draws the posterior noise (and in sketch
mode the noise map) for the global batch from the same generator, computes
its contiguous rows through its own kernels, and `gather_batch` returns the
global batch on every rank. Each rank's rows are then the one-process
engine's output on those rows with that noise.

With a model axis (`mesh.n_model` above 1; "edge_to_image" and "image"),
the engine shards its UNet over the model ranks at construction
(`parallel.tensor.shard_module`, JAX's rule): each rank holds only its
shards and runs the kernels on them, the VAE stays whole on every rank
(the JAX engine has no model axis; a sharded VAE would gather about
1.57 GB a 512x512 request, counted from its shapes, to save about 0.08 GB
of bf16 weights a rank), and the ranks of a model group serve the same
rows, each returning them whole.
The sketch mode merges LoRA per request and is not ported to shards: it
raises (ROADMAP, Queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from img2img_turbo_tpu_torch import resolve_device, scheduler
from img2img_turbo_tpu_torch.models.layers import prepare_kernels
from img2img_turbo_tpu_torch.ops import canny as canny_mod
from img2img_turbo_tpu_torch.ops import image as image_mod
from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                       generate_unclamped,
                                                       lora_merged_at)
from img2img_turbo_tpu_torch.utils import profiling

MODES = ("edge_to_image", "image", "sketch")


def _output(res: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """res with its image rounded to uint8 under "out"."""
    with profiling.span("i2i.serve.output"):
        res["out"] = image_mod.signed_to_uint8(res["img"])
    return res


def _serve_edge(unet, vae, cfgs: GeneratorConfigs, alphas, image_u8,
                caption_enc, low: float, high: float, *, kernels: bool,
                noise=None, generator=None, tp=None
                ) -> Dict[str, torch.Tensor]:
    """uint8 RGB -> canny control -> one-step generator -> uint8 RGB.
    Returns the uint8 output under "out", with the scaled latent "z", the
    denoised latent "x0" and the decoded image before the uint8 cast
    "img". tp: the model axis's mesh of a sharded UNet."""
    with profiling.span("i2i.serve.input"):
        c_t = canny_mod.canny_3ch_unit(image_u8, low, high).to(
            caption_enc.dtype)
    res = generate_unclamped(unet, vae, cfgs, alphas, c_t, caption_enc,
                             kernels=kernels, noise=noise,
                             generator=generator, tp=tp)
    return _output(res)


def _serve_image(unet, vae, cfgs: GeneratorConfigs, alphas, image_u8,
                 caption_enc, *, kernels: bool, noise=None,
                 generator=None, tp=None) -> Dict[str, torch.Tensor]:
    """uint8 RGB -> [-1, 1] -> one-step generator -> uint8 RGB; returns
    as `_serve_edge`."""
    with profiling.span("i2i.serve.input"):
        c_t = image_mod.uint8_to_signed(image_u8).to(caption_enc.dtype)
    res = generate_unclamped(unet, vae, cfgs, alphas, c_t, caption_enc,
                             kernels=kernels, noise=noise,
                             generator=generator, tp=tp)
    return _output(res)


def _serve_sketch(unet, vae, lora, cfgs: GeneratorConfigs, alphas, image_u8,
                  caption_enc, r, noise_map, *, kernels: bool, noise=None,
                  generator=None) -> Dict[str, torch.Tensor]:
    """uint8 sketch -> threshold < 0.5 -> the stochastic generator with
    LoRA merged at r -> uint8 (reference inference_paired.py:55-63 and
    pix2pix_turbo.py:204-218); returns as `_serve_edge`."""
    with profiling.span("i2i.serve.input"):
        c_t = (image_mod.uint8_to_unit(image_u8) < 0.5).to(
            caption_enc.dtype)
    with lora_merged_at(unet, vae, lora, r):
        res = generate_unclamped(unet, vae, cfgs, alphas, c_t, caption_enc,
                                 kernels=kernels, noise=noise,
                                 generator=generator, r=r,
                                 noise_map=noise_map)
    return _output(res)


class ServingEngine:
    """One-step translation server on one device.

    params ("edge_to_image", "image"): {"unet": UNet2DConditionModel,
    "vae": AutoencoderKL} with the LoRA-merged weights loaded (for a
    CycleGAN model, its UNet with the VAE of one direction). base and lora
    ("sketch"): {"unet" (with a TwinConv conv_in), "vae"} holding the base
    weights, and their factored adapters {"unet", "vae"}. Modules are moved
    to `device` (the CUDA card unless the caller names another; without a
    card the caller must pass device="cpu") and cast to `dtype` once, here;
    the merged modes' modules also get their kernel layouts here. With a
    model axis in `mesh`, the UNet module is sharded in place (as `.to()`
    moves it in place) before its layouts are packed."""

    def __init__(self, params: Optional[Dict[str, torch.nn.Module]] = None,
                 cfgs: Optional[GeneratorConfigs] = None,
                 mode: str = "edge_to_image", dtype=torch.bfloat16,
                 canny_low: float = 100.0, canny_high: float = 200.0,
                 device=None, use_kernels: bool = True,
                 base: Optional[Dict[str, torch.nn.Module]] = None,
                 lora: Optional[Dict] = None, mesh=None):
        if mode not in MODES:
            raise ValueError(f"unknown serving mode {mode!r}")
        if mode == "sketch" and (base is None or lora is None):
            raise ValueError("sketch mode takes base and lora (factored, for "
                             "the runtime r)")
        if mode != "sketch" and params is None:
            raise ValueError(f"{mode} mode takes params (merged weights)")
        self.tp = mesh if mesh is not None and mesh.n_model > 1 else None
        if self.tp is not None and mode == "sketch":
            raise NotImplementedError(
                "sketch mode under a model axis: its per-request LoRA merge "
                "(pipelines/pix2pix.py lora_merged_at) on shards is not "
                "ported (ROADMAP, Queue 1 item 3)")
        self.cfgs = cfgs or GeneratorConfigs()
        self.mode, self.dtype = mode, dtype
        self.canny_low, self.canny_high = canny_low, canny_high
        self.use_kernels = use_kernels
        self.mesh = mesh
        self.device = resolve_device(mesh.device if device is None and
                                     mesh is not None else device)
        if mode == "sketch":
            self.unet, self.vae = (base[k].to(device=self.device,
                                              dtype=dtype).eval()
                                   for k in ("unet", "vae"))
            self.lora = {k: dict(v, modules={
                n: {f: t.to(device=self.device, dtype=dtype)
                    for f, t in e.items()}
                for n, e in v["modules"].items()}) for k, v in lora.items()}
        else:
            unet = tensor_mod.shard_module(
                params["unet"].to(device=self.device, dtype=dtype),
                self.tp, tensor_mod.head_dim(self.cfgs.unet))
            self.unet, self.vae = (prepare_kernels(m.eval()) for m in (
                unet, params["vae"].to(device=self.device, dtype=dtype)))
        self.alphas = scheduler.make_alphas_cumprod(device=self.device)

    @classmethod
    def from_native(cls, path: str, mode: Optional[str] = None,
                    cfgs: Optional[GeneratorConfigs] = None, **kw
                    ) -> "ServingEngine":
        """An engine on a native checkpoint (`cli/convert_weights.py`): a
        deterministic one serves `mode` ("edge_to_image" by default, or
        "image"), a stochastic one "sketch". `kw` as the constructor's."""
        from img2img_turbo_tpu_torch.weights.native import load_native
        dev = kw.get("device")
        if dev is None and kw.get("mesh") is not None:
            dev = kw["mesh"].device
        loaded = load_native(path, cfgs, dev)
        if "params" in loaded:
            return cls(loaded["params"], loaded["cfgs"],
                       mode=mode or "edge_to_image", **kw)
        if mode not in (None, "sketch"):
            raise ValueError(f"{path} holds a stochastic model: mode "
                             f"'sketch', not {mode!r}")
        return cls(cfgs=loaded["cfgs"], mode="sketch", base=loaded["base"],
                   lora=loaded["lora"], **kw)

    @torch.no_grad()
    @profiling.spanned("i2i.serve.run", unit=True)
    def run(self, image_u8, caption_enc, generator=None, noise=None,
            r: float = 0.4, noise_map=None) -> Dict[str, torch.Tensor]:
        """image_u8: (B, H, W, 3) uint8 (numpy or tensor), H and W
        multiples of 8; caption_enc: (1 or B, 77, cross_dim). The posterior
        noise is `noise` when given, else drawn from `generator` (a
        torch.Generator on the engine's device; seed 0 when None). Sketch
        mode only: r (float or 0-d tensor) and the noise map
        (B, H/8, W/8, 4), drawn from `generator` before the posterior noise
        when not given. With a mesh whose data axis has W ranks, B must
        divide by W; the returned tensors are the global batch on every
        rank."""
        if not isinstance(image_u8, torch.Tensor):
            image_u8 = torch.from_numpy(np.asarray(image_u8))
        image_u8 = image_u8.to(self.device)
        if image_u8.dtype != torch.uint8 or image_u8.ndim != 4 \
                or image_u8.shape[-1] != 3:
            raise ValueError("image_u8 must be (B, H, W, 3) uint8, got "
                             f"{tuple(image_u8.shape)} {image_u8.dtype}")
        b, h, w, _ = image_u8.shape
        if h % 8 or w % 8:
            raise ValueError(f"H and W must be multiples of 8, got {(h, w)}")
        if noise_map is not None and self.mode != "sketch":
            raise ValueError("noise_map applies only to sketch mode")
        caption_enc = caption_enc.to(device=self.device, dtype=self.dtype)
        if caption_enc.shape[0] != b:
            caption_enc = caption_enc.expand(b, *caption_enc.shape[1:])
        caption_enc = caption_enc.contiguous()
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        f = 2 ** (self.cfgs.vae.num_levels - 1)
        lat = (b, h // f, w // f, self.cfgs.vae.latent_channels)
        if self.mode == "sketch" and noise_map is None:
            noise_map = torch.randn(lat, generator=generator,
                                    device=self.device, dtype=self.dtype)
        mesh = self.mesh
        if mesh is None or mesh.world == 1:
            return self._run(image_u8, caption_enc, generator, noise, r,
                             noise_map)
        if b % mesh.world:
            raise ValueError(f"batch {b} is not divisible by the "
                             f"{mesh.world} ranks of the data axis")
        if noise is None:   # the global batch's draw, as one process makes
            noise = torch.randn(lat, generator=generator,
                                device=self.device, dtype=self.dtype)
        rows = mesh_mod.shard_batch(
            {"image_u8": image_u8, "caption_enc": caption_enc,
             "noise": noise, "noise_map": noise_map}, mesh)
        res = self._run(rows["image_u8"], rows["caption_enc"].contiguous(),
                        None, rows["noise"], r, rows["noise_map"])
        return {k: mesh_mod.gather_batch(v.contiguous(), mesh)
                for k, v in res.items()}

    def _run(self, image_u8, caption_enc, generator, noise, r, noise_map):
        common = dict(kernels=self.use_kernels, noise=noise,
                      generator=generator)
        if self.mode == "edge_to_image":
            return _serve_edge(self.unet, self.vae, self.cfgs, self.alphas,
                               image_u8, caption_enc, self.canny_low,
                               self.canny_high, tp=self.tp, **common)
        if self.mode == "image":
            return _serve_image(self.unet, self.vae, self.cfgs, self.alphas,
                                image_u8, caption_enc, tp=self.tp, **common)
        r = torch.as_tensor(r, dtype=torch.float32, device=self.device)
        return _serve_sketch(self.unet, self.vae, self.lora, self.cfgs,
                             self.alphas, image_u8, caption_enc, r,
                             noise_map.to(device=self.device), **common)

    def __call__(self, image_u8, caption_enc, generator=None, noise=None,
                 r: float = 0.4, noise_map=None):
        """Returns the uint8 (B, H, W, 3) output on the engine's device."""
        return self.run(image_u8, caption_enc, generator, noise, r,
                        noise_map)["out"]

    def warmup(self, batch: int, height: int, width: int, caption_enc):
        dummy = torch.zeros((batch, height, width, 3), dtype=torch.uint8,
                            device=self.device)
        self(dummy, caption_enc)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self


# default shape buckets for arbitrary-size inputs (canvases of any size);
# one program shape per bucket instead of one per size
SIZE_BUCKETS = (256, 384, 512, 768, 1024)


def bucket_size(n: int, buckets=SIZE_BUCKETS) -> int:
    """The smallest bucket that holds n, else n rounded up to 256."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


class BucketedEngine:
    """Wraps a ServingEngine for arbitrary input sizes (engine.py:183-201):
    pads the image to the nearest (H, W) bucket by repeating its edge, runs
    the engine, crops the output back."""

    def __init__(self, engine: ServingEngine):
        self.engine = engine

    def __call__(self, image_u8, caption_enc, generator=None):
        arr = np.asarray(image_u8.cpu() if torch.is_tensor(image_u8)
                         else image_u8)
        b, h, w, c = arr.shape
        bh, bw = bucket_size(h), bucket_size(w)
        if (bh, bw) != (h, w):
            arr = np.pad(arr, ((0, 0), (0, bh - h), (0, bw - w), (0, 0)),
                         mode="edge")
        out = self.engine(arr, caption_enc, generator)
        return out[:, :h, :w]
