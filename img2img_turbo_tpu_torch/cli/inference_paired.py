"""Paired (pix2pix-turbo) inference CLI on one card (counterpart of
`cli/inference_paired.py`; reference src/inference_paired.py:11-75):

    python -m img2img_turbo_tpu_torch.cli.inference_paired \\
        --sd_turbo_path sd-turbo --model_name edge_to_image \\
        --input_image bird.png --prompt "a blue bird" --use_fp16

--sd_turbo_path (or $SD_TURBO_PATH) is a local stabilityai/sd-turbo
snapshot; --model_name resolves to <ckpt_folder>/<file>.pkl (the machine
needs no network: a missing file stops the run with its download URL);
--model_path takes any reference-schema pkl. The image is resized to a
multiple of 8 (PIL LANCZOS), then: edge_to_image takes its canny map at
the given thresholds; sketch_to_image_stochastic thresholds the sketch
(< 0.5 -> 1) and blends a noise map from a torch.Generator seeded --seed at
r = --gamma; a custom model takes the image in [0, 1]. The output PNG goes
to <output_dir>/<input file name>.

--use_fp16 means bf16, as in the JAX CLI. On a CUDA device the port's
Hopper kernels take bf16 activations only, so without --use_fp16 the CLI
stops there rather than fall back to the plain path; fp32 runs on the CPU
(`main(args, device="cpu")`).
"""

from __future__ import annotations

import argparse
import os
import time


NAMED_CKPTS = {
    "edge_to_image": "edge_to_image_loras.pkl",
    "sketch_to_image_stochastic": "sketch_to_image_stochastic_lora.pkl",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--input_image", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--model_name", type=str, default="")
    p.add_argument("--model_path", type=str, default="")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--low_threshold", type=int, default=100)
    p.add_argument("--high_threshold", type=int, default=200)
    p.add_argument("--gamma", type=float, default=0.4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--use_fp16", action="store_true")
    p.add_argument("--sd_turbo_path", type=str,
                   default=os.environ.get("SD_TURBO_PATH", ""),
                   help="local HF stabilityai/sd-turbo snapshot directory")
    p.add_argument("--ckpt_folder", type=str, default="checkpoints")
    return p


def inference_dtype(use_fp16: bool, device):
    """bf16 under --use_fp16, else fp32; on a CUDA device the kernels take
    bf16 only, so fp32 stops the run there."""
    import torch
    if torch.device(device).type == "cuda" and not use_fp16:
        raise SystemExit(
            "on a CUDA device the port runs its Hopper kernels, which take "
            "bf16 activations only: pass --use_fp16 (bf16); fp32 runs only "
            "on the CPU")
    return torch.bfloat16 if use_fp16 else torch.float32


def load_multiple_of_8(path: str):
    """(PIL image resized to a multiple of 8 with LANCZOS, its uint8 array
    (H, W, 3)) (reference inference_paired.py:38-41)."""
    import numpy as np
    from PIL import Image
    img = Image.open(path).convert("RGB")
    new_w, new_h = img.width - img.width % 8, img.height - img.height % 8
    img = img.resize((new_w, new_h), Image.LANCZOS)
    return img, np.array(img, np.uint8)


def prepare(args, arr, dtype, device):
    """(the generator input c_t, the pipeline call's keyword arguments) for
    the uint8 (H, W, 3) image `arr`, per mode."""
    import torch
    from img2img_turbo_tpu_torch.ops import canny as canny_mod
    from img2img_turbo_tpu_torch.ops import image as image_mod
    x = torch.from_numpy(arr)[None].to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.model_name == "edge_to_image":
        c_t = canny_mod.canny_3ch_unit(x, float(args.low_threshold),
                                       float(args.high_threshold))
        return c_t.to(dtype), dict(generator=gen)
    unit = image_mod.uint8_to_unit(x)
    if args.model_name == "sketch_to_image_stochastic":
        # the sketch: below 0.5 becomes 1 (reference :55-58)
        h, w = arr.shape[:2]
        noise_map = torch.randn((1, h // 8, w // 8, 4), generator=gen,
                                device=device, dtype=dtype)
        return (unit < 0.5).to(dtype), dict(
            deterministic=False, r=args.gamma, noise_map=noise_map,
            generator=gen)
    return unit.to(dtype), dict(generator=gen)


def main(args, device=None, cfgs=None):
    """Translate --input_image as the flags say, on `device` (the CUDA card
    when None); `cfgs` (GeneratorConfigs) only for small test models.
    Returns {"output": PNG path, "load_seconds", "image_seconds"}."""
    import torch
    from PIL import Image
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.ops import image as image_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import Pix2PixTurbo
    from img2img_turbo_tpu_torch.utils.download import BASE_URL

    # exactly one of model_name / model_path (reference :26-30)
    if (args.model_name == "") == (args.model_path == ""):
        raise SystemExit(
            "Either model_name or model_path should be provided, not both")
    if not args.sd_turbo_path:
        raise SystemExit("--sd_turbo_path (or $SD_TURBO_PATH) is required: "
                         "path to a local stabilityai/sd-turbo snapshot")
    ckpt_path = args.model_path
    if args.model_name:
        fname = NAMED_CKPTS.get(args.model_name)
        if fname is None:
            raise SystemExit(f"unknown model_name {args.model_name!r}; "
                             f"choose from {sorted(NAMED_CKPTS)}")
        ckpt_path = os.path.join(args.ckpt_folder, fname)
        if not os.path.exists(ckpt_path):
            raise SystemExit(
                f"checkpoint {ckpt_path} not found; this machine has no "
                f"network — download {BASE_URL}{fname} elsewhere and "
                f"place it there")
    dev = resolve_device(device)
    dtype = inference_dtype(args.use_fp16, dev)

    t0 = time.perf_counter()
    pipe = Pix2PixTurbo.from_pretrained(
        args.sd_turbo_path, ckpt_path,
        stochastic=args.model_name == "sketch_to_image_stochastic",
        cfgs=cfgs, dtype=dtype, device=dev)
    t1 = time.perf_counter()
    _, arr = load_multiple_of_8(args.input_image)
    c_t, kw = prepare(args, arr, dtype, dev)
    out = pipe(c_t, prompt=args.prompt, **kw)
    out_u8 = image_mod.signed_to_uint8(out)[0].cpu().numpy()
    t2 = time.perf_counter()

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            os.path.basename(args.input_image))
    Image.fromarray(out_u8).save(out_path)
    print(f"saved {out_path}")
    return {"output": out_path, "load_seconds": t1 - t0,
            "image_seconds": t2 - t1}


if __name__ == "__main__":
    main(build_parser().parse_args())
