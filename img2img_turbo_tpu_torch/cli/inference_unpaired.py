"""Unpaired (CycleGAN-Turbo) inference CLI on one card (counterpart of
`cli/inference_unpaired.py`; reference src/inference_unpaired.py:10-58):

    python -m img2img_turbo_tpu_torch.cli.inference_unpaired \\
        --sd_turbo_path sd-turbo --model_name day_to_night \\
        --input_image street.png --use_fp16

--model_name (a published model, resolved to <ckpt_folder>/<file>.pkl,
which fixes the caption and direction) or --model_path (any CycleGAN-Turbo
pkl, with --prompt and --direction). --image_prep is one of the training
data transforms (`training/data.py`); the output is resized back to the
input's size with LANCZOS and written to <output_dir>/<input file name>.
--use_fp16 means bf16; on a CUDA device it is required (the kernels take
bf16 only), as in `inference_paired`.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--input_image", type=str, required=True)
    p.add_argument("--prompt", type=str, default=None,
                   help="required when using a custom model_path")
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--ckpt_folder", type=str, default="checkpoints")
    p.add_argument("--direction", type=str, default=None,
                   help="a2b or b2a; required with model_path")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--image_prep", type=str, default="resize_512x512")
    p.add_argument("--use_fp16", action="store_true")
    p.add_argument("--sd_turbo_path", type=str,
                   default=os.environ.get("SD_TURBO_PATH", ""))
    return p


def prepare(args, path):
    """(the (1, H, W, 3) fp32 input in [-1, 1] after --image_prep, the
    original (width, height))."""
    import numpy as np
    import torch
    from PIL import Image
    from img2img_turbo_tpu_torch.training.data import build_transform
    img = Image.open(path).convert("RGB")
    arr = np.asarray(build_transform(args.image_prep)(img),
                     np.float32) / 127.5 - 1.0
    return torch.from_numpy(arr)[None], img.size


def main(args, device=None, cfgs=None):
    """Translate --input_image as the flags say, on `device` (the CUDA card
    when None); `cfgs` only for small test models. Returns {"output",
    "load_seconds", "image_seconds"}."""
    from PIL import Image
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.cli.inference_paired import inference_dtype
    from img2img_turbo_tpu_torch.ops import image as image_mod
    from img2img_turbo_tpu_torch.pipelines.cyclegan import (NAMED_MODELS,
                                                            CycleGANTurbo)
    from img2img_turbo_tpu_torch.utils.download import BASE_URL

    # reference :22-27
    if (args.model_name is None) == (args.model_path is None):
        raise SystemExit(
            "Either model_name or model_path should be provided, not both")
    if args.model_path is not None and args.prompt is None:
        raise SystemExit("prompt is required when loading a custom model_path")
    if args.model_name is not None and args.prompt is not None:
        raise SystemExit("prompt is not required when loading a named model")
    if not args.sd_turbo_path:
        raise SystemExit("--sd_turbo_path (or $SD_TURBO_PATH) is required")
    caption, direction = args.prompt, args.direction
    if args.model_name is not None:
        if args.model_name not in NAMED_MODELS:
            raise SystemExit(f"unknown model_name {args.model_name!r}; "
                             f"choose from {sorted(NAMED_MODELS)}")
        fname, caption, direction = NAMED_MODELS[args.model_name]
        ckpt_path = os.path.join(args.ckpt_folder, fname)
        if not os.path.exists(ckpt_path):
            raise SystemExit(
                f"checkpoint {ckpt_path} not found; download "
                f"{BASE_URL}{fname} elsewhere and place it there")
    else:
        ckpt_path = args.model_path
    dev = resolve_device(device)
    dtype = inference_dtype(args.use_fp16, dev)

    t0 = time.perf_counter()
    pipe = CycleGANTurbo.from_pretrained(args.sd_turbo_path, ckpt_path,
                                         caption=caption, direction=direction,
                                         cfgs=cfgs, dtype=dtype, device=dev)
    t1 = time.perf_counter()
    x, size = prepare(args, args.input_image)
    out_u8 = image_mod.signed_to_uint8(pipe(x.to(dtype)))[0].cpu().numpy()
    t2 = time.perf_counter()
    out_pil = Image.fromarray(out_u8).resize(size, Image.LANCZOS)

    os.makedirs(args.output_dir, exist_ok=True)
    out_path = os.path.join(args.output_dir,
                            os.path.basename(args.input_image))
    out_pil.save(out_path)
    print(f"saved {out_path}")
    return {"output": out_path, "load_seconds": t1 - t0,
            "image_seconds": t2 - t1}


if __name__ == "__main__":
    main(build_parser().parse_args())
