"""LPIPS acceptance harness: the parity gate against the reference's
published output (counterpart of `cli/accept_parity.py`).

The acceptance bar (BASELINE.md): LPIPS <= 0.05 between this port's output
and the reference's published output for the same input (reference
README.md:111-126: assets/examples/bird.png -> bird_canny_blue.png with
`--model_name edge_to_image`):

    python -m img2img_turbo_tpu_torch.cli.accept_parity \\
        --sd_turbo_path /path/to/stabilityai-sd-turbo \\
        --model_path /path/to/edge_to_image_loras.pkl \\
        --input_image bird.png --prompt "a blue bird" \\
        --reference_output bird_canny_blue.png \\
        --lpips_weights /path/to/lpips_vgg.pth

The same flags as the JAX harness. The input is resized to a multiple of 8
(PIL LANCZOS) and translated on the card in bf16 (fp32 on the CPU,
`main(args, device="cpu")`) with the posterior noise of a generator seeded
0; the stochastic path takes the reference's noise map from --noise_npy
(torch's own draw is not reproducible from here either). The LPIPS is the
port's VGG16 LPIPS (`models/vgg_lpips.py`) from --lpips_weights, or seeded
random weights, which make the number meaningless (the line says so).
`--tiny_random` runs the same plumbing on tiny random models and a
synthetic input.

Prints ONE JSON line: {"lpips", "threshold": 0.05, "pass", "mode",
"lpips_weights", "plumbing_only"}, the JAX harness's keys.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

THRESHOLD = 0.05


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--sd_turbo_path", type=str,
                   default=os.environ.get("SD_TURBO_PATH", ""))
    p.add_argument("--model_path", type=str, default="",
                   help="reference pkl checkpoint (pix2pix_turbo.py:221-229 "
                        "schema)")
    p.add_argument("--input_image", type=str, default="")
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--reference_output", type=str, default="",
                   help="the reference implementation's saved output image")
    p.add_argument("--lpips_weights", type=str, default="",
                   help="torch lpips VGG state dict (models/vgg_lpips."
                        "load_lpips_weights format); REQUIRED for a real "
                        "acceptance number")
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--gamma", type=float, default=0.4)
    p.add_argument("--noise_npy", type=str, default="",
                   help="(stochastic) torch-captured noise, shape "
                        "(1, 4, H/8, W/8) or (1, H/8, W/8, 4)")
    p.add_argument("--low_threshold", type=int, default=100)
    p.add_argument("--high_threshold", type=int, default=200)
    p.add_argument("--save_output", type=str, default="",
                   help="also save our output image here")
    p.add_argument("--tiny_random", action="store_true",
                   help="plumbing smoke: tiny random models + synthetic "
                        "input; the LPIPS number is meaningless")
    return p


def lpips_value(lpips, ours, ref) -> float:
    """LPIPS between two (1, H, W, 3) images in [-1, 1] (numpy or tensors),
    in fp32 on the LPIPS model's device."""
    import torch
    dev = next(lpips.parameters()).device
    with torch.no_grad():
        return float(lpips(torch.as_tensor(ours).float().to(dev),
                           torch.as_tensor(ref).float().to(dev))[0])


def _lpips_model(path: str, device):
    """The port's LPIPS from a torch lpips state dict, or seeded random."""
    import torch
    from img2img_turbo_tpu_torch.models.vgg_lpips import (VGGLPIPS,
                                                          load_lpips_weights)
    from img2img_turbo_tpu_torch.training.runner import random_init
    from img2img_turbo_tpu_torch.weights import torch_import as ti
    if path:
        model = ti.load_into(ti.build_on(VGGLPIPS, device),
                             load_lpips_weights(path))
    else:
        model = random_init(VGGLPIPS,
                            torch.Generator(device=device).manual_seed(1))
    return model.requires_grad_(False).eval()


def _tiny_random(args, dev):
    """(ours, synthetic reference): tiny random models on a seeded input."""
    import torch
    from img2img_turbo_tpu_torch import configs
    from img2img_turbo_tpu_torch.models.unet import make_twin_conv_in
    from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                           Pix2PixTurbo)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfgs = GeneratorConfigs(unet=configs.TINY_UNET, vae=configs.TINY_VAE,
                            text=configs.TINY_TEXT)
    pipe = Pix2PixTurbo.from_random(torch.Generator(device=dev).manual_seed(0),
                                    cfgs, dtype=dtype)
    rng = np.random.RandomState(0)
    h = w = 64
    c_t = torch.as_tensor(rng.rand(1, h, w, 3), dtype=dtype, device=dev)
    caption_enc = torch.as_tensor(
        rng.randn(1, 77, cfgs.unet.cross_attention_dim) * 0.1,
        dtype=torch.float32, device=dev)
    if args.stochastic:
        make_twin_conv_in(pipe.base["unet"])
        noise = torch.as_tensor(rng.randn(1, h // 8, w // 8, 4), dtype=dtype,
                                device=dev)
        ours = pipe(c_t, caption_enc=caption_enc, deterministic=False,
                    r=args.gamma, noise_map=noise)
    else:
        ours = pipe.merge()(c_t, caption_enc=caption_enc)
    ours = ours.float().cpu().numpy()
    # a synthetic "reference": a perturbed copy, plumbing only
    ref = np.clip(ours + 0.01 * rng.randn(*ours.shape), -1, 1)
    return ours, ref


def _pretrained(args, dev):
    """(ours, reference) for the real acceptance run."""
    import torch
    from PIL import Image
    from img2img_turbo_tpu_torch.ops import canny as canny_mod
    from img2img_turbo_tpu_torch.ops import image as image_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import Pix2PixTurbo
    for flag in ("sd_turbo_path", "model_path", "input_image", "prompt",
                 "reference_output"):
        if not getattr(args, flag):
            raise SystemExit(f"--{flag} is required (or --tiny_random "
                             "for the plumbing smoke)")
    if args.stochastic and not args.noise_npy:
        raise SystemExit(
            "--stochastic needs --noise_npy (torch-side captured noise of "
            "the reference run)")
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    pipe = Pix2PixTurbo.from_pretrained(
        args.sd_turbo_path, args.model_path, stochastic=args.stochastic,
        dtype=dtype, device=dev)
    img = Image.open(args.input_image).convert("RGB")
    new_w, new_h = img.width - img.width % 8, img.height - img.height % 8
    img = img.resize((new_w, new_h), Image.LANCZOS)
    arr = torch.from_numpy(np.array(img, np.uint8))[None].to(dev)
    if args.stochastic:
        c_t = (image_mod.uint8_to_unit(arr) < 0.5).to(dtype)
        noise = np.load(args.noise_npy)
        if noise.shape[1] == 4:        # NCHW -> NHWC
            noise = noise.transpose(0, 2, 3, 1)
        ours = pipe(c_t, prompt=args.prompt, deterministic=False,
                    r=args.gamma, noise_map=torch.as_tensor(
                        noise, dtype=dtype, device=dev))
    else:
        c_t = canny_mod.canny_3ch_unit(arr, float(args.low_threshold),
                                       float(args.high_threshold))
        ours = pipe(c_t.to(dtype), prompt=args.prompt)
    ref_img = Image.open(args.reference_output).convert("RGB")
    if ref_img.size != (new_w, new_h):
        ref_img = ref_img.resize((new_w, new_h), Image.LANCZOS)
    ref = np.asarray(ref_img, np.float32)[None] / 127.5 - 1.0
    return ours.float().cpu().numpy(), ref


def main(args, device=None):
    """Run the harness as the flags say on `device` (the CUDA card when
    None); prints and returns the result dictionary."""
    from PIL import Image
    from img2img_turbo_tpu_torch import resolve_device
    from img2img_turbo_tpu_torch.ops import image as image_mod

    dev = resolve_device(device)
    random_lpips = not args.lpips_weights
    ours, ref = (_tiny_random if args.tiny_random else _pretrained)(args,
                                                                     dev)
    if args.save_output:
        import torch
        Image.fromarray(image_mod.signed_to_uint8(
            torch.from_numpy(ours))[0].numpy()).save(args.save_output)
    val = lpips_value(_lpips_model(args.lpips_weights, dev), ours, ref)
    result = {
        "lpips": round(val, 5),
        "threshold": THRESHOLD,
        "pass": bool(val <= THRESHOLD),
        "mode": "stochastic" if args.stochastic else "deterministic",
        "lpips_weights": ("RANDOM (plumbing only — number is meaningless)"
                          if random_lpips else args.lpips_weights),
        "plumbing_only": bool(args.tiny_random or random_lpips),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(build_parser().parse_args())
