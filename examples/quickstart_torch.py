"""Quickstart for the PyTorch port: the three serving modes through the
port's own API, on random weights (no downloads needed).

    python examples/quickstart_torch.py              # the first CUDA card
    python examples/quickstart_torch.py --device cpu

Every mode runs the kernel path. On the card it builds SD-Turbo's widths
(`GeneratorConfigs()`, bf16) at 512x512, whose attention heads (64 and 512
wide) are the ones the attention kernels take, and prints each mode's
kernel launches. On the CPU it runs the TINY configs at 64x64 in fp32 in
seconds, each kernel wrapper taking its plain version. With real weights,
replace `from_random` by `Pix2PixTurbo.from_pretrained(sd_turbo_dir,
"edge_to_image")` or `CycleGANTurbo.from_pretrained(sd_turbo_dir,
"day_to_night")`.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from img2img_turbo_tpu_torch import configs, resolve_device
from img2img_turbo_tpu_torch.models.unet import make_twin_conv_in
from img2img_turbo_tpu_torch.ops import _build, canny
from img2img_turbo_tpu_torch.pipelines.cyclegan import CycleGANTurbo
from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                       Pix2PixTurbo)
from img2img_turbo_tpu_torch.serving.engine import ServingEngine


def _launches(name: str, dev) -> None:
    """Prints the kernel launches since the last call; on the card a mode
    that launched none is an error."""
    n = sum(_build.launch_counts.values())
    _build.reset_launch_counts()
    if dev.type == "cuda":
        print(f"   {name}: {n} kernel launches")
        if n == 0:
            raise RuntimeError(f"{name} launched no kernel on {dev}")


def main(device=None) -> dict:
    """Runs each mode once and returns its output by name."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        cfgs = GeneratorConfigs(unet=configs.TINY_UNET, vae=configs.TINY_VAE,
                                text=configs.TINY_TEXT)
        res, dtype = 64, torch.float32
    else:
        cfgs, res, dtype = GeneratorConfigs(), 512, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    pipe = Pix2PixTurbo.from_random(g, cfgs, dtype=dtype)
    pipe.merge()
    ctx = torch.zeros(1, 77, cfgs.unet.cross_attention_dim, device=dev)
    img_u8 = torch.randint(0, 256, (1, res, res, 3), dtype=torch.uint8,
                           generator=g, device=dev)
    out = {}
    _build.reset_launch_counts()

    # 1. edge_to_image: the library API, an edge map -> an image in [-1, 1]
    c_t = canny.canny_3ch_unit(img_u8)
    out["edge_to_image"] = pipe(c_t, caption_enc=ctx)
    print("1. edge_to_image:", tuple(out["edge_to_image"].shape), "in [-1, 1]")
    _launches("edge_to_image", dev)

    # 2. sketch: the stochastic path, LoRA merged at the runtime r
    make_twin_conv_in(pipe.base["unet"])
    noise_map = torch.randn(1, res // 8, res // 8, 4, generator=g, device=dev)
    out["sketch"] = pipe(c_t, caption_enc=ctx, deterministic=False, r=0.4,
                         noise_map=noise_map)
    print("2. sketch r=0.4:", tuple(out["sketch"].shape))
    _launches("sketch", dev)
    del pipe

    # 3. image (CycleGAN-Turbo), its a2b generator served uint8 -> uint8
    cyc = CycleGANTurbo.from_random(torch.Generator(device=dev).manual_seed(1),
                                    cfgs)
    engine = ServingEngine({"unet": cyc.params["unet"],
                            "vae": cyc.params["vae_a2b"]}, cfgs, mode="image",
                           dtype=dtype, device=dev)
    _build.reset_launch_counts()
    out["image"] = engine(img_u8, ctx)
    print("3. image a2b, served:", tuple(out["image"].shape),
          out["image"].dtype)
    _launches("image", dev)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (the first card when "
                             "not given)")
    main(parser.parse_args().device)
