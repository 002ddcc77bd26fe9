"""Where the time of one paired or unpaired train step, or of one served
request, goes, on the card.

    python -m img2img_turbo_tpu_torch.training.profile_step [--request | --unpaired]

Without arguments: builds the full-width paired run of chip_smoke.py's
train phase (seeded random weights, 512x512 b1, bf16 activations, UNet
remat), runs one step of the kernel path and one of the plain path to
warm up, then one step of each under torch.profiler. With --unpaired: the
same for the unpaired (CycleGAN-Turbo) run of chip_smoke.py's unpaired
phase (256x256 b1, eight generator forwards a step). With --request: one
512x512 b1 edge_to_image request of chip_smoke.py's engine phase (SD-Turbo
widths, seeded random weights, bf16), on the kernel path and on the plain
path, each after a warm-up. Prints for each: the wall time, the device time
summed over its GPU kernels, the number of GPU kernels, the peak device
memory (`max_memory_allocated`), the GPU kernels that take the most device
time, with their counts, and the package's
hand-written kernels by the TPU kernel each replaces (`KERNELS`: launches
and device time; the rest is PyTorch's). Needs a CUDA card; prints the
card's name and power limit first. It imports the package of the current
directory, so run as a file from another checkout's root it profiles that
checkout:

    cd <other checkout> && python3 <this checkout>/img2img_turbo_tpu_torch/training/profile_step.py --request
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import torch


SIZE = 512     # the train phase's and the request's image size
UNPAIRED_SIZE = 256   # the unpaired phase's
TOP = 30       # GPU kernels listed per path
# The package's kernels by the TPU kernel each replaces, matched in order
# on the GPU kernel's name: (label, substrings). K1 and K4 share
# conv_kernel, told apart by its mode (0 same, 1 upsample); K7's kernels
# live in namespaces h64 and h512 beside their prologue; the wmma names are
# an older checkout's hd-512 K7, partial_stats its Triton K5.
KERNELS = (
    ("K1 conv", ("conv_kernel<0", "conv_reduce<0")),
    ("K4 upsample conv", ("conv_kernel<1", "conv_reduce<1")),
    ("K8 du", ("dgrad_kernel", "dgrad_reduce")),
    ("K6 downsample conv", ("down_kernel", "down_reduce")),
    ("K3 fused matmul", ("mm_kernel",)),
    ("K2 attention", ("flash_kernel",)),
    ("K7 attention bwd hd 64", ("h64::", "prologue_kernel<64")),
    ("K7 attention bwd hd 512", ("h512::", "prologue_kernel<512",
                                 "bwd_dq_kernel", "bwd_dkv_kernel")),
    ("K5 group norm stats", ("partial_stats",)),
    ("K5 group norm combine", ("combine_kernel",)),
)


def _profile(fn):
    """Run fn() once under torch.profiler and print where its time went.
    Returns {"wall_ms", "device_ms" (the sum of its GPU kernels),
    "kernels" (their number), "peak_gib"}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        # GPU kernels only: a record_function range (the optimizer's step)
        # also shows on the device, spanning the kernels inside it
        if evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False):
            kernels[evt.name][0] += 1
            kernels[evt.name][1] += evt.device_time_total / 1e3
    device = sum(v[1] for v in kernels.values())
    n = sum(v[0] for v in kernels.values())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  wall {wall:.2f} ms, device (sum of GPU kernels) {device:.2f} "
          f"ms, {n} GPU kernels, peak memory {peak:.3f} GiB", flush=True)
    for name, (cnt, ms) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[
            :TOP]:
        print(f"    {ms:9.3f} ms {cnt:6d}x  {name[:110]}", flush=True)
    by = {label: [0, 0.0] for label, _ in KERNELS}
    by["PyTorch (everything else)"] = [0, 0.0]
    for name, (cnt, ms) in kernels.items():
        label = next((lb for lb, keys in KERNELS
                      if any(k in name for k in keys)),
                     "PyTorch (everything else)")
        by[label][0] += cnt
        by[label][1] += ms
    print("  by kernel (GPU kernels launched, device ms):", flush=True)
    for label, (cnt, ms) in by.items():
        print(f"    {ms:9.3f} ms {cnt:6d}x  {label}", flush=True)
    return {"wall_ms": wall, "device_ms": device, "kernels": n,
            "peak_gib": peak}


def _step(dev):
    """The kernel and the plain path's paired train step, each a call."""
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import losses, paired, runner
    cfgs = GeneratorConfigs()
    models, state, meta = runner.build_paired_run(
        cfgs, clip_vit.CLIP_VIT_B32, seed=4321, device=dev)
    g = torch.Generator(device=dev).manual_seed(4322)
    s = SIZE
    batch = {"conditioning_pixel_values": torch.rand(1, s, s, 3, generator=g,
                                                     device=dev),
             "output_pixel_values": torch.rand(1, s, s, 3, generator=g,
                                               device=dev) * 2 - 1,
             "input_ids": torch.randint(0, cfgs.text.vocab_size, (1, 77),
                                        generator=g, device=dev)}
    noise = tuple(paired.draw_noise(g, 1, s, s, cfgs, torch.bfloat16)
                  for _ in range(2))
    for kernels in (True, False):
        step = paired.make_paired_train_step(
            models, cfgs, losses.PairedLossConfig(), meta, kernels=kernels,
            remat=True, dtype=torch.bfloat16)
        yield (f"{'kernel' if kernels else 'plain'} path, one {s}x{s} b1 "
               f"step", lambda step=step: step(state, batch, noise))


def _unpaired_step(dev):
    """The kernel and the plain path's unpaired train step, each a call."""
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import (losses, paired, runner,
                                                  unpaired)
    cfgs = GeneratorConfigs()
    models, state, meta = runner.build_unpaired_run(
        cfgs, clip_vit.CLIP_VIT_B32, seed=5432, device=dev)
    g = torch.Generator(device=dev).manual_seed(5433)
    s, d = UNPAIRED_SIZE, cfgs.unet.cross_attention_dim
    batch = {"pixel_values_src": torch.rand(1, s, s, 3, generator=g,
                                            device=dev) * 2 - 1,
             "pixel_values_tgt": torch.rand(1, s, s, 3, generator=g,
                                            device=dev) * 2 - 1,
             "emb_a2b": torch.randn(1, 77, d, generator=g, device=dev),
             "emb_b2a": torch.randn(1, 77, d, generator=g, device=dev)}
    noise = tuple(paired.draw_noise(g, 1, s, s, cfgs, torch.bfloat16)
                  for _ in range(unpaired.NUM_NOISE))
    for kernels in (True, False):
        step = unpaired.make_unpaired_train_step(
            models, cfgs, losses.UnpairedLossConfig(), meta, kernels=kernels,
            remat=True, dtype=torch.bfloat16)
        yield (f"{'kernel' if kernels else 'plain'} path, one {s}x{s} b1 "
               f"unpaired step", lambda step=step: step(state, batch, noise))


def _request(dev):
    """The kernel and the plain path's edge_to_image request, each a
    call."""
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax
    cfgs = GeneratorConfigs()
    g = torch.Generator(device=dev).manual_seed(1234)
    params = {"unet": from_jax.random_model(cfgs.unet, g),
              "vae": from_jax.random_model(cfgs.vae, g)}
    caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim, generator=g,
                          device=dev)
    img = torch.randint(0, 256, (1, SIZE, SIZE, 3), generator=g, device=dev,
                        dtype=torch.uint8)
    for kernels in (True, False):
        eng = ServingEngine(params, cfgs, dtype=torch.bfloat16, device=dev,
                            use_kernels=kernels)
        eng.warmup(1, SIZE, SIZE, caption)
        yield (f"{'kernel' if kernels else 'plain'} path, one {SIZE}x{SIZE} "
               f"b1 edge_to_image request",
               lambda eng=eng: eng.run(img, caption,
                                       torch.Generator(device=dev)
                                       .manual_seed(1)))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    what = p.add_mutually_exclusive_group()
    what.add_argument("--request", action="store_true",
                      help="profile one 512x512 edge_to_image request "
                      "instead of a train step")
    what.add_argument("--unpaired", action="store_true",
                      help="profile one 256x256 unpaired (CycleGAN-Turbo) "
                      "train step instead of a paired one")
    args = p.parse_args()
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this profile runs only on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from img2img_turbo_tpu_torch.ops import _build
    _build.build()
    dev = torch.device("cuda", 0)
    paths = (_request if args.request else
             _unpaired_step if args.unpaired else _step)
    for what, fn in paths(dev):
        fn()  # warm-up
        print(f"{what}:", flush=True)
        _profile(fn)


if __name__ == "__main__":
    main()
