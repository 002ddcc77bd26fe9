"""Convert a local SD-Turbo snapshot (and an img2img-turbo pkl) into the
port's native serving checkpoint, LoRA merged for the deterministic models
(counterpart of `cli/convert_weights.py`, which writes the same payload with
orbax):

    python -m img2img_turbo_tpu_torch.cli.convert_weights \\
        --sd_turbo_path /path/sd-turbo \\
        [--ckpt_path edge_to_image_loras.pkl [--stochastic]] \\
        --out /path/native_ckpt

The payload is `Pix2PixTurbo.load_pretrained`'s: `params` (merged UNet and
VAE), or `base` + `lora` under --stochastic (the sketch model, LoRA
factored beside a TwinConv conv_in), and `text`, written by the port's own
safetensors writer (`weights/native.py`) with the snapshot's tokenizer
copied beside it. `Pix2PixTurbo.from_native(out)` and
`ServingEngine.from_native(out)` read it back without the snapshot or the
pkl. The merge runs on the CUDA card unless `main` is given another device.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sd_turbo_path", required=True)
    ap.add_argument("--ckpt_path", default=None,
                    help="reference pkl (or published model name)")
    ap.add_argument("--stochastic", action="store_true",
                    help="keep LoRA factored + TwinConv (sketch model)")
    ap.add_argument("--out", required=True)
    return ap


def main(argv=None, device=None, cfgs=None):
    """Convert as the flags in `argv` say; `cfgs` only for small test
    models. Returns {"path", "bytes", "tensors", "values", "load_seconds",
    "write_seconds"}."""
    from img2img_turbo_tpu_torch.pipelines.pix2pix import Pix2PixTurbo
    from img2img_turbo_tpu_torch.weights import native

    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()
    loaded = Pix2PixTurbo.load_pretrained(
        args.sd_turbo_path, args.ckpt_path, stochastic=args.stochastic,
        cfgs=cfgs, device=device)
    t1 = time.perf_counter()
    tok = os.path.join(args.sd_turbo_path, "tokenizer")
    res = native.save_native(os.path.abspath(args.out), loaded,
                             tok if os.path.isdir(tok) else None)
    res.update(load_seconds=t1 - t0, write_seconds=time.perf_counter() - t1)
    print(f"saved native checkpoint to {args.out} "
          f"({res['values'] / 1e6:.0f}M params)", flush=True)
    return res


if __name__ == "__main__":
    main()
