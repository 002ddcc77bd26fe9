"""Datasets and the host-side input pipeline (counterpart of
`img2img_turbo_tpu/training/data.py`; numpy and PIL, no torch.utils.data).

Same on-disk layouts as the reference (docs/training_pix2pix_turbo.md:13-35,
docs/training_cyclegan_turbo.md:13-36; loaders at
src/my_utils/training_utils.py:218-409):

- Paired:   train_A/ train_B/ train_prompts.json (+ test_*)
            input -> [0,1] float, target -> [-1,1], caption -> 77 ids
- Unpaired: train_A/ train_B/ fixed_prompt_a.txt fixed_prompt_b.txt
            len = len(A)+len(B); source indexed (random past range),
            target always random; both -> [-1,1]

Images are NHWC numpy arrays on the host; the trainer moves batches to the
card. PIL LANCZOS resizing matches the reference's transform registry
(training_utils.py:184-215). Given the same files, tokenizer and seed, the
arrays equal the JAX package's bit for bit. A tokenizer is any callable
text -> (1, 77) ids.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import random
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
from PIL import Image


# ---------------------------------------------------------------------------
# Transform registry (reference build_transform, training_utils.py:184-215)
# ---------------------------------------------------------------------------


def _resize_short(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w <= h:
        return img.resize((size, max(1, round(h * size / w))), Image.LANCZOS)
    return img.resize((max(1, round(w * size / h)), size), Image.LANCZOS)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def build_transform(image_prep: str) -> Callable:
    """name -> fn(PIL, rng: random.Random | None) -> PIL."""
    if image_prep == "resized_crop_512":
        return lambda im, rng=None: _center_crop(_resize_short(im, 512), 512)
    if image_prep == "resize_286_randomcrop_256x256_hflip":
        def t(im, rng=None):
            rng = rng or random
            im = im.resize((286, 286), Image.LANCZOS)
            left = rng.randint(0, 286 - 256)
            top = rng.randint(0, 286 - 256)
            im = im.crop((left, top, left + 256, top + 256))
            if rng.random() < 0.5:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
            return im
        return t
    if image_prep in ("resize_256", "resize_256x256"):
        return lambda im, rng=None: im.resize((256, 256), Image.LANCZOS)
    if image_prep in ("resize_512", "resize_512x512"):
        return lambda im, rng=None: im.resize((512, 512), Image.LANCZOS)
    if image_prep == "no_resize":
        return lambda im, rng=None: im
    raise ValueError(f"unknown image_prep {image_prep!r}")


def _to_unit(img: Image.Image) -> np.ndarray:
    return np.asarray(img.convert("RGB"), np.float32) / 255.0


def _to_signed(img: Image.Image) -> np.ndarray:
    return np.asarray(img.convert("RGB"), np.float32) / 127.5 - 1.0


# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------


class PairedDataset:
    def __init__(self, dataset_folder: str, split: str, image_prep: str,
                 tokenizer):
        sub = {"train": ("train_A", "train_B", "train_prompts.json"),
               "test": ("test_A", "test_B", "test_prompts.json")}[split]
        self.input_folder = os.path.join(dataset_folder, sub[0])
        self.output_folder = os.path.join(dataset_folder, sub[1])
        with open(os.path.join(dataset_folder, sub[2])) as f:
            self.captions: Dict[str, str] = json.load(f)
        self.img_names: List[str] = list(self.captions.keys())
        self.T = build_transform(image_prep)
        self.tokenizer = tokenizer

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None):
        name = self.img_names[idx]
        caption = self.captions[name]
        inp = Image.open(os.path.join(self.input_folder, name))
        out = Image.open(os.path.join(self.output_folder, name))
        return {
            "conditioning_pixel_values": _to_unit(self.T(inp, rng)),
            "output_pixel_values": _to_signed(self.T(out, rng)),
            "caption": caption,
            "input_ids": self.tokenizer(caption)[0],
        }


_IMG_EXTS = ("*.jpg", "*.jpeg", "*.png", "*.bmp", "*.gif")


class UnpairedDataset:
    def __init__(self, dataset_folder: str, split: str, image_prep: str,
                 tokenizer):
        sub = {"train": ("train_A", "train_B"),
               "test": ("test_A", "test_B")}[split]
        self.source_folder = os.path.join(dataset_folder, sub[0])
        self.target_folder = os.path.join(dataset_folder, sub[1])
        with open(os.path.join(dataset_folder, "fixed_prompt_a.txt")) as f:
            self.fixed_caption_src = f.read().strip()
        with open(os.path.join(dataset_folder, "fixed_prompt_b.txt")) as f:
            self.fixed_caption_tgt = f.read().strip()
        self.input_ids_src = tokenizer(self.fixed_caption_src)[0]
        self.input_ids_tgt = tokenizer(self.fixed_caption_tgt)[0]
        self.l_imgs_src = sorted(sum(
            (glob.glob(os.path.join(self.source_folder, e))
             for e in _IMG_EXTS), []))
        self.l_imgs_tgt = sorted(sum(
            (glob.glob(os.path.join(self.target_folder, e))
             for e in _IMG_EXTS), []))
        self.T = build_transform(image_prep)

    def __len__(self):
        return len(self.l_imgs_src) + len(self.l_imgs_tgt)

    def __getitem__(self, idx: int, rng: Optional[random.Random] = None):
        rng = rng or random
        if idx < len(self.l_imgs_src):
            src_path = self.l_imgs_src[idx]
        else:
            src_path = rng.choice(self.l_imgs_src)
        tgt_path = rng.choice(self.l_imgs_tgt)
        src = Image.open(src_path).convert("RGB")
        tgt = Image.open(tgt_path).convert("RGB")
        return {
            "pixel_values_src": _to_signed(self.T(src, rng)),
            "pixel_values_tgt": _to_signed(self.T(tgt, rng)),
            "caption_src": self.fixed_caption_src,
            "caption_tgt": self.fixed_caption_tgt,
            "input_ids_src": self.input_ids_src,
            "input_ids_tgt": self.input_ids_tgt,
        }


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def prefetch(loader: Iterator[Dict], depth: int = 2) -> Iterator[Dict]:
    """Background-thread prefetch: hides PIL decode/resize latency behind
    device steps (PIL releases the GIL during decode). The reference relies
    on torch DataLoader workers (default 0, training_utils.py:74,131)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in loader:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


def shard(loader: Iterator[Dict], mesh) -> Iterator[Dict]:
    """This rank's rows of each global batch of `loader`
    (`parallel.mesh.shard_batch`): every rank iterates the same seeded
    loader of the global batch and takes its contiguous rows, so a data-
    parallel run sees the batches a one-process run sees (the JAX CLI
    shards the global batch over its data axis the same way)."""
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    for batch in loader:
        yield mesh_mod.shard_batch(batch, mesh)


def accumulate_batches(loader: Iterator[Dict], k: int) -> Iterator[Dict]:
    """Concatenate k micro-batches into one logical batch (host side).

    Pairs with `accum_steps=k` on the train-step makers: the step re-splits
    the logical batch and runs one micro-batch's autograd at a time
    (training/accum.py), the counterpart of `accelerator.accumulate`. All
    losses are batch means over equal micro-batches, so the averaged
    gradient equals the big-batch gradient.
    """
    if k <= 1:
        yield from loader
        return
    while True:
        batches = list(itertools.islice(loader, k))
        if len(batches) < k:    # the loader ended
            return
        out = {}
        for key, v0 in batches[0].items():
            vals = [b[key] for b in batches]
            out[key] = (sum(vals, []) if isinstance(v0, list)
                        else np.concatenate(vals))
        yield out


def data_loader(dataset, batch_size: int, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True,
                epochs: Optional[int] = None) -> Iterator[Dict]:
    """Simple host loader: yields dicts of stacked numpy arrays (strings are
    collected into lists). Infinite when epochs is None."""
    rng = random.Random(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = list(range(len(dataset)))
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idxs = order[i:i + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            items = [dataset.__getitem__(j, rng) for j in idxs]
            batch = {}
            for k in items[0]:
                vals = [it[k] for it in items]
                if isinstance(vals[0], str):
                    batch[k] = vals
                else:
                    batch[k] = np.stack(vals)
            yield batch
        epoch += 1
