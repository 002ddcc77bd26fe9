"""The published img2img-turbo checkpoints and the CLIP tokenizer, found on
local disk (counterpart of `img2img_turbo_tpu/utils/download.py`, its
offline paths only: the port makes no network call).

The checkpoints are published under BASE_URL (reference
pix2pix_turbo.py:48, 82; cyclegan_turbo.py:127-145); fetch them on a
machine with network access and place them in the checkpoint folder.
"""

from __future__ import annotations

import os

BASE_URL = "https://www.cs.cmu.edu/~img2img-turbo/models/"

MODEL_FILES = {
    "edge_to_image": "edge_to_image_loras.pkl",
    "sketch_to_image_stochastic": "sketch_to_image_stochastic_lora.pkl",
    "day_to_night": "day2night.pkl",
    "night_to_day": "night2day.pkl",
    "clear_to_rainy": "clear2rainy.pkl",
    "rainy_to_clear": "rainy2clear.pkl",
}

TOKENIZER_FILES = ("vocab.json", "merges.txt", "merges.txt.gz",
                   "bpe_simple_vocab_16e6.txt.gz")


def get_checkpoint(name: str, ckpt_folder: str = "checkpoints") -> str:
    """The local path of a published model's pkl: `<ckpt_folder>/<file>`,
    or FileNotFoundError naming where to fetch it."""
    fname = MODEL_FILES[name]
    outf = os.path.join(ckpt_folder, fname)
    if os.path.exists(outf):
        return outf
    raise FileNotFoundError(
        f"checkpoint {outf} not found; fetch {BASE_URL}{fname} on a machine "
        f"with network access and place it at {outf}")


def get_clip_tokenizer(dest: str = "checkpoints/clip_tokenizer") -> str:
    """`dest` if it holds CLIP tokenizer files (vocab.json + merges.txt, or
    a merges file alone, from which `models.tokenizer.CLIPTokenizer.
    from_dir` derives the vocabulary); else FileNotFoundError."""
    if any(os.path.exists(os.path.join(dest, f)) for f in TOKENIZER_FILES):
        return dest
    raise FileNotFoundError(
        f"no CLIP tokenizer in {dest}: place vocab.json + merges.txt (the "
        f"stabilityai/sd-turbo snapshot's tokenizer/ folder) or a CLIP BPE "
        f"merges file such as bpe_simple_vocab_16e6.txt.gz there")
