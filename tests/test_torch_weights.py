"""The port's weight and prompt loaders against the JAX package's, on the
CPU:

- `weights.torch_import.load_safetensors` against the `safetensors`
  package's own readers (imported here only; `safetensors.numpy` for
  F32 / F16 / I64, `safetensors.torch` for BF16, which numpy lacks), on a
  file with unaligned data offsets and `__metadata__` and on one the
  package wrote; `save_safetensors`' files read back by the package to
  the same arrays; `load_torch_pickle`;
- the key maps (the VAE's legacy attention names and conv-shaped
  weights, the default skip convs, the text encoder's prefix and
  position_ids) against the JAX converters, through `from_jax`'s inverse
  converters, bit for bit;
- `models.tokenizer.CLIPTokenizer` against JAX's on the synthetic vocab of
  tests/test_tokenizer.py: the same ids for the same prompts, a prompt
  past 77 tokens, and the merges-only, `.gz` and OpenAI single-file forms;
- `lora.lora_from_torch_state_dict` / `overlay_base_weights` against
  JAX's on adapter-named, adapter-free and `.base_layer.` keys;
- each aux converter (CLIP in the OpenAI and transformers layouts, LPIPS,
  Inception, DINO) against the JAX converter: the same state dict bit for
  bit through `from_jax` (whose inverses are held to the JAX modules'
  outputs in test_torch_aux.py and test_torch_metrics.py), and the same
  module output;
- `runner.init_aux_models` / `init_inception` reading the files;
- no module of the port, nor chip_smoke.py, imports jax, the JAX package,
  safetensors or transformers.

Everything here is exact (bitwise) except the module outputs of a CLIP
tower, compared at 1e-6 relative (the same weights in two modules built
apart).
"""

import argparse
import gzip
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from img2img_turbo_tpu import configs as jcfg
from img2img_turbo_tpu import lora as jlora
from img2img_turbo_tpu.metrics import inception as jinc
from img2img_turbo_tpu.models import clip_vit as jclip
from img2img_turbo_tpu.models import dino as jdino
from img2img_turbo_tpu.models import vgg_lpips as jlpips
from img2img_turbo_tpu.models.tokenizer import CLIPTokenizer as JTok
from img2img_turbo_tpu.models.tokenizer import \
    vocab_from_merges as jvocab_from_merges
from img2img_turbo_tpu.weights import torch_import as jti
from img2img_turbo_tpu_torch import configs as tcfg
from test_torch_ops import PORT_MODULES
from img2img_turbo_tpu_torch import lora as tlora
from img2img_turbo_tpu_torch.metrics import inception as tinc
from img2img_turbo_tpu_torch.models import clip_vit as tclip
from img2img_turbo_tpu_torch.models import dino as tdino
from img2img_turbo_tpu_torch.models import vgg_lpips as tlpips
from img2img_turbo_tpu_torch.models.tokenizer import (CLIPTokenizer,
                                                      bytes_to_unicode,
                                                      vocab_from_merges)
from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
from img2img_turbo_tpu_torch.training import runner as trunner
from img2img_turbo_tpu_torch.utils import download
from img2img_turbo_tpu_torch.weights import from_jax
from img2img_turbo_tpu_torch.weights import torch_import as ti

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(t):
    return {k: v.detach().numpy().copy() for k, v in t.items()}


def _equal_sd(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k, w in want.items():
        g = np.asarray(got[k].detach() if torch.is_tensor(got[k]) else got[k])
        assert g.shape == np.asarray(w).shape and np.array_equal(g, w), k


# ---------------------------------------------------------------------------
# safetensors and pkl
# ---------------------------------------------------------------------------


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {"odd_f16": torch.randn(3, 5, generator=g).half(),   # 30 bytes
            "f32": torch.randn(4, 3, generator=g),              # unaligned
            "bf16": torch.randn(7, generator=g).bfloat16(),
            "i64": torch.arange(-5, 6),
            "empty": torch.zeros(0, 4)}


def test_reader_matches_the_safetensors_package(tmp_path):
    """A file of our writer (data offsets 30, 78, ...: not aligned; a
    `__metadata__` entry) and one of the package's writer, read by both."""
    import safetensors.numpy
    import safetensors.torch
    ours = tmp_path / "ours.safetensors"
    t = _tensors(0)
    ti.save_safetensors(t, str(ours), {"format": "pt"})
    header = json.loads(ours.read_bytes()[8:8 + int.from_bytes(
        ours.read_bytes()[:8], "little")])
    assert header["__metadata__"] == {"format": "pt"}
    assert header["f32"]["data_offsets"][0] % 4 != 0
    got = ti.load_safetensors(str(ours))
    want_t = safetensors.torch.load_file(str(ours))
    assert list(got) == list(t)
    for k in t:
        assert got[k].dtype == want_t[k].dtype == t[k].dtype, k
        assert torch.equal(got[k], want_t[k]) and torch.equal(got[k], t[k])
    # numpy has no bf16: the numpy reader on the other dtypes
    theirs = tmp_path / "theirs.safetensors"
    arrays = {k: v.numpy() for k, v in t.items() if k != "bf16"}
    safetensors.numpy.save_file(arrays, str(theirs), {"x": "y"})
    got = ti.load_safetensors(str(theirs))
    want_np = safetensors.numpy.load_file(str(theirs))
    assert set(got) == set(want_np) == set(arrays)
    for k, v in want_np.items():
        assert got[k].numpy().dtype == v.dtype and np.array_equal(
            got[k].numpy(), v), k


def test_writer_reads_back_in_the_safetensors_package(tmp_path):
    import safetensors.numpy
    path = str(tmp_path / "w.safetensors")
    t = {k: v for k, v in _tensors(1).items() if k != "bf16"}
    n = ti.save_safetensors(t, path)
    assert n == os.path.getsize(path)
    back = safetensors.numpy.load_file(path)
    for k, v in t.items():
        assert back[k].dtype == v.numpy().dtype
        assert np.array_equal(back[k], v.numpy()), k


def test_reader_missing_file_and_dtype(tmp_path):
    with pytest.raises(FileNotFoundError, match="sd-turbo snapshot"):
        ti.load_safetensors(str(tmp_path / "none.safetensors"))
    with pytest.raises(ValueError, match="dtype"):
        ti.save_safetensors({"x": torch.zeros(2, dtype=torch.int8)},
                            str(tmp_path / "x.safetensors"))


def test_load_torch_pickle_is_fp32_and_weights_only(tmp_path):
    path = str(tmp_path / "c.pkl")
    torch.save({"rank": 4, "names": ["a", "b"], "sd": {
        "w": torch.ones(2, dtype=torch.float16),
        "v": (torch.zeros(1, dtype=torch.bfloat16),)}}, path)
    obj = ti.load_torch_pickle(path)
    assert obj["rank"] == 4 and obj["names"] == ["a", "b"]
    assert obj["sd"]["w"].dtype == torch.float32
    assert obj["sd"]["v"][0].dtype == torch.float32
    # an object outside the weights-only allow list is refused, not built
    torch.save({"obj": argparse.Namespace(x=1)}, str(tmp_path / "bad.pkl"))
    with pytest.raises(pickle.UnpicklingError):
        ti.load_torch_pickle(str(tmp_path / "bad.pkl"))


# ---------------------------------------------------------------------------
# key maps against the JAX converters
# ---------------------------------------------------------------------------


def _legacy(sd):
    """A diffusers VAE state dict under the old attention names, with
    conv-shaped (C, C, 1, 1) projections and no skip convs."""
    ren = {"to_q": "query", "to_k": "key", "to_v": "value",
           "to_out.0": "proj_attn", "group_norm": "norm"}
    out = {}
    for k, v in sd.items():
        if "skip_conv" in k:
            continue
        for new, old in ren.items():
            if ".attentions.0." + new + "." in k:
                k = k.replace(".attentions.0." + new + ".",
                              ".attentions.0." + old + ".")
                if v.ndim == 2:
                    v = v[:, :, None, None]
        out[k] = v
    return out


@pytest.mark.parametrize("layout", ["current", "legacy"])
def test_vae_key_map_equals_jax(layout):
    g = torch.Generator().manual_seed(3)
    sd = from_jax.random_params(tcfg.TINY_VAE, g)
    sd = {k: v for k, v in sd.items() if "skip_conv" not in k}
    if layout == "legacy":
        sd = _legacy(sd)
        assert any(".query." in k for k in sd)
    got = ti.vae_state_dict(sd, tcfg.TINY_VAE)
    want = from_jax.vae_state_dict(jti.convert_vae_state_dict(
        _np(sd), jcfg.TINY_VAE))
    _equal_sd(got, want)
    AutoencoderKL(tcfg.TINY_VAE).load_state_dict(got, strict=True)
    assert all((got[f"decoder.skip_conv_{i}.weight"] == 1e-5).all()
               for i in range(1, 5))


def test_unet_and_text_files_load_as_jax_reads_them(tmp_path):
    g = torch.Generator().manual_seed(4)
    usd = from_jax.random_params(tcfg.MICRO_UNET, g)
    path = str(tmp_path / "u.safetensors")
    ti.save_safetensors({k: v.half() for k, v in usd.items()}, path)
    unet = ti.load_unet(path, tcfg.MICRO_UNET, "cpu")
    want = from_jax.unet_state_dict(jti.convert_unet_state_dict(
        jti.load_safetensors(path), jcfg.MICRO_UNET))
    _equal_sd({k: v.half() for k, v in unet.state_dict().items()},
              {k: v for k, v in want.items()})
    assert all(p.dtype == torch.float32 for p in unet.parameters())

    text = trunner.random_init(
        lambda: tclip_text_model(), torch.Generator().manual_seed(5))
    tsd = {"text_model." + k: v for k, v in text.state_dict().items()}
    tsd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    tpath = str(tmp_path / "t.safetensors")
    ti.save_safetensors(tsd, tpath)
    loaded = ti.load_clip_text(tpath, tcfg.TINY_TEXT, "cpu")
    want = from_jax.clip_text_state_dict(jti.convert_clip_text_state_dict(
        jti.load_safetensors(tpath), jcfg.TINY_TEXT))
    _equal_sd(loaded.state_dict(), want)


def tclip_text_model():
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    return CLIPTextModel(tcfg.TINY_TEXT)


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

MERGES = [("h", "e"), ("l", "l"), ("l", "o</w>"), ("he", "ll"),
          ("hell", "o</w>"), ("w", "o"), ("r", "l"), ("wo", "rl"),
          ("worl", "d</w>"), ("c", "a"), ("ca", "t</w>"), ("1", "2")]
PROMPTS = ["hello world", "a cat, hello!!", "HELLO World 123",
           "  spaces   and\ttabs ", "unicode: café", "",
           "&amp;lt;html&amp;gt; cat", " ".join(["hello world"] * 60)]


@pytest.fixture(scope="module")
def vocab_dirs(tmp_path_factory):
    """tests/test_tokenizer.py's synthetic vocab as the HF pair, and its
    merges alone as merges.txt, merges.txt.gz and OpenAI's single file."""
    root = tmp_path_factory.mktemp("tok")
    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    for a, b in MERGES:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    text = "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n"
    dirs = {}
    for form in ("pair", "merges", "gz", "openai"):
        d = root / form
        d.mkdir()
        if form == "pair":
            (d / "vocab.json").write_text(json.dumps(vocab))
            (d / "merges.txt").write_text(text)
        elif form == "merges":
            (d / "merges.txt").write_text(text)
        else:
            name = "merges.txt.gz" if form == "gz" else \
                "bpe_simple_vocab_16e6.txt.gz"
            with gzip.open(d / name, "wt", encoding="utf-8") as f:
                f.write(text)
        dirs[form] = str(d)
    return dirs


@pytest.mark.parametrize("form", ["pair", "merges", "gz", "openai"])
def test_tokenizer_ids_equal_jax(vocab_dirs, form):
    ours = CLIPTokenizer.from_dir(vocab_dirs[form])
    theirs = JTok.from_dir(vocab_dirs[form])
    assert ours.encoder == theirs.encoder
    for p in PROMPTS:
        got, want = ours(p), theirs(p)
        assert got.dtype == want.dtype == np.int32
        assert got.shape == (1, 77)
        np.testing.assert_array_equal(got, want)
        ids = [int(i) for i in got[0] if i != ours.pad_token_id]
        assert ours.decode(ids) == theirs.decode(ids)
    long = ours(PROMPTS[-1])
    assert long[0, -1] == ours.eos_token_id          # truncated at 77
    np.testing.assert_array_equal(ours(PROMPTS[:3]), theirs(PROMPTS[:3]))
    if form != "pair":
        merges = os.path.join(vocab_dirs[form], os.listdir(
            vocab_dirs[form])[0])
        assert vocab_from_merges(merges) == jvocab_from_merges(merges)


def test_tokenizer_dir_without_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        CLIPTokenizer.from_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        download.get_clip_tokenizer(str(tmp_path))
    with pytest.raises(FileNotFoundError, match=download.BASE_URL):
        download.get_checkpoint("day_to_night", str(tmp_path))
    (tmp_path / "day2night.pkl").write_bytes(b"")
    assert download.get_checkpoint("day_to_night", str(tmp_path)) == \
        str(tmp_path / "day2night.pkl")


# ---------------------------------------------------------------------------
# LoRA from pkls
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def micro_unet():
    g = torch.Generator().manual_seed(6)
    sd = from_jax.random_params(tcfg.MICRO_UNET, g)
    return sd, jti.convert_unet_state_dict(_np(sd), jcfg.MICRO_UNET)


def _peft_sd(seed):
    """peft keys: adapter-named and adapter-free LoRA pairs on convs and
    linears (one inside a `.base_layer.`-wrapped name), a wrapped base
    weight, a plain conv_in, and keys that name no weight module."""
    rng = np.random.RandomState(seed)

    def r(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32))
    a_lin = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    return {
        "conv_in.lora_A.default.weight": r(4, 4, 3, 3),
        "conv_in.lora_B.default.weight": r(32, 4, 1, 1),
        f"{a_lin}.lora_A.default.weight": r(4, 32),
        f"{a_lin}.lora_B.default.weight": r(32, 4),
        "down_blocks.0.resnets.0.conv1.lora_A.weight": r(4, 32, 3, 3),
        "down_blocks.0.resnets.0.conv1.lora_B.weight": r(32, 4, 1, 1),
        "up_blocks.0.resnets.0.conv2.base_layer.lora_A.other.weight":
            r(4, 64, 3, 3),
        "up_blocks.0.resnets.0.conv2.base_layer.lora_B.other.weight":
            r(64, 4, 1, 1),
        "conv_in.weight": r(32, 4, 3, 3),
        "conv_in.bias": r(32),
        "conv_out.base_layer.weight": r(4, 32, 3, 3),
        "conv_norm_out.weight": r(32),
        "no.such.module.weight": r(3),
    }


@pytest.mark.parametrize("adapter", [None, "default"])
def test_lora_from_torch_state_dict_equals_jax(adapter):
    sd = _peft_sd(0)
    got = tlora.lora_from_torch_state_dict(sd, rank=4, adapter=adapter)
    want = jlora.lora_from_torch_state_dict(_np(sd), rank=4, adapter=adapter)
    assert got["rank"] == want["rank"] == 4
    assert got["alpha"] == want["alpha"] == 8.0
    assert set(got["modules"]) == set(want["modules"])
    for n, e in want["modules"].items():
        for ab in ("a", "b"):
            assert np.array_equal(got["modules"][n][ab].numpy(),
                                  np.asarray(e[ab])), (n, ab)
    assert tlora.lora_from_torch_state_dict(sd, 4, alpha=4.0)["alpha"] == 4.0
    with pytest.raises(ValueError, match="incomplete"):
        tlora.lora_from_torch_state_dict(
            {"x.lora_A.weight": torch.zeros(1, 1)}, rank=1)


def test_overlay_base_weights_equals_jax(micro_unet):
    sd, tree = micro_unet
    unet = from_jax.load(UNet2DConditionModel(tcfg.MICRO_UNET), sd)
    ck = _peft_sd(1)
    applied = tlora.overlay_base_weights(unet, ck)
    new, japplied = jlora.overlay_base_weights(tree, _np(ck), "unet")
    assert applied == japplied == ["conv_in.weight", "conv_in.bias",
                                   "conv_out.base_layer.weight"]
    _equal_sd(unet.state_dict(), from_jax.unet_state_dict(new))


# ---------------------------------------------------------------------------
# aux converters
# ---------------------------------------------------------------------------


def _openai(hf, cfg):
    """The OpenAI `clip` layout of a transformers CLIPModel state dict."""
    out = {}

    def blocks(src, dst, n):
        for i in range(n):
            s, d = f"{src}.layers.{i}", f"{dst}.resblocks.{i}"
            out[d + ".attn.in_proj_weight"] = torch.cat(
                [hf[f"{s}.self_attn.{p}_proj.weight"] for p in "qkv"])
            out[d + ".attn.in_proj_bias"] = torch.cat(
                [hf[f"{s}.self_attn.{p}_proj.bias"] for p in "qkv"])
            for a, b in (("attn.out_proj", "self_attn.out_proj"),
                         ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                for f in ("weight", "bias"):
                    out[f"{d}.{a}.{f}"] = hf[f"{s}.{b}.{f}"]
    vm, tm = "vision_model.", "text_model."
    out["visual.conv1.weight"] = hf[vm + "embeddings.patch_embedding.weight"]
    out["visual.class_embedding"] = hf[vm + "embeddings.class_embedding"]
    out["visual.positional_embedding"] = \
        hf[vm + "embeddings.position_embedding.weight"]
    for a, b in (("visual.ln_pre", vm + "pre_layrnorm"),
                 ("visual.ln_post", vm + "post_layernorm"),
                 ("ln_final", tm + "final_layer_norm")):
        for f in ("weight", "bias"):
            out[f"{a}.{f}"] = hf[f"{b}.{f}"]
    blocks(vm + "encoder", "visual.transformer", cfg.num_layers)
    blocks(tm + "encoder", "transformer", cfg.text_layers)
    out["visual.proj"] = hf["visual_projection.weight"].t().contiguous()
    out["text_projection"] = hf["text_projection.weight"].t().contiguous()
    out["token_embedding.weight"] = hf[tm + "embeddings.token_embedding.weight"]
    out["positional_embedding"] = \
        hf[tm + "embeddings.position_embedding.weight"]
    out["logit_scale"] = hf["logit_scale"]
    return out


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    """A random TINY CLIPModel's state dict in both layouts, and the
    transformers one written as a torch file (with the position_ids
    buffers and the older `pre_layernorm` name)."""
    cfg = tclip.TINY_CLIP_VIT
    model = trunner.random_init(lambda: tclip.CLIPModel(cfg),
                                torch.Generator().manual_seed(8))
    hf = {k: v.detach().clone() for k, v in model.state_dict().items()}
    hf_file = {k.replace("pre_layrnorm", "pre_layernorm"): v
               for k, v in hf.items()}
    hf_file["vision_model.embeddings.position_ids"] = torch.arange(17)[None]
    hf_file["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    path = tmp_path_factory.mktemp("clip") / "clip.pt"
    torch.save({"state_dict": hf_file}, str(path))
    return model, {"hf": hf_file, "openai": _openai(hf, cfg)}, str(path)


@pytest.mark.parametrize("layout", ["hf", "openai"])
def test_clip_converter_equals_jax(clip_files, layout):
    model, layouts, _ = clip_files
    sd = layouts[layout]
    got = tclip.convert_clip_state_dict(sd, tclip.TINY_CLIP_VIT)
    want = from_jax.clip_state_dict(jclip.convert_clip_state_dict(
        _np(sd), jclip.TINY_CLIP_VIT))
    _equal_sd(got, want)
    loaded = tclip.CLIPModel(tclip.TINY_CLIP_VIT)
    loaded.load_state_dict(got, strict=True)
    rng = np.random.RandomState(9)
    px = torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 1000, (2, 77)))
    with torch.no_grad():
        for m in (loaded, model):
            m.eval()
        for f in (lambda m: m(px)[0], lambda m: m.text_forward(ids)):
            a, b = f(loaded), f(model)
            assert ((a - b).norm() / b.norm()).item() <= 1e-6


def test_lpips_converter_equals_jax(tmp_path):
    rng = np.random.RandomState(10)
    lp = {}
    slices = {1: (0, 2), 2: (5, 7), 3: (10, 12, 14), 4: (17, 19, 21),
              5: (24, 26, 28)}
    cin = 3
    for k, idxs in slices.items():
        for i in idxs:
            cout = tlpips.VGG_PLAN[k - 1][0]
            lp[f"net.slice{k}.{i}.weight"] = torch.from_numpy(
                rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
            lp[f"net.slice{k}.{i}.bias"] = torch.from_numpy(
                rng.randn(cout).astype(np.float32))
            cin = cout
        lp[f"lin{k - 1}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.randn(1, cout, 1, 1)).astype(np.float32))
    path = str(tmp_path / "lpips.pth")
    torch.save(lp, path)
    got = tlpips.load_lpips_weights(path)
    _equal_sd(got, from_jax.lpips_state_dict(jlpips.load_lpips_weights(path)))
    model = tlpips.VGGLPIPS()
    model.load_state_dict(got, strict=True)
    pair = {"vgg": {f"features.{k.split('.', 2)[2]}": v
                    for k, v in lp.items() if k.startswith("net.")},
            "lins": {k: v for k, v in lp.items() if k.startswith("lin")}}
    torch.save(pair, str(tmp_path / "pair.pth"))
    _equal_sd(tlpips.load_lpips_weights(str(tmp_path / "pair.pth")),
              {k: v.numpy() for k, v in got.items()})


def _torchvision_inception(seed):
    """A torchvision-layout inception_v3 state dict (conv + batch norm per
    BasicConv2d, num_batches_tracked, an fc head)."""
    rng = np.random.RandomState(seed)
    out = {}
    with torch.device("meta"):
        model = tinc.InceptionV3()
    for k, p in model.named_parameters():
        prefix, field = k.rsplit(".", 1)
        if field != "weight":
            continue
        co = p.shape[0]
        out[prefix + ".conv.weight"] = torch.from_numpy(
            rng.randn(*p.shape).astype(np.float32) * 0.05)
        out[prefix + ".bn.weight"] = torch.from_numpy(
            rng.rand(co).astype(np.float32) + 0.5)
        out[prefix + ".bn.bias"] = torch.from_numpy(
            rng.randn(co).astype(np.float32))
        out[prefix + ".bn.running_mean"] = torch.from_numpy(
            rng.randn(co).astype(np.float32))
        out[prefix + ".bn.running_var"] = torch.from_numpy(
            rng.rand(co).astype(np.float32) + 0.1)
        out[prefix + ".bn.num_batches_tracked"] = torch.tensor(7)
    out["fc.weight"] = torch.zeros(10, 2048)
    return out


def test_inception_converter_equals_jax(tmp_path, monkeypatch):
    """JAX's converter draws a random tree only for its structure (stride
    and padding entries; its values are not read): its normal draws are
    zeros here, which spares ~20 s of per-shape compiles on the CPU."""
    import jax
    sd = _torchvision_inception(11)
    got = tinc.convert_inception_state_dict(sd)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal",
                  lambda key, shape, dtype=np.float32: np.zeros(shape, dtype))
        tree = jinc.convert_inception_state_dict(_np(
            {k: v for k, v in sd.items()
             if not k.endswith("num_batches_tracked")}))
    want = from_jax.inception_state_dict(tree)
    _equal_sd(got, want)
    path = str(tmp_path / "inc.pth")
    torch.save({"state_dict": sd}, path)

    class Args:
        inception_weights = path
    model = trunner.init_inception(Args, torch.Generator())
    _equal_sd(model.state_dict(), want)
    x = torch.from_numpy(np.random.RandomState(12).rand(1, 80, 80, 3)
                         .astype(np.float32))
    ref = tinc.InceptionV3()
    from_jax.load(ref, want)
    with torch.no_grad():
        assert torch.equal(model(x), ref.eval()(x))


def test_dino_converter_equals_jax():
    cfg = tdino.TINY_DINO
    model = tdino.random_dino(cfg, torch.Generator().manual_seed(13))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd["head.weight"] = torch.zeros(3, 32)
    got = tdino.convert_dino_state_dict(sd, cfg)
    want = from_jax.dino_state_dict(jdino.convert_dino_state_dict(
        _np(sd), jdino.TINY_DINO))
    _equal_sd(got, want)
    loaded = tdino.DINO(cfg)
    loaded.load_state_dict(got, strict=True)
    x = torch.from_numpy(np.random.RandomState(14).randn(1, 32, 32, 3)
                         .astype(np.float32))
    with torch.no_grad():
        a, b = loaded.eval()(x)[0], model.eval()(x)[0]
    assert torch.equal(a, b)


def test_init_aux_models_reads_the_files(clip_files, tmp_path):
    model, _, clip_path = clip_files
    lpips = tlpips.VGGLPIPS()
    sd = {}
    for b, idxs in enumerate(tlpips.VGG_FEATURE_INDICES):
        for j, i in enumerate(idxs):
            for f in ("weight", "bias"):
                sd[f"features.{i}.{f}"] = torch.full_like(
                    lpips.state_dict()[f"blocks.{b}.{j}.{f}"], float(i))
    lins = {f"lin{i}.model.1.weight": torch.full_like(
        lpips.state_dict()[f"lins.{i}.weight"], float(i))
        for i in range(5)}
    lpath = str(tmp_path / "lp.pth")
    torch.save({"vgg": sd, "lins": lins}, lpath)
    lpips_m, backbone, clip, heads, sn = trunner.init_aux_models(
        tclip.TINY_CLIP_VIT, torch.Generator().manual_seed(1), True,
        clip_weights=clip_path, lpips_weights=lpath)
    _equal_sd(lpips_m.state_dict(), {k: v.numpy() for k, v in
                                     tlpips.load_lpips_weights(lpath).items()})
    want = _np(model.state_dict())
    _equal_sd(clip.state_dict(), want)
    _equal_sd(backbone.state_dict(), {
        k: v for k, v in want.items()
        if k.startswith(("vision_model.", "visual_projection."))})
    assert heads and sn
    assert not any(p.requires_grad for m in (lpips_m, backbone, clip)
                   for p in m.parameters())


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------


def test_port_never_imports_safetensors_or_transformers():
    """Beside test_torch_ops.py::test_port_never_imports_jax: every module
    of the port and chip_smoke.py, imported, load neither the JAX package,
    jax, safetensors nor transformers (the card machine has none of them)."""
    code = (
        "import sys, importlib, importlib.util, pkgutil\n"
        "import img2img_turbo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        "'chip_smoke.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'img2img_turbo_tpu', 'safetensors', "
        "'transformers'))\n"
        "assert not bad, bad\n"
        f"missing = [m for m in {PORT_MODULES} if m not in sys.modules]\n"
        "assert not missing, missing\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
