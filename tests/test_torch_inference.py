"""The port's `Pix2PixTurbo.from_pretrained`, `CycleGANTurbo.from_pretrained`
and the two inference CLIs against the JAX package, on the CPU, in fp32.

Files in the published layouts, written here: SD-Turbo snapshots at
MICRO_UNET / TINY_VAE / TINY_TEXT (seeded random weights drawn by the
port, saved with `weights.torch_import.save_safetensors`: the UNet and VAE
under their diffusers names, the VAE without skip convs, one snapshot with
its mid attention under the legacy names and conv-shaped weights, the text
encoder with its `text_model.` prefix and position_ids, a BPE vocabulary
and merges), and pkls written by the JAX package itself:
`Pix2PixTurbo.save_model` (deterministic, and stochastic with a TwinConv
conv_in) and `training/checkpoint.py::export_cyclegan_pkl`, each with
random LoRA B factors, conv_in and skip convs so that nothing is its init.

Both packages load the same files; the pipelines must agree within
relative L2 1e-4 on the same input and noise (the JAX posterior noise,
drawn from its key, handed to the port), the loaded weights within 1e-6
relative. The CLIs: the same flags, defaults and SystemExit messages as
JAX's, and a TINY `main(..., device="cpu", cfgs=...)` PNG that equals the
JAX CLI's (run on the same loaded JAX pipeline, so that each JAX program
compiles once) within 1 uint8 level on at most 0.1% of the values. On the
same JAX pipelines: the demos' `CannyDemo.process` and `SketchDemo.run`
(`serving/demo.py`) within that bar, and `cli/convert_weights.py`'s
payload against JAX's `from_pretrained` (`text`, `base` and `lora` bit for
bit, merged `params` within 1e-6 relative), read back by
`Pix2PixTurbo.from_native` and `ServingEngine.from_native`.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from img2img_turbo_tpu import configs as jcfg
from img2img_turbo_tpu import lora as jlora
from img2img_turbo_tpu.models import unet as junet
from img2img_turbo_tpu.pipelines import cyclegan as jcg
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.training import checkpoint as jckpt
from img2img_turbo_tpu.training import unpaired as junpaired
from img2img_turbo_tpu.weights import torch_import as jti
from img2img_turbo_tpu_torch import configs as tcfg
from img2img_turbo_tpu.serving import demo as jdemo
from img2img_turbo_tpu_torch.cli import convert_weights
from img2img_turbo_tpu_torch.cli import inference_paired as tip
from img2img_turbo_tpu_torch.cli import inference_unpaired as tiu
from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
from img2img_turbo_tpu_torch.models.tokenizer import bytes_to_unicode
from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
from img2img_turbo_tpu_torch.pipelines import cyclegan as tcg
from img2img_turbo_tpu_torch.pipelines import pix2pix as tp2p
from img2img_turbo_tpu_torch.serving import demo as tdemo
from img2img_turbo_tpu_torch.serving.engine import ServingEngine
from img2img_turbo_tpu_torch.training import runner as trunner
from img2img_turbo_tpu_torch.weights import from_jax
from img2img_turbo_tpu_torch.weights import native
from img2img_turbo_tpu_torch.weights import torch_import as ti

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_L2, W_REL = 1e-4, 1e-6
MAX_LEVELS, MAX_FRACTION = 1, 1e-3
JCFGS = jp2p.GeneratorConfigs(jcfg.MICRO_UNET, jcfg.TINY_VAE, jcfg.TINY_TEXT)
CFGS = tp2p.GeneratorConfigs(tcfg.MICRO_UNET, tcfg.TINY_VAE, tcfg.TINY_TEXT)
H, W = 40, 64                     # the CLIs' input after its crop
PROMPT, CAPTION = "a red bird", "driving in the night"
MERGES = [("r", "e"), ("re", "d</w>"), ("b", "i"), ("bi", "r"),
          ("bir", "d</w>"), ("n", "i"), ("g", "h"), ("gh", "t</w>"),
          ("i", "n</w>"), ("t", "h"), ("th", "e</w>")]


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _jax_cli(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "cli", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_tokenizer(d):
    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    for a, b in MERGES:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    os.makedirs(d)
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n"
                + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n")


def _legacy_vae(sd):
    ren = {"to_q": "query", "to_k": "key", "to_v": "value",
           "to_out.0": "proj_attn", "group_norm": "norm"}
    out = {}
    for k, v in sd.items():
        for new, old in ren.items():
            tag = ".attentions.0." + new + "."
            if tag in k:
                k = k.replace(tag, ".attentions.0." + old + ".")
                v = v[:, :, None, None] if v.ndim == 2 else v
        out[k] = v
    return out


def _lora_np(tree, model, names, rank, seed):
    """A JAX-layout adapter (alpha 8, peft's default) over `names`, from
    seeded numpy: A with std 1/rank, B random."""
    rng = np.random.RandomState(seed)
    mods = {}
    for n, path in sorted(jlora.module_names(tree, model).items()):
        if n in names:
            kern = jlora._get(tree, path)["kernel"]
            mods[n] = {"a": (rng.randn(*kern.shape[:-1], rank) / rank
                             ).astype(np.float32),
                       "b": (rng.randn(rank, kern.shape[-1]) * 0.05
                             ).astype(np.float32)}
    return {"rank": rank, "alpha": 8.0, "modules": mods}


def _targets(tree, model, targets):
    return {n for n in jlora.module_names(tree, model)
            if jlora.matches_target(n, targets)}


def _rand_conv(rng, conv):
    out = {"kernel": jnp.asarray(rng.randn(*conv["kernel"].shape)
                                 .astype(np.float32) * 0.05)}
    if "bias" in conv:
        out["bias"] = jnp.asarray(rng.randn(*conv["bias"].shape)
                                  .astype(np.float32) * 0.05)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two snapshots ("modern", "legacy" VAE attention names) and the
    three JAX-written pkls, under the published file names in one
    checkpoint folder."""
    root = str(tmp_path_factory.mktemp("weights"))
    g = torch.Generator().manual_seed(21)
    usd = from_jax.random_params(tcfg.MICRO_UNET, g)
    vsd = {k: v for k, v in from_jax.random_params(tcfg.TINY_VAE, g).items()
           if "skip_conv" not in k}
    text = trunner.random_init(lambda: CLIPTextModel(tcfg.TINY_TEXT), g)
    tsd = {"text_model." + k: v for k, v in text.state_dict().items()}
    tsd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    snaps = {}
    for name in ("modern", "legacy"):
        d = snaps[name] = os.path.join(root, name)
        for sub, sd in (("unet", usd), ("vae", vsd if name == "modern"
                                        else _legacy_vae(vsd))):
            os.makedirs(os.path.join(d, sub))
            ti.save_safetensors(sd, os.path.join(
                d, sub, "diffusion_pytorch_model.safetensors"))
        os.makedirs(os.path.join(d, "text_encoder"))
        ti.save_safetensors(tsd, os.path.join(d, "text_encoder",
                                              "model.safetensors"))
        _write_tokenizer(os.path.join(d, "tokenizer"))

    rng = np.random.RandomState(22)
    unet = jti.convert_unet_state_dict(_np(usd), jcfg.MICRO_UNET)
    vae = jti.convert_vae_state_dict(_np(vsd), jcfg.TINY_VAE)
    unet["conv_in"] = _rand_conv(rng, unet["conv_in"])
    vae["decoder"]["skip_convs"] = [_rand_conv(rng, c) for c in
                                    vae["decoder"]["skip_convs"]]
    lora = {"unet": _lora_np(unet, "unet", _targets(
                unet, "unet", jlora.PIX2PIX_UNET_TARGETS), 4, 23),
            "vae": _lora_np(vae, "vae", _targets(
                vae, "vae", jlora.PIX2PIX_VAE_TARGETS), 2, 24)}
    ckpts = os.path.join(root, "checkpoints")
    os.makedirs(ckpts)
    jp2p.Pix2PixTurbo(JCFGS, base={"unet": unet, "vae": vae},
                      lora=lora).save_model(
        os.path.join(ckpts, "edge_to_image_loras.pkl"))
    twin = junet.make_twin_conv_in(unet)
    twin["conv_in"] = {"pretrained": _rand_conv(rng, unet["conv_in"]),
                       "current": _rand_conv(rng, unet["conv_in"])}
    jp2p.Pix2PixTurbo(JCFGS, base={"unet": twin, "vae": vae},
                      lora=lora).save_model(
        os.path.join(ckpts, "sketch_to_image_stochastic_lora.pkl"))

    # CycleGAN: the UNet trio partitioned as cyclegan_unet_adapters does
    # (rank 4, alpha = rank), two VAEs with random skip convs and LoRA
    trio = tcg.cyclegan_unet_adapters(
        from_jax.load(UNet2DConditionModel(tcfg.MICRO_UNET), usd), 4,
        torch.Generator().manual_seed(25))
    adapters = {a: dict(_lora_np(unet, "unet", set(t["modules"]), 4, 26 + i),
                        alpha=4.0) for i, (a, t) in enumerate(trio.items())}
    vaes = {}
    for d in ("a2b", "b2a"):
        v = jti.convert_vae_state_dict(_np(vsd), jcfg.TINY_VAE)
        v["decoder"]["skip_convs"] = [_rand_conv(rng, c) for c in
                                      v["decoder"]["skip_convs"]]
        vaes[d] = v
    vae_loras = [_lora_np(vaes[d], "vae", _targets(
        vaes[d], "vae", jlora.CYCLEGAN_VAE_TARGETS), 2, 30 + i)
        for i, d in enumerate(("a2b", "b2a"))]
    jgen, frozen, jmeta = junpaired.split_trainable(
        unet, vaes["a2b"], vaes["b2a"], adapters, *vae_loras)
    cyc = os.path.join(root, "cyclegan.pkl")
    jckpt.export_cyclegan_pkl(cyc, jgen, jmeta,
                              {k: sorted(v["modules"])
                               for k, v in adapters.items()},
                              jlora.CYCLEGAN_VAE_TARGETS, frozen)
    return dict(snaps, ckpts=ckpts, cyclegan=cyc,
                edge=os.path.join(ckpts, "edge_to_image_loras.pkl"),
                sketch=os.path.join(ckpts,
                                    "sketch_to_image_stochastic_lora.pkl"))


@pytest.fixture(scope="module")
def pipes(files):
    """{mode: (JAX pipeline, port pipeline)}, each loaded by its own
    package's from_pretrained from the same files (the deterministic model
    from the legacy snapshot)."""
    f32 = jnp.float32
    return {
        "edge": (jp2p.Pix2PixTurbo.from_pretrained(
                     files["legacy"], files["edge"], cfgs=JCFGS, dtype=f32),
                 tp2p.Pix2PixTurbo.from_pretrained(
                     files["legacy"], files["edge"], cfgs=CFGS,
                     dtype=torch.float32, device="cpu")),
        "sketch": (jp2p.Pix2PixTurbo.from_pretrained(
                       files["modern"], "sketch_to_image_stochastic",
                       cfgs=JCFGS, dtype=f32, ckpt_folder=files["ckpts"]),
                   tp2p.Pix2PixTurbo.from_pretrained(
                       files["modern"], "sketch_to_image_stochastic",
                       cfgs=CFGS, dtype=torch.float32,
                       ckpt_folder=files["ckpts"], device="cpu")),
        "cyclegan": (jcg.CycleGANTurbo.from_pretrained(
                         files["modern"], files["cyclegan"], caption=CAPTION,
                         direction="a2b", cfgs=JCFGS, dtype=f32),
                     tcg.CycleGANTurbo.from_pretrained(
                         files["modern"], files["cyclegan"], caption=CAPTION,
                         direction="a2b", cfgs=CFGS, dtype=torch.float32,
                         device="cpu")),
    }


def _assert_weights(module, want):
    got = module.state_dict()
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k, w in want.items():
        assert rel_l2(got[k], w) <= W_REL, k


def _noise(key, shape=(1, H // 8, W // 8, 4)):
    return np.array(jax.random.normal(key, shape, jnp.float32))


# ---------------------------------------------------------------------------
# from_pretrained
# ---------------------------------------------------------------------------


def test_loaded_weights_equal_jax(pipes):
    """Every module the two packages loaded, merged or not, through
    from_jax's inverse converters."""
    jdet, tdet = pipes["edge"]
    for k, conv in (("unet", from_jax.unet_state_dict),
                    ("vae", from_jax.vae_state_dict)):
        _assert_weights(tdet.params[k], conv(jdet.params[k]))
    jsto, tsto = pipes["sketch"]
    _assert_weights(tsto.base["unet"], from_jax.unet_state_dict(
        jsto.base["unet"]))
    _assert_weights(tsto.base["vae"], from_jax.vae_state_dict(
        jsto.base["vae"]))
    for k in ("unet", "vae"):
        want = jsto.lora[k]
        got = tsto.lora[k]
        assert (got["rank"], got["alpha"]) == (want["rank"], want["alpha"])
        assert set(got["modules"]) == set(want["modules"])
        for n, e in want["modules"].items():
            for ab in ("a", "b"):
                assert np.array_equal(got["modules"][n][ab].numpy(),
                                      np.asarray(e[ab])), (k, n, ab)
    jcyc, tcyc = pipes["cyclegan"]
    for k, conv in (("unet", from_jax.unet_state_dict),
                    ("vae_a2b", from_jax.vae_state_dict),
                    ("vae_b2a", from_jax.vae_state_dict)):
        _assert_weights(tcyc.params[k], conv(jcyc.params[k]))
    _assert_weights(tdet.text, from_jax.clip_text_state_dict(
        jdet.text_params))


def test_prompt_ids_and_embedding_equal_jax(pipes):
    jdet, tdet = pipes["edge"]
    for p in (PROMPT, CAPTION, "Hello,  World!! " * 30):
        np.testing.assert_array_equal(tdet.tokenizer(p), jdet.tokenizer(p))
    got = tdet.encode_prompt(PROMPT)
    assert got is tdet.encode_prompt(PROMPT)            # cached
    assert rel_l2(got, jdet.encode_prompt(PROMPT)) <= REL_L2
    toks = jdet.tokenizer([PROMPT, CAPTION])
    assert rel_l2(tdet.encode_prompt_tokens(toks),
                  jdet.encode_prompt_tokens(toks)) <= REL_L2


@pytest.mark.parametrize("mode", ["edge", "sketch"])
def test_pix2pix_from_pretrained_matches_jax(pipes, mode):
    """Deterministic (legacy VAE names) and stochastic at r = 0.4, on the
    kernel and the plain path."""
    jpipe, tpipe = pipes[mode]
    rng = np.random.RandomState(40)
    c_t = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(41)
    kw = {}
    if mode == "sketch":
        nm = rng.randn(1, H // 8, W // 8, 4).astype(np.float32)
        kw = dict(deterministic=False, r=0.4)
        want = jpipe(jnp.asarray(c_t), prompt=PROMPT, rng=key,
                     noise_map=jnp.asarray(nm), **kw)
        kw["noise_map"] = torch.from_numpy(nm)
    else:
        want = jpipe(jnp.asarray(c_t), prompt=PROMPT, rng=key)
    noise = torch.from_numpy(_noise(key))
    for kernels in (True, False):
        tpipe.use_kernels = kernels
        got = tpipe(torch.from_numpy(c_t), prompt=PROMPT, noise=noise, **kw)
        assert got.shape == (1, H, W, 3)
        assert rel_l2(got, want) <= REL_L2, (mode, kernels)
    tpipe.use_kernels = True


@pytest.mark.parametrize("direction", ["a2b", "b2a"])
def test_cyclegan_from_pretrained_matches_jax(pipes, direction):
    """JAX's b2a is its a2b program on params whose vae_a2b is vae_b2a
    (one compile); the port runs its own b2a, the caption as a string."""
    jpipe, tpipe = pipes["cyclegan"]
    x = np.random.RandomState(42).uniform(-1, 1, (1, H, W, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(43)
    params = dict(jpipe.params, vae_a2b=jpipe.params["vae_" + direction])
    want = jpipe._fwd(params, x=jnp.asarray(x),
                      caption_enc=jpipe.encode_prompt(CAPTION), rng=key,
                      direction="a2b")
    got = tpipe(torch.from_numpy(x), direction,
                noise=torch.from_numpy(_noise(key)))
    assert rel_l2(got, want) <= REL_L2, direction
    other = tpipe(torch.from_numpy(x), direction,
                  noise=torch.from_numpy(_noise(key)), caption=PROMPT)
    assert not torch.equal(other, got)


def test_pipeline_refusals(pipes):
    _, tdet = pipes["edge"]
    _, tsto = pipes["sketch"]
    x = torch.zeros(1, 36, 64, 3)
    with pytest.raises(ValueError, match="multiples of 8"):
        tdet(x, prompt=PROMPT)
    with pytest.raises(ValueError, match="prompt"):
        tdet(torch.zeros(1, H, W, 3))
    with pytest.raises(ValueError, match="merge"):
        tsto(torch.zeros(1, H, W, 3), prompt=PROMPT)
    with pytest.raises(ValueError, match="noise_map"):
        tsto(torch.zeros(1, H, W, 3), prompt=PROMPT, deterministic=False)


def test_save_model_round_trips_the_jax_pkl(pipes, files, tmp_path):
    """The stochastic model the port loaded, written back by its
    save_model (export_pix2pix_pkl), equals the pkl JAX wrote."""
    _, tsto = pipes["sketch"]
    path = str(tmp_path / "sketch.pkl")
    tsto.save_model(path)
    got = torch.load(path, weights_only=True)
    want = torch.load(files["sketch"], weights_only=True)
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, dict):
            assert set(got[key]) == set(w), key
            for k, t in w.items():
                assert torch.equal(got[key][k], t), (key, k)
        else:
            assert got[key] == w, key


def test_from_random_merge_is_the_base():
    """B = 0 at init: merge() serves the base weights, as kernels-ready
    copies; the factored modules keep theirs."""
    pipe = tp2p.Pix2PixTurbo.from_random(torch.Generator().manual_seed(5),
                                         CFGS, dtype=torch.float32)
    assert pipe.params is None and pipe.tokenizer is None
    pipe.merge()
    for k in ("unet", "vae"):
        base = pipe.base[k].state_dict()
        for n, v in pipe.params[k].state_dict().items():
            assert torch.equal(v, base[n]), n
        assert pipe.params[k] is not pipe.base[k]


# ---------------------------------------------------------------------------
# the inference CLIs
# ---------------------------------------------------------------------------


PAIRED_CHECKS = [
    ["--model_name", "edge_to_image", "--model_path", "x.pkl"],
    [],
    ["--model_name", "edge_to_image", "--sd_turbo_path", ""],
    ["--model_name", "nope"],
    ["--model_name", "sketch_to_image_stochastic", "--ckpt_folder", "none"],
]
UNPAIRED_CHECKS = [
    ["--model_name", "day_to_night", "--model_path", "x.pkl"],
    [],
    ["--model_path", "x.pkl"],
    ["--model_name", "day_to_night", "--prompt", "p"],
    ["--model_name", "day_to_night", "--sd_turbo_path", ""],
    ["--model_name", "nope"],
    ["--model_name", "night_to_day", "--ckpt_folder", "none"],
]


@pytest.mark.parametrize("which,argv", [
    *[("paired", a) for a in PAIRED_CHECKS],
    *[("unpaired", a) for a in UNPAIRED_CHECKS]])
def test_cli_checks_equal_jax(which, argv, monkeypatch):
    """The same parsed flags and the same SystemExit as the JAX CLI."""
    monkeypatch.delenv("SD_TURBO_PATH", raising=False)
    port = tip if which == "paired" else tiu
    jax_cli = _jax_cli(f"inference_{which}")
    argv = ["--input_image", "in.png", "--sd_turbo_path", "snap"] \
        + (["--prompt", "p"] if which == "paired" else []) + argv
    assert vars(port.build_parser().parse_args(argv)) == \
        vars(jax_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as want:
        jax_cli.main(jax_cli.build_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        port.main(port.build_parser().parse_args(argv), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("port", [tip, tiu])
def test_cli_on_cuda_needs_bf16(port, files):
    """The kernels take bf16 only: on a CUDA device a run without
    --use_fp16 stops before loading anything (no card needed)."""
    argv = ["--input_image", "in.png", "--sd_turbo_path", files["modern"],
            "--model_path", files["edge"], "--prompt", "p", "--direction",
            "a2b"]
    if port is tip:
        argv.remove("--direction")
        argv.remove("a2b")
    with pytest.raises(SystemExit, match="bf16"):
        port.main(port.build_parser().parse_args(argv), device="cuda")


def _synth(h, w, seed):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synth_image(h, w, seed)[0]


def _with_noise(monkeypatch, cls, noise, noise_map=None):
    """The port pipeline's call with the JAX CLI's noise in place of its
    own generator's draws (the rest of the call as the CLI made it)."""
    real = cls.__call__

    def call(self, *args, **kw):
        kw.pop("generator", None)
        kw["noise"] = torch.from_numpy(noise)
        if noise_map is not None:
            kw["noise_map"] = torch.from_numpy(noise_map)
        return real(self, *args, **kw)
    monkeypatch.setattr(cls, "__call__", call)


def _png_agrees(got_path, want_path):
    got = np.asarray(Image.open(got_path))
    want = np.asarray(Image.open(want_path))
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_LEVELS, diff.max()
    assert (diff > 0).mean() <= MAX_FRACTION, (diff > 0).mean()
    assert want.std() > 0
    return got


@pytest.mark.parametrize("mode,snap", [("edge_to_image", "legacy"),
                                       ("sketch_to_image_stochastic",
                                        "modern")])
def test_inference_paired_cli_matches_jax(mode, snap, pipes, files, tmp_path,
                                          monkeypatch):
    """67x45 in, resized to 64x40 by the CLI; edge: canny at 100 / 200,
    sketch: the threshold and a noise map at --gamma 0.4."""
    inp = str(tmp_path / "in.png")
    Image.fromarray(_synth(45, 67, 50)).save(inp)
    argv = ["--input_image", inp, "--prompt", PROMPT, "--model_name", mode,
            "--sd_turbo_path", files[snap], "--ckpt_folder", files["ckpts"],
            "--seed", "7"]
    jpipe = pipes["edge" if mode == "edge_to_image" else "sketch"][0]
    jax_cli = _jax_cli("inference_paired")
    seen = []

    def loaded(sd_turbo_dir, ckpt_path, stochastic=False, **kw):
        seen.append((sd_turbo_dir, ckpt_path, stochastic))
        return jpipe
    monkeypatch.setattr(jp2p.Pix2PixTurbo, "from_pretrained", loaded)
    jax_cli.main(jax_cli.build_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "jax")]))
    assert seen == [(files[snap], os.path.join(files["ckpts"], os.path.basename(
        files["edge" if mode == "edge_to_image" else "sketch"])),
        mode != "edge_to_image")]

    # the JAX CLI draws its noise map and posterior noise from one key
    noise = _noise(jax.random.PRNGKey(7))
    _with_noise(monkeypatch, tp2p.Pix2PixTurbo, noise,
                noise if mode != "edge_to_image" else None)
    out = tip.main(tip.build_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "port")]), device="cpu",
        cfgs=CFGS)
    assert out["output"] == str(tmp_path / "port" / "in.png")
    got = _png_agrees(out["output"], str(tmp_path / "jax" / "in.png"))
    assert got.shape == (H, W, 3)


def test_inference_unpaired_cli_matches_jax(pipes, files, tmp_path,
                                            monkeypatch):
    """--model_path with --prompt and --direction a2b, --image_prep
    no_resize on a 64x40 image (the output is resized back to the input
    size)."""
    inp = str(tmp_path / "in.png")
    Image.fromarray(_synth(H, W, 51)).save(inp)
    argv = ["--input_image", inp, "--prompt", CAPTION, "--model_path",
            files["cyclegan"], "--direction", "a2b", "--image_prep",
            "no_resize", "--sd_turbo_path", files["modern"]]
    jpipe = pipes["cyclegan"][0]
    jax_cli = _jax_cli("inference_unpaired")

    def loaded(sd_turbo_dir, ckpt_path, caption=None, direction=None, **kw):
        assert (sd_turbo_dir, ckpt_path) == (files["modern"],
                                             files["cyclegan"])
        jpipe.caption, jpipe.direction = caption, direction
        return jpipe
    monkeypatch.setattr(jcg.CycleGANTurbo, "from_pretrained", loaded)
    jax_cli.main(jax_cli.build_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "jax")]))

    _with_noise(monkeypatch, tcg.CycleGANTurbo,
                _noise(jax.random.PRNGKey(0)))
    out = tiu.main(tiu.build_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "port")]), device="cpu",
        cfgs=CFGS)
    got = _png_agrees(out["output"], str(tmp_path / "jax" / "in.png"))
    assert got.shape == (H, W, 3)


def test_inference_cli_own_noise_is_seeded(files, tmp_path):
    """Without a stand-in the port CLI draws from its torch.Generator: the
    same --seed gives the same PNG, another seed another one."""
    inp = str(tmp_path / "in.png")
    Image.fromarray(_synth(45, 67, 52)).save(inp)
    outs = []
    for seed, d in (("1", "a"), ("1", "b"), ("2", "c")):
        out = tip.main(tip.build_parser().parse_args(
            ["--input_image", inp, "--prompt", PROMPT, "--model_name",
             "sketch_to_image_stochastic", "--sd_turbo_path",
             files["modern"], "--ckpt_folder", files["ckpts"], "--seed",
             seed, "--output_dir", str(tmp_path / d)]), device="cpu",
            cfgs=CFGS)
        outs.append(np.asarray(Image.open(out["output"])))
    assert outs[0].shape == (H, W, 3)
    assert np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# the demos and convert_weights, on the JAX pipelines above (compiled once)
# ---------------------------------------------------------------------------


def _agree(got, want):
    """1 uint8 level on at most 0.1% of the values, as `_png_agrees`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_LEVELS, diff.max()
    assert (diff > 0).mean() <= MAX_FRACTION, (diff > 0).mean()
    assert want.std() > 0


def _image(seed=60):
    return Image.fromarray(_synth(H, W, seed))


def test_canny_demo_matches_jax(pipes, monkeypatch):
    jpipe, tpipe = pipes["edge"]
    img = _image()
    want_edges, want = jdemo.CannyDemo(jpipe).process(img, PROMPT, 100, 200)
    _with_noise(monkeypatch, tp2p.Pix2PixTurbo,
                _noise(jax.random.PRNGKey(0)))
    edges, got = tdemo.CannyDemo(tpipe).process(img, PROMPT, 100, 200)
    np.testing.assert_array_equal(np.asarray(edges), np.asarray(want_edges))
    _agree(got, want)


def test_sketch_demo_matches_jax(pipes, monkeypatch):
    """The JAX demo draws its noise map and posterior noise from one key."""
    jpipe, tpipe = pipes["sketch"]
    img = _image(61)
    want = jdemo.SketchDemo(jpipe).run(img, PROMPT, "Anime", 7, 0.4)
    nz = _noise(jax.random.PRNGKey(7))
    _with_noise(monkeypatch, tp2p.Pix2PixTurbo, nz, nz)
    got = tdemo.SketchDemo(tpipe).run(img, PROMPT, "Anime", 7, 0.4)
    _agree(got, want)


def _payload(out):
    return ti.load_safetensors(os.path.join(out, native.FILE))


def _part(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


@pytest.mark.parametrize("model", ["edge", "sketch"])
def test_convert_weights_payload_equals_jax(pipes, files, tmp_path, model):
    """The payload against JAX's `from_pretrained` on the same files
    (through from_jax's inverse converters): `text`, and `base` + `lora`
    bit for bit; the merged `params` within relative L2 1e-6. Read back
    by `Pix2PixTurbo.from_native` and `ServingEngine.from_native`, the
    weights and an image equal the pipeline `from_pretrained` builds."""
    jpipe, tpipe = pipes[model]
    out = str(tmp_path / "native")
    snap = files["legacy" if model == "edge" else "modern"]
    argv = ["--sd_turbo_path", snap, "--ckpt_path", files[model], "--out",
            out] + (["--stochastic"] if model == "sketch" else [])
    res = convert_weights.main(argv, device="cpu", cfgs=CFGS)
    assert res["path"] == os.path.join(out, native.FILE)
    assert os.path.isfile(os.path.join(out, "tokenizer", "vocab.json"))
    sd = _payload(out)
    want = from_jax.clip_text_state_dict(jpipe.text_params)
    got = _part(sd, "text.")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    if model == "edge":
        assert not any(k.startswith(("base.", "lora.")) for k in sd)
        for m, conv in (("unet", from_jax.unet_state_dict),
                        ("vae", from_jax.vae_state_dict)):
            want, got = conv(jpipe.params[m]), _part(sd, f"params.{m}.")
            assert set(got) == set(want)
            for k, v in want.items():
                assert rel_l2(got[k], v) <= W_REL, (m, k)
    else:
        assert not any(k.startswith("params.") for k in sd)
        for m, conv in (("unet", from_jax.unet_state_dict),
                        ("vae", from_jax.vae_state_dict)):
            want, got = conv(jpipe.base[m]), _part(sd, f"base.{m}.")
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                              f"{m}.{k}")
            lora = _part(sd, f"lora.{m}.")
            for n, e in jpipe.lora[m]["modules"].items():
                for ab in ("a", "b"):
                    np.testing.assert_array_equal(
                        lora[f"{n}.{ab}"].numpy(), np.asarray(e[ab]))

    back = tp2p.Pix2PixTurbo.from_native(out, cfgs=CFGS, dtype=torch.float32,
                                         device="cpu")
    group = "params" if model == "edge" else "base"
    for m in ("unet", "vae"):
        a = getattr(back, group)[m].state_dict()
        for k, v in getattr(tpipe, group)[m].state_dict().items():
            assert torch.equal(a[k], v), (m, k)
    assert back.tokenizer(PROMPT).tolist() == tpipe.tokenizer(PROMPT).tolist()
    x = torch.from_numpy(_synth(H, W, 63))[None]
    caption = tpipe.encode_prompt(PROMPT)
    if model == "edge":
        engines = [ServingEngine.from_native(out, cfgs=CFGS,
                                             dtype=torch.float32,
                                             device="cpu"),
                   ServingEngine(tpipe.params, CFGS, dtype=torch.float32,
                                 device="cpu")]
    else:
        assert back.lora["unet"]["rank"] == tpipe.lora["unet"]["rank"]
        engines = [ServingEngine.from_native(out, cfgs=CFGS,
                                             dtype=torch.float32,
                                             device="cpu"),
                   ServingEngine(cfgs=CFGS, mode="sketch", base=tpipe.base,
                                 lora=tpipe.lora, dtype=torch.float32,
                                 device="cpu")]
    a, b = (e(x, caption, torch.Generator().manual_seed(1)) for e in engines)
    assert torch.equal(a, b)
