"""The port's training CLIs and what they are built from, on the CPU:

- both argument parsers equal to the JAX package's (`vars` of the
  Namespace) on the defaults and on a full argv;
- `runner.generator_configs` and `clip_config` equal to JAX's for SD-Turbo
  and --tiny_model; `SmokeTokenizer` equal to JAX's;
- both reference-schema pkl exports key for key and tensor for tensor
  equal to the JAX package's exporters (`Pix2PixTurbo.save_model`,
  `checkpoint.export_cyclegan_pkl`), on MICRO weights drawn by the port
  and converted by the JAX package's `torch_import`, with random LoRA B
  factors, conv_in and skip convs so that no tensor is its init;
- each CLI end to end at --tiny_model on 64x64 `no_resize` images, from a
  snapshot written in the HF layout (`--sd_turbo_path`): one step with a
  checkpoint, eval or validation and a viz panel, then a --resume run to
  step 2 that starts from the restored state: the JAX CLIs' files and
  metric keys; the run's UNet and VAE are the file's, its prompts go
  through the snapshot's BPE tokenizer. The two runs of each CLI are
  module fixtures, shared by the tests that check them;
- every weight flag reaches its loader (a missing file stops the run
  before any step); --tensor_parallel > 1 (not ported) and a non-bf16
  activation dtype on a CUDA device stop a run with a message, as does a
  run with no CUDA device that did not ask for the CPU; none of these
  needs a card;
- a wandb init that fails and keeps its exception does not keep the
  run's models alive after `main` returns (the pix2pix runs' first run);
- `unpaired.make_state` takes `max_grad_norm` (the unpaired CLI forwards
  it) and clips at the unpaired trainer's 10.0 by default.

The CLIs' FID runs the port's Inception at 299x299 on every image; the
Fréchet distance itself is a recording stand-in here (scipy's sqrtm of a
2048x2048 matrix costs tens of seconds of CPU time; its math is held
against JAX in test_torch_metrics.py).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch
from PIL import Image

from img2img_turbo_tpu import configs as jcfg
from img2img_turbo_tpu import lora as jlora
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.training import checkpoint as jckpt
from img2img_turbo_tpu.training import runner as jrunner
from img2img_turbo_tpu.training import unpaired as junpaired
from img2img_turbo_tpu.utils import config_args as jargs
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tcfg
from img2img_turbo_tpu_torch.cli import (train_cyclegan_turbo,
                                         train_pix2pix_turbo)
from img2img_turbo_tpu_torch.metrics import fid as tfid
from img2img_turbo_tpu_torch.models import clip_vit as tclip_vit
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.training import checkpoint as tckpt
from img2img_turbo_tpu_torch.training import optim as toptim
from img2img_turbo_tpu_torch.training import runner as trunner
from img2img_turbo_tpu_torch.training import unpaired as tunpaired
from img2img_turbo_tpu_torch.utils import config_args as targs

torch.set_num_threads(2)

HWIO = (2, 3, 1, 0)

PAIRED_FULL = [
    "--gan_disc_type", "vagan_clip", "--gan_loss_type", "multilevel_sigmoid",
    "--lambda_gan", "0.7", "--lambda_lpips", "3", "--lambda_l2", "2",
    "--lambda_clipsim", "0", "--dataset_folder", "d", "--train_image_prep",
    "no_resize", "--test_image_prep", "resize_256", "--eval_freq", "7",
    "--track_val_fid", "--num_samples_eval", "3", "--viz_freq", "5",
    "--tracker_project_name", "p", "--pretrained_model_name_or_path", "x",
    "--revision", "r", "--variant", "v", "--tokenizer_name", "t",
    "--lora_rank_unet", "16", "--lora_rank_vae", "8", "--output_dir", "o",
    "--cache_dir", "c", "--seed", "3", "--resolution", "256",
    "--train_batch_size", "2", "--num_training_epochs", "4",
    "--max_train_steps", "9", "--checkpointing_steps", "3",
    "--dataloader_num_workers", "1", "--max_grad_norm", "2.5",
    "--mixed_precision", "bf16", "--set_grads_to_none"]
UNPAIRED_FULL = [
    "--seed", "5", "--gan_disc_type", "vagan_clip", "--gan_loss_type",
    "multilevel_sigmoid_s", "--lambda_gan", "0.4", "--lambda_idt", "2",
    "--lambda_cycle", "3", "--lambda_cycle_lpips", "4",
    "--lambda_idt_lpips", "5", "--dataset_folder", "d", "--train_img_prep",
    "no_resize", "--val_img_prep", "resize_256", "--dataloader_num_workers",
    "2", "--train_batch_size", "3", "--max_train_epochs", "6",
    "--max_train_steps", "7", "--pretrained_model_name_or_path", "x",
    "--revision", "r", "--variant", "v", "--lora_rank_unet", "32",
    "--lora_rank_vae", "2", "--viz_freq", "3", "--output_dir", "o",
    "--tracker_project_name", "p", "--validation_steps", "4",
    "--validation_num_images", "5", "--checkpointing_steps", "6",
    "--max_grad_norm", "3.5"]
COMMON_FULL = [
    "--learning_rate", "1e-4", "--adam_beta1", "0.8", "--adam_beta2", "0.99",
    "--adam_weight_decay", "0.1", "--adam_epsilon", "1e-6",
    "--lr_scheduler", "cosine", "--lr_warmup_steps", "3",
    "--lr_num_cycles", "2", "--lr_power", "2", "--gradient_accumulation_steps",
    "2", "--allow_tf32", "--gradient_checkpointing",
    "--enable_xformers_memory_efficient_attention", "--report_to", "none",
    "--sd_turbo_path", "s", "--resume", "--tensor_parallel", "2",
    "--tiny_model", "--lpips_weights", "l", "--clip_weights", "c",
    "--inception_weights", "i"]


@pytest.mark.parametrize("which,argv", [
    ("paired", ["--dataset_folder", "d", "--output_dir", "o"]),
    ("paired", PAIRED_FULL + COMMON_FULL),
    ("unpaired", ["--dataset_folder", "d", "--output_dir", "o",
                  "--train_img_prep", "a", "--val_img_prep", "b",
                  "--tracker_project_name", "p"]),
    ("unpaired", UNPAIRED_FULL + COMMON_FULL)],
    ids=["paired-defaults", "paired-full", "unpaired-defaults",
         "unpaired-full"])
def test_parser_equals_jax(which, argv):
    name = f"parse_args_{which}_training"
    assert vars(getattr(targs, name)(argv)) == \
        vars(getattr(jargs, name)(argv))


@pytest.mark.parametrize("tiny", [False, True])
def test_run_configs_equal_jax(tiny):
    class Args:
        tiny_model = tiny
    got, want = trunner.generator_configs(Args), jrunner.generator_configs(
        Args)
    for part in ("unet", "vae", "text"):
        assert dataclasses.asdict(getattr(got, part)) == \
            dataclasses.asdict(getattr(want, part)), part
    assert dataclasses.asdict(trunner.clip_config(Args)) == \
        dataclasses.asdict(jrunner.clip_config(Args))


def test_smoke_tokenizer_equals_jax():
    for text in ("a red bird on a branch", "", ["two", "words"],
                 " ".join(["w"] * 90)):
        for vocab in (1000, 49408):
            np.testing.assert_array_equal(
                trunner.SmokeTokenizer(vocab)(text),
                jrunner.SmokeTokenizer(vocab)(text))


# ---------------------------------------------------------------------------
# reference-schema pkl exports
# ---------------------------------------------------------------------------


def _sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _randomize(gen, seed):
    """Random LoRA B factors, conv_in and skip convs (at init B = 0 and the
    skip convs are a constant)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, v in gen.items():
            if k.endswith(".b") or ":conv_in." in k or "skip_conv" in k:
                v.copy_(torch.randn(v.shape, generator=g) * 0.05)


def _lora_jax(gen, part):
    modules = {}
    for k, v in gen.items():
        if k.startswith(part + ":"):
            name, ab = k[len(part) + 1:].rsplit(".", 1)
            modules.setdefault(name, {})[ab] = v.detach().numpy().copy()
    return modules


def _unet_jax(unet, gen):
    sd = {**_sd(unet), **{k[5:]: v.detach().numpy().copy()
                          for k, v in gen.items() if k.startswith("unet:")}}
    return ti.convert_unet_state_dict(sd, jcfg.MICRO_UNET)


def _vae_jax(vae, gen, part):
    # the converter's skip-conv list assumes SD-Turbo's four levels
    tree = ti.convert_vae_state_dict(_sd(vae), jcfg.MICRO_VAE,
                                     with_skip_convs=False)
    tree["decoder"]["skip_convs"] = [
        {"kernel": jnp.asarray(gen[f"{part}:decoder.skip_conv_{i + 1}.weight"]
                               .detach().numpy().transpose(HWIO))}
        for i in range(jcfg.MICRO_VAE.num_levels)]
    return tree


def _assert_pkl_equal(got_path, want_path):
    got = torch.load(got_path, weights_only=True)
    want = torch.load(want_path, weights_only=True)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            assert set(g) == set(w), (key, sorted(set(g) ^ set(w))[:8])
            for k, t in w.items():
                assert g[k].dtype == t.dtype and g[k].shape == t.shape, k
                assert torch.equal(g[k], t), k
        else:
            assert g == w, key


MICRO = GeneratorConfigs(tcfg.MICRO_UNET, tcfg.MICRO_VAE, tcfg.TINY_TEXT)


def test_pix2pix_pkl_equals_jax_export(tmp_path):
    models, state, meta = trunner.build_paired_run(
        MICRO, tclip_vit.TINY_CLIP_VIT, seed=1, device="cpu",
        with_clipsim=False)
    assert models.clip is None
    _randomize(state.gen, 2)
    gen = state.gen
    unet_tree = _unet_jax(models.unet, gen)
    vae_tree = _vae_jax(models.vae, gen, "vae")
    pipe = jp2p.Pix2PixTurbo(
        base={"unet": unet_tree, "vae": vae_tree},
        lora={"unet": {"rank": meta.rank_unet, "alpha": meta.alpha_unet,
                       "modules": _lora_jax(gen, "unet_lora")},
              "vae": {"rank": meta.rank_vae, "alpha": meta.alpha_vae,
                      "modules": _lora_jax(gen, "vae_lora")}})
    pipe.save_model(str(tmp_path / "jax.pkl"))
    tckpt.export_pix2pix_pkl(str(tmp_path / "port.pkl"), gen, meta)
    _assert_pkl_equal(tmp_path / "port.pkl", tmp_path / "jax.pkl")


def test_cyclegan_pkl_equals_jax_export(tmp_path):
    models, state, meta = trunner.build_unpaired_run(
        MICRO, tclip_vit.TINY_CLIP_VIT, seed=3, device="cpu", rank_unet=8,
        rank_vae=2)
    assert (meta.rank_unet, meta.rank_vae) == (8, 2)
    _randomize(state.gen, 4)
    gen = state.gen
    adapters = {a: {"rank": meta.rank_unet, "alpha": float(meta.rank_unet),
                    "modules": _lora_jax(gen, f"unet_lora:{a}")}
                for a in ("default_encoder", "default_decoder",
                          "default_others")}
    vae_loras = [{"rank": meta.rank_vae, "alpha": meta.alpha_vae,
                  "modules": _lora_jax(gen, f"{v}_lora")}
                 for v in ("vae_a2b", "vae_b2a")]
    jgen, frozen, jmeta = junpaired.split_trainable(
        _unet_jax(models.unet, gen),
        _vae_jax(models.vae_a2b, gen, "vae_a2b"),
        _vae_jax(models.vae_b2a, gen, "vae_b2a"), adapters, *vae_loras)
    jckpt.export_cyclegan_pkl(
        str(tmp_path / "jax.pkl"), jgen, jmeta,
        {k: sorted(v["modules"]) for k, v in adapters.items()},
        jlora.CYCLEGAN_VAE_TARGETS, frozen)
    tckpt.export_cyclegan_pkl(
        str(tmp_path / "port.pkl"), gen,
        {"vae_a2b": models.vae_a2b, "vae_b2a": models.vae_b2a}, meta)
    _assert_pkl_equal(tmp_path / "port.pkl", tmp_path / "jax.pkl")


# ---------------------------------------------------------------------------
# the CLIs end to end
# ---------------------------------------------------------------------------


def _img(path, seed):
    Image.fromarray((np.random.RandomState(seed).rand(64, 64, 3) * 255)
                    .astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    paired, unpaired = root / "paired", root / "unpaired"
    seed = 0
    for split in ("train", "test"):
        prompts = {}
        for d in ("A", "B"):
            for folder in (paired, unpaired):
                (folder / f"{split}_{d}").mkdir(parents=True)
        for i in range(2):
            for d in ("A", "B"):
                seed += 1
                _img(paired / f"{split}_{d}" / f"{i}.png", seed)
                seed += 1
                _img(unpaired / f"{split}_{d}" / f"{i}.png", seed)
            prompts[f"{i}.png"] = f"a small red bird {i}"
        (paired / f"{split}_prompts.json").write_text(json.dumps(prompts))
    (unpaired / "fixed_prompt_a.txt").write_text("a horse")
    (unpaired / "fixed_prompt_b.txt").write_text("a zebra")
    return str(paired), str(unpaired)


def _fid_stub(calls):
    """The Fréchet distance as a recording stand-in (module docstring)."""
    def distance(mu1, s1, mu2, s2):
        calls.append((mu1.shape, s1.shape, mu2.shape, s2.shape))
        return float(np.sum((mu1 - mu2) ** 2))
    return distance


def _rows(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        assert all(np.isfinite(v) for v in row.values()), row
    return rows


def _resumed_from(out_dir, restored, first, last):
    """The resumed run restored checkpoint `first` and saved `last`."""
    saved = torch.load(os.path.join(out_dir, "state", f"{first}.pt"),
                       weights_only=True)
    (gen,) = restored
    assert set(gen) == set(saved["gen"])
    for k, v in saved["gen"].items():
        assert torch.equal(gen[k], v), k
    final = torch.load(os.path.join(out_dir, "state", f"{last}.pt"),
                       weights_only=True)
    assert final["step"] == last
    assert any(not torch.equal(final["gen"][k], v)
               for k, v in saved["gen"].items())


@pytest.fixture(scope="module")
def tiny_snapshot(tmp_path_factory):
    """A --tiny_model SD-Turbo snapshot in the HF layout (random weights,
    the VAE without skip convs) with a BPE tokenizer, and what it holds."""
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    from img2img_turbo_tpu_torch.models.tokenizer import bytes_to_unicode
    from img2img_turbo_tpu_torch.weights import from_jax
    from img2img_turbo_tpu_torch.weights import torch_import as tti
    root = str(tmp_path_factory.mktemp("snapshot"))
    g = torch.Generator().manual_seed(60)
    sds = {"unet": from_jax.random_params(tcfg.TINY_UNET, g),
           "vae": {k: v for k, v in from_jax.random_params(
               tcfg.TINY_VAE, g).items() if "skip_conv" not in k},
           "text": {"text_model." + k: v for k, v in trunner.random_init(
               lambda: CLIPTextModel(tcfg.TINY_TEXT), g).state_dict().items()}}
    for part, sd in sds.items():
        path = os.path.join(root, tti.SNAPSHOT_FILES[part])
        os.makedirs(os.path.dirname(path))
        tti.save_safetensors(sd, path)
    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    merges = [("r", "e"), ("re", "d</w>"), ("h", "o"), ("ho", "r")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    tok = os.path.join(root, "tokenizer")
    os.makedirs(tok)
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return root, sds


def _cli_runs(cli, datasets, tiny_snapshot, out, first, second,
              report_to="none"):
    """Each CLI's two runs, shared by the tests of this module that check
    them: from the tiny snapshot (--sd_turbo_path), a first run with
    `first`'s flags, then a --resume run with `second`'s. Recorded on the
    way: the Fréchet distance's calls (a stand-in), the state each restore
    left, the tokenizers the datasets were given, the frozen weights the
    run built (copies) and a weak reference to its UNet, a wandb stand-in
    whose init fails and keeps its exception."""
    import sys
    import types
    import weakref
    from img2img_turbo_tpu_torch.training import data as tdata
    rec = {"fid_calls": [], "restored": [], "tokenizers": [], "built": [],
           "weights": [], "wandb_kept": []}
    main, parse = _mains(cli)
    build_name = f"build_{'' if cli == 'pix2pix' else 'un'}paired_run"
    real_build = getattr(trunner, build_name)
    dataset_cls = "PairedDataset" if cli == "pix2pix" else "UnpairedDataset"
    real_ds = getattr(tdata, dataset_cls)
    real_restore = tckpt.restore_train_state

    def build(*args, **kw):
        models, *rest = real_build(*args, **kw)
        vaes = ([models.vae] if cli == "pix2pix"
                else [models.vae_a2b, models.vae_b2a])
        rec["weights"].append([{k: v.detach().clone() for k, v in
                                m.state_dict().items()}
                               for m in [models.unet] + vaes])
        rec["built"].append(weakref.ref(models.unet))
        return (models, *rest)

    def dataset(*args, **kw):
        rec["tokenizers"].append(type(args[3]).__name__)
        return real_ds(*args, **kw)

    def restore(directory, state, step=None, mesh=None):
        state = real_restore(directory, state, step, mesh)
        rec["restored"].append({k: v.detach().clone()
                                for k, v in state.gen.items()})
        return state

    def init(**kwargs):
        try:
            raise RuntimeError("No API key configured")
        except RuntimeError:
            rec["wandb_kept"].append(sys.exc_info())
            raise

    common = ["--dataset_folder", datasets[0 if cli == "pix2pix" else 1],
              "--output_dir", out, "--tiny_model", "--sd_turbo_path",
              tiny_snapshot[0], "--train_batch_size", "1",
              "--checkpointing_steps", "1"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfid, "frechet_distance", _fid_stub(rec["fid_calls"]))
        mp.setattr(trunner, build_name, build)
        mp.setattr(tdata, dataset_cls, dataset)
        mp.setattr(tckpt, "restore_train_state", restore)
        mp.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
        rec["results"] = [main(parse(common + ["--report_to", report_to]
                                     + first), device="cpu")]
        rec["first_rows"] = _rows(out)
        rec["first_state"] = sorted(os.listdir(os.path.join(out, "state")))
        rec["results"].append(main(parse(common + ["--report_to", "none"]
                                         + second), device="cpu"))
    return rec


def _mains(cli):
    if cli == "pix2pix":
        return (train_pix2pix_turbo.main,
                targs.parse_args_paired_training)
    return (train_cyclegan_turbo.main, targs.parse_args_unpaired_training)


@pytest.fixture(scope="module")
def pix2pix_runs(datasets, tiny_snapshot, tmp_path_factory):
    """One step with a checkpoint, eval (FID), a viz panel and a wandb
    tracker whose init fails, then a --resume run to step 2."""
    out = str(tmp_path_factory.mktemp("pix2pix") / "out")
    prep = ["--train_image_prep", "no_resize", "--test_image_prep",
            "no_resize"]
    rec = _cli_runs("pix2pix", datasets, tiny_snapshot, out,
                    prep + ["--max_train_steps", "1", "--eval_freq", "1",
                            "--viz_freq", "1", "--num_samples_eval", "2",
                            "--track_val_fid"],
                    prep + ["--max_train_steps", "2", "--eval_freq", "100",
                            "--viz_freq", "100", "--resume"],
                    report_to="wandb")
    return dict(rec, out=out)


@pytest.fixture(scope="module")
def cyclegan_runs(datasets, tiny_snapshot, tmp_path_factory):
    """One step with a checkpoint, validation and a viz panel, then a
    --resume run to step 2."""
    out = str(tmp_path_factory.mktemp("cyclegan") / "out")
    prep = ["--train_img_prep", "no_resize", "--val_img_prep", "no_resize",
            "--tracker_project_name", "t", "--lora_rank_unet", "8"]
    rec = _cli_runs("cyclegan", datasets, tiny_snapshot, out,
                    prep + ["--max_train_steps", "1", "--validation_steps",
                            "1", "--viz_freq", "1"],
                    prep + ["--max_train_steps", "2", "--validation_steps",
                            "100", "--viz_freq", "100", "--resume"])
    return dict(rec, out=out)


def test_pix2pix_cli_trains_evaluates_and_resumes(pix2pix_runs):
    run = pix2pix_runs
    out, res = run["out"], run["results"]
    assert res[0] == {"start_step": 0, "end_step": 1, "steps_run": 1,
                      "eval_seconds": res[0]["eval_seconds"]}
    assert run["fid_calls"] == [((2048,), (2048, 2048), (2048,),
                                 (2048, 2048))]
    rows = run["first_rows"]
    assert [r["step"] for r in rows] == [1, 1]
    assert set(rows[0]) == {"loss_l2", "loss_lpips", "loss_clipsim",
                            "loss_gan_g", "loss_d_real", "loss_d_fake",
                            "steps_per_sec", "step", "time"}
    assert set(rows[1]) == {"val_l2", "val_lpips", "val_clipsim", "val_fid",
                            "step", "time"}
    assert run["first_state"] == ["1.pt"]
    for step in (1, 2):
        pkl = torch.load(os.path.join(out, "checkpoints",
                                      f"model_{step}.pkl"), weights_only=True)
        assert set(pkl) == {"unet_lora_target_modules",
                            "vae_lora_target_modules", "rank_unet",
                            "rank_vae", "state_dict_unet", "state_dict_vae"}
        assert (pkl["rank_unet"], pkl["rank_vae"]) == (8, 4)
    assert Image.open(os.path.join(out, "viz", "step_1.png")).size == \
        (3 * 64, 64)

    assert (res[1]["start_step"], res[1]["end_step"],
            res[1]["steps_run"]) == (1, 2, 1)
    _resumed_from(out, run["restored"], 1, 2)
    assert [r["step"] for r in _rows(out)] == [1, 1, 2]
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "model_1.pkl", "model_2.pkl"]


def test_cyclegan_cli_trains_validates_and_resumes(cyclegan_runs):
    run = cyclegan_runs
    out, res = run["out"], run["results"]
    assert (res[0]["start_step"], res[0]["end_step"],
            res[0]["steps_run"]) == (0, 1, 1)
    assert len(run["fid_calls"]) == 2
    rows = run["first_rows"]
    assert [r["step"] for r in rows] == [1, 1]
    assert set(rows[0]) == {"cycle_a", "cycle_b", "gan_a", "gan_b", "idt_a",
                            "idt_b", "disc_fake", "disc_real",
                            "steps_per_sec", "step", "time"}
    assert set(rows[1]) == {"fid_a2b", "dino_struct_a2b", "fid_b2a",
                            "dino_struct_b2a", "step", "time"}
    for tag in ("a2b", "b2a"):
        assert sorted(os.listdir(os.path.join(out, f"fid_reference_{tag}"))) \
            == ["0.png", "1.png"]
        assert sorted(os.listdir(os.path.join(out, "fid-1",
                                              f"samples_{tag}"))) == \
            ["0.png", "1.png"]
    pkl = torch.load(os.path.join(out, "checkpoints", "model_1.pkl"),
                     weights_only=True)
    assert pkl["rank_unet"] == 8 and pkl["sd_vae_enc"] is not None
    assert any(k.startswith("vae_b2a.") for k in pkl["sd_vae_dec"])
    assert Image.open(os.path.join(out, "viz", "step_1.png")).size == \
        (3 * 64, 2 * 64)

    assert (res[1]["start_step"], res[1]["end_step"],
            res[1]["steps_run"]) == (1, 2, 1)
    _resumed_from(out, run["restored"], 1, 2)
    assert [r["step"] for r in _rows(out)] == [1, 1, 2]


@pytest.mark.parametrize("cli", ["pix2pix", "cyclegan"])
def test_cli_trains_from_a_snapshot(cli, request, tiny_snapshot):
    """--sd_turbo_path: the run's UNet and VAE are the snapshot's (skip
    convs at 1e-5), its prompts go through the snapshot's BPE tokenizer
    (the first run of each CLI's shared runs)."""
    run = request.getfixturevalue(f"{cli}_runs")
    _, sds = tiny_snapshot
    assert run["results"][0]["steps_run"] == 1
    assert run["tokenizers"] and \
        set(run["tokenizers"]) == {"CLIPTokenizer"}
    unet, *vaes = run["weights"][0]
    assert len(vaes) == (1 if cli == "pix2pix" else 2)
    for got, want in [(unet, sds["unet"])] + [(v, sds["vae"]) for v in vaes]:
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    for v in vaes:
        for i in range(1, 5):
            assert (v[f"decoder.skip_conv_{i}.weight"] == 1e-5).all()


def test_failed_wandb_init_does_not_hold_the_run(pix2pix_runs):
    """wandb keeps the exception of an init that fails (no API key) with
    its traceback; the run's models must still be freed when `main`
    returns (the shared pix2pix runs' first run tracks to a stand-in wandb
    that keeps the exception as wandb's early logger does)."""
    import gc
    gc.collect()
    assert len(pix2pix_runs["wandb_kept"]) == 1
    assert len(pix2pix_runs["built"]) == 2
    assert all(ref() is None for ref in pix2pix_runs["built"])


# ---------------------------------------------------------------------------
# what stops a run
# ---------------------------------------------------------------------------


def _args(which, extra=()):
    if which == "pix2pix":
        return train_pix2pix_turbo.main, targs.parse_args_paired_training(
            ["--dataset_folder", "missing", "--output_dir", "missing",
             *extra])
    return train_cyclegan_turbo.main, targs.parse_args_unpaired_training(
        ["--dataset_folder", "missing", "--output_dir", "missing",
         "--train_img_prep", "no_resize", "--val_img_prep", "no_resize",
         "--tracker_project_name", "t", *extra])


@pytest.mark.parametrize("cli", ["pix2pix", "cyclegan"])
@pytest.mark.parametrize("flag", ["--sd_turbo_path", "--lpips_weights",
                                  "--clip_weights", "--inception_weights"])
def test_weight_flags_stop_the_run(cli, flag, datasets, tmp_path):
    """Each weight flag reaches its loader: naming a file that is not there
    stops the run, before any step, with FileNotFoundError naming it."""
    missing = str(tmp_path / "weights.bin")
    main, args = _args(cli, [
        "--dataset_folder", datasets[0 if cli == "pix2pix" else 1],
        "--output_dir", str(tmp_path / "out"), "--tiny_model",
        "--report_to", "none", flag, missing]
        + (["--track_val_fid"] if cli == "pix2pix" else []))
    with pytest.raises(FileNotFoundError, match="weights.bin"):
        main(args, device="cpu")
    assert not os.path.exists(str(tmp_path / "out" / "metrics.jsonl"))


@pytest.mark.parametrize("cli", ["pix2pix", "cyclegan"])
def test_tensor_parallel_stops_the_run(cli, tmp_path):
    """--tensor_parallel 2 in one process stops the run before it writes:
    a model axis needs ranks that it divides (the CLIs under two ranks
    with --tensor_parallel 2: tests/test_torch_parallel.py)."""
    main, args = _args(cli, ["--tensor_parallel", "2", "--output_dir",
                             str(tmp_path / "out")])
    with pytest.raises(ValueError, match="model axis needs a divisor"):
        main(args, device="cpu")
    assert not os.path.exists(str(tmp_path / "out"))


@pytest.mark.parametrize("precision", [None, "no", "fp16"])
def test_non_bf16_on_cuda_stops_the_run(precision):
    """Checked before anything reaches the device, so no card is needed."""
    extra = [] if precision is None else ["--mixed_precision", precision]
    main, args = _args("pix2pix", extra)
    with pytest.raises(ValueError, match="bf16 activations only"):
        main(args, device="cuda")
    assert trunner.activation_dtype(precision, "cpu") == torch.float32
    assert trunner.activation_dtype("bf16", "cuda") == torch.bfloat16
    assert trunner.activation_dtype("bf16", "cpu") == torch.bfloat16


@pytest.mark.parametrize("cli", ["pix2pix", "cyclegan"])
def test_no_card_and_no_cpu_request_stops_the_run(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, args = _args(cli, ["--mixed_precision", "bf16"]
                       if cli == "pix2pix" else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


def test_unpaired_make_state_takes_max_grad_norm():
    gen = {"w": torch.ones(3, requires_grad=True)}
    disc = {"a:h": torch.ones(2)}
    sched = toptim.make_lr_schedule("constant", 1e-3, 0, 1)
    state = tunpaired.make_state(gen, disc, {}, sched, sched)
    assert state.gen_opt.max_grad_norm == tunpaired.MAX_GRAD_NORM == 10.0
    assert state.disc_opt.max_grad_norm == 10.0
    state = tunpaired.make_state(gen, disc, {}, sched, sched,
                                 max_grad_norm=2.5, eps=1e-6)
    assert state.gen_opt.max_grad_norm == state.disc_opt.max_grad_norm == 2.5
    assert state.gen_opt.param_groups[0]["eps"] == 1e-6
    # a gradient of norm 20 is clipped to the default 10: Adam's first
    # moment after one step is (1 - beta1) times the clipped gradient
    state = tunpaired.make_state(gen, disc, {}, sched, sched)
    gen["w"].grad = torch.full((3,), 20.0 / 3 ** 0.5)
    state.gen_opt.step()
    mu = state.gen_opt.state[gen["w"]]["mu"]
    torch.testing.assert_close(mu.norm(), torch.tensor(0.1 * 10.0))
