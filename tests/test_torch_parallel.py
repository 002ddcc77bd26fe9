"""The port's data parallelism (`parallel/mesh.py`) on the CPU, with two
gloo ranks spawned once a test process (`torch_dp.shared`), each with one
intra-op thread, as the one-process runs it is held against:

- `shard_batch` takes the rows JAX's `P(data)` places on each shard of a
  two-way data mesh (`jax.device_put` with `mesh.batch_sharding`, no
  compile); a batch that does not divide by the world size raises;
- `pmean`, `gather_batch` and `replicate` are exact (rows of fp32, bf16
  and uint8; (a + b) / 2 of exact values);
- the paired and the unpaired step at MICRO configs in fp32: tiled (every
  rank the same row and noise) bit-identical to the one-process step on
  that row, in the same process; distinct rows against the one-process
  step on the global batch of 2, metrics within rtol 2e-4, trainables and
  discriminator heads within the discipline of
  tests/test_training.py:186-205 (fewer than 1% of the state's elements
  outside rtol 1e-3 / atol 1e-5, every difference at most 2.1 lr);
  accum_steps = 2
  under DP; the state identical on every rank after two steps;
- the serving engine's `mesh=`: each rank's rows (edge_to_image and
  sketch) equal the one-process engine on those rows and noise, the
  gathered batch the same on every rank;
- both training CLIs under two ranks at a global batch of 2 (pix2pix: a
  step with a checkpoint and eval, then --resume to step 2; CycleGAN: a
  step with a checkpoint, then a --resume that restores and takes no
  step), data-parallel and with --tensor_parallel 2, against the
  one-process run of the same flags: only rank 0 writes, the output
  directory holds the same files, the metrics rows and the last pkl agree
  within the tolerances above;
- the mesh's refusals: a model axis without the ranks for it, a batch
  that does not divide.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_dp
from img2img_turbo_tpu_torch.cli import (train_cyclegan_turbo,
                                         train_pix2pix_turbo)
from img2img_turbo_tpu_torch.parallel import mesh as tmesh
from img2img_turbo_tpu_torch.utils import config_args as targs
from test_torch_cli import datasets, tiny_snapshot  # noqa: F401 (fixtures)

WORLD = 2
METRIC_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    return torch_dp.shared(WORLD)


def _mesh(rank, world=WORLD):
    return tmesh.DataMesh(rank, world, torch.device("cpu"))


def _assert_discipline(got, want, lr=torch_dp.LR, what=""):
    """tests/test_training.py:186-205: fewer than 1% of the elements outside
    rtol 1e-3 / atol 1e-5 and every difference at most 2.1 lr (Adam's
    first steps move an element whose gradient is near zero by up to lr
    either way, so a sum in another order may flip it). The fraction is
    taken over the whole state: a 128-element LoRA factor holds two such
    elements, 1.6% of it."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    n_bad = n = 0
    for k, w in want.items():
        a, r = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        n_bad += int((~np.isclose(a, r, rtol=1e-3, atol=1e-5)).sum())
        n += a.size
        assert np.abs(a - r).max() <= 2.1 * lr, (what, k,
                                                 np.abs(a - r).max())
    assert n_bad < 0.01 * n, (what, n_bad, n)


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_shard_batch_rows_equal_jax_data_shards():
    import jax
    from img2img_turbo_tpu.parallel import mesh as jmesh
    jm = jmesh.make_mesh(n_data=WORLD, n_model=1,
                         devices=jax.devices()[:WORLD])
    x = np.arange(4 * 3 * 2, dtype=np.float32).reshape(4, 3, 2)
    shards = {s.device: np.asarray(s.data) for s in jax.device_put(
        x, jmesh.batch_sharding(jm)).addressable_shards}
    for r, dev in enumerate(jm.devices[:, 0]):
        tree = {"x": x, "t": (torch.from_numpy(x), [x[:, 0]]), "n": 3}
        got = tmesh.shard_batch(tree, _mesh(r))
        np.testing.assert_array_equal(got["x"], shards[dev])
        np.testing.assert_array_equal(got["t"][0].numpy(), shards[dev])
        np.testing.assert_array_equal(got["t"][1][0], shards[dev][:, 0])
        assert got["n"] == 3
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch({"x": x[:3]}, _mesh(0))


def test_mesh_refuses_a_model_axis_and_runs_alone_without_a_group():
    """Without a process group there is one rank: a model axis of 2 has
    too few (the model axis itself: tests/test_torch_tensor_parallel.py)."""
    with pytest.raises(ValueError, match="model axis needs a divisor"):
        tmesh.make_mesh(n_model=2, device="cpu")
    assert tmesh.init_distributed(device="cpu") is True
    m = tmesh.make_mesh(device="cpu")
    assert (m.rank, m.world, m.group, m.is_main) == (0, 1, None, True)
    x = torch.arange(4.0)
    assert tmesh.pmean([x], m)[0] is x and tmesh.gather_batch(x, m) is x
    assert tmesh.choose_backend("cpu") == "gloo"


def test_pmean_gather_and_replicate_are_exact(ranks):
    out = ranks.run(torch_dp.collectives)
    for res in out:
        for k in ("f32", "bf16", "u8"):
            want = np.concatenate([o["rows"][k] for o in out])
            np.testing.assert_array_equal(res["gathered"][k], want)
        # the means of 1 + r, r and 2r over r = 0, 1, each in its dtype
        for k, want, dtype in (("a", 1.5, "float32"), ("b", 0.5, "float32"),
                               ("c", 1.0, "bfloat16")):
            v, got_dtype = res["pmean"][k]
            np.testing.assert_array_equal(v, np.full_like(v, want))
            assert got_dtype == "torch." + dtype
        assert res["pmean_stats"]["calls"] == 1
        assert res["pmean_stats"]["bytes"] == 4 * (1 + 4 + 3)
        assert res["pmean_stats"]["seconds"] > 0
        assert res["differ_before"] == ["st"] and res["differ_after"] == []
        np.testing.assert_equal(res["replicated"], out[0]["replicated"])
    np.testing.assert_array_equal(out[0]["replicated"]["w"], torch.randn(
        5, generator=torch.Generator().manual_seed(0)).numpy())


# ---------------------------------------------------------------------------
# the training steps
# ---------------------------------------------------------------------------


SCENARIOS = {
    # name, tiled, rows a rank, accum_steps, steps
    "paired": [("tiled", True, 1, 1, 1), ("distinct", False, 1, 1, 2),
               ("accum", True, 2, 2, 1)],
    "unpaired": [("tiled", True, 1, 1, 1), ("distinct", False, 1, 1, 1)]}


@pytest.fixture(scope="module")
def step_runs(ranks):
    """Each step's scenarios on the two ranks, built once a step."""
    return {kind: ranks.run(torch_dp.step_scenarios, kind, scenarios)
            for kind, scenarios in SCENARIOS.items()}


def _assert_tiled(out):
    """(g + g) / 2 = g exactly: every rank's state after the step equals
    the one-process step on the same rows bit for bit."""
    for res in out:
        assert res["ranks_differ"] == []
        assert res["metrics"] == res["one_metrics"]
        got, want = res["states"][0], res["one_state"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    np.testing.assert_equal(out[0]["states"], out[1]["states"])


@pytest.mark.parametrize("kind", ["paired", "unpaired"])
def test_dp_step_tiled_is_the_one_process_step(step_runs, kind):
    _assert_tiled([r["tiled"] for r in step_runs[kind]])


def test_dp_step_accum_steps_2_is_the_one_process_step(step_runs):
    """accum_steps = 2 under DP, two rows a rank, tiled: each rank
    accumulates its two micro-batches, then the ranks average."""
    _assert_tiled([r["accum"] for r in step_runs["paired"]])


@pytest.mark.parametrize("kind", ["paired", "unpaired"])
def test_dp_step_distinct_rows_match_the_global_batch(step_runs, kind):
    """Rank r takes row r of the global batch: the step's metrics and
    trainables against the one-process step on the whole global batch;
    the paired run's second step leaves every rank the same state too."""
    out = [r["distinct"] for r in step_runs[kind]]
    steps = 2 if kind == "paired" else 1
    for res in out:
        assert res["ranks_differ"] == []
        assert len(res["states"]) == steps
    _assert_metrics(out[0]["metrics"][0], out[0]["one_metrics"][0])
    params = {k: v for k, v in out[0]["states"][0].items()
              if k.startswith(("gen.", "disc."))}
    _assert_discipline(params, {k: out[0]["one_state"][k] for k in params},
                       what=kind)
    for i in range(steps):
        assert out[0]["metrics"][i] == out[1]["metrics"][i]
        np.testing.assert_equal(out[0]["states"][i], out[1]["states"][i])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_engine_mesh_rows_equal_one_process_calls(ranks):
    out = ranks.run(torch_dp.engine_dp)
    for mode in ("edge_to_image", "sketch"):
        for res in out:
            r = res[mode]
            np.testing.assert_array_equal(r["mine"], r["one"])
            assert r["img_equal"]
            np.testing.assert_array_equal(r["gathered"],
                                          out[0][mode]["gathered"])
            assert r["gathered"].shape == (WORLD, torch_dp.RES,
                                           torch_dp.RES, 3)


def test_engine_mesh_refuses_an_indivisible_batch():
    from img2img_turbo_tpu_torch import configs
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax
    cfgs = GeneratorConfigs(configs.MICRO_UNET, configs.MICRO_VAE,
                            configs.TINY_TEXT)
    g = torch.Generator().manual_seed(0)
    eng = ServingEngine({"unet": from_jax.random_model(cfgs.unet, g),
                         "vae": from_jax.random_model(cfgs.vae, g)}, cfgs,
                        dtype=torch.float32, device="cpu", mesh=_mesh(0))
    with pytest.raises(ValueError, match="not divisible"):
        eng.run(np.zeros((3, 16, 16, 3), np.uint8), torch.zeros(1, 77, 32))


# ---------------------------------------------------------------------------
# the training CLIs under two ranks
# ---------------------------------------------------------------------------


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _pkl_tensors(path):
    def flat(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            elif torch.is_tensor(v):
                yield prefix + k, v.numpy()
    return dict(flat(torch.load(path, weights_only=True)))


CLI_FLAGS = {
    # common flags, the first run's, the resumed run's, its last step
    "pix2pix": (
        ["--train_image_prep", "no_resize", "--test_image_prep",
         "no_resize", "--viz_freq", "100"],
        ["--eval_freq", "1", "--num_samples_eval", "1"],
        ["--eval_freq", "100"], 2),
    "cyclegan": (
        ["--train_img_prep", "no_resize", "--val_img_prep", "no_resize",
         "--tracker_project_name", "t", "--lora_rank_unet", "8",
         "--validation_steps", "100", "--viz_freq", "100"], [], [], 1),
}


@pytest.fixture(scope="module")
def cli_runs(datasets, tiny_snapshot, tmp_path_factory):
    """run(which, out) -> each CLI run's argv list for output directory
    `out`; one(which) -> (the one-process run's output directory, its
    mains' results), run once a CLI for the module. pix2pix on the paired
    dataset; cyclegan on the unpaired dataset's training half alone (no
    test sets, so no validation set-up)."""
    folders = {"pix2pix": datasets[0],
               "cyclegan": str(tmp_path_factory.mktemp("unpaired_train"))}
    for name in ("train_A", "train_B", "fixed_prompt_a.txt",
                 "fixed_prompt_b.txt"):
        src = os.path.join(datasets[1], name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(
            src, os.path.join(folders["cyclegan"], name))

    def argv(which, out, tp=1):
        common, first, second, last = CLI_FLAGS[which]
        base = ["--dataset_folder", folders[which], "--output_dir", out,
                "--tiny_model", "--report_to", "none", "--sd_turbo_path",
                tiny_snapshot[0], "--train_batch_size", "2",
                "--checkpointing_steps", "1", "--tensor_parallel",
                str(tp)] + common
        return [base + ["--max_train_steps", "1"] + first,
                base + ["--max_train_steps", str(last), "--resume"]
                + second]

    done = {}

    def one(which):
        # a resume that takes no step writes no file that the first run
        # did not, so the one-process run needs it only to step
        if which not in done:
            out = str(tmp_path_factory.mktemp(f"one_{which}"))
            main, parse = ((train_pix2pix_turbo.main,
                            targs.parse_args_paired_training)
                           if which == "pix2pix" else
                           (train_cyclegan_turbo.main,
                            targs.parse_args_unpaired_training))
            last = CLI_FLAGS[which][3]
            done[which] = (out, [main(parse(a), device="cpu")
                                 for a in argv(which, out)[
                                     :1 if last == 1 else 2]])
        return done[which]
    return argv, one


@pytest.mark.parametrize("which,tp", [
    pytest.param("pix2pix", 1, id="pix2pix"),
    pytest.param("cyclegan", 1, id="cyclegan"),
    pytest.param("pix2pix", 2, id="pix2pix-tensor_parallel_2"),
    pytest.param("cyclegan", 2, id="cyclegan-tensor_parallel_2")])
def test_training_cli_data_parallel(ranks, which, tp, cli_runs, tmp_path):
    """At a global --train_batch_size of 2, under two ranks and in one
    process: a step with a checkpoint (pix2pix: and eval, on rank 0), then
    --resume (pix2pix: to step 2; cyclegan, on the training images alone:
    at step 1, a restore that takes no step, as chip_smoke's CycleGAN run
    resumes). The two ranks are a (2, 1) mesh, or with --tensor_parallel 2
    a (1, 2) one: both take the whole batch, the UNet and the VAE(s)
    sharded over them, eval on both and rank 0 alone writing. The metrics
    rows within rtol 2e-4 and the last pkl within the discipline of
    `_assert_discipline` at the CLIs' lr 5e-6, in both cases; the CycleGAN
    pkl's VAEs whole (every `sd_vae_enc` tensor at the one-process run's
    shape, its frozen ones equal)."""
    argv, one = cli_runs
    last = CLI_FLAGS[which][3]
    dp_out = str(tmp_path / "ranks")
    ranks.submit(torch_dp.run_cli, which, argv(which, dp_out, tp))
    one_out, one_res = one(which)
    (res0, wrote0), (res1, wrote1) = ranks.collect()

    # what each rank wrote among the test's files (torch may make its own
    # cache directories elsewhere): rank 0 the run's, rank 1 nothing
    mine = [[p for p in w if p.startswith(str(tmp_path))]
            for w in (wrote0, wrote1)]
    assert mine[1] == [] and mine[0]
    assert all(p.startswith(dp_out) for p in mine[0])
    runs = [(0, 1, 1), (1, last, last - 1)]
    for res in (res0, res1, one_res):
        assert [(r["start_step"], r["end_step"], r["steps_run"])
                for r in res] == runs[:len(res)]
    assert _files(dp_out) == _files(one_out)
    got, want = _rows(dp_out), _rows(one_out)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert len(got) == (3 if which == "pix2pix" else 1)
    for g, w in zip(got, want):
        drop = ("time", "steps_per_sec", "step")
        _assert_metrics({k: v for k, v in g.items() if k not in drop},
                        {k: v for k, v in w.items() if k not in drop})
    pkl = os.path.join("checkpoints", f"model_{last}.pkl")
    got_pkl, want_pkl = (_pkl_tensors(os.path.join(out, pkl))
                         for out in (dp_out, one_out))
    if which == "cyclegan":
        # both VAEs whole in the pkl (under --tensor_parallel 2 gathered
        # from the ranks' shards): every tensor at the whole's shape, the
        # frozen ones equal to the one-process run's
        vae = [k for k in want_pkl if k.startswith("sd_vae_enc.")]
        assert vae
        for k in vae:
            assert got_pkl[k].shape == want_pkl[k].shape, k
            if "lora_" not in k and "skip_conv" not in k:
                np.testing.assert_array_equal(got_pkl[k], want_pkl[k],
                                              err_msg=k)
    _assert_discipline(got_pkl, want_pkl, lr=5e-6, what=which)
