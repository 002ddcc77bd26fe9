"""The port's model axis (`parallel/tensor.py`, the `tp` path of
`models/layers.py`, `ServingEngine(mesh=...)`) on the CPU, in fp32, with
two gloo ranks spawned once a test process (`torch_dp.shared`, one
intra-op thread each):

- the sharding rule at full SD-Turbo width, on shapes alone (a `meta`
  UNet), equals the JAX package's `param_shardings` on the 8 virtual CPU
  devices leaf for leaf at n_model = 2 and 4, after the name map and the
  transposes, except the departures of `parallel/tensor.py`, asserted
  exactly: (b) the attention layers whose heads do not divide by n_model,
  (a) the GEGLU proj's bias and (c) the sharded convs' biases, which the
  port slices with their weights;
- the same for the VAE at SD-Turbo width against JAX's rule on the
  frozen VAE tree (the skip convs popped, as `split_trainable` leaves it),
  at n_model = 2 and 4, with departures (b) (the one-head mid
  attentions whole), (c) and (e) (the skip convs whole) asserted
  exactly;
- `shard_state_dict` then `unshard_state_dict` is exact, the GEGLU proj's
  value and gate halves sliced alike, for a UNet and a VAE;
- the 2-rank (1, 2) VAE encode (posterior mean) and skip-fused decode, on
  live weights and the plain path, at MICRO and TINY, against JAX's
  `encode` / `decode` jitted with `in_shardings=param_shardings` and
  kernels off, within 1e-4 of max|ref|, both ranks equal to the whole VAE
  bit for bit;
- the 2-rank (1, 2) UNet forward, kernel and plain path, at MICRO and at a
  config with 3 heads at level 0 (kept whole) and 4 in the mid block,
  against JAX's `unet_forward` jitted with `in_shardings=param_shardings`
  and kernels off (as `__graft_entry__.py:309-316` lowers it), within 1e-4
  of max|ref|, both ranks equal;
- the engine under (1, 2) in edge_to_image and image mode against the
  one-process engine: within 1 uint8 level on at most 0.1% of values;
- `make_mesh`'s subgroups for (2, 2) and (4, 2) are JAX's grid columns
  and rows (rank arithmetic, no spawn);
- training (the steps themselves against JAX: tests/test_torch_train.py
  and tests/test_torch_unpaired.py): the one rule keeps conv_in whole,
  departure (d); each model-axis operator's
  forward and gradient on two ranks against whole-tensor autograd,
  exactly, in fp32 and bf16; a sharded ResnetBlock2D (extra bias,
  residual, 1x1 skip, stats) and Transformer2DModel (self and cross
  attention, GEGLU) at MICRO and the odd-head config, their output and
  input, context and weight gradients within 1e-5 of the whole module's,
  every kernel wrapper called as often as by the whole module (no
  fallback);
  both steps build under a (1, 2) mesh once the UNet is sharded, and the
  sketch mode still refuses one.
"""

import re

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding

import torch_dp
from img2img_turbo_tpu import configs as jconfigs
from img2img_turbo_tpu.models import unet as junet
from img2img_turbo_tpu.models import vae as jvae
from img2img_turbo_tpu.parallel import mesh as jmesh
from img2img_turbo_tpu.weights import torch_import as ti
from img2img_turbo_tpu_torch import configs as tconfigs
from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
from img2img_turbo_tpu_torch.parallel import mesh as tmesh
from img2img_turbo_tpu_torch.parallel import tensor as ttp
from img2img_turbo_tpu_torch.weights import from_jax

WORLD = 2
TOL = 1e-4          # max|err| / max|ref|, fp32
# 3 heads at level 0 (head dim 16, kept whole at n_model = 2), 4 in the mid
ODD = dict(block_out_channels=(48, 64), layers_per_block=1,
           attention_head_dim=(3, 4), cross_attention_dim=32,
           transformer_levels=(True, False), norm_num_groups=8)
CONFIGS = {"micro": (tconfigs.MICRO_UNET, jconfigs.MICRO_UNET),
           "odd_heads": (tconfigs.UNetConfig(**ODD),
                         jconfigs.UNetConfig(**ODD))}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    return torch_dp.shared(WORLD)


def _mesh(m, n, n_data=1):
    return tmesh.DataMesh(0, n_data, torch.device("cpu"), model_rank=m,
                          n_model=n)


# ---------------------------------------------------------------------------
# the rule at SD-Turbo width, on shapes
# ---------------------------------------------------------------------------


def _jax_dims(n_model, model="unet"):
    """{port name: the port dim JAX's rule shards, or None}, through a
    marker tree (2 on JAX's sharded dim, 1 elsewhere) sent through the
    port's name map and transposes; and JAX's leaf count and share of
    parameters sharded. model "vae": the frozen VAE tree of the JAX
    training steps (its skip convs popped, `split_trainable`)."""
    if model == "unet":
        shapes = jax.eval_shape(
            lambda k: junet.init_unet(k, jconfigs.SD_TURBO_UNET),
            jax.random.PRNGKey(0))
        to_port = from_jax.unet_state_dict
    else:
        shapes = jax.eval_shape(
            lambda k: jvae.init_vae(k, jconfigs.SD_TURBO_VAE),
            jax.random.PRNGKey(0))
        shapes["decoder"].pop("skip_convs")
        to_port = from_jax.vae_state_dict
    jm = jmesh.make_mesh(n_data=8 // n_model, n_model=n_model)
    specs = jax.tree_util.tree_leaves(
        jmesh.param_shardings(shapes, jm, tensor_parallel=True),
        is_leaf=lambda x: isinstance(x, NamedSharding))
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    markers, n_sharded, p_sharded = [], 0, 0
    for leaf, sh in zip(leaves, specs):
        shape = [1] * leaf.ndim
        for d, axis in enumerate(sh.spec):
            if axis is not None:
                shape[d] = 2
        if 2 in shape:
            n_sharded += 1
            p_sharded += leaf.size
        markers.append(np.zeros(shape, np.int8))
    tree = jax.tree_util.tree_unflatten(treedef, markers)
    dims = {k: (v.shape.index(2) if 2 in v.shape else None)
            for k, v in to_port(tree).items()}
    total = sum(leaf.size for leaf in leaves)
    return dims, n_sharded, p_sharded / total


def _whole_heads(n_model):
    """Departure (b) at SD-Turbo width: the attention weights of the levels
    whose 5, 10 or 20 heads do not divide by n_model."""
    levels = [("down_blocks.0", 2, 5), ("up_blocks.3", 3, 5),
              ("down_blocks.1", 2, 10), ("up_blocks.2", 3, 10)]
    return {f"{blk}.attentions.{j}.transformer_blocks.0.attn{a}.{p}.weight"
            for blk, n_layers, heads in levels if heads % n_model
            for j in range(n_layers) for a in (1, 2)
            for p in ("to_q", "to_k", "to_v", "to_out.0")}


@pytest.mark.parametrize("n_model", [2, 4])
def test_rule_equals_jax_param_shardings_at_sd_turbo_width(n_model):
    with torch.device("meta"):
        sd = UNet2DConditionModel(tconfigs.SD_TURBO_UNET).state_dict()
    got = ttp.param_shardings(sd, n_model)
    want, n_sharded, share = _jax_dims(n_model)
    assert set(got) == set(want)
    differ = {k for k in got if got[k] != want[k]}
    whole = _whole_heads(n_model)
    conv_in = {"conv_in.weight"}                    # (d)
    biases = {k for k in got if k.endswith(".bias") and (
        (len(sd[k[:-5] + ".weight"].shape) == 4
         and want[k[:-5] + ".weight"] == 0 and k[:-5] + ".weight" not in
         conv_in) or k.endswith(".ff.net.0.proj.bias"))}
    assert differ == whole | biases | conv_in
    assert all(got[k] is None and want[k] is not None
               for k in whole | conv_in)
    assert all(got[k] == 0 and want[k] is None for k in biases)
    assert len(whole) == (40 if n_model == 2 else 80)
    if n_model == 2:
        assert (n_sharded, round(share, 3)) == (226, 0.939)
        total = sum(v.numel() for v in sd.values())
        mine = sum(sd[k].numel() for k, d in got.items() if d is not None)
        assert round(mine / total, 3) == 0.932


@pytest.mark.parametrize("n_model", [2, 4])
def test_vae_rule_equals_jax_param_shardings_at_sd_turbo_width(n_model):
    """Every VAE tensor JAX's frozen tree holds gets JAX's dim, except
    (b) the two one-head mid attentions' q / k / v and to_out weights
    (JAX shards them, the port keeps them whole) and (c) the sharded
    convs' biases, quant_conv's and post_quant_conv's among them; (e) the
    four skip convs, trainables that JAX's frozen tree lacks, are whole.
    Every conv but the decoder's conv_out (3 output channels) is
    sharded, quant_conv and post_quant_conv included."""
    cfg = tconfigs.SD_TURBO_VAE
    with torch.device("meta"):
        sd = AutoencoderKL(cfg).state_dict()
    got = ttp.param_shardings(sd, n_model, ttp.vae_head_dim(cfg))
    want, n_sharded, share = _jax_dims(n_model, "vae")
    skips = {f"decoder.skip_conv_{i}.weight" for i in range(1, 5)}
    assert set(got) == set(want) | skips
    assert all(got[k] is None for k in skips)                   # (e)
    differ = {k for k in want if got[k] != want[k]}
    heads = {f"{part}.mid_block.attentions.0.{p}.weight"
             for part in ("encoder", "decoder")
             for p in ("to_q", "to_k", "to_v", "to_out.0")}
    biases = {k for k in want if k.endswith(".bias")
              and len(sd[k[:-5] + ".weight"].shape) == 4
              and want[k[:-5] + ".weight"] == 0}
    assert differ == heads | biases
    assert all(got[k] is None and want[k] is not None for k in heads)
    assert all(got[k] == 0 and want[k] is None for k in biases)
    convs = {k for k in sd if k.endswith(".weight") and sd[k].ndim == 4}
    assert {k for k in convs if got[k] is None} == \
        skips | {"decoder.conv_out.weight"}
    if n_model == 2:
        assert (n_sharded, round(share, 3)) == (71, 0.999)
        total = sum(v.numel() for v in sd.values())
        mine = sum(sd[k].numel() for k, d in got.items() if d is not None)
        assert round(mine / total, 3) == 0.969


def test_shard_then_unshard_is_exact():
    sd = from_jax.random_params(tconfigs.MICRO_UNET,
                                torch.Generator().manual_seed(1))
    hd = ttp.head_dim(tconfigs.MICRO_UNET)
    for n in (2, 4):
        specs = ttp.param_shardings(sd, n, hd)
        shards = [ttp.shard_state_dict(sd, _mesh(m, n), hd) for m in range(n)]
        back = ttp.unshard_state_dict(shards, specs)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        proj = "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj"
        for suffix in (".weight", ".bias"):
            whole = sd[proj + suffix]
            value, gate = whole.chunk(2)
            k = value.shape[0] // n
            for m, s in enumerate(shards):
                assert torch.equal(s[proj + suffix], torch.cat(
                    [value[m * k:(m + 1) * k], gate[m * k:(m + 1) * k]]))


def test_vae_shard_then_unshard_is_exact():
    """As for the UNet, on a TINY VAE at n_model 2 and 4: the skip convs
    whole on every rank (e), a conv's weight the rank's output channels."""
    cfg = tconfigs.TINY_VAE
    hd = ttp.vae_head_dim(cfg)
    sd = from_jax.random_params(cfg, torch.Generator().manual_seed(1))
    for n in (2, 4):
        specs = ttp.param_shardings(sd, n, hd)
        shards = [ttp.shard_state_dict(sd, _mesh(m, n), hd) for m in range(n)]
        back = ttp.unshard_state_dict(shards, specs)
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
        for m, shard in enumerate(shards):
            assert torch.equal(shard["decoder.skip_conv_1.weight"],
                               sd["decoder.skip_conv_1.weight"])
            assert torch.equal(shard["encoder.conv_in.weight"],
                               sd["encoder.conv_in.weight"].chunk(n)[m])


# ---------------------------------------------------------------------------
# the 2-rank UNet forward against JAX's sharded forward
# ---------------------------------------------------------------------------


def _jax_sharded_eps(jcfg, usd, x, t, ctx):
    tree = jax.tree_util.tree_map(
        np.asarray, ti.convert_unet_state_dict(usd, jcfg))
    jm = jmesh.make_mesh(n_data=1, n_model=WORLD,
                         devices=jax.devices()[:WORLD])
    rep = jmesh.replicated(jm)
    with jmesh.kernels_scope(jm):
        fwd = jax.jit(lambda p, x, t, c: junet.unet_forward(p, jcfg, x, t, c),
                      in_shardings=(jmesh.param_shardings(
                          tree, jm, tensor_parallel=True), rep, rep, rep))
        return np.asarray(fwd(tree, x, t.astype(np.int32), ctx))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_two_rank_unet_equals_jax_sharded_forward(ranks, name):
    cfg, jcfg = CONFIGS[name]
    usd = {k: v.numpy() for k, v in from_jax.random_params(
        cfg, torch.Generator().manual_seed(11)).items()}
    rng = np.random.RandomState(12)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.full((2,), 999, np.int64)
    ctx = (rng.randn(2, 77, 32) * 0.5).astype(np.float32)
    ranks.submit(torch_dp.tp_unet, cfg, usd, x, t, ctx)
    want = _jax_sharded_eps(jcfg, usd, x, t, ctx)
    out = ranks.collect()
    scale = np.abs(want).max()
    for res in out:
        for path, eps in res["eps"].items():
            err = np.abs(eps - want).max() / scale
            assert err <= TOL, (name, path, err)
        assert res["numel"] < sum(v.size for v in usd.values())
    for path in (True, False):
        np.testing.assert_array_equal(out[0]["eps"][path],
                                      out[1]["eps"][path])
    # (b): 3 heads stay whole at level 0; MICRO's 2 heads are split
    level0 = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    assert (level0 in out[0]["sharded"]) == (name == "micro")
    assert "mid_block.attentions.0.transformer_blocks.0.attn1.to_q" \
        in out[0]["sharded"]


VAES = {"micro": (tconfigs.MICRO_VAE, jconfigs.MICRO_VAE),
        "tiny": (tconfigs.TINY_VAE, jconfigs.TINY_VAE)}


def _jax_sharded_vae(jcfg, vsd, x):
    # the converter's skip-conv list assumes SD-Turbo's four levels
    tree = ti.convert_vae_state_dict(vsd, jcfg, with_skip_convs=False)
    tree["decoder"]["skip_convs"] = [
        {"kernel": vsd[f"decoder.skip_conv_{i + 1}.weight"].transpose(
            2, 3, 1, 0)} for i in range(jcfg.num_levels)]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    jm = jmesh.make_mesh(n_data=1, n_model=WORLD,
                         devices=jax.devices()[:WORLD])
    rep = jmesh.replicated(jm)

    def fwd(p, x):
        z, skips = jvae.encode(p, jcfg, x, sample_posterior=False)
        return z, jvae.decode(p, jcfg, z, skips)
    with jmesh.kernels_scope(jm):
        run = jax.jit(fwd, in_shardings=(jmesh.param_shardings(
            tree, jm, tensor_parallel=True), rep))
        return tuple(np.asarray(t) for t in run(tree, x))


@pytest.mark.parametrize("name", list(VAES))
def test_two_rank_vae_equals_jax_sharded_vae(ranks, name):
    """Encode (the posterior mean) and decode with the skips (one a level)
    through random skip convs (not the 1e-5 zero-convs, so the skips count), the
    VAE sharded over two ranks, on live weights (the kernel path as
    training runs it) and the plain path, against JAX's sharded jit: the latent and the image each
    within 1e-4 of max|ref|; both ranks bit-equal, and equal to the whole
    VAE's in one process; each rank below 0.6 of the whole's parameters,
    the mid attentions and skip convs whole."""
    cfg, jcfg = VAES[name]
    g = torch.Generator().manual_seed(21)
    vsd = from_jax.random_params(cfg, g)
    for k in [k for k in vsd if ".skip_conv_" in k]:
        vsd[k] = torch.randn(vsd[k].shape, generator=g) * 0.2
    vsd = {k: v.numpy() for k, v in vsd.items()}
    x = np.random.RandomState(22).uniform(-1, 1, (1, 32, 32, 3)).astype(
        np.float32)
    ranks.submit(torch_dp.tp_vae, cfg, vsd, x)
    want = dict(zip(("z", "img"), _jax_sharded_vae(jcfg, vsd, x)))
    out = ranks.collect()
    for res in out:
        for path, got in res["out"].items():
            for k, w in want.items():
                err = np.abs(got[k] - w).max() / np.abs(w).max()
                assert err <= TOL, (name, path, k, err)
        assert res["numel"] < 0.6 * sum(v.size for v in vsd.values())
        assert not any(".attentions." in n or "skip_conv" in n
                       for n in res["sharded"]), res["sharded"]
        assert "decoder.up_blocks.0.upsamplers.0.conv" in res["sharded"]
    for path in out[0]["out"]:
        for k in want:
            np.testing.assert_array_equal(out[0]["out"][path][k],
                                          out[1]["out"][path][k])
            # a column-parallel conv computes the whole conv's channels,
            # statistics included (fp64-accumulated in the plain versions)
            np.testing.assert_array_equal(out[0]["out"][path][k],
                                          out[0]["whole"][path][k])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_engine_model_axis_matches_one_process_engine(ranks):
    out = ranks.run(torch_dp.engine_tp)
    for mode in ("edge_to_image", "image"):
        for res in out:
            r = res[mode]
            diff = np.abs(r["tp"].astype(np.int32) - r["one"].astype(np.int32))
            assert diff.max() <= 1, mode
            assert (diff > 0).mean() <= 1e-3, (mode, (diff > 0).mean())
            assert r["numel"] < r["whole"]
        np.testing.assert_array_equal(out[0][mode]["tp"], out[1][mode]["tp"])
        assert out[0][mode]["tp"].shape == (2, torch_dp.RES, torch_dp.RES, 3)


# ---------------------------------------------------------------------------
# the mesh's groups and the refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_data,n_model", [(2, 2), (4, 2)])
def test_mesh_groups_are_jax_grid_columns_and_rows(n_data, n_model):
    jm = jmesh.make_mesh(n_data=n_data, n_model=n_model,
                         devices=jax.devices()[:n_data * n_model])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    data, model = tmesh.mesh_groups(n_data, n_model)
    assert data == [list(ids[:, m]) for m in range(n_model)]
    assert model == [list(ids[d, :]) for d in range(n_data)]


def test_training_and_sketch_refuse_a_model_axis():
    """The sketch mode still refuses a model axis; both training steps
    build under a (1, 2) mesh once `runner.shard_for_training` sharded the
    UNet (rank 0's shards here, without a process group), and refuse one
    on a whole UNet."""
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.training import (losses, paired, runner,
                                                  unpaired)
    m = _mesh(0, 2)
    with pytest.raises(NotImplementedError, match=re.escape("lora_merged_at")):
        ServingEngine(mode="sketch", base={"unet": None, "vae": None},
                      lora={}, device="cpu", mesh=m)
    cfgs = GeneratorConfigs(tconfigs.MICRO_UNET, tconfigs.MICRO_VAE,
                            tconfigs.TINY_TEXT)
    for build, make, loss_cfg in (
            (runner.build_paired_run, paired.make_paired_train_step,
             losses.PairedLossConfig()),
            (runner.build_unpaired_run, unpaired.make_unpaired_train_step,
             losses.UnpairedLossConfig())):
        models, state, meta = build(cfgs, clip_vit.TINY_CLIP_VIT,
                                    device="cpu")
        with pytest.raises(ValueError, match="shard_for_training"):
            make(models, cfgs, loss_cfg, meta, mesh=m)
        whole = sum(p.numel() for p in models.unet.parameters())
        runner.shard_for_training(models, m, state)
        assert callable(make(models, cfgs, loss_cfg, meta, mesh=m))
        assert sum(p.numel() for p in models.unet.parameters()) < whole
        assert models.unet.conv_in.weight.shape[0] == \
            tconfigs.MICRO_UNET.block_out_channels[0]


def test_training_rule_keeps_conv_in_whole():
    """Departure (d): the one rule, for serving and training alike, keeps
    conv_in's weight and bias whole at SD-Turbo width (where the conv
    rule would shard its 320 output channels), and `shard_module` leaves
    the module whole and unmarked while it slices conv_out."""
    with torch.device("meta"):
        sd = UNet2DConditionModel(tconfigs.SD_TURBO_UNET).state_dict()
    for n in (2, 4):
        specs = ttp.param_shardings(sd, n)
        assert sd["conv_in.weight"].shape[0] % n == 0
        assert specs["conv_in.weight"] is None
        assert specs["conv_in.bias"] is None
        assert specs["conv_out.weight"] == 0
    unet = from_jax.random_params(tconfigs.MICRO_UNET,
                                  torch.Generator().manual_seed(2))
    model = UNet2DConditionModel(tconfigs.MICRO_UNET)
    model.load_state_dict(unet)
    ttp.shard_module(model, _mesh(1, 2), ttp.head_dim(tconfigs.MICRO_UNET))
    assert torch.equal(model.conv_in.weight, unet["conv_in.weight"])
    assert not getattr(model.conv_in, "tp_sharded", False)
    assert model.conv_out.weight.shape[0] * 2 == \
        unet["conv_out.weight"].shape[0]


def test_model_axis_operators_are_exact(ranks):
    out = ranks.run(torch_dp.tp_ops)
    for res in out:
        assert len(res) == 10
        for op, (fwd, grad) in res.items():
            assert fwd and grad, op


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_layers_gradients_match_one_process(ranks, name):
    """Output, input / time-embedding / context gradients and every
    weight gradient (a sharded weight's against its slice of the whole's)
    within 1e-5 of max|ref| on both ranks; at the odd-head config the
    level-0 attention stays whole (departure (b)) and its GEGLU splits.
    No fallback: the sharded layers call every kernel wrapper (K1 and K8's
    du in a resnet, K3, K2 and K7 in a transformer) as often as the whole
    ones, forward and backward."""
    out = ranks.run(torch_dp.tp_layers, CONFIGS[name][0])
    for res in out:
        for block, r in res.items():
            worst = max(r["err"], key=r["err"].get)
            assert r["err"][worst] <= 1e-5, (name, block, worst,
                                             r["err"][worst])
            assert r["sharded"], block
            assert r["calls"]["tp"] == r["calls"]["whole"], block
            need = (("fused_gn_silu_conv3x3", "conv3x3_input_grad")
                    if block.startswith("resnet") else
                    ("fused", "flash_attention_folded",
                     "flash_attention_folded_bwd"))
            assert all(r["calls"]["tp"].get(k) for k in need), (block, r)
            attn = "transformer_blocks.0.attn1.to_q"
            if block == "transformer_level0":
                assert (attn in r["sharded"]) == (name == "micro")
                assert "transformer_blocks.0.ff.net.0.proj" in r["sharded"]
    assert out[0].keys() == out[1].keys()
