"""The port's validation metrics against the JAX package, on the CPU, in
fp32, on the same numpy-seeded inputs:

- the FID InceptionV3 (`metrics/inception.py`) on a JAX-initialised tree
  carried across by `from_jax.inception_state_dict`, every parameter, and
  its features against JAX's `inception_features` for both pool variants
  at 107x99 (max |err| / max |ref| <= 1e-4);
- `clean_resize_299` equal to JAX's, bit for bit;
- the FID statistics and Fréchet distance against JAX's `fid` module on
  random features, a full-rank and a rank-deficient case (rel <= 1e-6);
- DINO (`models/dino.py`) at TINY_DINO on a JAX-initialised tree carried
  across by `from_jax.dino_state_dict`, every parameter; every block's q,
  k and v against `dino_forward` on a 224x224 and a 224x280 input (the
  28x35 grid resizes the position embedding; <= 1e-4), and the resize
  matrix against `jax.image.resize` itself;
- the DINO-Struct preprocess equal to JAX's, and `dino_struct_distance`
  against JAX's (<= 1e-4);
- `evaluate_direction` on two 64x64 images with a fixed forward: the PNGs
  and metric keys of the JAX module, and its FID composed from the port's
  own parts (features, statistics, distance).

To keep the file cheap on a CPU, JAX's Inception runs at 107x99, not
299x299, and the JAX trees are drawn under one jax.jit (an eager init
runs op by op). The port's Inception does run at 299x299 in
`evaluate_direction` (each feature batch pads to 8 images). There the
Fréchet distance is a recording stand-in: scipy's sqrtm of a 2048x2048
matrix costs tens of seconds of CPU time, and the distance's own math is
held against JAX above, on smaller features.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from PIL import Image

from img2img_turbo_tpu.metrics import dino_struct as jds
from img2img_turbo_tpu.metrics import fid as jfid
from img2img_turbo_tpu.metrics import inception as jinc
from img2img_turbo_tpu.models import dino as jdino
from img2img_turbo_tpu_torch.metrics import dino_struct as tds
from img2img_turbo_tpu_torch.metrics import fid as tfid
from img2img_turbo_tpu_torch.metrics import inception as tinc
from img2img_turbo_tpu_torch.models import dino as tdino
from img2img_turbo_tpu_torch.training import eval_unpaired
from img2img_turbo_tpu_torch.weights import from_jax

torch.set_num_threads(2)

TOL = 1e-4


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def inception():
    """A JAX-initialised Inception tree and the port's model loaded from it."""
    static = {}

    def init(key):
        arrays, static["tree"] = jinc.split_static(jinc.init_inception(key))
        return arrays

    arrays = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(init)(jax.random.PRNGKey(0)))
    params = jinc.merge_static(arrays, static["tree"])
    model = tinc.InceptionV3()
    from_jax.load(model, from_jax.inception_state_dict(params))
    return params, model.eval()


def test_inception_state_dict_carries_every_parameter(inception):
    params, model = inception
    tree = {}

    def walk(p, prefix):
        if "kernel" in p:
            tree[prefix] = p
            return
        for k, v in p.items():
            walk(v, f"{prefix}.{k}" if prefix else k)

    walk(params, "")
    got = dict(model.named_parameters())
    assert set(got) == {f"{k}.{leaf}" for k in tree
                        for leaf in ("weight", "scale", "bias")}
    for name, p in tree.items():
        conv = model.get_submodule(name)
        np.testing.assert_array_equal(
            conv.weight.detach().numpy(), p["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(conv.scale.detach().numpy(), p["scale"])
        np.testing.assert_array_equal(conv.bias.detach().numpy(), p["bias"])
        assert conv.stride == p["stride"], name
        assert ((conv.padding[0],) * 2, (conv.padding[1],) * 2) == \
            tuple(map(tuple, p["pad"])), name
    assert sum(v.numel() for v in got.values()) == sum(
        x.size for x in jax.tree_util.tree_leaves(params)
        if isinstance(x, np.ndarray))


@pytest.mark.parametrize("fid_variant", [True, False])
def test_inception_features_match_jax(inception, fid_variant):
    params, model = inception
    x = np.random.RandomState(0).rand(2, 107, 99, 3).astype(np.float32)
    want = np.asarray(jinc.make_feature_fn(params)(
        jnp.asarray(x), fid_variant=fid_variant))
    with torch.no_grad():
        got = model(torch.from_numpy(x), fid_variant=fid_variant).numpy()
    assert got.shape == (2, tinc.InceptionV3.FEATURES)
    assert _max_rel(got, want) <= TOL


def test_inception_pool_variants_differ(inception):
    """Mixed_7c's pool branch is the only difference, and it shows."""
    _, model = inception
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 107, 99, 3)
                         .astype(np.float32))
    with torch.no_grad():
        assert not torch.equal(model(x, True), model(x, False))


@pytest.mark.parametrize("hw", [(40, 50), (320, 300)])
def test_clean_resize_299_equals_jax(hw):
    img = (np.random.RandomState(2).rand(*hw, 3) * 255).astype(np.uint8)
    got = tfid.clean_resize_299(img)
    assert got.shape == (299, 299, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jfid.clean_resize_299(img))


@pytest.mark.parametrize("n,d", [(40, 16), (6, 24)])
def test_fid_math_matches_jax(n, d):
    """Statistics, Fréchet distance and fid_from_feats in float64, on a
    full-rank (n > d) and a rank-deficient (n < d) covariance."""
    rng = np.random.RandomState(3)
    f1 = rng.randn(n, d)
    f2 = rng.randn(n, d) * 1.3 + 0.2
    for got, want in zip(tfid.compute_stats(f1), jfid.compute_stats(f1)):
        np.testing.assert_array_equal(got, want)
    stats = tfid.compute_stats(f1) + tfid.compute_stats(f2)
    want = jfid.frechet_distance(*stats)
    assert abs(tfid.frechet_distance(*stats) - want) <= 1e-6 * abs(want)
    want = jfid.fid_from_feats(f1, f2)
    assert abs(tfid.fid_from_feats(f1, f2) - want) <= 1e-6 * abs(want)
    assert tfid.fid_from_feats(f1, f1) == pytest.approx(0.0, abs=1e-6)


@pytest.fixture(scope="module")
def dino():
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jdino.init_dino(k, jdino.TINY_DINO))(jax.random.PRNGKey(3)))
    model = tdino.DINO(tdino.TINY_DINO)
    from_jax.load(model, from_jax.dino_state_dict(params))
    return params, model.eval()


def test_dino_state_dict_carries_every_parameter(dino):
    params, model = dino
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(sd["cls_token"][0, 0], params["cls_token"])
    np.testing.assert_array_equal(sd["pos_embed"][0, 0],
                                  params["pos_embed_cls"])
    np.testing.assert_array_equal(
        sd["pos_embed"][0, 1:].reshape(params["pos_embed_grid"].shape),
        params["pos_embed_grid"])
    np.testing.assert_array_equal(
        sd["patch_embed.proj.weight"],
        params["patch_embed"]["kernel"].transpose(3, 2, 0, 1))
    for i, blk in enumerate(params["blocks"]):
        for port, jax_name in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                               ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            np.testing.assert_array_equal(sd[f"blocks.{i}.{port}.weight"],
                                          blk[jax_name]["kernel"].T)
            np.testing.assert_array_equal(sd[f"blocks.{i}.{port}.bias"],
                                          blk[jax_name]["bias"])
        for port, jax_name in (("norm1", "ln1"), ("norm2", "ln2")):
            np.testing.assert_array_equal(sd[f"blocks.{i}.{port}.weight"],
                                          blk[jax_name]["scale"])
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert sum(v.size for v in sd.values()) == n_jax


@pytest.mark.parametrize("hw", [(224, 224), (224, 280)])
def test_dino_qkv_match_jax(dino, hw):
    """Every block's q, k and v and the final tokens; 224x280 takes a
    28x35 patch grid, so the position embedding is resized."""
    params, model = dino
    px = np.random.RandomState(4).randn(1, *hw, 3).astype(np.float32)
    jx, jqkv = jdino.dino_forward(params, jdino.TINY_DINO, jnp.asarray(px))
    with torch.no_grad():
        tx, tqkv = model(torch.from_numpy(px))
    assert len(tqkv) == len(jqkv) == jdino.TINY_DINO.num_layers
    n = 1 + (hw[0] // 8) * (hw[1] // 8)
    for jb, tb in zip(jqkv, tqkv):
        for k in "qkv":
            assert tb[k].shape == (1, 4, n, 8)
            assert _max_rel(tb[k], jb[k]) <= TOL, k
    assert _max_rel(tx, jx) <= TOL


@pytest.mark.parametrize("out", [35, 20, 28])
def test_cubic_resize_matrix_equals_jax_image_resize(out):
    """float64 here, float32 in jax.image.resize: equal to ~1e-6."""
    m = tdino.cubic_resize_matrix(28, out)
    want = np.asarray(jax.image.resize(jnp.eye(28), (out, 28), "bicubic"))
    np.testing.assert_allclose(m, want, rtol=0, atol=1e-5)


def _pil(h, w, seed):
    return Image.fromarray((np.random.RandomState(seed).rand(h, w, 3) * 255)
                           .astype(np.uint8))


@pytest.fixture(scope="module")
def structure(dino):
    params, model = dino
    return (jds.DinoStructureLoss(params=jax.tree_util.tree_map(
        jnp.asarray, params), cfg=jdino.TINY_DINO),
        tds.DinoStructureLoss(model=model))


@pytest.mark.parametrize("hw", [(300, 200), (200, 300), (64, 64)])
def test_dino_preprocess_equals_jax(structure, hw):
    jloss, tloss = structure
    img = _pil(*hw, 5)
    got = tloss.preprocess(img).numpy()
    np.testing.assert_array_equal(got, np.asarray(jloss.preprocess(img)))
    assert min(got.shape[1:3]) == 224


def test_dino_struct_distance_matches_jax(structure):
    jloss, tloss = structure
    a, b = (tloss.preprocess(_pil(180, 225, s)) for s in (6, 7))
    assert a.shape == (1, 224, 280, 3)
    want = jloss.calculate_global_ssim_loss(jnp.asarray(b.numpy()),
                                            jnp.asarray(a.numpy()))
    got = tloss.calculate_global_ssim_loss(b, a)
    assert want > 0 and abs(got - want) <= TOL * want
    assert tloss.calculate_global_ssim_loss(a, a) == pytest.approx(0.0,
                                                                   abs=1e-7)


def test_evaluate_direction_files_keys_and_fid(tmp_path, dino, monkeypatch):
    """Three 64x64 images through a fixed forward (colour inversion): the
    translated PNGs and the reference PNGs land where the JAX module puts
    them, the keys are fid_<tag> and dino_struct_<tag>, and the FID is the
    distance of the statistics of the saved translations' features from
    the reference statistics, as composed here by hand."""
    src = tmp_path / "test_A"
    ref = tmp_path / "test_B"
    for d in (src, ref):
        d.mkdir()
    for i in range(3):
        _pil(64, 64, 10 + i).save(src / f"img{i}.jpg", quality=95)
    for i in range(2):
        _pil(64, 64, 20 + i).save(ref / f"img{i}.png")
    model = tinc.random_inception(torch.Generator().manual_seed(7))
    out = tmp_path / "out"
    ref_paths = sorted(str(p) for p in ref.iterdir())
    src_paths = sorted(str(p) for p in src.iterdir())
    ref_stats = eval_unpaired.cache_reference_fid_stats(
        model, ref_paths, lambda im: im, str(out), "a2b")
    assert sorted(os.listdir(out / "fid_reference_a2b")) == ["img0.png",
                                                              "img1.png"]

    calls = []

    def distance(mu1, s1, mu2, s2):
        calls.append((mu1, s1, mu2, s2))
        return float(np.sum((mu1 - mu2) ** 2) + np.trace(s1) + np.trace(s2))

    monkeypatch.setattr(tfid, "frechet_distance", distance)
    metrics = eval_unpaired.evaluate_direction(
        lambda x: -x, src_paths, lambda im: im, model, ref_stats,
        tds.DinoStructureLoss(model=dino[1]), str(out), "a2b", 5)
    assert set(metrics) == {"fid_a2b", "dino_struct_a2b"}
    assert np.isfinite(list(metrics.values())).all()
    saved = sorted(os.listdir(out / "fid-5" / "samples_a2b"))
    assert saved == ["img0.png", "img1.png", "img2.png"]
    outs = [np.asarray(Image.open(out / "fid-5" / "samples_a2b" / n))
            for n in saved]
    for p, o in zip(src_paths, outs):
        x = np.asarray(Image.open(p).convert("RGB"), np.float32) / 127.5 - 1
        np.testing.assert_array_equal(
            o, np.clip((-x * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8))
    mu, sigma = tfid.compute_stats(tfid.features_from_images(model, outs))
    (mu1, s1, mu2, s2), = calls
    np.testing.assert_array_equal(mu1, mu)
    np.testing.assert_array_equal(s1, sigma)
    assert mu2 is ref_stats[0] and s2 is ref_stats[1]
    assert metrics["fid_a2b"] == distance(mu, sigma, *ref_stats)
    # max_images keeps the first images; no DINO model, no DINO key
    few = eval_unpaired.evaluate_direction(
        lambda x: x, src_paths, lambda im: im, model, ref_stats, None,
        str(out), "b2a", 6, max_images=2)
    assert set(few) == {"fid_b2a"}
    assert sorted(os.listdir(out / "fid-6" / "samples_b2a")) == [
        "img0.png", "img1.png"]
