"""The port's serving slice end to end on the CPU: img2img_turbo_tpu_torch's
ServingEngine(mode="edge_to_image") against the JAX package's
ServingEngine(dtype=float32, donate_input=False), uint8 in and uint8 out,
at configs.TINY_UNET / TINY_VAE widths with the same weights and the same
posterior noise (recomputed from the JAX key). Tolerance: at most 1 level
of difference, on at most 0.1% of the output values.
"""

import importlib.util
import os
import collections

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from img2img_turbo_tpu import configs
from img2img_turbo_tpu.models import unet as junet
from img2img_turbo_tpu.models import vae as jvae
from img2img_turbo_tpu.pipelines import pix2pix as jp2p
from img2img_turbo_tpu.serving import engine as jengine
from img2img_turbo_tpu_torch import configs as tconfigs
from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
from img2img_turbo_tpu_torch.ops import (attention, fused_conv, fused_matmul,
                                         groupnorm)
from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
from img2img_turbo_tpu_torch.serving.engine import ServingEngine
from img2img_turbo_tpu_torch.utils import profiling
from img2img_turbo_tpu_torch.weights import from_jax

# The suite runs in several pytest-xdist workers at once on a few cores:
# two intra-op threads a worker keep them from oversubscribing the cores.
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_LEVELS, MAX_FRACTION = 1, 1e-3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup():
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    unet_p = jax.tree_util.tree_map(np.asarray,
                                    junet.init_unet(k1, configs.TINY_UNET))
    vae_p = jax.tree_util.tree_map(np.asarray,
                                   jvae.init_vae(k2, configs.TINY_VAE))
    rng = np.random.RandomState(1)
    for conv in vae_p["decoder"]["skip_convs"]:
        conv["kernel"] = (rng.randn(*conv["kernel"].shape) * 0.1).astype(
            np.float32)
    jcfgs = jp2p.GeneratorConfigs(configs.TINY_UNET, configs.TINY_VAE)
    jeng = jengine.ServingEngine({"unet": unet_p, "vae": vae_p}, jcfgs,
                                 dtype=jnp.float32, donate_input=False)
    cfgs = GeneratorConfigs(tconfigs.TINY_UNET, tconfigs.TINY_VAE)
    params = {
        "unet": from_jax.load(UNet2DConditionModel(cfgs.unet),
                              from_jax.unet_state_dict(unet_p)),
        "vae": from_jax.load(AutoencoderKL(cfgs.vae),
                             from_jax.vae_state_dict(vae_p))}
    engines = {k: ServingEngine(params, cfgs, dtype=torch.float32,
                                device="cpu", use_kernels=k)
               for k in (True, False)}
    caption = rng.randn(1, 77, 32).astype(np.float32)
    return jeng, engines, caption


@pytest.mark.parametrize("hw", [(64, 64), (40, 56)])
@pytest.mark.parametrize("kernels", [True, False])
def test_matches_jax_engine_on_uint8(setup, hw, kernels):
    jeng, engines, caption = setup
    smoke = _chip_smoke()
    img = smoke.synth_image(*hw, seed=hw[1])
    key = jax.random.PRNGKey(5)
    want = np.asarray(jeng(jnp.asarray(img), jnp.asarray(caption), rng=key))
    # the JAX engine draws the posterior noise inside vae.encode as
    # jax.random.normal(key, mean.shape, mean.dtype)
    noise = np.array(jax.random.normal(key, (1, hw[0] // 8, hw[1] // 8, 4),
                                       jnp.float32))
    got = engines[kernels](img, torch.from_numpy(caption),
                           noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (1, *hw, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_LEVELS, diff.max()
    assert (diff > 0).mean() <= MAX_FRACTION, (diff > 0).mean()
    assert want.std() > 0  # a constant image would prove nothing


def test_generator_seed_decides_the_noise(setup):
    _, engines, caption = setup
    img = _chip_smoke().synth_image(64, 64, 0)
    cap = torch.from_numpy(caption)

    def run(seed):
        return engines[True](img, cap, torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_generate_deterministic_is_the_clamped_engine_image(setup):
    from img2img_turbo_tpu_torch.ops import canny as tcanny
    from img2img_turbo_tpu_torch.pipelines.pix2pix import (
        generate_deterministic)
    _, engines, caption = setup
    eng = engines[True]
    img = _chip_smoke().synth_image(40, 56, 2)
    noise = torch.randn(1, 5, 7, 4, generator=torch.Generator().manual_seed(0))
    cap = torch.from_numpy(caption)
    c_t = tcanny.canny_3ch_unit(torch.from_numpy(img))
    with torch.no_grad():
        got = generate_deterministic(eng.unet, eng.vae, eng.cfgs, eng.alphas,
                                     c_t, cap, noise=noise)
    want = eng.run(img, cap, noise=noise)["img"].clamp(-1, 1)
    assert torch.equal(got, want)
    assert got.min() >= -1 and got.max() <= 1


def test_launch_table_matches_call_sites(setup, monkeypatch):
    """chip_smoke.py's expected per-request launch counts, checked here by
    counting the kernel wrappers' calls (the TINY configs share SD-Turbo's
    topology, so the counts are the same)."""
    _, engines, caption = setup
    smoke = _chip_smoke()
    calls = collections.Counter()

    def spy(mod, fn, key):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[key] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)

    spy(fused_conv, "fused_gn_silu_conv3x3", "fused_gn_silu_conv3x3")
    spy(fused_conv, "upsample2x_conv3x3", "upsample2x_conv3x3")
    spy(fused_conv, "downsample2x_conv3x3", "downsample2x_conv3x3")
    spy(fused_matmul, "fused", "fused_matmul")
    spy(attention, "flash_attention_folded", "flash_attention_folded")
    spy(groupnorm, "partial_stats", "group_norm_stats")
    spy(groupnorm, "combine_stats", "group_norm_combine")
    cap = torch.from_numpy(caption)
    for (h, w), want in (((64, 64), smoke.EXPECTED_LAUNCHES),
                         ((560, 840), smoke.EXPECTED_LAUNCHES_840x560)):
        calls.clear()
        engines[True](smoke.synth_image(h, w, 0), cap)
        assert dict(calls) == want, (h, w)
    calls.clear()
    engines[False](smoke.synth_image(64, 64, 0), cap)
    assert not calls  # the plain path reaches no kernel wrapper


def test_timing_tables_match_launch_tables():
    """tools/time_kernels.py's launch columns, which chip_smoke.py holds
    each path's launches by shape against, add up to chip_smoke.py's launch
    tables: K1's forward, K4 and K6 per 512x512 request and per train step,
    K7 and the du per train step."""
    from img2img_turbo_tpu_torch.tools import time_kernels as tk
    smoke = _chip_smoke()
    k1, k4 = "fused_gn_silu_conv3x3", "upsample2x_conv3x3"
    assert sum(c[11] for c in tk.K1_CASES) == smoke.EXPECTED_LAUNCHES[k1]
    assert sum(c[12] for c in tk.K1_CASES) == \
        smoke.EXPECTED_TRAIN_LAUNCHES[k1] - smoke.TRAIN_DU_LAUNCHES
    assert not any(c[11] or c[12] for c in tk.K1_CASES[tk.K1_PATH_CASES:])
    assert len({c[1:11] for c in tk.K1_CASES}) == len(tk.K1_CASES)
    assert sum(c[8] for c in tk.K4_CASES) == smoke.EXPECTED_LAUNCHES[k4]
    assert sum(c[9] for c in tk.K4_CASES) == smoke.EXPECTED_TRAIN_LAUNCHES[k4]
    assert len({c[1:8] for c in tk.K4_CASES}) == len(tk.K4_CASES)
    k6, k7 = "downsample2x_conv3x3", "flash_attention_folded_bwd"
    assert sum(c[7] for c in tk.K6_CASES) == smoke.EXPECTED_LAUNCHES[k6]
    assert sum(c[8] for c in tk.K6_CASES) == smoke.EXPECTED_TRAIN_LAUNCHES[k6]
    assert not any(c[7] or c[8] for c in tk.K6_CASES[tk.K6_PATH_CASES:])
    assert sum(c[6] for c in tk.K7_CASES) == smoke.EXPECTED_TRAIN_LAUNCHES[k7]
    assert sum(c[-1] for c in tk.DU_CASES) == smoke.TRAIN_DU_LAUNCHES


def test_a_request_records_its_stage_spans(setup):
    """Under recording, one request is one `i2i.serve.run` span holding
    the input, the generator's three stages and the output, all under one
    request id; on prepared layouts it packs no weight."""
    _, engines, caption = setup
    img = np.random.RandomState(3).randint(0, 256, (1, 40, 56, 3),
                                           dtype=np.uint8)
    with profiling.recording() as rec:
        engines[True](img, torch.from_numpy(caption),
                      torch.Generator().manual_seed(0))
    spans = sorted(rec.spans, key=lambda s: s.seq)
    root = spans[0]
    assert root.name == "i2i.serve.run" and root.parent is None
    assert [s.name for s in spans[1:]] == [
        "i2i.serve.input", "i2i.gen.encode", "i2i.gen.unet",
        "i2i.gen.decode", "i2i.serve.output"]
    assert all(s.parent == root.seq for s in spans[1:])
    assert {s.unit for s in spans} == {1} and rec.units == 1
    assert rec.counters().get("weight_packs", 0) == 0


def test_rejects_what_it_does_not_serve(setup):
    _, engines, caption = setup
    eng = engines[True]
    cap = torch.from_numpy(caption)
    with pytest.raises(ValueError):
        eng(np.zeros((1, 60, 64, 3), np.uint8), cap)
    with pytest.raises(ValueError):
        eng(np.zeros((1, 64, 64, 3), np.float32), cap)
    with pytest.raises(ValueError):     # sketch mode takes base and lora
        ServingEngine({"unet": eng.unet, "vae": eng.vae}, eng.cfgs,
                      mode="sketch", device="cpu")


def test_engine_refuses_to_pick_the_cpu_by_itself(setup, monkeypatch):
    """With no device given the engine runs on the card; with no card it
    raises instead of serving on the CPU, whatever the parameters' device."""
    _, engines, _ = setup
    eng = engines[True]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        ServingEngine({"unet": eng.unet, "vae": eng.vae}, eng.cfgs)


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """Without a CUDA device the smoke exits non-zero and prints no result
    line, and a lone copy of it (no package beside it) fails too."""
    import shutil
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and '"ok"' not in out.stdout
