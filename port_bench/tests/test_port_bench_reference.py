"""The frozen reference against the port's plain path (ServingEngine with
use_kernels=False) on the benchmark's weights, at tiny widths in fp32 on
the CPU, in both serving modes; and the parameter layout the benchmark
draws against the port's modules."""

import json

import numpy as np
import pytest
import torch

from port_bench import compare, run, system, weights
from port_bench.reference import generator, sd_turbo
from port_bench.tests.tiny import tiny_cfg


def _cfg(name):
    cfg = json.loads((run.BENCH / "configs" / f"{name}.json").read_text())
    cfg.update(tiny_cfg(cfg))
    return cfg


@pytest.mark.parametrize("config,mode", [
    ("pix2pix_turbo_edge", "edge_to_image"),
    ("cyclegan_turbo_day2night", "image")])
def test_reference_matches_port_plain_path(config, mode):
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    cfg = _cfg(config)
    w = weights.make(cfg, 11, "cpu", torch.float32)
    cfgs, mods = system.merged_modules(cfg, w, "cpu")
    engine = ServingEngine(mods, cfgs, mode=mode, dtype=torch.float32,
                           device="cpu", use_kernels=False)
    from port_bench import inputs
    img = inputs.image_pool(5, 2, 40, 56, "cpu")
    noise = torch.randn(2, 5, 7, 4, generator=torch.Generator().manual_seed(1))
    got = engine.run(img, w.caption, noise=noise)
    p_unet, p_vae = (sd_turbo.merge_lora(getattr(w, m), [
        a for a in w.adapters if a.model == m]) for m in ("unet", "vae"))
    ref = generator.serve(p_unet, p_vae, cfg, mode, torch.from_numpy(img),
                          w.caption, noise)
    r = compare.readings(got, ref)
    assert r["x0_rel_l2"] < 1e-4 and r["img_rel_l2"] < 1e-4
    assert r["out_mean_abs"] < 0.01
    if mode == "edge_to_image":
        from img2img_turbo_tpu_torch.ops.canny import canny
        e = generator.control_input(cfg, mode, torch.from_numpy(img))
        assert torch.equal(e[:, 0], canny(torch.from_numpy(img), 100, 200)
                           .float() / 255)
        assert 0.01 < e.mean().item() < 0.5   # the images have edges


def test_drawn_layout_is_the_ports():
    """Every drawn name and shape is a parameter of the port's modules
    (strict loads), every adapter targets modules that exist, and one seed
    draws the same weights twice."""
    cfg = _cfg("cyclegan_turbo_day2night")
    w = weights.make(cfg, 4, "cpu", torch.float32)
    _, mods = system.merged_modules(cfg, w, "cpu")
    assert set(w.unet) == set(dict(mods["unet"].named_parameters()))
    counts = {a.name: len(a.factors) for a in w.adapters}
    assert min(counts.values()) > 0
    enc = {n for a in w.adapters if a.name == "default_encoder"
           for n in a.factors}
    assert "conv_in" in enc and all("up_blocks" not in n for n in enc)
    w2 = weights.make(cfg, 4, "cpu", torch.float32)
    assert all(torch.equal(w.unet[k], w2.unet[k]) for k in w.unet)
    assert not torch.equal(w.caption, weights.make(cfg, 5, "cpu",
                                                   torch.float32).caption)


def test_image_pool_is_seeded_and_distinct():
    from port_bench import inputs
    a = inputs.image_pool(9, 4, 32, 32, "cpu")
    assert a.dtype == np.uint8 and a.shape == (4, 32, 32, 3)
    assert np.array_equal(a, inputs.image_pool(9, 4, 32, 32, "cpu"))
    assert len({x.tobytes() for x in a}) == 4


def test_paired_step_reference_matches_port():
    """The reference's first three paired steps against the port's step
    (its CPU path) on the benchmark's weights, at tiny widths in fp32:
    every loss, the first moments after the first step (generator and
    heads) and the trainables' changes."""
    from port_bench.tests.tiny import tiny_cfg as tiny
    cell = run.Cell(run.ROOT, "edge_train_b4_512")
    rec, _, _ = run.run_cell(
        run.ROOT, "edge_train_b4_512", 12, 0.1, 0, "cpu",
        dtype=torch.float32, cfg_override=tiny(cell.cfg),
        traffic_override={"batch": 2, "height": 64, "width": 64,
                          "pool_batches": 3})
    r = rec["numbers"]
    assert r["loss_rel"] < 1e-5 and r["grad1_gap"] < 1e-2 \
        and r["update_gap"] < 3e-2, r
    assert len(rec["reference"]["losses"]) == 3
    assert set(rec["program"]["mu1"]) == set(rec["reference"]["mu1"]) \
        == set(sum(rec["reference"]["groups"], []))
    assert rec["reference"]["groups"][1], "the heads are compared"
