"""port_bench/flops.py against torch's FlopCounterMode on the reference at
tiny widths, and the roofline formulas at a known shape."""

import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, roofline, run, weights
from port_bench.reference import generator, sd_turbo
from port_bench.tests.tiny import tiny_cfg


@pytest.mark.parametrize("config,mode,hw", [
    ("pix2pix_turbo_edge", "edge_to_image", (64, 48)),
    ("cyclegan_turbo_day2night", "image", (72, 40))])
def test_flops_equal_flop_counter(config, mode, hw):
    cfg = json.loads((run.BENCH / "configs" / f"{config}.json").read_text())
    cfg.update(tiny_cfg(cfg))
    w = weights.make(cfg, 3, "cpu", torch.float32)
    p_unet, p_vae = (sd_turbo.merge_lora(getattr(w, m), [
        a for a in w.adapters if a.model == m]) for m in ("unet", "vae"))
    h, wd = hw
    img = torch.randint(0, 256, (2, h, wd, 3), dtype=torch.uint8)
    noise = torch.randn(2, h // 8, wd // 8, 4)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        generator.serve(p_unet, p_vae, cfg, mode, img, w.caption, noise)
    assert fc.get_total_flops() == 2 * flops.serve_image(cfg, h, wd)


def test_roofline_bounds():
    f, b = roofline.k1(1, 8, 8, 64, 64, True, False, False, 0, False)
    assert f == 2 * 64 * 64 * 9 * 64
    assert b == 64 * 64 * 2 + 9 * 64 * 64 * 2 + 64 * 4 + 2 * 64 * 4 \
        + 64 * 64 * 2
    assert roofline.k6(1, 9, 9, 8, 8, 1)[0] == 2 * 25 * 8 * 9 * 8
    assert roofline.k4(1, 4, 4, 8, 8, 0, False)[0] == 2 * 64 * 8 * 32
    assert roofline.k2(1, 10, 20, 2, 64)[0] == 4 * 10 * 20 * 2 * 64
    shapes = {("fused_gn_silu_conv3x3", (1, 8, 8, 64, 64, True, False,
                                         False, 0, False)): 2,
              ("group_norm_stats", (1, 64, 64)): 5}
    t, n = roofline.bound_total(shapes, roofline.CONV)
    assert n == 2 and t == pytest.approx(2 * roofline.bound_s(f, b))
    kernels = [("void conv_kernel<1, 2>(ConvArgs)", 0, 2 * t),
               ("void flash_kernel<Cfg>(...)", 0, 1.0)]
    assert roofline.share_pct(shapes, roofline.CONV, kernels,
                              roofline.CONV_KERNELS) == pytest.approx(50.0)
    assert roofline.share_pct(shapes, roofline.ATTN, kernels,
                              roofline.ATTN_KERNELS) is None


def test_train_pieces_equal_flop_counter():
    """Each forward that flops.paired_step composes, against FlopCounterMode
    on the reference at tiny widths."""
    from port_bench.reference import aux_models as aux
    cfg = json.loads((run.BENCH / "configs" / "pix2pix_turbo_edge.json")
                     .read_text())
    cfg.update(tiny_cfg(cfg))
    w = weights.make_train(cfg, 5, "cpu")
    clip = cfg["clip"]
    ids = torch.randint(1, 900, (2, 77))
    size = clip["vision_config"]["image_size"]
    pix = torch.randn(2, 3, size, size)
    img = torch.rand(2, 3, 64, 48) * 2 - 1
    cases = [
        (lambda: aux.text_tower(w.text, cfg["text_encoder"], ids),
         flops.text_tower(cfg["text_encoder"])),
        (lambda: aux.clip_vision(w.clip, clip, pix),
         flops.clip_vision(clip)),
        (lambda: aux.clip_text(w.clip, clip, ids),
         flops.text_tower(clip["text_config"]) + 2 * 32 * 16),
        (lambda: aux.lpips(w.lpips, img, img), flops.lpips(64, 48))]
    for fn, expect in cases:
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            fn()
        assert fc.get_total_flops() == 2 * expect
    # the heads' spectral norm (a norm, not counted) adds its few
    # matrix-vector products, independent of the batch
    sn = sum(4 * math.prod(s) for _, s in aux.head_shapes(clip))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        aux.disc_logits(w.clip, clip, w.heads, w.sn, pix)
    extra = fc.get_total_flops() - 2 * (flops.clip_vision(clip)
                                        + flops.disc_heads(clip))
    assert 0 <= extra <= sn


def test_lora_layers_are_the_adapters():
    """The layers whose LoRA factors flops.generator counts a weight
    gradient for are the configuration's adapted modules: their factors'
    parameters agree."""
    cfg = json.loads((run.BENCH / "configs" / "pix2pix_turbo_edge.json")
                     .read_text())
    shapes = {"unet": sd_turbo.unet_shapes(cfg["unet"]),
              "vae": sd_turbo.vae_shapes(cfg["vae"])}
    want = 0
    for spec in cfg["adapters"]:
        shape_of = dict(shapes[spec["model"]])
        for m in weights.adapter_modules(shapes[spec["model"]], spec):
            s = shape_of[m + ".weight"]
            want += spec["rank"] * (math.prod(s[1:]) + s[0])
    assert flops.generator(cfg, 64, 64).lora_params == want


def test_paired_step_composition():
    cfg = json.loads((run.BENCH / "configs" / "pix2pix_turbo_edge.json")
                     .read_text())
    g = flops.generator(cfg, 512, 512)
    # the weight gradients: the whole weights that train (the UNet's
    # conv_in at the 64x64 latent, skip conv i at 64 * 2^i) and the LoRA
    # factors, a small part of the forward
    whole = 2 * 64 * 64 * 320 * 4 * 9 + sum(
        2 * (64 << i) ** 2 * ci * co
        for i, (ci, co) in enumerate(sd_turbo.skip_conv_channels(cfg["vae"])))
    assert whole < g.wgrad < 0.1 * g.total
    step = flops.paired_step(cfg, 4, 512, 512)
    assert step > 4 * 2 * (2 * g.total + g.wgrad)
    assert step == 4 * flops.paired_step(cfg, 1, 512, 512)
