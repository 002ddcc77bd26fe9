"""Tiny widths of the benchmark's configurations, for CPU tests: the
topology of SD-Turbo (four levels, two layers a block, attention on three
levels, skip convs) at 16-64 channels, and two-layer text and CLIP
towers."""

TINY_UNET = {"block_out_channels": [32, 64, 64, 64],
             "attention_head_dim": [2, 4, 4, 4], "cross_attention_dim": 32,
             "norm_num_groups": 8}
TINY_VAE = {"block_out_channels": [16, 32, 32, 32], "norm_num_groups": 8}
TINY_TEXT = {"vocab_size": 1000, "hidden_size": 32, "intermediate_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4}
TINY_CLIP_VISION = {"image_size": 64, "patch_size": 16, "hidden_size": 32,
                    "intermediate_size": 64, "num_hidden_layers": 2,
                    "num_attention_heads": 4}
TINY_TRAFFIC = {"batch": 2, "height": 64, "width": 48, "pool_batches": 3,
                "warmup_requests": 1}


def tiny_cfg(cfg):
    """cfg's keys cut to tiny widths (those it has)."""
    out = {"unet": dict(cfg["unet"], **TINY_UNET),
           "vae": dict(cfg["vae"], **TINY_VAE)}
    if "text_encoder" in cfg:
        out["text_encoder"] = dict(cfg["text_encoder"], **TINY_TEXT)
    if "clip" in cfg:
        c = cfg["clip"]
        out["clip"] = dict(c, projection_dim=16, vision_config=dict(
            c["vision_config"], **TINY_CLIP_VISION), text_config=dict(
            c["text_config"], **dict(TINY_TEXT, intermediate_size=128)))
    return out
