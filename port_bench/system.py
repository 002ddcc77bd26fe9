"""The system under test: `img2img_turbo_tpu_torch`, the PyTorch/CUDA port.
This is the one module of the benchmark that imports it. The benchmark's
weights reach it in memory through the key maps and LoRA readers that its
`from_pretrained` loaders use on files."""

from __future__ import annotations

import torch

from port_bench import weights as weights_mod


def launch_shapes():
    """The port's launch counter by (kernel, shape)."""
    from img2img_turbo_tpu_torch.ops import _build
    return _build.launch_shapes


def build_kernels() -> dict:
    """Compile (first run in a checkout) and load the port's CUDA
    libraries; {library: seconds compiling}."""
    from img2img_turbo_tpu_torch.ops import _build
    return _build.build()


def generator_configs(cfg):
    from img2img_turbo_tpu_torch import configs
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    u, v = cfg["unet"], cfg["vae"]
    attn = tuple(t.startswith("CrossAttn") for t in u["down_block_types"])
    unet = configs.UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        layers_per_block=u["layers_per_block"],
        attention_head_dim=tuple(u["attention_head_dim"]),
        cross_attention_dim=u["cross_attention_dim"],
        transformer_levels=attn, norm_num_groups=u["norm_num_groups"],
        norm_eps=u["norm_eps"], flip_sin_to_cos=u["flip_sin_to_cos"],
        freq_shift=float(u["freq_shift"]))
    vae = configs.VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"],
        norm_num_groups=v["norm_num_groups"], norm_eps=v["norm_eps"],
        scaling_factor=v["scaling_factor"])
    t = cfg.get("text_encoder")
    text = configs.SD_TURBO_TEXT if t is None else configs.CLIPTextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
        num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
        intermediate_size=t["intermediate_size"],
        max_position_embeddings=t["max_position_embeddings"],
        layer_norm_eps=t["layer_norm_eps"], hidden_act=t["hidden_act"])
    return GeneratorConfigs(unet=unet, vae=vae, text=text)


def merged_modules(cfg, w: weights_mod.Weights, device):
    """{"unet", "vae"}: fp32 modules holding the benchmark's base weights
    with every adapter merged, as the pipelines' loaders build them from an
    SD-Turbo snapshot and an img2img-turbo checkpoint."""
    from img2img_turbo_tpu_torch import lora as lora_mod
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    from img2img_turbo_tpu_torch.pipelines.pix2pix import lora_to, merge_into
    from img2img_turbo_tpu_torch.weights import torch_import as ti
    cfgs = generator_configs(cfg)
    mods = {"unet": ti.load_into(ti.build_on(
                lambda: UNet2DConditionModel(cfgs.unet), device), w.unet),
            "vae": ti.vae_from_state_dict(w.vae, cfgs.vae, device)}
    for ad in w.adapters:
        lora = lora_mod.lora_from_torch_state_dict(
            ad.peft_state_dict(), rank=ad.rank, alpha=ad.alpha,
            adapter=ad.name)
        merge_into(mods[ad.model], [lora_to(lora, device)])
    return cfgs, mods


def serving_engine(cfg, w: weights_mod.Weights, mode: str, device,
                   dtype=torch.bfloat16):
    """The port's ServingEngine in `mode`, on its defaults (kernels on),
    in `dtype`."""
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    cfgs, mods = merged_modules(cfg, w, device)
    canny = cfg.get("canny", {})
    return ServingEngine(mods, cfgs, mode=mode, dtype=dtype,
                         canny_low=canny.get("low", 100.0),
                         canny_high=canny.get("high", 200.0), device=device)


def clip_config(cfg):
    from img2img_turbo_tpu_torch.models import clip_vit
    c = cfg["clip"]
    v, t = c["vision_config"], c["text_config"]
    return clip_vit.CLIPViTConfig(
        image_size=v["image_size"], patch_size=v["patch_size"],
        hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
        num_heads=v["num_attention_heads"],
        intermediate_size=v["intermediate_size"],
        projection_dim=c["projection_dim"], vocab_size=t["vocab_size"],
        text_hidden=t["hidden_size"], text_layers=t["num_hidden_layers"],
        text_heads=t["num_attention_heads"],
        max_positions=t["max_position_embeddings"],
        layer_norm_eps=v["layer_norm_eps"], hidden_act=v["hidden_act"])


def paired_training(cfg, w, device, dtype=torch.bfloat16):
    """(state, train_step) of the port's paired trainer on the benchmark's
    weights (`weights.TrainWeights`), wired as its training CLI wires it:
    kernels on, UNet remat, `dtype` activations, fp32 masters, AdamW with
    global-norm clipping and the configuration's constant learning rate.
    The weights enter through the key maps of the port's loaders."""
    from img2img_turbo_tpu_torch import lora as lora_mod
    from img2img_turbo_tpu_torch.models import clip_vit, vgg_lpips
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    from img2img_turbo_tpu_torch.pipelines.pix2pix import lora_to
    from img2img_turbo_tpu_torch.training import losses as losses_mod
    from img2img_turbo_tpu_torch.training import optim, paired
    from img2img_turbo_tpu_torch.weights import torch_import as ti
    cfgs, ccfg, t = generator_configs(cfg), clip_config(cfg), cfg["train"]
    unet = ti.load_into(ti.build_on(
        lambda: UNet2DConditionModel(cfgs.unet), device), w.gen.unet)
    vae = ti.vae_from_state_dict(w.gen.vae, cfgs.vae, device)
    text = ti.load_into(ti.build_on(lambda: CLIPTextModel(cfgs.text), device),
                        ti.clip_text_state_dict(w.text))
    lpips = ti.load_into(ti.build_on(vgg_lpips.VGGLPIPS, device),
                         vgg_lpips.convert_lpips_state_dict(
                             {k: v for k, v in w.lpips.items()
                              if k.startswith("features.")},
                             {k: v for k, v in w.lpips.items()
                              if k.startswith("lin")}))
    clip_sd = clip_vit.convert_clip_state_dict(w.clip, ccfg)
    backbone = ti.load_into(
        ti.build_on(lambda: clip_vit.CLIPVision(ccfg), device),
        {k: v for k, v in clip_sd.items()
         if k.startswith(("vision_model.", "visual_projection."))})
    clip = ti.load_into(ti.build_on(lambda: clip_vit.CLIPModel(ccfg), device),
                        clip_sd)
    for m in (text, lpips, backbone, clip):
        m.requires_grad_(False)
    loras = {ad.model: lora_to(lora_mod.lora_from_torch_state_dict(
        ad.peft_state_dict(), rank=ad.rank, alpha=ad.alpha, adapter=ad.name),
        device) for ad in w.gen.adapters}
    gen, meta = paired.split_trainable(unet, vae, loras["unet"], loras["vae"])
    sched = optim.make_lr_schedule(t["lr_scheduler"], t["learning_rate"], 0,
                                   1)
    state = paired.make_state(
        gen, w.heads, w.sn, sched, sched, beta1=t["adam_beta1"],
        beta2=t["adam_beta2"], eps=t["adam_epsilon"],
        weight_decay=t["adam_weight_decay"], max_grad_norm=t["max_grad_norm"])
    loss_cfg = losses_mod.PairedLossConfig(
        lambda_gan=t["lambda_gan"], lambda_lpips=t["lambda_lpips"],
        lambda_l2=t["lambda_l2"], lambda_clipsim=t["lambda_clipsim"],
        gan_loss_type=t["gan_loss_type"])
    models = paired.PairedModels(unet, vae, text, lpips, backbone, clip)
    step = paired.make_paired_train_step(
        models, cfgs, loss_cfg, meta, kernels=True,
        remat=t["gradient_checkpointing"], dtype=dtype)
    return state, step
