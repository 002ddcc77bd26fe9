"""Unpaired (CycleGAN-Turbo) training CLI on one card or over several,
data-parallel and with the UNet and the VAE sharded over a model axis
(counterpart of `cli/train_cyclegan_turbo.py`; reference
`accelerate launch src/train_cyclegan_turbo.py`,
train_cyclegan_turbo.py:25-390), with resume:

    python -m img2img_turbo_tpu_torch.cli.train_cyclegan_turbo \\
        --dataset_folder data/horse2zebra --output_dir out \\
        --tracker_project_name h2z --train_img_prep \\
        resize_286_randomcrop_256x256_hflip --val_img_prep resize_256
    torchrun --nproc_per_node N -m \\
        img2img_turbo_tpu_torch.cli.train_cyclegan_turbo ... \\
        [--tensor_parallel M]

Under torchrun, as in the paired CLI: each rank on `cuda:LOCAL_RANK`,
--train_batch_size the global batch (each rank its contiguous rows of the
same seeded loader's batch, and of the global batch's noise), every pass's
losses and gradients averaged over the ranks before its update, the
frozen modules and the caption embeddings checked to agree across ranks,
a fresh state broadcast from rank 0; rank 0 alone logs, validates (FID and
DINO-Struct), writes viz panels, checkpoints and pkls while the others
wait at a barrier. --tensor_parallel M shards the UNet and both VAEs
over a model axis of M ranks, as in the paired CLI: the batch split over
the data axis only, the frozen modules and the state checked over the
model group before they are sharded (`runner.shard_for_training`), the
state whole on every rank; the model ranks of data rank 0 run the
validation and viz translations together on the sharded models (the
others translate the same images in the same order), and global rank 0
alone scores, logs and writes; the pkl holds the whole VAEs, gathered
over the model group.

In the JAX CLI's order: seeds; the UNet with its three adapters at
--lora_rank_unet, the two VAEs with adapters at --lora_rank_vae, LPIPS and
two discriminators on one CLIP backbone (SD-Turbo and its text encoder and
BPE tokenizer from the --sd_turbo_path snapshot, the backbone from
--clip_weights, LPIPS from --lpips_weights, seeded random weights for what
no flag names); the fixed caption embeddings, computed once by
the text encoder from the dataset's fixed prompts (the encoder is dropped
after); AdamW from the --adam_*, --lr_* and --max_grad_norm flags;
--resume from the newest checkpoint in <output_dir>/state; the six-
objective step with accum_steps = --gradient_accumulation_steps; metrics
to <output_dir>/metrics.jsonl at the first step and every 10th; every
--validation_steps FID and DINO-Struct in both directions over the test
sets (`training/eval_unpaired.py`; the reference statistics cached once a
run), at most --validation_num_images a direction; every --viz_freq a
src | fake | rec panel for each direction; every --checkpointing_steps the
full state and the reference-schema pkl; a final state save.

The run is on the CUDA card unless `main` is given another device (the
tests pass device="cpu"). The unpaired parser has no --mixed_precision
(the reference takes its precision from accelerate's config): on the card
the step computes in bf16, the only activation dtype the port's Hopper
kernels take, and on the CPU in fp32, as the JAX CLI does. --allow_tf32
lets cuBLAS use TF32 for the fp32 matmuls left. Posterior noise comes from
a device torch.Generator seeded with seed + 1; validation and viz
translations draw theirs from one seeded 0 for each image (the JAX CLI's
PRNGKey(0)). A resumed run restarts the loader from its seed, as the JAX
CLI does. Prompts go through the snapshot's BPE tokenizer, or, without
--sd_turbo_path, `runner.SmokeTokenizer`. FID's Inception comes from
--inception_weights when given.
"""

from __future__ import annotations

import glob
import os
import time

EXTS = ("*.jpg", "*.jpeg", "*.png", "*.bmp")


def _images(folder):
    return sorted(sum((glob.glob(os.path.join(folder, e)) for e in EXTS),
                      []))


def main(args, device=None):
    """Train as the flags in `args` say (`parse_args_unpaired_training`),
    on `device` (the CUDA card when None). Returns {"start_step",
    "end_step", "steps_run", "eval_seconds"}."""
    import torch
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.training import runner

    dev = mesh_mod.local_device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if args.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
    with mesh_mod.distributed(device, args.tensor_parallel) as mesh:
        # The tracker is made here, apart from the run's models: a wandb
        # init that fails (no API key) keeps its exception, whose traceback
        # holds this frame and so would hold the models until the process
        # exits.
        log = runner.make_tracker(args.report_to, args.tracker_project_name,
                                  args.output_dir, vars(args))
        return _train(args, mesh.device, dtype, log, mesh)


def _train(args, dev, dtype, log, mesh):
    import numpy as np
    import torch
    from img2img_turbo_tpu_torch import lora as lora_mod
    from img2img_turbo_tpu_torch import scheduler
    from img2img_turbo_tpu_torch.metrics.dino_struct import DinoStructureLoss
    from img2img_turbo_tpu_torch.models import dino as dino_mod
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.cyclegan import forward_with_params
    from img2img_turbo_tpu_torch.training import (checkpoint as ckpt_mod,
                                                  data, eval_unpaired,
                                                  losses as losses_mod,
                                                  optim, paired, runner,
                                                  unpaired)

    np.random.seed(args.seed)
    cfgs = runner.generator_configs(args)
    clip_cfg = runner.clip_config(args)
    base, text, tok = None, None, None
    if args.sd_turbo_path:
        unet, vae, text, tok = runner.load_base_models(
            cfgs, torch.Generator(device=dev), args.sd_turbo_path)
        base = (unet, vae)
    if tok is None:
        tok = runner.SmokeTokenizer(cfgs.text.vocab_size)
    runner.check_tokenizer(tok, mesh)

    dataset = data.UnpairedDataset(args.dataset_folder, "train",
                                   args.train_img_prep, tok)
    total = args.max_train_steps or (args.max_train_epochs * max(
        1, len(dataset) // args.train_batch_size))
    sched = optim.make_lr_schedule(args.lr_scheduler, args.learning_rate,
                                   args.lr_warmup_steps, total,
                                   args.lr_num_cycles, args.lr_power)
    adam = dict(beta1=args.adam_beta1, beta2=args.adam_beta2,
                eps=args.adam_epsilon, weight_decay=args.adam_weight_decay,
                max_grad_norm=args.max_grad_norm)
    models, state, meta = runner.build_unpaired_run(
        cfgs, clip_cfg, args.seed, dev, lr_schedule=sched, adam_kwargs=adam,
        rank_unet=args.lora_rank_unet, rank_vae=args.lora_rank_vae,
        base=base, clip_weights=args.clip_weights,
        lpips_weights=args.lpips_weights)

    # the fixed caption embeddings, once (train_cyclegan_turbo.py:140-144)
    if text is None:
        text = runner.random_init(
            lambda: CLIPTextModel(cfgs.text),
            torch.Generator(device=dev).manual_seed(args.seed + 2))
    with torch.no_grad():
        emb_a2b, emb_b2a = (text(torch.as_tensor(
            ids[None].astype(np.int64), device=dev))
            for ids in (dataset.input_ids_tgt, dataset.input_ids_src))
    del text
    mesh_mod.assert_replicated(
        {"unet": models.unet, "vae_a2b": models.vae_a2b,
         "vae_b2a": models.vae_b2a, "lpips": models.lpips,
         "disc_backbone": models.disc_backbone,
         "caption embeddings": [emb_a2b, emb_b2a]}, mesh,
        "the frozen modules")

    state_dir = os.path.join(args.output_dir, "state")
    start_step = 0
    latest = ckpt_mod.latest_step(state_dir) if args.resume else None
    if latest is not None:
        ckpt_mod.restore_train_state(state_dir, state, mesh=mesh)
        start_step = int(latest)
        if mesh.is_main:
            print(f"resumed from step {start_step}", flush=True)
    else:
        mesh_mod.replicate(state, mesh)

    # every rank the global batch's loader, then its rows
    loader = data.data_loader(dataset, args.train_batch_size, seed=args.seed)
    loader = data.accumulate_batches(loader,
                                     args.gradient_accumulation_steps)
    loader = data.prefetch(data.shard(loader, mesh), depth=2)
    loss_cfg = losses_mod.UnpairedLossConfig(
        lambda_gan=args.lambda_gan, lambda_idt=args.lambda_idt,
        lambda_cycle=args.lambda_cycle,
        lambda_cycle_lpips=args.lambda_cycle_lpips,
        lambda_idt_lpips=args.lambda_idt_lpips,
        gan_loss_type=args.gan_loss_type)
    runner.shard_for_training(models, mesh, state)
    tp = paired.model_axis(mesh, models)
    step_fn = unpaired.make_unpaired_train_step(
        models, cfgs, loss_cfg, meta, kernels=True,
        remat=args.gradient_checkpointing or not args.tiny_model,
        dtype=dtype, accum_steps=args.gradient_accumulation_steps,
        mesh=mesh)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    if mesh.is_main:
        os.makedirs(ckpt_dir, exist_ok=True)
    alphas = scheduler.make_alphas_cumprod(device=dev)
    mods = {"unet": models.unet, "vae_a2b": models.vae_a2b,
            "vae_b2a": models.vae_b2a}

    def translator(params, direction, emb):
        """x (B, H, W, 3) in [-1, 1] -> its translation, on the merged
        `params`, the posterior noise drawn from a generator seeded 0."""
        @torch.no_grad()
        def f(x):
            e = emb.to(dtype).expand(x.shape[0], *emb.shape[1:])
            g = torch.Generator(device=dev).manual_seed(0)
            with lora_mod.swap_params(models.unet, params["unet"]), \
                    lora_mod.swap_params(models.vae_a2b, params["vae_a2b"]), \
                    lora_mod.swap_params(models.vae_b2a, params["vae_b2a"]):
                return forward_with_params(mods, cfgs, alphas,
                                           x.to(dev, dtype), e.contiguous(),
                                           direction, kernels=True,
                                           generator=g, tp=tp)
        return f

    # validation set-up: cached reference FID stats and DINO
    # (train_cyclegan_turbo.py:89-125)
    test_a = _images(os.path.join(args.dataset_folder, "test_A"))
    test_b = _images(os.path.join(args.dataset_folder, "test_B"))
    val = None
    val_T = (data.build_transform(args.val_img_prep) if test_a and test_b
             else None)
    if test_a and test_b and mesh.is_main:
        inception = runner.init_inception(
            args, torch.Generator(device=dev).manual_seed(7))
        dino = DinoStructureLoss(cfg=dino_mod.TINY_DINO if args.tiny_model
                                 else dino_mod.DINO_VITB8, device=dev)
        val = dict(T=val_T, inception=inception, dino=dino, ref={
            "a2b": eval_unpaired.cache_reference_fid_stats(
                inception, test_b, val_T, args.output_dir, "a2b"),
            "b2a": eval_unpaired.cache_reference_fid_stats(
                inception, test_a, val_T, args.output_dir, "b2a")})

    def run_validation(step_now):
        m = {}
        for direction, paths, emb in (("a2b", test_a, emb_a2b),
                                      ("b2a", test_b, emb_b2a)):
            with torch.no_grad():
                params = unpaired.build_gen_params(state.gen, models, meta,
                                                   dtype, tp)
            fwd = translator(params, direction, emb)
            if val is None:   # a model rank beside global rank 0
                for _ in eval_unpaired.translations(
                        fwd, paths, val_T, dev, args.validation_num_images):
                    pass
            else:
                m.update(eval_unpaired.evaluate_direction(
                    fwd, paths, val["T"], val["inception"],
                    val["ref"][direction], val["dino"], args.output_dir,
                    direction, step_now,
                    max_images=args.validation_num_images))
            del params, fwd   # the merged weights, before the next one
        if val is None:
            return
        log(m, step_now)
        print(f"validation @ {step_now}: " +
              " ".join(f"{k}={v:.3f}" for k, v in m.items()), flush=True)

    noise_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t_last, eval_s, steps_run = time.time(), 0.0, 0
    for step_i, batch in zip(range(start_step, total), loader):
        src = torch.from_numpy(batch["pixel_values_src"]).to(dev)
        bsz, h, w = src.shape[:3]
        dev_batch = {
            "pixel_values_src": src,
            "pixel_values_tgt": torch.from_numpy(
                batch["pixel_values_tgt"]).to(dev),
            "emb_a2b": emb_a2b.expand(bsz, *emb_a2b.shape[1:]).contiguous(),
            "emb_b2a": emb_b2a.expand(bsz, *emb_b2a.shape[1:]).contiguous()}
        # the global batch's noise on every rank, then this rank's rows
        noise = mesh_mod.shard_batch(tuple(
            paired.draw_noise(noise_gen, bsz * mesh.world, h, w, cfgs, dtype)
            for _ in range(unpaired.NUM_NOISE)), mesh)
        metrics, _ = step_fn(state, dev_batch, noise)
        steps_run += 1

        if mesh.is_main and ((step_i + 1) % 10 == 0
                             or step_i == start_step):
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = 10.0 / max(time.time() - t_last, 1e-9)
            t_last = time.time()
            log(m, step_i + 1)
            print(f"step {step_i + 1}: " +
                  " ".join(f"{k}={v:.4f}" for k, v in m.items()), flush=True)

        # validation and viz on data rank 0 (its rows start with the
        # global batch's first pair), every model rank of it translating
        # and global rank 0 alone writing, while the others wait
        if test_a and test_b and (step_i + 1) % args.validation_steps == 0:
            t0 = time.time()
            if mesh.rank == 0:
                run_validation(step_i + 1)
            mesh_mod.barrier(mesh)
            eval_s += time.time() - t0

        if (step_i + 1) % args.viz_freq == 0:
            if mesh.rank == 0:
                with torch.no_grad():
                    params = unpaired.build_gen_params(state.gen, models,
                                                       meta, dtype, tp)
                _save_viz(args.output_dir, step_i + 1, dev_batch,
                          {d: translator(params, d, e) for d, e in
                           (("a2b", emb_a2b), ("b2a", emb_b2a))},
                          write=mesh.is_main)
                del params
            mesh_mod.barrier(mesh)

        if (step_i + 1) % args.checkpointing_steps == 0:
            # every rank: a model axis gathers the VAEs' shards (the main
            # process alone writes)
            ckpt_mod.export_cyclegan_pkl(
                os.path.join(ckpt_dir, f"model_{step_i + 1}.pkl"),
                state.gen, {"vae_a2b": models.vae_a2b,
                            "vae_b2a": models.vae_b2a}, meta, mesh)
            ckpt_mod.save_train_state(state_dir, step_i + 1, state,
                                      mesh=mesh)

    ckpt_mod.save_train_state(state_dir, total, state, mesh=mesh)
    if mesh.is_main:
        print("training done", flush=True)
    return {"start_step": start_step, "end_step": total,
            "steps_run": steps_run, "eval_seconds": eval_s}


def _save_viz(out_dir, step, dev_batch, fwd, write=True):
    """src | fake | rec for both directions, from the batch's first pair
    (train_cyclegan_turbo.py:276-289); fwd: {"a2b", "b2a"} translators.
    Saved when `write`."""
    import numpy as np
    from PIL import Image
    a = dev_batch["pixel_values_src"][:1]
    b = dev_batch["pixel_values_tgt"][:1]
    fake_b = fwd["a2b"](a)
    rec_a = fwd["b2a"](fake_b)
    fake_a = fwd["b2a"](b)
    rec_b = fwd["a2b"](fake_a)
    if not write:
        return
    rows = [np.concatenate([t[0].float().cpu().numpy() for t in row], 1)
            for row in ((a, fake_b, rec_a), (b, fake_a, rec_b))]
    grid = np.concatenate(rows, 0)
    u8 = np.clip((grid * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)
    viz_dir = os.path.join(out_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    Image.fromarray(u8).save(os.path.join(viz_dir, f"step_{step}.png"))


if __name__ == "__main__":
    from img2img_turbo_tpu_torch.utils.config_args import (
        parse_args_unpaired_training)
    main(parse_args_unpaired_training())
