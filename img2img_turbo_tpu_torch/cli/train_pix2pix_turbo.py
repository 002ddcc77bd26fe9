"""Paired (pix2pix-turbo) training CLI on one card or over several,
data-parallel and with the UNet and the VAE sharded over a model axis
(counterpart of `cli/train_pix2pix_turbo.py`; reference
`accelerate launch src/train_pix2pix_turbo.py`,
train_pix2pix_turbo.py:27-307), with resume:

    python -m img2img_turbo_tpu_torch.cli.train_pix2pix_turbo \\
        --dataset_folder data/edges --output_dir out --mixed_precision bf16
    torchrun --nproc_per_node N -m \\
        img2img_turbo_tpu_torch.cli.train_pix2pix_turbo ...
    torchrun --nproc_per_node N -m \\
        img2img_turbo_tpu_torch.cli.train_pix2pix_turbo ... \\
        --tensor_parallel M

Under torchrun each rank joins the process group from the environment
(`parallel.mesh.distributed`: NCCL when each rank has a card of its own,
gloo when ranks share one) and runs on `cuda:LOCAL_RANK`. As in the JAX CLI,
--train_batch_size is the global batch: every rank iterates the same seeded
loader and takes its contiguous rows (`data.shard`), draws the posterior
noise for the global batch and takes its rows, and the step averages each
pass's losses and gradients over the ranks before the update, so a W-rank
run computes the one-process run's steps up to summation order. The frozen
modules are built on every rank and checked to agree (a fingerprint
all-reduce); a fresh state is broadcast from rank 0, a resumed one read by
every rank and checked. Rank 0 alone logs, writes checkpoints, pkls and
viz panels and runs eval (val_fid included) while the others wait at a
barrier.

--tensor_parallel M (M dividing N) adds the model axis, as the JAX CLI's
`make_mesh(n_model=M)` does: a (N / M, M) mesh, global rank d * M + m on
data rank d and model rank m. The batch is split over the data axis only
(the M ranks of a model group take the same rows); once the frozen modules
and the state are checked to agree over the model group, the UNet's
and the VAE's frozen base weights are sharded over it
(`runner.shard_for_training`; the trainable conv_in and skip convs, the
VAE's one-head mid attentions and the other modules stay whole), and the
step runs every kernel on the rank's shards, forward and backward, as
eval and viz do forward (`training/paired.py`). The state
stays whole on every rank, so checkpoints and pkls hold no slice; the
model ranks of data rank 0 run eval and viz together, and global rank 0
alone logs and writes.

In the JAX CLI's order: seeds; the models with LoRA at --lora_rank_*
(SD-Turbo from the --sd_turbo_path snapshot with its BPE tokenizer, CLIP
from --clip_weights, LPIPS from --lpips_weights; seeded random weights for
what no flag names); AdamW from the
--adam_*, --lr_* and --max_grad_norm flags; --resume from the newest
checkpoint in <output_dir>/state; the training set through the loader,
micro-batch accumulation and a prefetch thread; the four-pass step with
accum_steps = --gradient_accumulation_steps; metrics to
<output_dir>/metrics.jsonl at the first step and every 10th, with
steps_per_sec; every --checkpointing_steps the full state
(`<output_dir>/state/<step>.pt`) and the reference-schema pkl
(`<output_dir>/checkpoints/model_<step>.pkl`); every --viz_freq an
input | prediction | target panel (`<output_dir>/viz/step_<step>.png`);
every --eval_freq the validation metrics over the test split (val_l2,
val_lpips, val_clipsim, and val_fid under --track_val_fid); a final save.

The run is on the CUDA card unless `main` is given another device (the
tests pass device="cpu"). On the card the step runs the port's Hopper
kernels, which take bf16 activations only: without --mixed_precision bf16
the run stops rather than fall back to the plain path; on the CPU the
activations follow the flag, as in JAX. --allow_tf32 lets cuBLAS use TF32
for the fp32 matmuls left (the CLIP, LPIPS and Inception towers run
plain PyTorch). Posterior noise comes from a device torch.Generator seeded
with seed + 1, the eval noise from one seeded 42 and the viz noise from
one seeded 0 (the JAX CLI's PRNGKey(seed + 1), PRNGKey(42), PRNGKey(0)).
A resumed run restarts the loader from its seed, as the JAX CLI does.
Prompts go through the snapshot's BPE tokenizer, or, without
--sd_turbo_path, `runner.SmokeTokenizer` (cli/train_pix2pix_turbo.py:34-36).
FID's Inception comes from --inception_weights when given.
"""

from __future__ import annotations

import os
import time


def _device_batch(batch, dev):
    import numpy as np
    import torch
    return {"conditioning_pixel_values": torch.from_numpy(
                batch["conditioning_pixel_values"]).to(dev),
            "output_pixel_values": torch.from_numpy(
                batch["output_pixel_values"]).to(dev),
            "input_ids": torch.from_numpy(
                batch["input_ids"].astype(np.int64)).to(dev)}


def _to_u8(img):
    """(H, W, 3) in [-1, 1] -> uint8, truncated as the JAX CLI rounds."""
    import numpy as np
    return np.clip((img * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


def main(args, device=None):
    """Train as the flags in `args` say (`parse_args_paired_training`), on
    `device` (the CUDA card when None). Returns {"start_step", "end_step",
    "steps_run", "eval_seconds"}."""
    import torch
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.training import runner

    dtype = runner.activation_dtype(args.mixed_precision,
                                    mesh_mod.local_device(device))
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
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.training import (checkpoint as ckpt_mod,
                                                  data, losses as losses_mod,
                                                  optim, paired, runner)

    if args.seed is not None:
        np.random.seed(args.seed)
    seed = args.seed or 0
    cfgs = runner.generator_configs(args)
    clip_cfg = runner.clip_config(args)
    base, tok = None, None
    if args.sd_turbo_path:
        *base, tok = runner.load_base_models(
            cfgs, torch.Generator(device=dev), args.sd_turbo_path)
    if tok is None:
        tok = runner.SmokeTokenizer(cfgs.text.vocab_size)
    runner.check_tokenizer(tok, mesh)

    # models and optimizers ----------------------------------------------
    sched = optim.make_lr_schedule(args.lr_scheduler, args.learning_rate,
                                   args.lr_warmup_steps, args.max_train_steps,
                                   args.lr_num_cycles, args.lr_power)
    adam = dict(beta1=args.adam_beta1, beta2=args.adam_beta2,
                eps=args.adam_epsilon, weight_decay=args.adam_weight_decay,
                max_grad_norm=args.max_grad_norm)
    models, state, meta = runner.build_paired_run(
        cfgs, clip_cfg, seed, dev, lr_schedule=sched, adam_kwargs=adam,
        rank_unet=args.lora_rank_unet, rank_vae=args.lora_rank_vae,
        with_clipsim=args.lambda_clipsim > 0, base=base,
        clip_weights=args.clip_weights, lpips_weights=args.lpips_weights)
    mesh_mod.assert_replicated(
        {n: getattr(models, n) for n in ("unet", "vae", "text", "lpips",
                                         "disc_backbone", "clip")
         if getattr(models, n) is not None}, mesh, "the frozen modules")

    # resume --------------------------------------------------------------
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

    # data: every rank the global batch's loader, then its rows -----------
    dataset = data.PairedDataset(args.dataset_folder, "train",
                                 args.train_image_prep, tok)
    loader = data.data_loader(dataset, args.train_batch_size, seed=seed)
    loader = data.accumulate_batches(loader,
                                     args.gradient_accumulation_steps)
    loader = data.prefetch(data.shard(loader, mesh), depth=2)
    try:
        val_dataset = data.PairedDataset(args.dataset_folder, "test",
                                         args.test_image_prep, tok)
    except FileNotFoundError:
        val_dataset = None

    # step (the UNet sharded first under a model axis) --------------------
    runner.shard_for_training(models, mesh, state)
    loss_cfg = losses_mod.PairedLossConfig(
        lambda_gan=args.lambda_gan, lambda_lpips=args.lambda_lpips,
        lambda_l2=args.lambda_l2, lambda_clipsim=args.lambda_clipsim,
        gan_loss_type=args.gan_loss_type)
    step_fn = paired.make_paired_train_step(
        models, cfgs, loss_cfg, meta, kernels=True,
        remat=args.gradient_checkpointing or not args.tiny_model,
        dtype=dtype, accum_steps=args.gradient_accumulation_steps,
        mesh=mesh)
    eval_fn = paired.make_eval_step(models, cfgs, meta, kernels=True,
                                    dtype=dtype, mesh=mesh)
    ckpt_dir = os.path.join(args.output_dir, "checkpoints")
    if mesh.is_main:
        os.makedirs(ckpt_dir, exist_ok=True)

    # clean-FID against the test targets (train_pix2pix_turbo.py:152-163)
    fid_ctx = None
    if args.track_val_fid and val_dataset is not None and mesh.is_main:
        from PIL import Image
        from img2img_turbo_tpu_torch.metrics import fid as fid_mod
        inception = runner.init_inception(
            args, torch.Generator(device=dev).manual_seed(7))
        refs = [np.asarray(val_dataset.T(Image.open(os.path.join(
            val_dataset.output_folder, name))).convert("RGB"), np.uint8)
            for name in val_dataset.img_names]
        fid_ctx = {"inception": inception, "fid": fid_mod,
                   "ref_feats": fid_mod.features_from_images(inception,
                                                             refs)}

    noise_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t_last, eval_s, steps_run = time.time(), 0.0, 0
    for step_i, batch in zip(range(start_step, args.max_train_steps),
                             loader):
        dev_batch = _device_batch(batch, dev)
        b, h, w = dev_batch["output_pixel_values"].shape[:3]
        # the global batch's noise on every rank, then this rank's rows
        noise = mesh_mod.shard_batch(tuple(
            paired.draw_noise(noise_gen, b * mesh.world, h, w, cfgs, dtype)
            for _ in range(2)), mesh)
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

        if (step_i + 1) % args.checkpointing_steps == 0:
            _save(state_dir, ckpt_dir, step_i + 1, state, meta, mesh)

        # viz and eval on data rank 0 (its rows start with the global
        # batch's first pair), every model rank of it computing and global
        # rank 0 alone writing, while the others wait
        if (step_i + 1) % args.viz_freq == 0:
            if mesh.rank == 0:
                _save_viz(args.output_dir, step_i + 1, dev_batch, state,
                          eval_fn, cfgs, dtype, write=mesh.is_main)
            mesh_mod.barrier(mesh)

        if val_dataset is not None and (step_i + 1) % args.eval_freq == 0:
            t0 = time.time()
            if mesh.rank == 0:
                _run_eval(eval_fn, state, val_dataset, args, log, step_i + 1,
                          dev, cfgs, dtype, fid_ctx, mesh.is_main)
            mesh_mod.barrier(mesh)
            eval_s += time.time() - t0

    _save(state_dir, ckpt_dir, args.max_train_steps, state, meta, mesh)
    if mesh.is_main:
        print("training done", flush=True)
    return {"start_step": start_step, "end_step": args.max_train_steps,
            "steps_run": steps_run, "eval_seconds": eval_s}


def _save(state_dir, ckpt_dir, step, state, meta, mesh):
    """The reference-schema pkl and the full state at `step`, written by
    rank 0 (`checkpoint.save_train_state` ends with a barrier)."""
    from img2img_turbo_tpu_torch.training import checkpoint as ckpt_mod
    if mesh.is_main:
        ckpt_mod.export_pix2pix_pkl(
            os.path.join(ckpt_dir, f"model_{step}.pkl"), state.gen, meta)
    ckpt_mod.save_train_state(state_dir, step, state, mesh=mesh)


def _run_eval(eval_fn, state, val_dataset, args, log, step, dev, cfgs, dtype,
              fid_ctx=None, write=True):
    """Mean validation metrics over the first --num_samples_eval test pairs
    (train_pix2pix_turbo.py:259-301), val_fid against the test targets
    under --track_val_fid; logged and printed when `write` (the other
    model ranks compute alongside)."""
    import numpy as np
    import torch
    from img2img_turbo_tpu_torch.training import data, paired
    n = min(args.num_samples_eval, len(val_dataset))
    loader = data.data_loader(val_dataset, 1, shuffle=False, epochs=1,
                              drop_last=False)
    g = torch.Generator(device=dev).manual_seed(42)
    agg, preds = {}, []
    for i, batch in enumerate(loader):
        if i >= n:
            break
        b = _device_batch(batch, dev)
        _, h, w = b["output_pixel_values"].shape[:3]
        pred, m = eval_fn(state.gen, b,
                          paired.draw_noise(g, 1, h, w, cfgs, dtype))
        for k, v in m.items():
            agg.setdefault(k, []).append(float(v))
        if fid_ctx is not None:
            preds.append(_to_u8(pred[0].float().cpu().numpy()))
    means = {k: float(np.mean(v)) for k, v in agg.items()}
    if fid_ctx is not None and preds:
        feats = fid_ctx["fid"].features_from_images(fid_ctx["inception"],
                                                    preds)
        means["val_fid"] = fid_ctx["fid"].fid_from_feats(
            feats, fid_ctx["ref_feats"])
    if write:
        log(means, step)
        print(f"eval @ {step}: " +
              " ".join(f"{k}={v:.4f}" for k, v in means.items()), flush=True)


def _save_viz(out_dir, step, dev_batch, state, eval_fn, cfgs, dtype,
              write=True):
    """input | prediction | target of the batch's first pair
    (train_pix2pix_turbo.py:244-251), saved when `write`."""
    import numpy as np
    import torch
    from PIL import Image
    from img2img_turbo_tpu_torch.training import paired
    batch1 = {k: v[:1] for k, v in dev_batch.items()}
    _, h, w = batch1["output_pixel_values"].shape[:3]
    g = torch.Generator(device=batch1["input_ids"].device).manual_seed(0)
    pred, _ = eval_fn(state.gen, batch1,
                      paired.draw_noise(g, 1, h, w, cfgs, dtype))
    if not write:
        return
    cond = batch1["conditioning_pixel_values"][0].float().cpu().numpy()
    tgt = batch1["output_pixel_values"][0].float().cpu().numpy()
    row = np.concatenate([cond * 2 - 1, pred[0].float().cpu().numpy(), tgt],
                         axis=1)
    viz_dir = os.path.join(out_dir, "viz")
    os.makedirs(viz_dir, exist_ok=True)
    Image.fromarray(_to_u8(row)).save(os.path.join(viz_dir,
                                                   f"step_{step}.png"))


if __name__ == "__main__":
    from img2img_turbo_tpu_torch.utils.config_args import (
        parse_args_paired_training)
    main(parse_args_paired_training())
