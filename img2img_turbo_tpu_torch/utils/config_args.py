"""The training CLIs' argument parsers (counterpart of
`img2img_turbo_tpu/utils/config_args.py`): the reference's flags
(src/my_utils/training_utils.py:12-181) with the same names and defaults,
plus the port's own:

- `--resume` restarts from the newest `torch.save` checkpoint in
  `<output_dir>/state` (`training/checkpoint.py`);
- `--tiny_model` takes the TINY configs (smoke runs and tests);
- `--sd_turbo_path`, `--lpips_weights`, `--clip_weights` and
  `--inception_weights` name pretrained files, which the run loads;
- `--tensor_parallel M` is the model axis's size, as in the JAX CLIs:
  under `torchrun --nproc_per_node N` the ranks form a (N / M, M) mesh
  (`parallel.mesh.make_mesh(n_model=M)`), the batch split over the N / M
  data ranks and the UNet's frozen weights sharded over the M model ranks
  of each (`runner.shard_for_training`); 1 (the default) is data
  parallelism alone;
- `--allow_tf32` lets cuBLAS use TF32 for the fp32 matmuls left in a run
  (as the reference sets it); `--enable_xformers_memory_efficient_attention`
  is accepted and changes nothing (the port's attention is its own kernel).
"""

from __future__ import annotations

import argparse


def _add_common_optim(parser):
    parser.add_argument("--learning_rate", type=float, default=5e-6)
    parser.add_argument("--adam_beta1", type=float, default=0.9)
    parser.add_argument("--adam_beta2", type=float, default=0.999)
    parser.add_argument("--adam_weight_decay", type=float, default=1e-2)
    parser.add_argument("--adam_epsilon", type=float, default=1e-08)
    parser.add_argument("--lr_scheduler", type=str, default="constant")
    parser.add_argument("--lr_warmup_steps", type=int, default=500)
    parser.add_argument("--lr_num_cycles", type=int, default=1)
    parser.add_argument("--lr_power", type=float, default=1.0)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--allow_tf32", action="store_true",
                        help="let cuBLAS use TF32 for fp32 matmuls")
    parser.add_argument("--gradient_checkpointing", action="store_true")
    parser.add_argument("--enable_xformers_memory_efficient_attention",
                        action="store_true",
                        help="accepted for parity; has no effect")
    parser.add_argument("--report_to", type=str, default="wandb")
    parser.add_argument("--sd_turbo_path", type=str, default=None,
                        help="local sd-turbo snapshot (its loader is not "
                             "ported yet: giving it stops the run); random "
                             "init if omitted (smoke tests)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the newest torch.save checkpoint "
                             "in output_dir/state")
    parser.add_argument("--tensor_parallel", type=int, default=1,
                        help="model-axis size: the UNet sharded over this "
                             "many of the torchrun ranks (it must divide "
                             "them); the rest is the data axis")
    parser.add_argument("--tiny_model", action="store_true",
                        help="tiny configs for smoke tests (no pretrained)")
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="lpips.LPIPS(net='vgg') state-dict file (its "
                             "loader is not ported yet: giving it stops the "
                             "run); random LPIPS net if omitted")
    parser.add_argument("--clip_weights", type=str, default="",
                        help="OpenAI ViT-B-32.pt or HF CLIPModel state-dict "
                             "file for the vision-aided discriminator and "
                             "the CLIP-sim loss (its loader is not ported "
                             "yet: giving it stops the run)")
    parser.add_argument("--inception_weights", type=str, default="",
                        help="torchvision inception_v3 state-dict file for "
                             "FID (its loader is not ported yet: giving it "
                             "stops the run)")


def parse_args_paired_training(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gan_disc_type", default="vagan_clip")
    parser.add_argument("--gan_loss_type", default="multilevel_sigmoid_s")
    parser.add_argument("--lambda_gan", default=0.5, type=float)
    parser.add_argument("--lambda_lpips", default=5, type=float)
    parser.add_argument("--lambda_l2", default=1.0, type=float)
    parser.add_argument("--lambda_clipsim", default=5.0, type=float)

    parser.add_argument("--dataset_folder", required=True, type=str)
    parser.add_argument("--train_image_prep", default="resized_crop_512",
                        type=str)
    parser.add_argument("--test_image_prep", default="resized_crop_512",
                        type=str)

    parser.add_argument("--eval_freq", default=100, type=int)
    parser.add_argument("--track_val_fid", default=False,
                        action="store_true")
    parser.add_argument("--num_samples_eval", type=int, default=100)
    parser.add_argument("--viz_freq", type=int, default=100)
    parser.add_argument("--tracker_project_name", type=str,
                        default="train_pix2pix_turbo")

    parser.add_argument("--pretrained_model_name_or_path")
    parser.add_argument("--revision", type=str, default=None)
    parser.add_argument("--variant", type=str, default=None)
    parser.add_argument("--tokenizer_name", type=str, default=None)
    parser.add_argument("--lora_rank_unet", default=8, type=int)
    parser.add_argument("--lora_rank_vae", default=4, type=int)

    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--cache_dir", default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--train_batch_size", type=int, default=4)
    parser.add_argument("--num_training_epochs", type=int, default=10)
    parser.add_argument("--max_train_steps", type=int, default=10_000)
    parser.add_argument("--checkpointing_steps", type=int, default=500)
    parser.add_argument("--dataloader_num_workers", type=int, default=0)
    parser.add_argument("--max_grad_norm", default=1.0, type=float)
    parser.add_argument("--mixed_precision", type=str, default=None,
                        choices=["no", "fp16", "bf16"])
    parser.add_argument("--set_grads_to_none", action="store_true")
    _add_common_optim(parser)
    return parser.parse_args(input_args)


def parse_args_unpaired_training(input_args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--gan_disc_type", default="vagan_clip")
    parser.add_argument("--gan_loss_type", default="multilevel_sigmoid")
    parser.add_argument("--lambda_gan", default=0.5, type=float)
    parser.add_argument("--lambda_idt", default=1, type=float)
    parser.add_argument("--lambda_cycle", default=1, type=float)
    parser.add_argument("--lambda_cycle_lpips", default=10.0, type=float)
    parser.add_argument("--lambda_idt_lpips", default=1.0, type=float)

    parser.add_argument("--dataset_folder", required=True, type=str)
    parser.add_argument("--train_img_prep", required=True)
    parser.add_argument("--val_img_prep", required=True)
    parser.add_argument("--dataloader_num_workers", type=int, default=0)
    parser.add_argument("--train_batch_size", type=int, default=4)
    parser.add_argument("--max_train_epochs", type=int, default=100)
    parser.add_argument("--max_train_steps", type=int, default=None)

    parser.add_argument("--pretrained_model_name_or_path",
                        default="stabilityai/sd-turbo")
    parser.add_argument("--revision", default=None, type=str)
    parser.add_argument("--variant", default=None, type=str)
    parser.add_argument("--lora_rank_unet", default=128, type=int)
    parser.add_argument("--lora_rank_vae", default=4, type=int)

    parser.add_argument("--viz_freq", type=int, default=20)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--tracker_project_name", type=str, required=True)
    parser.add_argument("--validation_steps", type=int, default=500)
    parser.add_argument("--validation_num_images", type=int, default=-1)
    parser.add_argument("--checkpointing_steps", type=int, default=500)
    parser.add_argument("--max_grad_norm", default=10.0, type=float)
    _add_common_optim(parser)
    return parser.parse_args(input_args)
