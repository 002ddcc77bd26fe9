"""Chip smoke for the PyTorch port: the three serving modes, the paired
(pix2pix-turbo) and unpaired (CycleGAN-Turbo) training steps, the weight
loaders and both inference CLIs, both training CLIs, the public attention
op, data parallelism and the model axis (serving and both training steps)
on torch.distributed, the profiling helpers, the web demo and the parity
and conversion CLIs on one GPU.

    python3 chip_smoke.py    # one CUDA card

Phases, each fatal on failure:
1. build every CUDA kernel of the package from `csrc/` (nvcc, sm_90a);
2. kernel phase: each kernel wrapper against its plain PyTorch version on
   the card, at the main paths' shapes, in bf16, with stated tolerances.
   Errors are taken against the exact plain version (`*_ref`, fp32 with one
   rounding); times against the composition the plain path runs
   (`*_plain`, `mha_ref`, or autograd through `mha_ref` for K7), beside
   the least time the card could take (`bound_ms`, from the H100's
   published peaks) and, where one PyTorch call computes the same function,
   that call's time (`library_ms`, timed here, never called by the port).
   K1's forward and K4 run every shape of a 512x512 request, a train step
   and an 840x560 request (tools/time_kernels.py K1_CASES, K4_CASES), each
   with the form the engine picks (`conv_plan`), its stats and a
   bit-identical repeat, K1 beside cuDNN's conv alone on the activated
   input; the run fails unless every form ran, and their times are
   weighted per 512x512 request and per train step by the launches their
   wrappers counted by shape, which must match those tables.
   K2 runs every attention shape of the paths, each with its launch plan
   (grid and waves, as the library reports it), and its times are also
   weighted by the launches the wrapper counted at each shape in one
   512x512 request and one train step (`per_request`, `per_step`). For K2
   and K9 each case also reports the kernel's device time alone (a CUDA
   graph of 20 calls), the host time of one call and, of that, the
   library's set-up (shared-memory limit and tensor-map encodes). K3 runs
   every launch shape of the paths (nn.Linear's (Co, C) weights), each
   with its launch plan, its device time alone and the time of F.linear on
   the same input and weights, and its times are weighted by the launches
   its wrapper counted at each shape on every path (`per_request` at
   512x512 and 840x560, image, sketch, `per_step`); K8's du (a kernel of
   its own, on the forward's packed weight) runs at every shape of the
   train step and three more, and its times are weighted by the
   launches its wrapper counted at each shape in one train step
   (`per_step`). K6 runs every downsample shape of the paths and one that
   takes its last form, each with the form its library picks
   (`downsample_plan`), a bit-identical repeat and its stats (split or
   not); its times are weighted per 512x512 request and per train step, and
   K7's, beside SDPA's backward, per train step at each head dim, by the
   launches their wrappers counted by shape, which must match
   tools/time_kernels.py's tables. K7 runs every attention shape of the
   train step, four hd-64 edge cases (batch 2, a ragged Sq = Skv = 4000,
   Sq = 1000 and Sq = 37 against Skv = 77) and three hd-512 ones (the
   ragged S = 7350, Sq = 300 against Skv = 333 at B = H = 2, and S =
   16384, which walks bands of Q rows), each with its launch plan
   (`flash_attention_bwd_plan`) and a bit-identical repeat; the run fails
   unless both a split and an unsplit hd-64 dk/dv walk ran, and both a
   one-band and a banded hd-512 call. K5 (`group_norm_coeffs`: the
   partial-stats and combine kernels from one host call) runs its four
   cases against the exact plain versions, its partials too, with a
   bit-identical repeat; its combine alone runs on stats K1 emitted at
   four path shapes. Every case of every kernel reports its device time
   alone (a CUDA graph of 20 calls), and of its library call where it has
   one. Each kernel also runs every shape of the unpaired step that no
   case above runs (tools/time_kernels.py's `*_UNPAIRED` tables, summed
   apart as part "unpaired"), with the same checks; after the unpaired
   phase every kernel's times are weighted per unpaired step by the
   launches its wrapper counted by shape there (`per_unpaired_step`),
   which must match those tables;
3. attention path: `ops.attention.default_attention` (K9) at the UNet's
   (B, H, S, 64) shapes, its launches counted around those calls alone;
4. engine phase: `ServingEngine(mode="edge_to_image")` at the full
   SD-Turbo widths with seeded random weights, serving 512x512 b1 requests
   and one 840x560 request, checked for shape, range, determinism, launch
   counts and agreement with the plain path on the same weights;
5. modes phase: `ServingEngine(mode="image")` on a random CycleGAN-Turbo
   model in both directions and `ServingEngine(mode="sketch")` on a random
   factored pix2pix-turbo model at r = 0.4 and 1.0, 512x512 b1, each with
   the engine phase's checks, and a2b != b2a, r = 0.4 != r = 1.0, r = 1.0
   ignoring the noise map;
6. train phase: the paired step at full width (SD-Turbo UNet and VAE with
   LoRA, OpenCLIP-H text encoder, CLIP ViT-B/32, VGG16 LPIPS), 512x512 b1,
   bf16 activations, fp32 master weights, UNet blocks recomputed; a
   warm-up step and three timed steps with kernels and as many plain from
   the same seeded state, checked
   for finite losses, moved trainables and unmoved frozen weights, launch
   counts, pass-1 gradient agreement between the paths and a bit-identical
   repeated step;
7. unpaired phase: the CycleGAN-Turbo step at full width (SD-Turbo UNet
   with its three rank-128 LoRA adapters, two VAEs with LoRA and skip
   convs, two discriminators on CLIP ViT-B/32, VGG16 LPIPS), 256x256 b1,
   fixed random caption embeddings, bf16 activations, fp32 masters, UNet
   remat; a warm-up and three timed steps with kernels and as many plain,
   with the train phase's checks (the cycle pass's gradients in place of
   pass 1's, held against a plain step in fp32; both discriminators'
   heads), its p50 and peak memory.
8. weights phase: a full-width stabilityai/sd-turbo snapshot written in
   the HF layout to a temporary directory with the port's own safetensors
   writer (seeded random UNet, VAE and OpenCLIP-H text tower in fp16, as
   sd-turbo's fp16 variant stores them, the text encoder with its
   `text_model.` prefix and position_ids, a synthetic BPE tokenizer), and
   three pkls written by the port's exporters (edge_to_image at ranks 8 / 4
   with random B, a retrained conv_in and skip convs; the sketch model with
   a TwinConv conv_in; CycleGAN-Turbo at rank 128 / 4 with both VAEs).
   Each file read alone (wall, GB, GB/s); `Pix2PixTurbo.load_pretrained`
   (deterministic and stochastic) and `CycleGANTurbo.load_pretrained`, every
   loaded tensor equal to the file's, upcast from fp16, and every merged one
   within 1e-6 of `lora.merge_lora` / `merge_multi` of the written factors;
   peak memory. Then both inference CLIs in-process through `main` with
   --use_fp16 on a 517x389 PNG (edge_to_image, sketch at --gamma 0.4,
   CycleGAN by --model_path --prompt --direction a2b): each PNG at its
   size, equal bit for bit to the pipeline called directly on the same
   prepared input and seed, that pipeline's kernel path within
   PATH_REL_L2_TOL of its plain path, K1-K6 launched and no backward
   kernel; each CLI's wall and its time to the first image after load;
9. CLI phase: both training CLIs in-process through their `main`, at
   full SD-Turbo width, the pix2pix runs from the weights phase's
   snapshot with its BPE tokenizer (CycleGAN on seeded random weights), on
   two small synthetic
   datasets written to a temporary directory: pix2pix-turbo (4 train and
   2 test pairs at 512x512, bf16, 3 steps with a checkpoint at 2, eval
   with val_fid and a viz panel at 3), then the same run resumed to step
   4; CycleGAN-Turbo (4 + 4 train and 2 + 2 test images at 256x256, 3
   steps with validation (FID and DINO-Struct in both directions), a viz
   panel and a checkpoint at 3), then resumed at 3, which restores the
   state and takes no step. Checked: finite metrics.jsonl rows with the
   JAX CLIs' keys, the checkpoints and the reference-schema pkls (loaded
   with torch.load, their keys), the viz and validation PNGs, the resumed
   run's first and last step, and the launch counters: in each run K7's
   and K8's du launches equal its steps times the per-step counts of
   phases 6 and 7 exactly (eval, viz and validation run no backward), and
   K1-K6 launch at least that. Each run's wall time, its eval or
   validation time and its peak memory are printed.
10. DP phase (after phase 7, the train and unpaired models freed): data
   parallelism on torch.distributed, two gloo ranks sharing the card
   (spawned, `file://` rendezvous in a temporary directory; the exchange
   goes through the host, so its times are not NCCL's). Each rank: (a) the
   paired step at full width, 512x512 b1 a rank, seeds as phase 6's, tiled
   (both ranks phase 6's row and noise): every trainable, both AdamW
   moments, the heads and the spectral-norm vectors bit-identical to the
   same process's step without a mesh and across the ranks (a fingerprint
   all-reduce), the metrics equal, the launch table that step's and
   EXPECTED_TRAIN_LAUNCHES; then distinct rows (rank r row r of the global
   batch and its noise), a warm-up and TRAIN_STEPS timed steps, finite
   metrics, the state identical across ranks, the all-reduce timed (per
   pass, and its bytes); (c) rank 0: NCCL at world size 1 (a one-rank NCCL
   group beside the gloo world), the step through `mesh=` bit-identical to
   the step without a mesh; (b) the unpaired step at full width, 256x256
   b1 a rank, tiled, the same identity checks, launches
   EXPECTED_UNPAIRED_LAUNCHES; (d) `ServingEngine(mode="edge_to_image",
   mesh=...)`, a global batch of 2 at 512x512: each rank's rows equal bit
   for bit to the engine without a mesh on those rows and the global
   noise's rows, the gathered batch the same on both ranks, the launches a
   b1 request's. Frozen modules and engine weights are checked to agree
   across ranks;
11. tools phase (after phase 9, on phase 8's files): `utils/profiling.
   device_time_per_call` on one 512x512 request beside
   `training/profile_step.py`'s profile of it, `device_memory_stats`;
   `serving/web_demo.launch_in_thread` on the full-width edge (merged) and
   sketch (factored) models, one POST /api/canny and one POST /api/sketch
   at 512x512, each response equal bit for bit to the direct
   `CannyDemo.process` / `SketchDemo.run`; `cli/convert_weights` on the
   snapshot and the edge pkl, read back (`weights/native.load_native`)
   equal tensor for tensor to `Pix2PixTurbo.load_pretrained`, with its
   write and read times and GB; `cli/accept_parity` on the snapshot and
   the edge pkl against phase 8's edge PNG (its CLI run seeded 0, the
   generator accept_parity draws from) with random LPIPS, below 1e-3;
12. model-axis phase (after phase 10, before phase 8; the earlier models
   freed): two gloo ranks sharing the card at mesh (1, 2) (spawned as
   phase 10's; the exchange goes through the host, so its times are not
   NCCL's). Each rank serves edge_to_image at full width on phase 4's
   weights (seed 1234) and image a2b on phase 5's CycleGAN (seed 2345),
   512x512 b1: first the one-process kernel-path engine on fixed
   posterior noise, then `ServingEngine(mesh=make_mesh(1, 2))` on the
   same weights, its UNet sharded in place. Checked: the UNet holds only
   this rank's shards (every parameter's shape against the rule, its bytes
   beside the whole's); the image within PATH_REL_L2_TOL of the
   one-process request (x0's rel L2 and the uint8 levels printed); both
   ranks' results bit-identical and a repeat bit-identical; the launch
   table the one-process request's and EXPECTED_LAUNCHES (K2 on the
   local heads). Edge_to_image prints its p50 of 5 requests and the
   collectives' calls, bytes and time a request. Then every kernel runs
   each launch shape of the ranks that the one-process requests and no
   case ran (the shards' channel counts) against its `*_ref`, part
   "model_axis" of the kernels line.
13. model-axis training phase (after phase 12): two gloo ranks sharing the
   card at mesh (1, 2), spawned likewise. Each rank builds phase 6's
   paired run (seed 4321, 512x512 b1) and then phase 7's unpaired run
   (seed 5432, 256x256 b1), shards the UNet and the VAE(s)
   (`runner.shard_for_training`: conv_in, the skip convs and the VAE's
   one-head mid attentions whole) and runs the step on that
   phase's first row and noise, then TP_TRAIN_STEPS more (one: a step
   moves 12.7 / 14.1 GB through the host) and one with the collectives
   timed.
   Checked: the UNet and each VAE hold only the rank's shards (shapes by
   `parallel.tensor`'s rule, bytes beside the whole's); every trainable, head, spectral-norm
   vector and AdamW moment bit-identical across the model ranks after the
   first and the last step (`mesh.differing` over the model group); the
   losses, first-pass gradients and the state after the first step
   against phases 6 and 7's one-process kernel-path first step from the
   same state (TP_LOSS_TOL, GRAD_REL_L2_TOL overall and per part, and the
   trainables' rule beside TP_FLIP_FRAC); the launch table that step's and
   EXPECTED_TRAIN_LAUNCHES / EXPECTED_UNPAIRED_LAUNCHES, the du's launches
   by shape the one-process table's with the UNet's and the VAE's Co
   halved (the UNet conv_out's Co = 2 and the VAE encoder conv_out's
   Co = 4 among them; the VAE decoder's conv_out, Co = 3, whole) and K7's
   with the UNet's heads halved where they split. Each prints UNet and
   VAE bytes a rank, the time of the untimed step (a p50 if
   TP_TRAIN_STEPS > 1), peak memory and the collectives a step
   (calls, bytes, time). Then every kernel runs each launch shape of the
   ranks that no case ran against its `*_ref` (part "model_axis"; the
   du's "du_model_axis"): K1 on the VAE's Co slices (4 to 256, with and
   without a 1x1 skip sliced to them), K4 with a sliced skip, K6 at Co
   64 to 256, K8's du at Co = 2 and 4 and K7 on local heads among them.
Each of these phases prints its numbers with the card's name and power
limit.

Prints the card's name and power limit, a JSON line with every kernel's
error and times, and as its last line {"ok": true, "device": {...}}. Exits
non-zero, with no result line, when no CUDA device is present or any check
fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time


def _fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# K2's cases beyond K7's (tools/time_kernels.py, every attention shape of
# the paired step): the 840x560 request's ragged ones (Sq = Skv = 7350) and
# one batch-2 case that crosses the batch stride.
K2_EXTRA_CASES = [
    ("unet ragged self S=7350 H=5", 1, 7350, 7350, 5, 64),
    ("vae mid ragged hd=512 S=7350", 1, 7350, 7350, 1, 512),
    ("unet self S=1024 H=10 B=2", 2, 1024, 1024, 10, 64)]
# (B, H, S, 64) attention at the UNet's shapes, through default_attention:
# (case, B, H, Sq, Skv)
K9_CASES = [
    ("self S=4096 H=5", 1, 5, 4096, 4096),
    ("cross S=4096 Skv=77 H=5", 1, 5, 4096, 77),
    ("ragged S=7350 H=5", 1, 5, 7350, 7350),
    ("self S=1024 H=10", 1, 10, 1024, 1024),
    ("ragged S=1089 H=2", 1, 2, 1089, 1089)]
# K7's edge cases beyond K7_CASES: (case, B, Sq, Skv, H, hd). At hd 512:
# the 840x560 request's ragged S = 7350, a small ragged case with two
# batches and two heads that runs every mask of both kernels, and the VAE
# mid attention of a 1024^2 image, S = 16384, whose P and dS take bands.
K7_EDGE_CASES = [
    ("edge self S=1024 H=10 B=2", 2, 1024, 1024, 10, 64),
    ("edge ragged self S=4000 H=5", 1, 4000, 4000, 5, 64),
    ("edge split cross Sq=1000 Skv=77 H=10", 1, 1000, 77, 10, 64),
    ("edge cross Sq=37 Skv=77 H=10", 1, 37, 77, 10, 64),
    ("edge hd=512 ragged S=7350", 1, 7350, 7350, 1, 512),
    ("edge hd=512 Sq=300 Skv=333 H=2 B=2", 2, 300, 333, 2, 512),
    ("edge hd=512 banded S=16384", 1, 16384, 16384, 1, 512)]
REL_TOL = 1e-2      # kernel vs plain, bf16 output: max|err| / max|ref|
STATS_TOL = 1e-3    # folded GN (a, b): emitted stats vs stats of the same y
LSE_TOL = 1e-3      # K2's logsumexp (fp32) vs the fp32 plain version, abs

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# full 700 W): the least time for a call is the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over the bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
NUM_SMS = 132


def _bound(flops: float, nbytes: float):
    """(bound_ms, bound_by) of a call."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _attention_lib():
    """csrc/attention.cu's report entry points: the launch plan of a call
    and the host time of its set-up."""
    import ctypes
    from img2img_turbo_tpu_torch.ops import _build
    lib = _build.load("attention")
    lib.flash_attention_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_plan.restype = ctypes.c_int
    lib.flash_attention_setup_ns.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 6
    lib.flash_attention_setup_ns.restype = ctypes.c_double
    return lib


def _attention_report(lib, B, Sq, Skv, H, hd, q, k, v, call) -> dict:
    """Print and return a K2/K9 case's launch plan (from the library), the
    kernel's device time alone, the host time of one `call` and the
    library's set-up time within it (folded layout)."""
    import ctypes
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.tools.time_kernels import (
        device_ms, host_us)
    plan = (ctypes.c_int * 5)()
    if lib.flash_attention_plan(B, H, Sq, hd, plan):
        _fail(f"flash_attention_plan refused hd={hd}")
    grid, rows, slices = tuple(plan[:3]), plan[3], plan[4]
    blocks = math.prod(grid)
    setup_ns = lib.flash_attention_setup_ns(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), B, Sq, Skv, H, hd, 200)
    if setup_ns < 0:
        _fail(f"flash_attention_setup_ns failed with {-setup_ns:.0f}")
    dev_ms, call_us = device_ms(call), host_us(call)
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f}ms"
    print(f"  {'':26s} {rows} query rows x {slices} column slices a block, "
          f"grid {grid}, {blocks} blocks = {blocks / NUM_SMS:.2f} waves on "
          f"{NUM_SMS} SMs; device {dev} a call (CUDA graph of 20), host "
          f"{call_us:.1f}us a call, set-up {setup_ns / 1e3:.2f}us of it",
          flush=True)
    return dict(grid=grid, device_ms=dev_ms, host_us=call_us,
                setup_us=setup_ns / 1e3)


def _unseen(rows, seen, lo: int, hi: int) -> list:
    """The rows of `rows` whose shape (columns lo:hi) no row of `seen`
    has: the unpaired step's cases that no earlier case runs."""
    have = {tuple(r[lo:hi]) for r in seen}
    return [r for r in rows if tuple(r[lo:hi]) not in have]


def _rel(a, b) -> tuple:
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    scale = max(b.abs().max().item(), 1e-6)
    if not math.isfinite(err):
        err = float("inf")
    return err, err / scale


def kernel_phase(dev, results: list):
    import ctypes

    import torch
    import torch.nn.functional as F
    from img2img_turbo_tpu_torch.models import layers
    from img2img_turbo_tpu_torch.ops import (
        _build, attention, fused_conv as fc, fused_matmul as fm,
        groupnorm as gn)
    from img2img_turbo_tpu_torch.tools.time_kernels import (
        DU_CASES, DU_UNPAIRED, K1_CASES, K1_PATH_CASES, K1_UNPAIRED,
        K3_SHAPES, K3_UNPAIRED_SHAPES, K4_CASES, K4_UNPAIRED, K5_CASES,
        K5_UNPAIRED_CASES, K6_CASES, K6_PATH_CASES, K6_UNPAIRED, K7_CASES,
        K7_UNPAIRED, conv_alone, device_ms, k3_name,
        one_call_ms as _time_ms, sdpa, sdpa_backward)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def oihw(w):
        """HWIO (3, 3, C, Co) or (C, Co) -> nn.Conv2d's (Co, C, kh, kw)."""
        w = w if w.ndim == 4 else w[None, None]
        return w.permute(3, 2, 0, 1).contiguous()

    def record(name, route, source, replaces, case, err, rel, tol, ms,
               plain_ms, flops, nbytes, library_ms=None, library=None,
               part=None, device_ms=None, library_device_ms=None, **extra):
        ok = rel <= tol
        bound_ms, bound_by = _bound(flops, nbytes)
        lib = ("" if library_ms is None
               else f" {library}={library_ms:.4f}ms")
        devs = "".join(f" {k}={v:.4f}ms" for k, v in (
            ("device", device_ms), ("library_device", library_device_ms))
            if v is not None)
        print(f"  {name:26s} {case:44s} max_abs={err:.3e} rel={rel:.3e} "
              f"tol={tol:.0e} kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
              f"bound={bound_ms:.4f}ms({bound_by}){lib}{devs} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        torch.cuda.synchronize()
        if not ok:
            _fail(f"{name} {case}: rel err {rel:.3e} > {tol:.0e}")
        results.append(dict(name=name, route=route, source=source,
                            replaces=replaces, case=case, max_abs_err=err,
                            rel_err=rel, ms=ms, plain_ms=plain_ms,
                            device_ms=device_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms,
                            library_device_ms=library_device_ms,
                            library=library, part=part, **extra))

    # ---- K1: every forward shape of the paths (tools/time_kernels.py
    # K1_CASES: a 512x512 request, a train step and an 840x560 request),
    # each with the form the engine picks (`conv_plan`), against the exact
    # version with its stats, and a repeated call bit-identical; timed as
    # its path calls it (stats or not) beside the plain path's composition
    # and cuDNN's conv alone on the activated input (`conv_alone`, not K1's
    # function: no library call computes K1's). The run fails unless every
    # form ran: the 16 x 8 and 32 x 8 tiles, the small-N form (Co <= 32),
    # the 16-channel form (C not a multiple of 8), split and unsplit.
    k1 = ("fused_gn_silu_conv3x3", "cuda",
          "img2img_turbo_tpu_torch/csrc/conv.cu",
          "img2img_turbo_tpu/ops/fused_conv.py:1083")
    k1_forms = set()

    def form_str(f):
        return (f"{f['tile_rows']}x8 tile, {f['channels_a_block']} channels a "
                f"block, {f['channels_a_step']}-channel steps (skip "
                f"{f['skip_channels_a_step']}), {f['blocks_an_sm']} block(s) "
                f"an SM, {f['stages']}-stage ring, {f['splits']} split(s) of "
                f"{f['units_a_split']} units, {f['blocks']} blocks")

    def check_stats(name, case, y, st, count):
        co = y.shape[-1]
        one = torch.ones(co, device=dev)
        zero = torch.zeros(co, device=dev)
        ng = 32 if co % 32 == 0 else 1
        ca = gn.combine_stats(st, one, zero, ng, 1e-6, count)
        cr = gn.combine_stats(fc.output_stats(y), one, zero, ng, 1e-6, count)
        serr = max(_rel(ca[0], cr[0])[1], _rel(ca[1], cr[1])[1])
        if not serr <= STATS_TOL:
            _fail(f"{name} {case}: stats rel err {serr:.3e} > {STATS_TOL:.0e}")
        return serr

    def k1_case(case, B, H, W, C, Co, norm, has_eb, has_res, csk, stats,
                part):
        form = fc.conv_plan(B, H, W, C, Co, csk)
        k1_forms.add(f"{form['tile_rows']}x8")
        k1_forms.add("split" if form["splits"] > 1 else "unsplit")
        if form["channels_a_block"] < 128:
            k1_forms.add("small-N")
        if form["channels_a_step"] == 16:
            k1_forms.add("16-channel")
        x = rn(B, H, W, C)
        w = rn(3, 3, C, Co, scale=1 / math.sqrt(9 * C))
        bias = rn(Co, scale=0.1, dtype=torch.float32)
        a = b = eb = res = skx = skw = None
        if norm:
            a = 1 + 0.1 * rn(B, C, dtype=torch.float32)
            b = 0.1 * rn(B, C, dtype=torch.float32)
        if has_eb:
            eb = rn(B, Co, dtype=torch.float32)
        if has_res:
            res = rn(B, H, W, Co)
        if csk:
            skx = rn(B, H, W, csk)
            skw = rn(csk, Co, scale=1 / math.sqrt(csk))
        wp = fc.pack_weights(w)
        skwp = None if skw is None else fc.pack_weights(skw)

        def call(st=stats):
            return fc.fused_gn_silu_conv3x3(
                x, w, bias, a, b, eb, res, skx, skw, emit_stats=st,
                w_packed=wp, skip_w_packed=skwp)
        y, st = call(True)
        y2, st2 = call(True)
        if not (torch.equal(y, y2) and torch.equal(st, st2)) or \
                not torch.equal(y, call(False)[0]):
            _fail(f"K1 {case}: a repeated call, or one without stats, gave "
                  f"another y or stats")
        yr, _ = fc.conv3x3_ref(x, w, bias, a, b, eb, res, skx, skw)
        err, rel = _rel(y, yr)
        serr = check_stats("K1", case, y, st, H * W)
        ms, dev_ms = _time_ms(call), device_ms(call)
        w_oihw = oihw(w)
        skw_oihw = None if skw is None else oihw(skw)
        pms = _time_ms(lambda: fc.gn_silu_conv3x3_plain(
            x, w_oihw, bias, a, b, eb, res, skx, skw_oihw))
        alone = conv_alone(x, w, a, b)
        alone_ms, alone_dev = _time_ms(alone), device_ms(alone)
        flops = 2 * B * H * W * Co * (9 * C + csk)
        nbytes = _nbytes(x, wp, bias, a, b, eb, res, skx, skwp, y,
                         st if stats else None)
        lms = lib = lib_dev = None
        if not (norm or has_eb or has_res or csk or stats):
            # one cuDNN convolution with its bias computes the same
            xc, bb = x.permute(0, 3, 1, 2), bias.to(bf)
            lib_call = lambda: F.conv2d(xc, w_oihw, bb,  # noqa: E731
                                        padding=1)
            lms, lib_dev = _time_ms(lib_call), device_ms(lib_call)
            lib = "F.conv2d"
        print(f"  {'':26s} {case}: {form_str(form)}; stats rel "
              f"{serr:.1e}, repeat bit-identical; device {dev_ms:.4f}ms, "
              f"conv alone device {alone_dev:.4f}ms", flush=True)
        record(*k1, case, err, rel, REL_TOL, ms, pms, flops, nbytes, lms,
               lib, device_ms=dev_ms, library_device_ms=lib_dev,
               conv_alone_ms=alone_ms, conv_alone_device_ms=alone_dev,
               shape=(B, H, W, C, Co, norm, has_eb, has_res, csk, stats),
               form=form, part=part)

    k1_rows = K1_CASES + _unseen(K1_UNPAIRED, K1_CASES, 1, 11)
    for idx, (case, *shape) in enumerate(k1_rows):
        k1_case(case, *shape[:10], None if idx < K1_PATH_CASES else "forms"
                if idx < len(K1_CASES) else "unpaired")
    every = {"16x8", "32x8", "small-N", "16-channel", "split", "unsplit"}
    if k1_forms != every:
        _fail(f"K1 ran the forms {sorted(k1_forms)} of {sorted(every)}: add "
              f"a case to tools/time_kernels.py K1_CASES that takes the rest")

    # ---- K8's du: the input gradient of the train step's fused GN convs
    # at every shape the step runs (and three it does not), the du kernel
    # reading the forward's packed weight as it is
    # (fc.conv3x3_input_grad), recorded under K1, the kernel the JAX
    # package runs for it. The exact version is the fp32 transposed conv of
    # the nn.Conv2d weight, so a wrong tap order or channel swap fails here;
    # the plain time is the plain path's transposed conv on the unpacked
    # weight, the library's cuDNN's on the nn.Conv2d one; device time alone
    # from a CUDA graph of 20 calls.
    conv_lib = fc._lib()
    conv_lib.conv_dgrad_plan.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    form = (ctypes.c_int * 6)()

    def du_case(case, B, H, W, C, Co, part):
        conv_lib.conv_dgrad_plan(B, H, W, C, Co, form)
        gy = rn(B, H, W, Co)
        w = rn(Co, C, 3, 3, scale=1 / math.sqrt(9 * C))   # nn.Conv2d's
        wp = fc.pack_weights(layers._hwio(w))              # as the forward
        du = fc.conv3x3_input_grad(gy, wp, C)
        dur = F.conv_transpose2d(gy.float().permute(0, 3, 1, 2), w.float(),
                                 padding=1).permute(0, 2, 3, 1)
        err, rel = _rel(du, dur)
        call = lambda: fc.conv3x3_input_grad(gy, wp, C)  # noqa: E731
        ms, dev_ms = _time_ms(call), device_ms(call)
        pms = _time_ms(lambda: fc.conv3x3_input_grad_plain(gy, wp, C))
        gyc = gy.permute(0, 3, 1, 2)
        lib_call = lambda: F.conv_transpose2d(gyc, w, padding=1)  # noqa: E731
        lms, lib_dev = _time_ms(lib_call), device_ms(lib_call)
        flops = 2 * B * H * W * C * 9 * Co
        nbytes = _nbytes(gy, wp, du)
        print(f"  {'':26s} {case}: {16 * form[1]}x8 pixel tiles, "
              f"{form[0]} channels a step, {form[5]} blocks ({form[2]} an SM), "
              f"{form[3]} split(s) of {form[4]} chunks; device "
              f"{dev_ms:.4f}ms, F.conv_transpose2d device {lib_dev:.4f}ms",
              flush=True)
        record(*k1, case, err, rel, REL_TOL, ms, pms, flops, nbytes, lms,
               "F.conv_transpose2d", part=part, device_ms=dev_ms,
               library_device_ms=lib_dev, shape=(B, H, W, C, Co))

    for (case, B, H, W, C, Co, _), part in (
            [(c, "du") for c in DU_CASES]
            + [(c, "du_unpaired") for c in _unseen(DU_UNPAIRED, DU_CASES, 1,
                                                    6)]):
        du_case(case, B, H, W, C, Co, part)

    # ---- K4: every upsample of the paths (K4_CASES), each with its form,
    # against the exact version with its stats, a repeat bit-identical;
    # the run fails unless both a split and an unsplit call ran
    k4 = ("upsample2x_conv3x3", "cuda", "img2img_turbo_tpu_torch/csrc/conv.cu",
          "img2img_turbo_tpu/ops/fused_conv.py:1758")
    k4_splits = set()

    def k4_case(case, B, H, W, C, Co, csk, stats, part):
        form = fc.conv_plan(B, H, W, C, Co, csk, up=True)
        k4_splits.add(form["splits"] > 1)
        x = rn(B, H, W, C)
        w = rn(3, 3, C, Co, scale=1 / math.sqrt(9 * C))
        wp = fc.pack_weights(fc.fold_upsample_weights(w))
        bias = rn(Co, scale=0.1, dtype=torch.float32)
        skx = skw = None
        if csk:
            skx = rn(B, 2 * H, 2 * W, csk)
            skw = rn(csk, Co, scale=1 / math.sqrt(csk))
        skwp = None if skw is None else fc.pack_weights(skw)

        def call(st=stats):
            return fc.upsample2x_conv3x3(x, w, bias, skx, skw, emit_stats=st,
                                         w_packed=wp, skip_w_packed=skwp)
        y, st = call(True)
        y2, st2 = call(True)
        if not (torch.equal(y, y2) and torch.equal(st, st2)) or \
                not torch.equal(y, call(False)[0]):
            _fail(f"K4 {case}: a repeated call, or one without stats, gave "
                  f"another y or stats")
        yr, _ = fc.upsample2x_conv3x3_ref(x, w, bias, skx, skw)
        err, rel = _rel(y, yr)
        serr = check_stats("K4", case, y, st, 4 * H * W)
        ms, dev_ms = _time_ms(call), device_ms(call)
        w_oihw = oihw(w)
        skw_oihw = None if skw is None else oihw(skw)
        pms = _time_ms(lambda: fc.upsample2x_conv3x3_plain(
            x, w_oihw, bias, skx, skw_oihw))
        # four phases of 2x2 taps on the low-resolution input
        flops = 2 * B * 4 * H * W * Co * (4 * C + csk)
        nbytes = _nbytes(x, wp, bias, skx, skwp, y, st if stats else None)
        print(f"  {'':26s} {case}: {form_str(form)} (a tile of the "
              f"low-resolution input, four phases); stats rel {serr:.1e}, "
              f"repeat bit-identical; device {dev_ms:.4f}ms", flush=True)
        record(*k4, case, err, rel, REL_TOL, ms, pms, flops, nbytes,
               device_ms=dev_ms, shape=(B, H, W, C, Co, csk, stats),
               form=form, part=part)

    for idx, (case, *shape) in enumerate(
            K4_CASES + _unseen(K4_UNPAIRED, K4_CASES, 1, 8)):
        k4_case(case, *shape[:7], None if idx < len(K4_CASES)
                else "unpaired")
    if k4_splits != {False, True}:
        _fail(f"K4 did not run both a split and an unsplit call (split seen: "
              f"{sorted(k4_splits)})")

    # ---- K6: every downsample shape of the paths, and one more at which
    # the kernel takes the 32 x 8 tile with a split (summed apart, as
    # "forms"); each case prints its form (down_form, through
    # downsample_plan), and a repeated call must give the same y and stats
    # bit for bit. The stats are checked on every case, split or not.
    k6 = ("downsample2x_conv3x3", "cuda",
          "img2img_turbo_tpu_torch/csrc/conv.cu",
          "img2img_turbo_tpu/ops/fused_conv.py:1408")
    conv_lib.downsample_plan.argtypes = [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int)]
    k6_plan = (ctypes.c_int * 7)()
    forms = set()

    def k6_case(case, B, H, W, C, Co, pad_lo, stats, part):
        conv_lib.downsample_plan(B, H, W, C, Co, pad_lo, k6_plan)
        forms.add((k6_plan[0], k6_plan[3] > 1))
        x = rn(B, H, W, C)
        w = rn(3, 3, C, Co, scale=1 / math.sqrt(9 * C))
        bias = rn(Co, scale=0.1, dtype=torch.float32)
        wp = fc.pack_weights(w)
        y, st = fc.downsample2x_conv3x3(x, w, bias, pad_lo, emit_stats=True,
                                        w_packed=wp)
        y2, st2 = fc.downsample2x_conv3x3(x, w, bias, pad_lo,
                                          emit_stats=True, w_packed=wp)
        y_ns, _ = fc.downsample2x_conv3x3(x, w, bias, pad_lo, w_packed=wp)
        yr, _ = fc.downsample2x_conv3x3_ref(x, w, bias, pad_lo)
        if y.shape != yr.shape or not torch.equal(y, y_ns):
            _fail(f"K6 {case}: output {tuple(y.shape)} (ref "
                  f"{tuple(yr.shape)}) or differs without stats")
        if not (torch.equal(y, y2) and torch.equal(st, st2)):
            _fail(f"K6 {case}: a repeated call gave another y or stats")
        err, rel = _rel(y, yr)
        ho, wo = y.shape[1:3]
        one, zero = torch.ones(Co, device=dev), torch.zeros(Co, device=dev)
        ca = gn.combine_stats(st, one, zero, 32, 1e-6, ho * wo)
        cr = gn.combine_stats(fc.output_stats(y), one, zero, 32, 1e-6,
                              ho * wo)
        serr = max(_rel(ca[0], cr[0])[1], _rel(ca[1], cr[1])[1])
        if serr > STATS_TOL:
            _fail(f"K6 {case}: stats rel err {serr:.3e} > {STATS_TOL:.0e}")
        # timed as its path calls it: with stats in the VAE, without in
        # the UNet
        call = lambda: fc.downsample2x_conv3x3(  # noqa: E731
            x, w, bias, pad_lo, emit_stats=stats, w_packed=wp)
        ms, dev_ms = _time_ms(call), device_ms(call)
        w_oihw = oihw(w)
        pms = _time_ms(lambda: fc.downsample2x_conv3x3_plain(
            x, w_oihw, bias, pad_lo, emit_stats=stats))
        # the library: one cuDNN strided conv on the input padded beforehand
        xpad = F.pad(x.permute(0, 3, 1, 2), (pad_lo, 1, pad_lo, 1))
        bb = bias.to(bf)
        lib_call = lambda: F.conv2d(xpad, w_oihw, bb, stride=2)  # noqa: E731
        lms, lib_dev = _time_ms(lib_call), device_ms(lib_call)
        flops = 2 * B * ho * wo * C * 9 * Co
        nbytes = _nbytes(x, wp, bias, y, st if stats else None)
        print(f"  {'':26s} {case}: {k6_plan[0]}x8 pixel tiles, "
              f"{k6_plan[1]} channels a chunk, {k6_plan[2]}-stage weight "
              f"ring, {k6_plan[3]} split(s) of {k6_plan[4]} chunks, "
              f"{k6_plan[5]} items on {k6_plan[6]} blocks; stats "
              f"{st.shape[1]} tiles, repeat bit-identical; device "
              f"{dev_ms:.4f}ms, F.conv2d(stride=2) device {lib_dev:.4f}ms",
              flush=True)
        record(*k6, case, err, rel, REL_TOL, ms, pms, flops, nbytes, lms,
               "F.conv2d(stride=2)", device_ms=dev_ms,
               library_device_ms=lib_dev, shape=(B, H, W, C, Co, pad_lo),
               part=part)

    for idx, (case, B, H, W, C, pad_lo, stats, *_) in enumerate(
            K6_CASES + _unseen(K6_UNPAIRED, K6_CASES, 1, 6)):
        k6_case(case, B, H, W, C, C, pad_lo, stats,
                None if idx < K6_PATH_CASES else "forms"
                if idx < len(K6_CASES) else "unpaired")
    every = {(th, sp) for th in (32, 16, 8) for sp in (False, True)}
    if forms != every:
        _fail(f"K6 ran the forms {sorted(forms)} of {sorted(every)}: add a "
              f"case to tools/time_kernels.py K6_CASES that takes the rest")

    # ---- K5 -------------------------------------------------------------
    # group_norm_coeffs (the partial-stats and combine kernels from one host
    # call) against the exact plain versions, its partials alone too; timed
    # beside the plain engine's two-pass (a, b)
    k5 = ("group_norm_stats", "cuda",
          "img2img_turbo_tpu_torch/csrc/groupnorm.cu",
          "img2img_turbo_tpu/ops/groupnorm.py:81")

    def k5_case(case, shape, part):
        x = rn(*shape) * 2 + 0.5
        c = shape[-1]
        scale = 1 + 0.1 * rn(c, dtype=torch.float32)
        bias = 0.1 * rn(c, dtype=torch.float32)
        ka, kb = gn.group_norm_coeffs(x, scale, bias, 32, 1e-5)
        parts = gn.partial_stats(x)
        parts_ref = gn.partial_stats_ref(x)
        ra, rb = gn.combine_stats_ref(parts_ref, scale, bias, 32, 1e-5,
                                      x.numel() // (shape[0] * c))
        err_a, rel_a = _rel(ka, ra)
        err_b, rel_b = _rel(kb, rb)
        rel_p = _rel(parts, parts_ref)[1]
        if not rel_p <= STATS_TOL:
            _fail(f"K5 {case}: partial sums rel err {rel_p:.3e} > "
                  f"{STATS_TOL:.0e}")
        again = gn.group_norm_coeffs(x, scale, bias, 32, 1e-5)
        if not (torch.equal(ka, again[0]) and torch.equal(kb, again[1])):
            _fail(f"K5 {case}: a repeated call differs")
        call = lambda: gn.group_norm_coeffs(x, scale, bias, 32,  # noqa: E731
                                            1e-5)
        ms, dev_ms = _time_ms(call), device_ms(call)
        pms = _time_ms(lambda: gn.group_norm_coeffs_plain(x, scale, bias, 32,
                                                          1e-5))
        # the function reads x, scale and bias once and writes (a, b) (the
        # partials are its own scratch); one op per element for the sum,
        # two for the sum of squares
        flops = 3 * x.numel()
        nbytes = _nbytes(x, scale, bias, ka, kb)
        print(f"  {'':26s} K5 {case}: partials rel {rel_p:.1e}, repeat "
              f"bit-identical", flush=True)
        record(*k5, case, max(err_a, err_b), max(rel_a, rel_b), STATS_TOL,
               ms, pms, flops, nbytes, device_ms=dev_ms, part=part,
               shape=(shape[0], x.numel() // (shape[0] * c), c))

    for (case, shape), part in (
            [(c, None) for c in K5_CASES]
            + [(c, "unpaired") for c in K5_UNPAIRED_CASES]):
        k5_case(case, shape, part)

    # ---- K5's combine on the stats the conv kernels emit (K1 at four
    # path shapes), against its plain version, beside it; one launch
    kc = ("group_norm_combine", "cuda",
          "img2img_turbo_tpu_torch/csrc/groupnorm.cu",
          "img2img_turbo_tpu/ops/fused_conv.py:1782 (XLA combine_stats)")

    def combine_case(case, st, count, part):
        C = st.shape[-1]
        scale = 1 + 0.1 * rn(C, dtype=torch.float32)
        bias = 0.1 * rn(C, dtype=torch.float32)
        ka, kb = gn.combine_stats(st, scale, bias, 32, 1e-6, count)
        ra, rb = gn.combine_stats_ref(st, scale, bias, 32, 1e-6, count)
        err_a, rel_a = _rel(ka, ra)
        err_b, rel_b = _rel(kb, rb)
        call = lambda: gn.combine_stats(st, scale, bias, 32,  # noqa: E731
                                        1e-6, count)
        ms, dev_ms = _time_ms(call), device_ms(call)
        # the plain time: the combine in fp32, as the plain engine would
        # take it (the fp64 reference above is the yardstick of the error)
        pms = _time_ms(lambda: gn.combine_stats_ref(
            st, scale, bias, 32, 1e-6, count, acc=torch.float32))
        print(f"  {'':26s} combine {case}: {st.shape[1]} stats tiles",
              flush=True)
        record(*kc, case, max(err_a, err_b), max(rel_a, rel_b), STATS_TOL,
               ms, pms, 2 * st.numel(), _nbytes(st, scale, bias, ka, kb),
               device_ms=dev_ms, part=part,
               shape=(st.shape[0], st.shape[1], C, 32))

    for case, B, H, W, C, part in (
            ("vae 512^2x128", 1, 512, 512, 128, None),
            ("vae 128^2x512", 1, 128, 128, 512, None),
            ("unet 64^2x320", 1, 64, 64, 320, None),
            ("unet 8^2x1280", 1, 8, 8, 1280, None),
            ("unet 4^2x1280", 1, 4, 4, 1280, "unpaired")):
        w = rn(3, 3, C, C, scale=1 / math.sqrt(9 * C))
        _, st = fc.fused_gn_silu_conv3x3(
            rn(B, H, W, C), w, rn(C, dtype=torch.float32), emit_stats=True,
            w_packed=fc.pack_weights(w))
        combine_case(case, st, H * W, part)

    # ---- K3: every launch shape of the paths (tools/time_kernels.py's
    # K3_SHAPES: the transformers and VAE mid attentions of a 512x512 and
    # an 840x560 request, which a train step shares), weights in nn.Linear's
    # (Co, C) layout. Each case also times F.linear on the same input and
    # weights (the product alone: no LN, the weights of a 2- or 3-output
    # call concatenated, no residual), the library's share of the work;
    # only an LN-free single plain output is one F.linear call exactly.
    k3 = ("fused_matmul", "cuda", "img2img_turbo_tpu_torch/csrc/fused_matmul.cu",
          "img2img_turbo_tpu/ops/fused_matmul.py:276")
    k3_lib = _build.load("fused_matmul")
    k3_lib.fused_matmul_plan.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int)]
    k3_lib.fused_matmul_plan.restype = ctypes.c_int

    def k3_case(shape, part):
        M, C, Co, n_w, ln, gate, has_res = shape
        plan = (ctypes.c_int * 7)()
        case = k3_name(shape)
        x = rn(1, M, C)
        wrows = 2 * Co if gate else Co
        ws = tuple(rn(wrows, C, scale=1 / math.sqrt(C)) for _ in range(n_w))
        bs = tuple(rn(wrows, scale=0.1, dtype=torch.float32)
                   for _ in range(n_w))
        lnp = None
        if ln:
            lnp = (1 + 0.1 * rn(C, dtype=torch.float32),
                   0.1 * rn(C, dtype=torch.float32))
        res = rn(1, M, Co) if has_res else None
        outs = fm.fused(x, ws, bs, ln=lnp, residual=res, gate=gate)
        refs = fm.fused_ref(x, ws, bs, ln=lnp, residual=res, gate=gate)
        errs = [_rel(o, r) for o, r in zip(outs, refs)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        call = lambda: fm.fused(x, ws, bs, ln=lnp, residual=res,  # noqa: E731
                                gate=gate)
        ms, dev_ms = _time_ms(call), device_ms(call)
        pms = _time_ms(lambda: fm.fused_plain(x, ws, bs, ln=lnp,
                                              residual=res, gate=gate))
        wcat = torch.cat(ws) if n_w > 1 else ws[0]
        bcat = torch.cat(bs).to(bf)
        linear = lambda: F.linear(x, wcat, bcat)  # noqa: E731
        linear_ms, linear_dev = _time_ms(linear), device_ms(linear)
        flops = 2 * M * C * wrows * n_w
        nbytes = _nbytes(x, *ws, *bs, res, *outs) \
            + (0 if lnp is None else _nbytes(*lnp))
        exact = not ln and n_w == 1 and not gate and not has_res
        k3_lib.fused_matmul_plan(M, Co, n_w, int(ln), int(gate), plan)
        grid = tuple(plan[:3])
        print(f"  {'':26s} {case}: grid {grid} = {math.prod(grid)} blocks, "
              f"{plan[3]}x{plan[4]} tiles, {plan[5]} a block"
              f"{', resident LN panel' if plan[6] else ''}; device "
              f"{dev_ms:.4f}ms, F.linear {linear_ms:.4f}ms (device "
              f"{linear_dev:.4f}ms)", flush=True)
        record(*k3, case, err, rel, REL_TOL, ms, pms, flops, nbytes,
               linear_ms if exact else None, "F.linear" if exact else None,
               device_ms=dev_ms,
               library_device_ms=linear_dev if exact else None, shape=shape,
               linear_ms=linear_ms, linear_device_ms=linear_dev,
               part=part)

    for shape in K3_SHAPES + [s for s in K3_UNPAIRED_SHAPES
                              if s not in K3_SHAPES]:
        k3_case(shape, None if shape in K3_SHAPES else "unpaired")

    # ---- K2 -------------------------------------------------------------
    k2 = ("flash_attention_folded", "cuda",
          "img2img_turbo_tpu_torch/csrc/attention.cu",
          "img2img_turbo_tpu/ops/attention.py:261")
    lib = _attention_lib()
    k2_rows = [c[:6] for c in K7_CASES] + K2_EXTRA_CASES

    def k2_case(case, B, Sq, Skv, H, hd, part):
        q, k, v = (rn(B, s, H * hd) for s in (Sq, Skv, Skv))
        print(f"  {'':26s} {case}:", flush=True)
        report = _attention_report(
            lib, B, Sq, Skv, H, hd, q, k, v,
            lambda: attention.flash_attention_folded(q, k, v, H,
                                                     return_lse=True))
        o, lse = attention.flash_attention_folded(q, k, v, H,
                                                  return_lse=True)
        orf, lse_ref = attention.mha_ref(q, k, v, H, return_lse=True)
        err, rel = _rel(o, orf)
        lse_err = (lse - lse_ref).abs().max().item()
        if not lse_err <= LSE_TOL:
            _fail(f"K2 {case}: lse max abs err {lse_err:.3e} > {LSE_TOL}")
        ms = _time_ms(lambda: attention.flash_attention_folded(
            q, k, v, H, return_lse=True))
        pms = _time_ms(lambda: attention.mha_ref(q, k, v, H))
        backend, sdpa_call = sdpa(q, k, v, H)
        lms, lib_dev = _time_ms(sdpa_call), device_ms(sdpa_call)
        flops = 4 * B * Sq * Skv * H * hd
        nbytes = _nbytes(q, k, v, o, lse)
        print(f"  {'':26s} lse max_abs={lse_err:.3e} tol={LSE_TOL:.0e}",
              flush=True)
        record(*k2, case, err, rel, REL_TOL, ms, pms, flops, nbytes, lms,
               f"sdpa[{backend}]", library_device_ms=lib_dev, **report,
               shape=(B, Sq, Skv, H, hd), part=part)

    for idx, (case, B, Sq, Skv, H, hd) in enumerate(
            k2_rows + [c[:6] for c in _unseen(K7_UNPAIRED, k2_rows, 1, 6)]):
        k2_case(case, B, Sq, Skv, H, hd,
                None if idx < len(k2_rows) else "unpaired")

    # ---- K9 -------------------------------------------------------------
    k9 = ("flash_attention", "cuda",
          "img2img_turbo_tpu_torch/csrc/attention.cu",
          "img2img_turbo_tpu/ops/attention.py:119")
    for case, B, H, Sq, Skv in K9_CASES:
        q, k, v = rn(B, H, Sq, 64), rn(B, H, Skv, 64), rn(B, H, Skv, 64)
        print(f"  {'':26s} K9 {case}:", flush=True)
        # the set-up is timed on the folded layout: the same encodes
        report = _attention_report(
            lib, B, Sq, Skv, H, 64, q, k, v,
            lambda: attention.flash_attention(q, k, v))
        o = attention.flash_attention(q, k, v)
        err, rel = _rel(o, attention.flash_attention_ref(q, k, v))
        ms = _time_ms(lambda: attention.flash_attention(q, k, v))
        pms = _time_ms(lambda: attention.scaled_dot_product_attention(q, k,
                                                                      v))
        backend, sdpa_call = sdpa(q, k, v)
        lms, lib_dev = _time_ms(sdpa_call), device_ms(sdpa_call)
        record(*k9, case, err, rel, REL_TOL, ms, pms,
               4 * B * H * Sq * Skv * 64, _nbytes(q, k, v, o), lms,
               f"sdpa[{backend}]", library_device_ms=lib_dev, **report)

    # ---- K7 -------------------------------------------------------------
    # every case with its launch plan (`flash_attention_bwd_plan`) and a
    # bit-identical repeat. The edge cases (part "edge", summed apart from
    # the train step's shapes) cross the batch stride, a ragged Sq = Skv,
    # the split and unsplit dk/dv walk at Skv = 77 (hd 64), and ragged,
    # batched and banded calls at hd 512.
    k7 = ("flash_attention_folded_bwd", "cuda",
          "img2img_turbo_tpu_torch/csrc/attention_bwd.cu",
          "img2img_turbo_tpu/ops/attention.py:390")
    k7_splits, k7_bands = set(), set()

    def k7_case(case, B, Sq, Skv, H, hd, part):
        q, k, v = (rn(B, s, H * hd) for s in (Sq, Skv, Skv))
        do = rn(B, Sq, H * hd)
        o, lse = attention.flash_attention_folded(q, k, v, H,
                                                  return_lse=True)
        plan = attention.flash_attention_bwd_plan(B, H, Sq, Skv, hd)
        if hd == 64:
            k7_splits.add(plan["split"] > 1)
            print(f"  {'':26s} K7 {case}: dq grid {plan['dq_grid']} "
                  f"({plan['dq_rows']} Q rows, {plan['dq_kv_tile']}-row KV "
                  f"tiles, {plan['dq_stages']} stages); dk/dv grid "
                  f"{plan['dkv_grid']} ({plan['dkv_rows']} KV rows, "
                  f"{plan['dkv_q_tile']}-row Q tiles, {plan['dkv_stages']} "
                  f"stages), {plan['split']} split(s) of "
                  f"{plan['q_tiles_a_split']} Q tiles; {plan['kernels']} "
                  f"kernels a call", flush=True)
        else:
            k7_bands.add(plan["bands"] > 1)
            print(f"  {'':26s} K7 {case}: scores grid {plan['scores_grid']}"
                  f" ({plan['scores_tile']} tiles, {plan['scores_stages']} "
                  f"stages); products grid {plan['products_grid']} "
                  f"({plan['products_tile']} tiles, "
                  f"{plan['products_k_step']}-row steps, "
                  f"{plan['products_stages']} stages); {plan['bands']} "
                  f"band(s) of {plan['band_rows']} Q rows; "
                  f"{plan['kernels']} kernels a call", flush=True)
        grads = attention.flash_attention_folded_bwd(q, k, v, o, do, lse, H)
        again = attention.flash_attention_folded_bwd(q, k, v, o, do, lse, H)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(grads, again)):
            _fail(f"K7 {case}: a repeated call differs")
        del again
        refs = attention.attention_bwd_ref(q, k, v, o, do, lse, H)
        errs = [_rel(g_, r_) for g_, r_ in zip(grads, refs)]
        err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
        call = lambda: attention.flash_attention_folded_bwd(  # noqa: E731
            q, k, v, o, do, lse, H)
        ms, dev_ms = _time_ms(call), device_ms(call)
        # the plain path's backward: autograd through mha_ref
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention.mha_ref(qg, kg, vg, H)
        pms = _time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        backend, lib_call = sdpa_backward(q, k, v, do, H)
        lms, lib_dev = _time_ms(lib_call), device_ms(lib_call)
        del out, lib_call
        # the least work: S, dP, dV, dQ and dK, five products
        flops = 10 * B * Sq * Skv * H * hd
        nbytes = _nbytes(q, k, v, o, do, lse, *grads)
        record(*k7, case, err, rel, REL_TOL, ms, pms, flops, nbytes, lms,
               f"sdpa[{backend}] backward", part=part, device_ms=dev_ms,
               library_device_ms=lib_dev, shape=(B, Sq, Skv, H, hd),
               plan=plan)

    for case, B, Sq, Skv, H, hd, part in (
            [(*c[:6], None) for c in K7_CASES]
            + [(*c, "edge") for c in K7_EDGE_CASES]
            + [(*c[:6], "unpaired")
               for c in _unseen(K7_UNPAIRED, K7_CASES, 1, 6)]):
        k7_case(case, B, Sq, Skv, H, hd, part)
    if k7_splits != {False, True}:
        _fail(f"K7's hd-64 cases did not run both a split and an unsplit "
              f"dk/dv walk (split seen: {sorted(k7_splits)})")
    if k7_bands != {False, True}:
        _fail(f"K7's hd-512 cases did not run both a one-band and a banded "
              f"call (banded seen: {sorted(k7_bands)})")

    # a CUDA tensor the kernel does not take raises; it never falls back
    x = rn(1, 8, 8, 64)
    w = rn(3, 3, 64, 64)
    bias = torch.zeros(64, device=dev)
    wp = fc.pack_weights(w)
    refused = {
        "K1 fp32 input": lambda: fc.fused_gn_silu_conv3x3(
            x.float(), w, bias, w_packed=wp),
        "K1 strided input": lambda: fc.fused_gn_silu_conv3x3(
            x.transpose(1, 2), w, bias, w_packed=wp),
        "K1 without packed weights": lambda: fc.fused_gn_silu_conv3x3(
            x, w, bias),
        "K4 unfolded weights": lambda: fc.upsample2x_conv3x3(
            x, w, bias, w_packed=wp),
        "K1 skip channels not a multiple of 8": lambda:
            fc.fused_gn_silu_conv3x3(
                x, w, bias, skip_x=rn(1, 8, 8, 12), skip_w=rn(12, 64),
                w_packed=wp, skip_w_packed=fc.pack_weights(rn(12, 64))),
        "K3 C not a multiple of 8": lambda: fm.fused(
            rn(4, 12), (rn(16, 12),), (torch.zeros(16, device=dev),)),
        "K3 JAX-layout (C, Co) weight": lambda: fm.fused(
            rn(4, 16), (rn(16, 8),), (torch.zeros(8, device=dev),)),
        "K8 du on an unpacked weight": lambda: fc.conv3x3_input_grad(
            rn(1, 8, 8, 64), rn(64, 64, 3, 3), 64),
        "K2 head dim 32": lambda: attention.flash_attention_folded(
            rn(1, 16, 64), rn(1, 16, 64), rn(1, 16, 64), 2),
        "K7 lse not fp32": lambda: attention.flash_attention_folded_bwd(
            *(rn(1, 16, 64) for _ in range(5)),
            torch.zeros(1, 16, 1, device=dev, dtype=bf), 1),
        "K5 fp16 input": lambda: gn.partial_stats(x.half()),
        "K5 combine, 30 channels in 32 groups": lambda: gn.combine_stats(
            torch.zeros(1, 1, 2, 30, device=dev), torch.ones(30, device=dev),
            torch.zeros(30, device=dev), 32, 1e-6, 64),
        "K6 C not a multiple of 8": lambda: fc.downsample2x_conv3x3(
            rn(1, 8, 8, 12), rn(3, 3, 12, 16), torch.zeros(16, device=dev),
            0, w_packed=fc.pack_weights(rn(3, 3, 12, 16))),
        "K6 pad_lo 2": lambda: fc.downsample2x_conv3x3(
            x, w, bias, 2, w_packed=wp),
        "K9 head dim 32": lambda: attention.flash_attention(
            rn(1, 2, 16, 32), rn(1, 2, 16, 32), rn(1, 2, 16, 32)),
    }
    for what, fn in refused.items():
        try:
            fn()
        except ValueError:
            continue
        _fail(f"wrapper accepted what its kernel does not take: {what}")
    print(f"  wrappers refused all {len(refused)} unsupported CUDA inputs",
          flush=True)
    _build.reset_launch_counts()
    def path_case(kernel, shape, part):
        """A kernel at a path's launch shape (as its wrapper counts it in
        `_build.launch_shapes`) that no case above runs, with that kernel's
        checks, recorded under `part`: K1, K4, K6 (timed without stats, as
        the UNet calls it), K3, K2, K7, K8's du (recorded under "du_" +
        part), K5 on an input of that (B, S, C), and the combine on fp32
        partial sums of that (B, tiles, C) over tiles of 64 rows."""
        case = f"{part} " + "x".join(
            str(int(v) if isinstance(v, bool) else v) for v in shape)
        if kernel == "fused_gn_silu_conv3x3":
            k1_case(case, *shape, part)
        elif kernel == "upsample2x_conv3x3":
            k4_case(case, *shape, part)
        elif kernel == "downsample2x_conv3x3":
            k6_case(case, *shape, False, part)
        elif kernel == "fused_matmul":
            k3_case(tuple(shape), part)
        elif kernel == "flash_attention_folded":
            k2_case(case, *shape, part)
        elif kernel == "flash_attention_folded_bwd":
            k7_case(case, *shape, part)
        elif kernel == "conv3x3_input_grad":
            du_case(case, *shape, "du_" + part)
        elif kernel == "group_norm_stats":
            b, rows, c = shape
            k5_case(f"{part} {b}x{rows}x{c}", (b, rows, c), part)
        elif kernel == "group_norm_combine":
            b, tiles, c, _ = shape
            x = torch.randn(b, tiles, 64, c, generator=g, device=dev) * 2 \
                + 0.5
            st = torch.stack([x.sum(2), x.square().sum(2)], 2).contiguous()
            combine_case(f"{part} {b}x{tiles}x{c}", st, tiles * 64, part)
        else:
            _fail(f"no case for the kernel {kernel}")

    return path_case


def _have(results, kernel: str) -> set:
    """The launch shapes (as a wrapper counts them) that a case of
    `results` ran for `kernel`; K8's du is recorded under K1's name."""
    if kernel == "conv3x3_input_grad":
        return {tuple(r["shape"]) for r in results
                if r["name"] == "fused_gn_silu_conv3x3" and "shape" in r
                and (r["part"] or "").startswith("du")}
    return {tuple(r["shape"]) for r in results
            if r["name"] == kernel and "shape" in r}


def _summed(rs):
    """The worst error over cases `rs`, and their time, device time alone
    (where every case has one), plain version's time, bound and library
    call's time and device time summed (`library_ms` and
    `library_device_ms` sum only the cases that have a library call, named
    in `library_cases`, and are null when none has). bound_by names the
    bound of the cases that make up most of the summed bound."""
    by = {"bytes": 0.0, "operations": 0.0}
    for r in rs:
        by[r["bound_by"]] += r["bound_ms"]
    lib = [r for r in rs if r["library_ms"] is not None]
    dev = [r["device_ms"] for r in rs]
    lib_dev = [r["library_device_ms"] for r in lib]
    return dict(
        max_abs_err=max(r["max_abs_err"] for r in rs),
        ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
        device_ms=None if None in dev else sum(dev),
        bound_ms=sum(r["bound_ms"] for r in rs), bound_by=max(by, key=by.get),
        library_ms=sum(r["library_ms"] for r in lib) if lib else None,
        library_device_ms=None if not lib or None in lib_dev
        else sum(lib_dev),
        library_cases=[r["case"] for r in lib], n_cases=len(rs))


def _weighted(rs, shapes, launches, path,
              keys=("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")):
    """Times of a kernel's cases `rs` (K2's, K3's or the du's, each with
    its launch `shape`) weighted by the launches the wrapper counted at each shape on
    one run of a path (`shapes`, {shape: launches}): what the kernel, its
    device time alone, its plain version, its bound and the library call
    cost on that path (`keys`). Fails the run if a shape of the path has no
    case or the shapes' launches do not add up to the path's count of the
    kernel, `launches`."""
    name = rs[0]["name"]
    by_shape = {r["shape"]: r for r in rs}
    missing = sorted(set(shapes) - set(by_shape))
    if missing:
        _fail(f"{name} ran shapes {missing} on the {path} path with no case")
    if sum(shapes.values()) != launches:
        _fail(f"{name}'s launches by shape on the {path} path {shapes} do "
              f"not add up to its count {launches}")
    out = {"launches": launches,
           "by_shape": {"x".join(str(int(v) if isinstance(v, bool) else v)
                                 for v in s): n for s, n in shapes.items()}}
    for key in keys:
        vals = [n * by_shape[s][key] if by_shape[s][key] is not None
                else None for s, n in shapes.items()]
        out[key] = None if None in vals else sum(vals)
    return out


def _per_kernel(results, paths):
    """One entry per kernel. `launches` counts the kernel's launches on the
    first path of `paths` ({path: launch counts of one run}, in order) that
    runs it, named in `launches_path`: one 512x512 edge_to_image request
    ("serve", as in the serving slice's line), one image or sketch request,
    one train step ("train"), or the default_attention calls;
    `launches_<path>` gives every path's count. A kernel that no path
    launched fails the run. The errors and times sum the kernel's forward
    cases (each case is on its own line of the kernel phase's output); a
    kernel that also runs in another role (K1 as K8's du) has those cases
    summed under the role's key."""
    out = []
    names = list(dict.fromkeys(r["name"] for r in results))
    for name in names:
        rs = [r for r in results if r["name"] == name]
        counts = {p: c.get(name, 0) for p, c in paths.items()}
        first = next((p for p, n in counts.items() if n), None)
        if first is None:
            _fail(f"kernel {name} was launched on no path")
        e = dict(name=name, route=rs[0]["route"], source=rs[0]["source"],
                 replaces=rs[0]["replaces"], launches=counts[first],
                 launches_path=first,
                 **{f"launches_{p}": n for p, n in counts.items()},
                 **_summed([r for r in rs if r["part"] is None]))
        for part in dict.fromkeys(r["part"] for r in rs if r["part"]):
            e[part] = _summed([r for r in rs if r["part"] == part])
        out.append(e)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: this smoke runs only on a GPU")
    print(_smi(), flush=True)  # the card's name and power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from img2img_turbo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    times = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f}s "
          + " ".join(f"{k}={v:.1f}s" for k, v in times.items()), flush=True)

    results: list = []
    print("kernel phase (bf16, kernel vs plain PyTorch version):", flush=True)
    path_case = kernel_phase(dev, results)
    torch.cuda.synchronize()

    summary: dict = {"paths": {}, "k1_shapes": {}, "k2_shapes": {},
                     "k3_shapes": {}, "k4_shapes": {}, "k5_shapes": {},
                     "k5c_shapes": {}, "k6_shapes": {}, "k7_shapes": {},
                     "du_shapes": {}, "tp_reference": {}}
    attention_path(dev, summary)
    engine_phase(dev, summary)
    modes_phase(dev, summary)
    train_phase(dev, summary)
    unpaired_phase(dev, summary)
    # K5 and its combine at the unpaired step's launch shapes that no case
    # of the kernel phase ran, so that both weigh per unpaired step
    for key, kernel in (("k5", "group_norm_stats"),
                        ("k5c", "group_norm_combine")):
        have = {r["shape"] for r in results if r["name"] == kernel}
        for shape in summary[f"{key}_shapes"]["unpaired"]:
            if shape not in have:
                path_case(kernel, shape, "unpaired")
    torch.cuda.synchronize()
    dp_phase(dev, summary)
    # the model axis, and every kernel at the shard shapes it launched that
    # no case ran, checked against its *_ref (part "model_axis")
    # then training under it (phase 13), and its new shapes likewise (the
    # du's part "du_model_axis")
    for phase, what in ((tp_phase, "model-axis phase"),
                        (tp_train_phase, "model-axis training phase")):
        t0 = time.perf_counter()
        n_new = 0
        for kernel, shapes in phase(dev, summary).items():
            for shape in sorted(shapes - _have(results, kernel), key=str):
                path_case(kernel, shape, "model_axis")
                n_new += 1
        torch.cuda.synchronize()
        print(f"{what} with its {n_new} new kernel cases: "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    with tempfile.TemporaryDirectory() as root:
        snap = weights_phase(dev, summary, root)
        cli_phase(dev, summary, snap)
        tools_phase(dev, summary, root, snap)
    paths = {p: summary["paths"][p] for p in (
        "serve", "image", "sketch", "train", "default_attention",
        "unpaired", "cli_pix2pix", "cli_pix2pix_resume", "cli_cyclegan",
        "model_axis", "model_axis_paired", "model_axis_unpaired")}
    kernels = _per_kernel(results, paths)
    k2 = next(e for e in kernels if e["name"] == "flash_attention_folded")
    k2_cases = [r for r in results if r["name"] == k2["name"]]
    for key, path in (("per_request", "serve"), ("per_step", "train")):
        k2[key] = _weighted(k2_cases, summary["k2_shapes"][path],
                            paths[path][k2["name"]], path)
    print(f"K2 per 512x512 request: {k2['per_request']}; per train step: "
          f"{k2['per_step']}", flush=True)
    # K3 on every path, weighted by its launches there: the 512x512
    # request, the 840x560 one, an image and a sketch request, a train step
    k3 = next(e for e in kernels if e["name"] == "fused_matmul")
    k3_cases = [r for r in results if r["name"] == k3["name"]]
    k3_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "linear_ms",
               "linear_device_ms")
    for key, path in (("per_request", "serve"),
                      ("per_request_840x560", "serve_840x560"),
                      ("per_request_image", "image"),
                      ("per_request_sketch", "sketch"),
                      ("per_step", "train")):
        launches = (summary["engine"]["launches_840x560"] if path ==
                    "serve_840x560" else paths[path])[k3["name"]]
        k3[key] = _weighted(k3_cases, summary["k3_shapes"][path], launches,
                            path, k3_keys)
        print(f"K3 {key}: " + ", ".join(
            f"{n}={k3[key][n]:.4f}ms" for n in k3_keys)
            + f" over {launches} launches", flush=True)
    # K8's du in a train step, weighted by its launches there (which must
    # be DU_CASES' table, from which tools/time_kernels.py weights its own)
    from img2img_turbo_tpu_torch.tools.time_kernels import DU_CASES
    k1 = next(e for e in kernels if e["name"] == "fused_gn_silu_conv3x3")
    du_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
               "library_device_ms")
    du_shapes = summary["du_shapes"]["train"]
    table = {tuple(c[1:6]): c[6] for c in DU_CASES if c[6]}
    if du_shapes != table:
        _fail(f"du launches by shape in a train step {du_shapes} differ from "
              f"tools/time_kernels.py DU_CASES {table}")
    k1["du"]["per_step"] = _weighted(
        [r for r in results if r["part"] == "du"], du_shapes,
        TRAIN_DU_LAUNCHES, "train", du_keys)
    print("du per_step: " + ", ".join(
        f"{n}={k1['du']['per_step'][n]:.4f}ms" for n in du_keys)
        + f" over {TRAIN_DU_LAUNCHES} launches", flush=True)
    # K1's forward and K4 per 512x512 request and per train step, weighted
    # by their launches there, which must be the tables of
    # tools/time_kernels.py (K1_CASES, K4_CASES; the du's launches, counted
    # as K1's, are not in K1's table)
    from img2img_turbo_tpu_torch.tools.time_kernels import (
        K1_CASES, K4_CASES, K6_CASES, K7_CASES)
    conv_keys = du_keys + ("conv_alone_ms", "conv_alone_device_ms")
    for e, cases, width, keys in ((k1, K1_CASES, 10, conv_keys),
                                  (next(e for e in kernels if e["name"] ==
                                        "upsample2x_conv3x3"), K4_CASES, 7,
                                   du_keys)):
        rs = [r for r in results if r["name"] == e["name"] and not r["part"]]
        for key, path, col in (("per_request", "serve", width + 1),
                               ("per_step", "train", width + 2)):
            table = {tuple(c[1:width + 1]): c[col] for c in cases if c[col]}
            kname = "k1" if e is k1 else "k4"
            if summary[f"{kname}_shapes"][path] != table:
                _fail(f"{e['name']} launches by shape on the {path} path "
                      f"{summary[f'{kname}_shapes'][path]} differ from "
                      f"tools/time_kernels.py {kname.upper()}_CASES {table}")
            launches = paths[path][e["name"]] - (
                TRAIN_DU_LAUNCHES if e is k1 and path == "train" else 0)
            e[key] = _weighted(rs, table, launches, path, keys)
            print(f"{kname.upper()} {key}: " + ", ".join(
                f"{n}={e[key][n]:.4f}ms" for n in keys
                if e[key][n] is not None)
                + f" over {launches} launches", flush=True)
    # K6 per 512x512 request and per train step, and K7 per train step at
    # each head dim, weighted by their launches there, which must be the
    # tables of tools/time_kernels.py (K6_CASES, K7_CASES)
    k6 = next(e for e in kernels if e["name"] == "downsample2x_conv3x3")
    k6_cases = [r for r in results if r["name"] == k6["name"]]
    for key, path, col in (("per_request", "serve", 7),
                           ("per_step", "train", 8)):
        table = {(c[1], c[2], c[3], c[4], c[4], c[5]): c[col]
                 for c in K6_CASES if c[col]}
        if summary["k6_shapes"][path] != table:
            _fail(f"K6 launches by shape on the {path} path "
                  f"{summary['k6_shapes'][path]} differ from "
                  f"tools/time_kernels.py K6_CASES {table}")
        k6[key] = _weighted(k6_cases, table, paths[path][k6["name"]], path,
                            du_keys)
        print(f"K6 {key}: " + ", ".join(
            f"{n}={k6[key][n]:.4f}ms" for n in du_keys)
            + f" over {k6[key]['launches']} launches", flush=True)
    k7 = next(e for e in kernels if e["name"] == "flash_attention_folded_bwd")
    table = {tuple(c[1:6]): c[6] for c in K7_CASES}
    if summary["k7_shapes"]["train"] != table:
        _fail(f"K7 launches by shape in a train step "
              f"{summary['k7_shapes']['train']} differ from "
              f"tools/time_kernels.py K7_CASES {table}")
    for hd in sorted({s_[4] for s_ in table}):
        shapes = {s_: n for s_, n in table.items() if s_[4] == hd}
        k7[f"per_step_hd{hd}"] = _weighted(
            [r for r in results if r["name"] == k7["name"]], shapes,
            sum(shapes.values()), "train", du_keys)
        print(f"K7 per_step hd {hd}: " + ", ".join(
            f"{n}={k7[f'per_step_hd{hd}'][n]:.4f}ms" for n in du_keys)
            + f" over {sum(shapes.values())} launches", flush=True)
    # every kernel per unpaired step, weighted by its launches by shape in
    # that step, which must be the unpaired tables of tools/time_kernels.py
    # (K2's and K3's shapes are counted in the run, as on the other paths)
    from img2img_turbo_tpu_torch.tools.time_kernels import (
        DU_UNPAIRED, K1_UNPAIRED, K4_UNPAIRED, K6_UNPAIRED, K7_UNPAIRED)
    du_unpaired = sum(c[-1] for c in DU_UNPAIRED)
    k4 = next(e for e in kernels if e["name"] == "upsample2x_conv3x3")
    k5, k5c = (next(e for e in kernels if e["name"] == n)
               for n in ("group_norm_stats", "group_norm_combine"))
    k2_keys = ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")
    for entry, key, rows, shape_of, parts, launches, keys in (
            (k1, "k1", K1_UNPAIRED, lambda c: tuple(c[1:11]),
             (None, "forms", "unpaired"),
             paths["unpaired"][k1["name"]] - du_unpaired, conv_keys),
            (k1["du"], "du", DU_UNPAIRED, lambda c: tuple(c[1:6]),
             ("du", "du_unpaired"), du_unpaired, du_keys),
            (k4, "k4", K4_UNPAIRED, lambda c: tuple(c[1:8]),
             (None, "unpaired"), paths["unpaired"][k4["name"]], du_keys),
            (k6, "k6", K6_UNPAIRED,
             lambda c: (c[1], c[2], c[3], c[4], c[4], c[5]),
             (None, "forms", "unpaired"), paths["unpaired"][k6["name"]],
             du_keys),
            (k7, "k7", K7_UNPAIRED, lambda c: tuple(c[1:6]),
             (None, "edge", "unpaired"), paths["unpaired"][k7["name"]],
             du_keys),
            (k2, "k2", None, None, (None, "unpaired"),
             paths["unpaired"][k2["name"]], k2_keys),
            (k3, "k3", None, None, (None, "unpaired"),
             paths["unpaired"][k3["name"]], k3_keys),
            (k5, "k5", None, None, (None, "unpaired"),
             paths["unpaired"][k5["name"]], k2_keys),
            # the combines launched alone: those K5 launched with its stats
            # are in K5's time
            (k5c, "k5c", None, None, (None, "unpaired"),
             paths["unpaired"][k5c["name"]] - paths["unpaired"][k5["name"]],
             k2_keys)):
        name = k1["name"] if entry is k1["du"] else entry["name"]
        shapes = summary[f"{key}_shapes"]["unpaired"]
        if rows is not None:
            table = {shape_of(c): c[-1] for c in rows}
            if shapes != table:
                _fail(f"{key} launches by shape in an unpaired step {shapes} "
                      f"differ from tools/time_kernels.py's table {table}")
        entry["per_unpaired_step"] = _weighted(
            [r for r in results if r["name"] == name and r["part"] in parts],
            shapes, launches, "unpaired", keys)
        print(f"{key.upper()} per_unpaired_step: " + ", ".join(
            f"{n}={entry['per_unpaired_step'][n]:.4f}ms" for n in keys
            if entry["per_unpaired_step"][n] is not None)
            + f" over {launches} launches", flush=True)
    print(_smi(), flush=True)  # again, beside the results
    print(json.dumps({"kernels": kernels,
                      "engine": summary["engine"],
                      "modes": summary["modes"],
                      "train": summary["train"],
                      "unpaired": summary["unpaired"],
                      "weights": summary["weights"],
                      "cli": summary["cli"], "dp": summary["dp"],
                      "model_axis": summary["model_axis"],
                      "model_axis_train": summary["model_axis_train"],
                      "tools": summary["tools"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


# Kernel launches of one edge_to_image request at the SD-Turbo topology
# (4 levels, 2 layers per block, transformers on the top 3 levels), b1:
#   K1  VAE enc 22 + dec 30 (conv_in, 2 per resnet, conv_out)
#       + UNet 46 (conv_in, 2 per resnet x 22: 8 down, 2 mid, 12 up,
#       norm_out + conv_out)
#   K2  2 per transformer x 16 + 1 per VAE mid attention x 2
#   K3  9 per transformer x 16 + 2 per VAE mid attention x 2
#   K4  3 VAE decoder upsamples + 3 UNet upsamples (latent sizes even)
#   K5  GNs with no chained stats: VAE 2 mid res2 GN1; UNet 7 down + 2 mid
#       + 12 up-block concats + norm_out (the VAE encoder's 3 GNs after its
#       downsamples read K6's stats)
#   K5's combine: every GroupNorm of the path, 113: 95 K1 prologues (98
#       less the three conv_ins), 16 transformer GNs, 2 VAE mid-attention
#       GNs; each K5 launch above comes with its combine in the same host
#       call, the rest combine the stats K1 and K6 emitted
#   K6  3 VAE encoder downsamples (with stats) + 3 UNet downsamples
EXPECTED_LAUNCHES = {"fused_gn_silu_conv3x3": 98, "flash_attention_folded": 34,
                     "fused_matmul": 148, "upsample2x_conv3x3": 6,
                     "group_norm_stats": 24, "group_norm_combine": 113,
                     "downsample2x_conv3x3": 6}
# At 840x560 the UNet's skip sizes are odd at every level, so its three
# upsamples take upsample_nearest_to + a plain conv (unet.py:350-355); its
# six downsamples (560x840 -> 280x420 -> 140x210 -> 70x105 in the VAE,
# 70x105 -> 35x53 -> 18x27 -> 9x14 in the UNet) all take K6.
EXPECTED_LAUNCHES_840x560 = dict(EXPECTED_LAUNCHES, upsample2x_conv3x3=3)
# An image request (CycleGAN-Turbo) runs the edge_to_image generator on
# another input (canny launches no kernel of the package); a sketch request
# adds the TwinConv's second conv_in (K1).
EXPECTED_LAUNCHES_IMAGE = dict(EXPECTED_LAUNCHES)
EXPECTED_LAUNCHES_SKETCH = dict(EXPECTED_LAUNCHES, fused_gn_silu_conv3x3=99)
PATH_REL_L2_TOL = 5e-2  # kernel path vs plain path, bf16, same weights


def synth_image(h: int, w: int, seed: int):
    """Seeded uint8 (1, h, w, 3) image with real edges: filled rectangles
    and discs on a flat background, plus mild noise."""
    import numpy as np
    rng = np.random.RandomState(seed)
    img = np.empty((h, w, 3), np.float32)
    img[:] = rng.randint(0, 256, 3)
    yy, xx = np.mgrid[:h, :w]
    for _ in range(12):
        color = rng.randint(0, 256, 3)
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        r = rng.randint(h // 16, h // 4)
        if rng.rand() < 0.5:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            m = (abs(yy - cy) < r) & (abs(xx - cx) < r * 3 // 2)
        img[m] = color
    img += rng.randn(h, w, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)[None]


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-12)).item()


def _shapes(kernel: str) -> dict:
    """A kernel's launches by shape (K1: (B, H, W, C, Co, GN prologue,
    extra bias, residual, Csk, stats); K4: (B, H, W, C, Co, Csk, stats); K2
    and K7: (B, Sq, Skv, H, hd); K3: (M, C, Co, outputs, LN, gate,
    residual); K6: (B, H, W, C, Co, pad_lo); the du: (B, H, W, C, Co)) since
    the counters were last reset."""
    from img2img_turbo_tpu_torch.ops import _build
    return {shape: n for (name, shape), n in _build.launch_shapes.items()
            if name == kernel}


def engine_phase(dev, summary):
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax

    t0 = time.perf_counter()
    cfgs = GeneratorConfigs()
    g = torch.Generator(device=dev).manual_seed(1234)
    params = {"unet": from_jax.random_model(cfgs.unet, g),
              "vae": from_jax.random_model(cfgs.vae, g)}
    caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim, generator=g,
                          device=dev)
    fast = ServingEngine(params, cfgs, dtype=torch.bfloat16, device=dev)
    plain = ServingEngine(params, cfgs, dtype=torch.bfloat16, device=dev,
                          use_kernels=False)
    n_params = sum(p.numel() for m in params.values() for p in m.parameters())
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated(dev) / 2 ** 30
    print(f"engine phase: SD-Turbo widths, {n_params / 1e6:.1f}M params "
          f"(random, seed 1234), bf16, set-up "
          f"{time.perf_counter() - t0:.1f}s, weights and kernel layouts "
          f"{weights_gib:.3f} GiB on the card", flush=True)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    img512 = torch.as_tensor(synth_image(512, 512, 0), device=dev)
    fast.warmup(1, 512, 512, caption)
    plain.warmup(1, 512, 512, caption)

    # one request with the launch counters read around it
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    r = fast.run(img512, caption, gen(1))
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    summary["k1_shapes"]["serve"] = _shapes("fused_gn_silu_conv3x3")
    summary["k2_shapes"]["serve"] = _shapes("flash_attention_folded")
    summary["k3_shapes"]["serve"] = _shapes("fused_matmul")
    summary["k4_shapes"]["serve"] = _shapes("upsample2x_conv3x3")
    summary["k6_shapes"]["serve"] = _shapes("downsample2x_conv3x3")
    print(f"  launches in one 512x512 request: {counts}", flush=True)
    if counts != EXPECTED_LAUNCHES:
        _fail(f"launch counts {counts} != expected {EXPECTED_LAUNCHES}")

    def check_out(res, h, w, what):
        out, img = res["out"], res["img"]
        if out.shape != (1, h, w, 3) or out.dtype != torch.uint8:
            _fail(f"{what}: output {tuple(out.shape)} {out.dtype}")
        if not torch.isfinite(img.float()).all():
            _fail(f"{what}: non-finite values before the uint8 cast")
        if out.float().std().item() == 0.0:
            _fail(f"{what}: constant output")

    check_out(r, 512, 512, "512x512")
    again = fast.run(img512, caption, gen(1))
    if not torch.equal(again["out"], r["out"]):
        _fail("same request with the same generator seed gave another image")

    # requests timed with CUDA events, kernel path and plain path in turns
    times = {"kernels": [], "plain": []}
    for i in range(5):
        for name, eng in (("kernels", fast), ("plain", plain)):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            eng(img512, caption, gen(100 + i))
            e.record()
            e.synchronize()
            times[name].append(s.elapsed_time(e))
    p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  request p50 512x512 b1 (5 requests each, CUDA events): "
          f"kernels {p50['kernels']:.2f} ms, plain {p50['plain']:.2f} ms",
          flush=True)

    # kernel path vs plain path on the same weights and the same noise
    noise = torch.randn(1, 64, 64, 4, generator=gen(7), device=dev,
                        dtype=torch.bfloat16)
    rk = fast.run(img512, caption, noise=noise)
    rp = plain.run(img512, caption, noise=noise)
    errs = {k: _rel_l2(rk[k], rp[k]) for k in ("z", "x0", "img")}
    print(f"  kernel vs plain path, rel L2: {errs} (tol "
          f"{PATH_REL_L2_TOL:.0e})", flush=True)
    if max(errs.values()) > PATH_REL_L2_TOL:
        _fail(f"kernel path disagrees with the plain path: {errs}")

    # ragged request: 840x560 (latent 105x70)
    img840 = torch.as_tensor(synth_image(560, 840, 1), device=dev)
    _build.reset_launch_counts()
    rk = fast.run(img840, caption, gen(2))
    torch.cuda.synchronize()
    counts840 = dict(_build.launch_counts)
    summary["k3_shapes"]["serve_840x560"] = _shapes("fused_matmul")
    check_out(rk, 560, 840, "840x560")
    if counts840 != EXPECTED_LAUNCHES_840x560:
        _fail(f"840x560 launch counts {counts840} != "
              f"{EXPECTED_LAUNCHES_840x560}")
    rp = plain.run(img840, caption, gen(2))
    errs840 = {k: _rel_l2(rk[k], rp[k]) for k in ("z", "x0", "img")}
    print(f"  840x560: launches {counts840}; kernel vs plain rel L2 "
          f"{errs840}", flush=True)
    if max(errs840.values()) > PATH_REL_L2_TOL:
        _fail(f"840x560 kernel path disagrees with the plain path: {errs840}")
    summary["engine"] = {"p50_ms": p50, "weights_gib": weights_gib,
                         "rel_l2_512": errs,
                         "rel_l2_840x560": errs840, "launches_512": counts,
                         "launches_840x560": counts840}
    summary["paths"]["serve"] = counts


def attention_path(dev, summary):
    """The one path that reaches K9: the package's public attention op
    `ops.attention.default_attention` on (B, H, S, 64) tensors at the
    UNet's shapes (K9_CASES), with the launch counters read around these
    calls alone; each output is held against the plain version."""
    import torch
    from img2img_turbo_tpu_torch.ops import _build, attention

    g = torch.Generator(device=dev).manual_seed(5)
    inputs = [tuple(torch.randn(B, H, s, 64, generator=g, device=dev).to(
        torch.bfloat16) for s in (Sq, Skv, Skv))
        for _, B, H, Sq, Skv in K9_CASES]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = [attention.default_attention(*qkv) for qkv in inputs]
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"default_attention path: launches {counts}", flush=True)
    if counts != {"flash_attention": len(K9_CASES)}:
        _fail(f"default_attention launches {counts}")
    for (case, *_), qkv, o in zip(K9_CASES, inputs, outs):
        _, rel = _rel(o, attention.flash_attention_ref(*qkv))
        if not rel <= REL_TOL:
            _fail(f"default_attention {case}: rel err {rel:.3e}")
    summary["paths"]["default_attention"] = counts


def _serve_checks(name, fast, plain, img, caption, expected, dev,
                  **kw):
    """The checks of one serving mode on a kernel-path engine `fast` and a
    plain-path engine `plain` on the same weights: the launch table of one
    request, shape and range, a bit-identical repeat, the p50 of 5 requests
    of each path (CUDA events, in turns), and the kernel path against the
    plain path on the same posterior noise (rel L2 of z, x0 and the image,
    as for edge_to_image). `kw`
    goes to every request (r and the noise map of a sketch request).
    Returns (summary, kernel-path result of the compared request, K3's
    launches by shape in the first request)."""
    import torch
    from img2img_turbo_tpu_torch.ops import _build

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    r = fast.run(img, caption, gen(1), **kw)
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    k3_shapes = _shapes("fused_matmul")
    if counts != expected:
        _fail(f"{name}: launch counts {counts} != expected {expected}")
    out = r["out"]
    if out.shape != img.shape or out.dtype != torch.uint8 \
            or not torch.isfinite(r["img"].float()).all() \
            or out.float().std().item() == 0.0:
        _fail(f"{name}: output {tuple(out.shape)} {out.dtype}, or non-finite "
              f"or constant")
    if not torch.equal(fast.run(img, caption, gen(1), **kw)["out"], out):
        _fail(f"{name}: the same request gave another image")
    times = {"kernels": [], "plain": []}
    for i in range(5):
        for path, eng in (("kernels", fast), ("plain", plain)):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            eng(img, caption, gen(100 + i), **kw)
            e_ev.record()
            e_ev.synchronize()
            times[path].append(s_ev.elapsed_time(e_ev))
    p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    b, h, w, _ = img.shape
    noise = torch.randn(b, h // 8, w // 8, 4, generator=gen(7), device=dev,
                        dtype=torch.bfloat16)
    rk = fast.run(img, caption, noise=noise, **kw)
    rp = plain.run(img, caption, noise=noise, **kw)
    rel = {k: _rel_l2(rk[k], rp[k]) for k in ("z", "x0", "img")}
    print(f"  {name}: launches {counts}; p50 {h}x{w} b{b} (5 requests each, "
          f"CUDA events) kernels {p50['kernels']:.2f} ms, plain "
          f"{p50['plain']:.2f} ms; kernel vs plain rel L2 {rel} (tol "
          f"{PATH_REL_L2_TOL:.0e})", flush=True)
    if not max(rel.values()) <= PATH_REL_L2_TOL:
        _fail(f"{name}: kernel path disagrees with the plain path: {rel}")
    return {"p50_ms": p50, "launches": counts, "rel_l2": rel}, rk, k3_shapes


def modes_phase(dev, summary):
    """The image (CycleGAN-Turbo) and sketch (stochastic pix2pix-turbo)
    modes at SD-Turbo width on seeded random weights, 512x512 b1: a random
    CycleGAN model (UNet with its three rank-128 adapters merged, vae_a2b
    and vae_b2a with rank-4 adapters) served in both directions, and a
    random factored pix2pix model with TwinConv served at r = 0.4 and 1.0
    (LoRA merged per request). Each mode passes `_serve_checks`; besides,
    a2b and b2a differ, two r differ, and r = 1.0 ignores the noise map."""
    import torch
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax

    cfgs = GeneratorConfigs()
    modes = {}
    bf = torch.bfloat16

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(2345)
    cyc = from_jax.random_cyclegan_model(cfgs, g)
    caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim, generator=g,
                          device=dev)
    engines = {(d, k): ServingEngine(
        {"unet": cyc["unet"], "vae": cyc["vae_" + d]}, cfgs, mode="image",
        dtype=bf, device=dev, use_kernels=k)
        for d in ("a2b", "b2a") for k in (True, False)}
    print(f"image mode: random CycleGAN-Turbo (seed 2345), set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    img = torch.as_tensor(synth_image(512, 512, 5), device=dev)
    for eng in engines.values():
        eng.warmup(1, 512, 512, caption)
    outs = {}
    for d in ("a2b", "b2a"):
        modes[f"image_{d}"], outs[d], shapes = _serve_checks(
            f"image {d}", engines[d, True], engines[d, False], img, caption,
            EXPECTED_LAUNCHES_IMAGE, dev)
        summary["k3_shapes"].setdefault("image", shapes)
    if torch.equal(outs["a2b"]["out"], outs["b2a"]["out"]):
        _fail("image mode: a2b and b2a gave the same image")
    summary["paths"]["image"] = modes["image_a2b"]["launches"]
    del engines, cyc

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(3456)
    unet, vae, lora = from_jax.random_sketch_model(cfgs, g)
    caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim, generator=g,
                          device=dev)
    engines = {k: ServingEngine(cfgs=cfgs, mode="sketch", dtype=bf,
                                device=dev, use_kernels=k,
                                base={"unet": unet, "vae": vae}, lora=lora)
               for k in (True, False)}
    print(f"sketch mode: random factored pix2pix-turbo with TwinConv (seed "
          f"3456), set-up {time.perf_counter() - t0:.1f}s", flush=True)
    sketch = torch.as_tensor(synth_image(512, 512, 6), device=dev)
    for eng in engines.values():
        eng.warmup(1, 512, 512, caption)
    maps = [torch.randn(1, 64, 64, 4, generator=torch.Generator(
        device=dev).manual_seed(s), device=dev, dtype=bf) for s in (11, 12)]
    outs = {}
    for r in (0.4, 1.0):
        modes[f"sketch_r{r}"], outs[r], shapes = _serve_checks(
            f"sketch r={r}", engines[True], engines[False], sketch, caption,
            EXPECTED_LAUNCHES_SKETCH, dev, r=r, noise_map=maps[0])
        summary["k3_shapes"].setdefault("sketch", shapes)
    if torch.equal(outs[0.4]["out"], outs[1.0]["out"]):
        _fail("sketch mode: r = 0.4 and r = 1.0 gave the same image")
    noise = torch.randn(1, 64, 64, 4, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev, dtype=bf)
    other = engines[True].run(sketch, caption, noise=noise, r=1.0,
                              noise_map=maps[1])
    if not torch.equal(other["out"], outs[1.0]["out"]):
        _fail("sketch mode: at r = 1.0 the noise map changed the image")
    print("  a2b != b2a; r = 0.4 != r = 1.0; r = 1.0 ignores the noise map",
          flush=True)
    summary["paths"]["sketch"] = modes["sketch_r0.4"]["launches"]
    summary["modes"] = modes



# Kernel launches of one paired train step at the SD-Turbo topology, 512x512
# b1. Each generator pass (1 and 2) runs the serving forward's launches
# (K1 98, K2 34, K3 148, K4 6, K5 24 and its combine 113, K6 6), then its
# backward: the UNet's down, mid and up blocks run again (recompute: K1 44
# resnet convs, K2 32, K3 144, K4 3 upsamples, K5 21, the combine 60: every
# GroupNorm of the UNet but norm_out, K6 3 downsamples), each fused GN conv's
# du is one launch of the du kernel, counted as K1 (95, all K1 but the
# three prologue-free conv_ins; by shape in tools/time_kernels.py
# DU_CASES) and each
# attention's backward one K7 (34: 32 UNet + 2 VAE mid); K6's backward is
# autograd through the plain strided conv. Passes 3 and 4 (discriminator)
# and the text encoder launch none.
TRAIN_DU_LAUNCHES = 2 * 95
EXPECTED_TRAIN_LAUNCHES = {
    "fused_gn_silu_conv3x3": 2 * (98 + 44) + TRAIN_DU_LAUNCHES,
    "flash_attention_folded": 2 * (34 + 32),
    "fused_matmul": 2 * (148 + 144),
    "upsample2x_conv3x3": 2 * (6 + 3),
    "group_norm_stats": 2 * (24 + 21),
    "group_norm_combine": 2 * (113 + 60),
    "downsample2x_conv3x3": 2 * (6 + 3),
    "flash_attention_folded_bwd": 2 * 34}
GRAD_REL_L2_TOL = 1e-1  # pass-1 gradients, kernel vs plain path, bf16
# One unpaired (CycleGAN-Turbo) step runs eight generator forwards, each
# with its backward (cycle 4, GAN 2, identity 2), where a paired step runs
# two: four times a paired step's launches, at 256x256 in place of 512x512.
# The gradient into the second hop of each cycle reaches the first
# generator's output through the VAE encoder's prologue-free conv_in,
# whose input gradient is the plain recompute of KernelFn (no launch);
# the discriminators and LPIPS launch none.
EXPECTED_UNPAIRED_LAUNCHES = {k: 4 * v
                              for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
TRAIN_STEPS = 3      # timed steps per path, after one warm-up step
TRAIN_HW = 512


def _snapshot(state):
    import copy
    return copy.deepcopy(state)


def _state_tensors(state):
    return {**{"gen." + k: v for k, v in state.gen.items()},
            **{"disc." + k: v for k, v in state.disc.items()},
            **{"sn." + k: v for k, v in state.disc_sn.items()}}


def _fingerprint(module):
    """An fp64 sum of every parameter, to show frozen weights unmoved."""
    return sum(float(p.detach().double().sum()) for p in module.parameters())


def _grad_rel(gk, gp, parts):
    """Relative L2 of gradients `gk` against `gp` over all trainables and
    over each part (a key prefix)."""
    def rel(names):
        num = sum(float((gk[n].float() - gp[n].float()).square().sum())
                  for n in names)
        den = sum(float(gp[n].float().square().sum()) for n in names)
        return (num / max(den, 1e-30)) ** 0.5
    return rel(list(gk)), {p: rel([n for n in gk if n.startswith(p + ":")])
                           for p in parts}


def _grad_agreement(gk, gp, parts, what, vs="kernel vs plain path"):
    """Relative L2 of the kernel path's gradients `gk` against the plain
    path's `gp` from the same state, over all trainables and over each
    part (a key prefix); fails the run past GRAD_REL_L2_TOL."""
    overall, per_part = _grad_rel(gk, gp, parts)
    print(f"  {what} gradients, {vs}: rel L2 {overall:.3e} "
          f"(tol {GRAD_REL_L2_TOL:.0e}, overall and for each part); by part "
          f"{per_part}", flush=True)
    if not overall <= GRAD_REL_L2_TOL:
        _fail(f"{what} gradients disagree: rel L2 {overall:.3e}")
    for part, r in per_part.items():
        if not r <= GRAD_REL_L2_TOL:
            _fail(f"{what} gradients of {part} disagree: rel L2 {r:.3e}")
    return overall, per_part


# kernel wrappers counted by shape, under the summary's "<key>_shapes"
SHAPE_KEYS = (("k1", "fused_gn_silu_conv3x3"),
              ("k2", "flash_attention_folded"),
              ("k3", "fused_matmul"), ("k4", "upsample2x_conv3x3"),
              ("k5", "group_norm_stats"), ("k5c", "group_norm_combine"),
              ("k6", "downsample2x_conv3x3"),
              ("k7", "flash_attention_folded_bwd"),
              ("du", "conv3x3_input_grad"))


def _reference(run, state0) -> dict:
    """The kernel path's first step of a `_run_steps` run from `state0` on
    the host, for the model-axis training phase: its metrics, its first
    pass's gradients and the state's tensors before and after it (fp32)."""
    def host(d):
        return {n: v.detach().float().cpu() for n, v in d.items()}
    return {"metrics": run["first_metrics"], "counts": run["counts"],
            "grads": host(run["grads"][True]),
            "start": host(_state_tensors(state0)),
            "after": host(_state_tensors(run["after_first"]))}


def _run_steps(steps, state0, batch, noise, dev, summary, path):
    """A warm-up step and TRAIN_STEPS timed steps (CUDA events) of the
    kernel and the plain path (`steps`, {kernels: step}) from copies of
    `state0`, in turns; `noise(i)` is step i's posterior noise. Fails on a
    non-finite loss and on a kernel launched by the plain path. The kernel
    path's step 0 gives the launch counts, and the launches by shape under
    summary["<key>_shapes"][path]; both paths' step 0 their gradients.
    Returns {"states", "times", "peaks", "metrics", "grads", "counts",
    "start" (the kernel path's state before step 0), "after_first" (after
    it), "first_metrics"}."""
    import numpy as np
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    run = {"states": {k: _snapshot(state0) for k in (True, False)},
           "times": {True: [], False: []}, "peaks": {True: 0, False: 0},
           "metrics": {True: [], False: []}, "grads": {}}
    states = run["states"]
    for i in range(1 + TRAIN_STEPS):   # step 0: warm-up, launches, gradients
        for k in (True, False):
            if i == 0 and k:
                run["start"] = _snapshot(states[k])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _build.reset_launch_counts()
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            m, gr = steps[k](states[k], batch, noise(i), keep_grads=i == 0)
            e_ev.record()
            e_ev.synchronize()
            run["times"][k].append(s_ev.elapsed_time(e_ev))
            run["peaks"][k] = max(run["peaks"][k],
                                  torch.cuda.max_memory_allocated(dev))
            m = {n: float(v) for n, v in m.items()}
            run["metrics"][k].append(m)
            if not all(np.isfinite(v) for v in m.values()):
                _fail(f"{path} step {i} ({'kernels' if k else 'plain'}): "
                      f"non-finite loss {m}")
            if not k and sum(_build.launch_counts.values()):
                _fail(f"the plain {path} step launched a kernel")
            if i == 0:
                run["grads"][k] = gr
                if k:
                    run["counts"] = dict(_build.launch_counts)
                    for key, kernel in SHAPE_KEYS:
                        summary[f"{key}_shapes"][path] = _shapes(kernel)
                    run["after_first"] = _snapshot(states[k])
                    run["first_metrics"] = m
    return run


def train_phase(dev, summary):
    import numpy as np
    import torch
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.ops import canny as canny_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import losses, paired, runner

    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True   # the repeated-step check
    torch.backends.cudnn.benchmark = False
    cfgs = GeneratorConfigs()
    models, state0, meta = runner.build_paired_run(
        cfgs, clip_vit.CLIP_VIT_B32, seed=4321, device=dev)
    g = torch.Generator(device=dev).manual_seed(4322)
    steps = {k: paired.make_paired_train_step(
        models, cfgs, losses.PairedLossConfig(), meta, kernels=k,
        remat=True, dtype=torch.bfloat16) for k in (True, False)}
    frozen = {n: getattr(models, n) for n in (
        "unet", "vae", "text", "lpips", "disc_backbone", "clip")}
    prints = {n: _fingerprint(m) for n, m in frozen.items()}
    n_train = sum(v.numel() for v in state0.gen.values())
    n_frozen = sum(p.numel() for m in frozen.values() for p in m.parameters())

    h = w = TRAIN_HW
    img = torch.as_tensor(synth_image(h, w, 3), device=dev)
    batch = {
        "conditioning_pixel_values": canny_mod.canny_3ch_unit(img, 100, 200),
        "output_pixel_values": torch.as_tensor(
            synth_image(h, w, 4), device=dev).float() / 127.5 - 1.0,
        "input_ids": torch.randint(0, cfgs.text.vocab_size, (1, 77),
                                   generator=g, device=dev)}

    def noise(step_i):
        gn_ = torch.Generator(device=dev).manual_seed(1000 + step_i)
        return tuple(paired.draw_noise(gn_, 1, h, w, cfgs, torch.bfloat16)
                     for _ in range(2))

    torch.cuda.synchronize()
    print(f"train phase: SD-Turbo UNet/VAE + LoRA, OpenCLIP-H text, CLIP "
          f"ViT-B/32, VGG16 LPIPS; {n_train / 1e6:.2f}M trainable, "
          f"{n_frozen / 1e6:.1f}M frozen (random, seed 4321); "
          f"{TRAIN_HW}x{TRAIN_HW} b1, "
          f"bf16 activations, fp32 masters, UNet remat; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    run = _run_steps(steps, state0, batch, noise, dev, summary, "train")
    counts, metrics, states = run["counts"], run["metrics"], run["states"]
    print(f"  launches in one train step: {counts}", flush=True)
    if counts != EXPECTED_TRAIN_LAUNCHES:
        _fail(f"train launch counts {counts} != {EXPECTED_TRAIN_LAUNCHES}")
    for k in (True, False):
        print(f"  {'kernels' if k else 'plain'}: " + "; ".join(
            ", ".join(f"{n}={v:.4f}" for n, v in m.items())
            for m in metrics[k]), flush=True)

    # pass-1 gradients of the two paths from the same state
    grad_rel, per_group = _grad_agreement(
        run["grads"][True], run["grads"][False],
        ("unet_lora", "vae_lora", "unet", "vae"), "pass-1")

    # trainables moved, frozen weights did not
    for k in (True, False):
        moved = [n for n, v in state0.gen.items()
                 if not torch.equal(v, states[k].gen[n])]
        if len(moved) != len(state0.gen):
            _fail(f"trainables did not move: "
                  f"{sorted(set(state0.gen) - set(moved))}")
        if all(torch.equal(v, states[k].disc[n])
               for n, v in state0.disc.items()):
            _fail("the discriminator heads did not move")
    for n, m in frozen.items():
        if _fingerprint(m) != prints[n]:
            _fail(f"frozen {n} weights moved")

    # a step repeated from the same state is bit-identical
    again = run["start"]
    m2, _ = steps[True](again, batch, noise(0))
    m2 = {n: float(v) for n, v in m2.items()}
    a_t, b_t = _state_tensors(run["after_first"]), _state_tensors(again)
    same = all(torch.equal(a_t[n], b_t[n]) for n in a_t) \
        and m2 == run["first_metrics"]
    print(f"  repeated step bit-identical: {same}", flush=True)
    if not same:
        _fail("a step repeated from the same state gave other results")

    # the eval step on the trained generator
    ev = paired.make_eval_step(models, cfgs, meta, kernels=True)
    pred, val = ev(states[True].gen, batch, noise(9)[0])
    val = {n: float(v) for n, v in val.items()}
    if pred.shape != (1, h, w, 3) or not torch.isfinite(pred.float()).all() \
            or not all(np.isfinite(v) for v in val.values()):
        _fail(f"eval step: {tuple(pred.shape)} {val}")

    p50 = {("kernels" if k else "plain"): sorted(v[1:])[TRAIN_STEPS // 2]
           for k, v in run["times"].items()}
    peak = {("kernels" if k else "plain"): v / 2 ** 30
            for k, v in run["peaks"].items()}
    print(f"  train step p50 {h}x{w} b1 ({TRAIN_STEPS} steps each after a "
          f"warm-up step, CUDA events): kernels {p50['kernels']:.2f} ms, "
          f"plain {p50['plain']:.2f} ms; peak memory kernels "
          f"{peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB; "
          f"eval {val}", flush=True)
    summary["paths"]["train"] = counts
    summary["tp_reference"]["paired"] = _reference(run, state0)
    summary["train"] = {
        "step_ms": {("kernels" if k else "plain"): v
                    for k, v in run["times"].items()},
        "p50_ms": p50, "peak_gib": peak, "grad_rel_l2": grad_rel,
        "grad_rel_l2_by_part": per_group, "launches": counts,
        "metrics": {("kernels" if k else "plain"): v
                    for k, v in metrics.items()},
        "eval": val}


UNPAIRED_HW = 256   # the repo's CycleGAN-Turbo recipe: 256x256 crops


def _unpaired_inputs(cfgs, dev):
    """The unpaired phase's 256x256 b1 batch (synth images 7 and 8, caption
    embeddings from a generator seeded 5433) and noise(i), step i's
    posterior noise of the eight forwards (a generator seeded 2000 + i)."""
    import torch
    from img2img_turbo_tpu_torch.training import paired, unpaired
    h = w = UNPAIRED_HW
    g = torch.Generator(device=dev).manual_seed(5433)
    d = cfgs.unet.cross_attention_dim
    batch = {"pixel_values_src": torch.as_tensor(
                 synth_image(h, w, 7), device=dev).float() / 127.5 - 1.0,
             "pixel_values_tgt": torch.as_tensor(
                 synth_image(h, w, 8), device=dev).float() / 127.5 - 1.0,
             "emb_a2b": torch.randn(1, 77, d, generator=g, device=dev),
             "emb_b2a": torch.randn(1, 77, d, generator=g, device=dev)}

    def noise(step_i):
        gn_ = torch.Generator(device=dev).manual_seed(2000 + step_i)
        return tuple(paired.draw_noise(gn_, 1, h, w, cfgs, torch.bfloat16)
                     for _ in range(unpaired.NUM_NOISE))
    return batch, noise


def unpaired_phase(dev, summary):
    """The unpaired (CycleGAN-Turbo) step at SD-Turbo width on seeded
    random weights (seed 5432): the UNet with its three rank-128 adapters,
    vae_a2b and vae_b2a with rank-4 adapters and their skip convs, two
    discriminators on one CLIP ViT-B/32, VGG16 LPIPS; 256x256 b1, fixed
    random caption embeddings (1, 77, 1024), bf16 activations, fp32
    masters, UNet remat. A warm-up step and TRAIN_STEPS timed steps with
    kernels and as many plain from the same state, checked for finite
    losses, every trainable and both discriminators' heads moved, frozen
    weights unmoved, launch counts (EXPECTED_UNPAIRED_LAUNCHES, and by
    shape the unpaired tables of tools/time_kernels.py), the kernel path's
    cycle-pass gradients against a plain fp32 step's from the same state,
    and a bit-identical repeat."""
    import torch
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import losses, runner, unpaired

    t0 = time.perf_counter()
    cfgs = GeneratorConfigs()
    models, state0, meta = runner.build_unpaired_run(
        cfgs, clip_vit.CLIP_VIT_B32, seed=5432, device=dev)
    steps = {k: unpaired.make_unpaired_train_step(
        models, cfgs, losses.UnpairedLossConfig(), meta, kernels=k,
        remat=True, dtype=torch.bfloat16) for k in (True, False)}
    frozen = {n: getattr(models, n) for n in (
        "unet", "vae_a2b", "vae_b2a", "lpips", "disc_backbone")}
    prints = {n: _fingerprint(m) for n, m in frozen.items()}
    n_train = sum(v.numel() for v in state0.gen.values())
    n_frozen = sum(p.numel() for m in frozen.values() for p in m.parameters())

    h = w = UNPAIRED_HW
    batch, noise = _unpaired_inputs(cfgs, dev)
    torch.cuda.synchronize()
    print(f"unpaired phase: SD-Turbo UNet (3 LoRA adapters, rank "
          f"{meta.rank_unet}) + vae_a2b/vae_b2a (LoRA rank {meta.rank_vae}), "
          f"two discriminators on CLIP ViT-B/32, VGG16 LPIPS; "
          f"{n_train / 1e6:.2f}M trainable, {n_frozen / 1e6:.1f}M frozen "
          f"(random, seed 5432); {h}x{w} b1, bf16 activations, fp32 "
          f"masters, UNet remat; set-up {time.perf_counter() - t0:.1f}s",
          flush=True)

    run = _run_steps(steps, state0, batch, noise, dev, summary, "unpaired")
    counts, metrics, states = run["counts"], run["metrics"], run["states"]
    grads = run["grads"]
    print(f"  launches in one unpaired step: {counts}", flush=True)
    if counts != EXPECTED_UNPAIRED_LAUNCHES:
        _fail(f"unpaired launch counts {counts} != "
              f"{EXPECTED_UNPAIRED_LAUNCHES}")
    for k in (True, False):
        print(f"  {'kernels' if k else 'plain'}: " + "; ".join(
            ", ".join(f"{n}={v:.4f}" for n, v in m.items())
            for m in metrics[k]), flush=True)

    # The cycle pass's gradients go through two chained generators, so two
    # bf16 computations of them differ by more than pass 1's of the paired
    # step: the kernel path is held against the plain path in fp32 from the
    # same state and inputs (the exact composition), and the plain path in
    # bf16 is measured against it beside, with the two bf16 paths' mutual
    # difference.
    parts = ("unet_lora:default_encoder", "unet_lora:default_decoder",
             "unet_lora:default_others", "unet", "vae_a2b_lora", "vae_a2b",
             "vae_b2a_lora", "vae_b2a")
    ref_step = unpaired.make_unpaired_train_step(
        models, cfgs, losses.UnpairedLossConfig(), meta, kernels=False,
        remat=True, dtype=torch.float32)
    _, ref = ref_step(_snapshot(state0), batch,
                      tuple(n.float() for n in noise(0)), keep_grads=True)
    grad_rel, per_part = _grad_agreement(
        grads[True], ref, parts, "cycle-pass",
        "bf16 kernel path vs fp32 plain path")
    plain_rel = _grad_rel(grads[False], ref, parts)
    mutual = _grad_rel(grads[True], grads[False], parts)
    print(f"  cycle-pass gradients, bf16 plain path vs fp32 plain path: rel "
          f"L2 {plain_rel[0]:.3e}, by part {plain_rel[1]}; bf16 kernel vs "
          f"bf16 plain path: rel L2 {mutual[0]:.3e}, by part {mutual[1]}",
          flush=True)
    del ref

    # every trainable and both discriminators' heads moved, frozen weights
    # did not
    for k in (True, False):
        still = sorted(n for n, v in state0.gen.items()
                       if torch.equal(v, states[k].gen[n]))
        if still:
            _fail(f"unpaired trainables did not move: {still}")
        for side in ("a", "b"):
            if all(torch.equal(v, states[k].disc[n])
                   for n, v in state0.disc.items()
                   if n.startswith(side + ":")):
                _fail(f"discriminator {side}'s heads did not move")
    for n, m in frozen.items():
        if _fingerprint(m) != prints[n]:
            _fail(f"frozen {n} weights moved in the unpaired step")

    # a step repeated from the same state is bit-identical
    again = run["start"]
    m2, _ = steps[True](again, batch, noise(0))
    m2 = {n: float(v) for n, v in m2.items()}
    a_t, b_t = _state_tensors(run["after_first"]), _state_tensors(again)
    same = all(torch.equal(a_t[n], b_t[n]) for n in a_t) \
        and m2 == run["first_metrics"]
    print(f"  repeated unpaired step bit-identical: {same}", flush=True)
    if not same:
        _fail("an unpaired step repeated from the same state gave other "
              "results")

    p50 = {("kernels" if k else "plain"): sorted(v[1:])[TRAIN_STEPS // 2]
           for k, v in run["times"].items()}
    peak = {("kernels" if k else "plain"): v / 2 ** 30
            for k, v in run["peaks"].items()}
    print(f"  unpaired step p50 {h}x{w} b1 ({TRAIN_STEPS} steps each after "
          f"a warm-up step, CUDA events): kernels {p50['kernels']:.2f} ms, "
          f"plain {p50['plain']:.2f} ms; peak memory kernels "
          f"{peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB",
          flush=True)
    summary["paths"]["unpaired"] = counts
    summary["tp_reference"]["unpaired"] = _reference(run, state0)
    summary["unpaired"] = {
        "step_ms": {("kernels" if k else "plain"): v
                    for k, v in run["times"].items()},
        "p50_ms": p50, "peak_gib": peak, "grad_rel_l2": grad_rel,
        "grad_rel_l2_by_part": per_part,
        "grad_rel_l2_plain_bf16": plain_rel[0],
        "grad_rel_l2_plain_bf16_by_part": plain_rel[1],
        "grad_rel_l2_kernel_vs_plain_bf16": mutual[0],
        "grad_rel_l2_kernel_vs_plain_bf16_by_part": mutual[1],
        "launches": counts, "trainable_m": n_train / 1e6,
        "metrics": {("kernels" if k else "plain"): v
                    for k, v in metrics.items()}}


# ---------------------------------------------------------------------------
# weights phase
# ---------------------------------------------------------------------------

SNAPSHOT_SEED = 4567
PROMPT = "a red bird on a branch"        # the paired CLI's --prompt
CAPTION = "driving in the night"         # the unpaired CLI's --prompt
CLI_IMAGE_HW = (389, 517)                # neither side a multiple of 8
RANK_EDGE = (8, 4)                       # the paired trainer's ranks
RANK_CYCLEGAN = (128, 4)                 # the unpaired trainer's ranks
MERGE_REL_TOL = 1e-6                     # loaded merged weights vs merge_lora
TRAINING_PROMPTS = ("a photo of scene 0", "a photo of scene 1",
                    "driving in the day", "driving in the night")


def synth_bpe(texts):
    """(vocab, merges) of a synthetic byte-level CLIP BPE: the 512 byte
    symbols, merges that build each word of `texts` left to right (its
    last character with the end-of-word mark), the two specials; every id
    is under CLIP's 49,408."""
    from img2img_turbo_tpu_torch.models.tokenizer import bytes_to_unicode
    units = list(bytes_to_unicode().values())
    vocab = {u: i for i, u in enumerate(units + [u + "</w>" for u in units])}
    merges = []
    for word in sorted({w for t in texts for w in t.lower().split()}):
        syms = list(word[:-1]) + [word[-1] + "</w>"]
        while len(syms) > 1:
            pair = (syms[0], syms[1])
            if pair not in merges:
                merges.append(pair)
                vocab.setdefault(pair[0] + pair[1], len(vocab))
            syms = [pair[0] + pair[1]] + syms[2:]
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab, merges


def write_snapshot(root: str, cfgs, dev):
    """A full-width stabilityai/sd-turbo snapshot under `root` in the HF
    layout, fp16 as sd-turbo's fp16 variant stores it: seeded random UNet,
    VAE (no skip convs, as SD-Turbo's) and OpenCLIP-H text tower (with its
    `text_model.` prefix and position_ids), and a synthetic BPE tokenizer.
    Returns ({part: state dict as written, on the card}, {part: (path,
    bytes, seconds)})."""
    import os
    import torch
    from img2img_turbo_tpu_torch.models.clip_text import CLIPTextModel
    from img2img_turbo_tpu_torch.training.runner import random_init
    from img2img_turbo_tpu_torch.weights import from_jax
    from img2img_turbo_tpu_torch.weights import torch_import as ti

    g = torch.Generator(device=dev).manual_seed(SNAPSHOT_SEED)
    half = torch.float16
    sds = {"unet": from_jax.random_params(cfgs.unet, g, dtype=half),
           "vae": {k: v for k, v in from_jax.random_params(
               cfgs.vae, g, dtype=half).items() if "skip_conv" not in k}}
    text = random_init(lambda: CLIPTextModel(cfgs.text), g)
    sds["text"] = {"text_model." + k: v.half()
                   for k, v in text.state_dict().items()}
    del text
    sds["text"]["text_model.embeddings.position_ids"] = torch.arange(
        cfgs.text.max_position_embeddings, device=dev)[None]
    files = {}
    for part, sd in sds.items():
        path = os.path.join(root, ti.SNAPSHOT_FILES[part])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        t0 = time.perf_counter()
        n = ti.save_safetensors(sd, path)
        files[part] = (path, n, time.perf_counter() - t0)
    vocab, merges = synth_bpe((PROMPT, CAPTION) + TRAINING_PROMPTS)
    tok = os.path.join(root, ti.SNAPSHOT_FILES["tokenizer"])
    os.makedirs(tok)
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n"
                + "".join(f"{a} {b}\n" for a, b in merges))
    return sds, files


def _random_b(loras, g, std=0.01):
    """Random B factors (at init B = 0 and a merge would change nothing)."""
    import torch
    for lora in loras:
        for e in lora["modules"].values():
            e["b"] = torch.randn(e["b"].shape, generator=g,
                                 device=g.device) * std


def write_pkls(ckpt_dir: str, cfgs, sds, dev):
    """The three reference-schema pkls, written by the port's exporters
    (`training/checkpoint.py`) from seeded random trainables: edge (LoRA at
    ranks 8 / 4, random B, a retrained conv_in and skip convs), sketch (the
    same with a TwinConv conv_in) and CycleGAN (the UNet trio at rank 128,
    a rank-4 adapter and skip convs per VAE, both VAEs whole under "vae."
    and "vae_b2a."). Returns {name: (path, what was written: the adapters
    and the retrained weights)}."""
    import os
    import torch
    from img2img_turbo_tpu_torch import lora as lora_mod
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
    from img2img_turbo_tpu_torch.pipelines import cyclegan
    from img2img_turbo_tpu_torch.training import checkpoint as ckpt
    from img2img_turbo_tpu_torch.training.paired import LoraMeta
    from img2img_turbo_tpu_torch.training.unpaired import CycleLoraMeta
    from img2img_turbo_tpu_torch.weights import torch_import as ti

    g = torch.Generator(device=dev).manual_seed(SNAPSHOT_SEED + 1)
    with torch.device("meta"):      # shapes only
        unet_m = UNet2DConditionModel(cfgs.unet)
        vae_m = AutoencoderKL(cfgs.vae)

    def rand(shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev) * std

    def flat(part, lora):
        return {f"{part}:{n}.{ab}": e[ab]
                for n, e in lora["modules"].items() for ab in ("a", "b")}

    skips = {f"decoder.skip_conv_{i + 1}.weight": (oc, ic, 1, 1)
             for i, (ic, oc) in enumerate(cfgs.vae.skip_conv_channels)}
    w_in = sds["unet"]["conv_in.weight"].shape
    out = {}
    loras = {"unet": lora_mod.init_lora(unet_m, RANK_EDGE[0],
                                        lora_mod.PIX2PIX_UNET_TARGETS, g),
             "vae": lora_mod.init_lora(vae_m, RANK_EDGE[1],
                                       lora_mod.PIX2PIX_VAE_TARGETS, g)}
    _random_b(loras.values(), g)
    for name, fname, conv_in in (
            ("edge", "edge_to_image_loras.pkl", ("conv_in",)),
            ("sketch", "sketch_to_image_stochastic_lora.pkl",
             ("conv_in.conv_in_pretrained", "conv_in.conv_in_curr"))):
        gen = {**flat("unet_lora", loras["unet"]),
               **flat("vae_lora", loras["vae"])}
        own = {"unet": {}, "vae": {k: rand(s) for k, s in skips.items()}}
        for c in conv_in:
            own["unet"][c + ".weight"] = rand(w_in)
            own["unet"][c + ".bias"] = rand(w_in[:1])
        for part, sd in own.items():
            gen.update({f"{part}:{k}": v for k, v in sd.items()})
        path = os.path.join(ckpt_dir, fname)
        ckpt.export_pix2pix_pkl(path, gen, LoraMeta(rank_unet=RANK_EDGE[0],
                                                    rank_vae=RANK_EDGE[1]))
        out[name] = (path, {"lora": loras, "own": own})

    trio = cyclegan.cyclegan_unet_adapters(unet_m, RANK_CYCLEGAN[0], g)
    vae_loras = {v: lora_mod.init_lora(vae_m, RANK_CYCLEGAN[1],
                                       lora_mod.CYCLEGAN_VAE_TARGETS, g)
                 for v in ("vae_a2b", "vae_b2a")}
    _random_b([*trio.values(), *vae_loras.values()], g)
    gen, own = {}, {}
    for a, lora in trio.items():
        gen.update(flat(f"unet_lora:{a}", lora))
    for v, lora in vae_loras.items():
        gen.update(flat(f"{v}_lora", lora))
        own[v] = {k: rand(s) for k, s in skips.items()}
        gen.update({f"{v}:{k}": t for k, t in own[v].items()})
    # both VAEs start from the snapshot's (vae_b2a is a copy of vae_a2b)
    vae = ti.load_into(ti.build_on(lambda: AutoencoderKL(cfgs.vae), dev),
                       {**sds["vae"], **own["vae_a2b"]})
    path = os.path.join(ckpt_dir, "cyclegan.pkl")
    ckpt.export_cyclegan_pkl(path, gen, {"vae_a2b": vae, "vae_b2a": vae},
                             CycleLoraMeta(*RANK_CYCLEGAN))
    out["cyclegan"] = (path, {"lora": {"unet": list(trio.values()),
                                       **vae_loras}, "own": own})
    return out


def _check_loaded(what, module, base, loras):
    """`module`'s every tensor (fp32, loaded) against what was written:
    `base` ({name: tensor}, the snapshot's fp16 tensors and the pkl's
    retrained ones) upcast exactly, and where `loras` adapt a module,
    `lora.merge_multi` of the written factors onto that base within
    MERGE_REL_TOL relative. Returns (tensors checked, worst merged rel)."""
    import torch
    from img2img_turbo_tpu_torch import lora as lora_mod
    got = module.state_dict()
    if set(got) != set(base):
        _fail(f"{what}: loaded keys differ from the written ones: "
              f"{sorted(set(got) ^ set(base))[:6]}")
    base = {k: v.float() for k, v in base.items()}
    merged = lora_mod.merge_multi(base, loras) if loras else {}
    worst = 0.0
    for k, v in got.items():
        if v.dtype != torch.float32:
            _fail(f"{what}: {k} loaded as {v.dtype}, not fp32")
        if k in merged:
            rel = _rel_l2(v, merged[k])
            worst = max(worst, rel)
            if not rel <= MERGE_REL_TOL:
                _fail(f"{what}: merged {k} rel {rel:.2e} > "
                      f"{MERGE_REL_TOL:.0e}")
        elif not torch.equal(v, base[k]):
            _fail(f"{what}: {k} differs from the written tensor")
    return len(got), worst


def _check_factors(what, got, want):
    import torch
    for part in ("unet", "vae"):
        g, w = got[part], want[part]
        if set(g["modules"]) != set(w["modules"]) or g["rank"] != w["rank"] \
                or g["alpha"] != 8.0:
            _fail(f"{what}: the {part} adapter loaded as rank {g['rank']} "
                  f"alpha {g['alpha']} over {len(g['modules'])} modules")
        for n, e in w["modules"].items():
            for ab in ("a", "b"):
                if not torch.equal(g["modules"][n][ab], e[ab]):
                    _fail(f"{what}: {part} factor {n}.{ab} differs")


def load_checks(dev, cfgs, snap, ckpt_dir, sds, pkls):
    """Each snapshot file and pkl read alone (wall, GB, GB/s), then
    Pix2PixTurbo (deterministic and stochastic) and CycleGANTurbo
    `load_pretrained` with every tensor checked against the file."""
    import os
    import torch
    from img2img_turbo_tpu_torch.pipelines.cyclegan import CycleGANTurbo
    from img2img_turbo_tpu_torch.pipelines.pix2pix import Pix2PixTurbo
    from img2img_turbo_tpu_torch.weights import torch_import as ti

    reads = {}
    for part in ("unet", "vae", "text"):
        path = os.path.join(snap, ti.SNAPSHOT_FILES[part])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sd = ti.load_safetensors(path, dev)
        torch.cuda.synchronize()
        reads[part] = (os.path.getsize(path), time.perf_counter() - t0)
        for k, v in sds[part].items():
            if not torch.equal(sd[k], v):
                _fail(f"load_safetensors: {part} {k} differs")
        del sd
    for name, (path, _) in pkls.items():
        t0 = time.perf_counter()
        ti.load_torch_pickle(path)
        reads[name + ".pkl"] = (os.path.getsize(path),
                                time.perf_counter() - t0)
    for k, (n, dt) in reads.items():
        print(f"  read {k}: {n / 1e9:.3f} GB in {dt:.3f}s, "
              f"{n / 1e9 / dt:.2f} GB/s", flush=True)
    total_b = sum(n for n, _ in reads.values())
    total_s = sum(dt for _, dt in reads.values())
    print(f"  read total: {total_b / 1e9:.3f} GB in {total_s:.3f}s, "
          f"{total_b / 1e9 / total_s:.2f} GB/s", flush=True)

    text_sd = {k[len("text_model."):]: v for k, v in sds["text"].items()
               if not k.endswith("position_ids")}
    loads, checked = {}, {}
    for name in ("edge", "sketch", "cyclegan"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "cyclegan":
            kw = CycleGANTurbo.load_pretrained(
                snap, pkls[name][0], CAPTION, "a2b", cfgs, device=dev)
        else:
            kw = Pix2PixTurbo.load_pretrained(
                snap, "sketch_to_image_stochastic" if name == "sketch"
                else "edge_to_image", cfgs=cfgs, ckpt_folder=ckpt_dir,
                device=dev)
        torch.cuda.synchronize()
        loads[name] = time.perf_counter() - t0
        wrote = pkls[name][1]
        res = {"text": _check_loaded(f"{name} text", kw["text"], text_sd,
                                     [])}
        if name == "edge":
            for part in ("unet", "vae"):
                res[part] = _check_loaded(
                    f"edge {part}", kw["params"][part],
                    {**sds[part], **wrote["own"][part]},
                    [wrote["lora"][part]])
        elif name == "sketch":
            for part in ("unet", "vae"):
                res[part] = _check_loaded(
                    f"sketch {part}", kw["base"][part],
                    {**{k: v for k, v in sds[part].items()
                        if not k.startswith("conv_in.")},
                     **wrote["own"][part]}, [])
            _check_factors("sketch", kw["lora"], wrote["lora"])
        else:
            res["unet"] = _check_loaded("cyclegan unet", kw["params"]["unet"],
                                        sds["unet"], wrote["lora"]["unet"])
            for v in ("vae_a2b", "vae_b2a"):
                res[v] = _check_loaded(
                    f"cyclegan {v}", kw["params"][v],
                    {**sds["vae"], **wrote["own"][v]}, [wrote["lora"][v]])
            if (kw["caption"], kw["direction"]) != (CAPTION, "a2b"):
                _fail(f"cyclegan caption / direction {kw['caption']!r} "
                      f"{kw['direction']!r}")
        checked[name] = {p: {"tensors": n, "merged_rel_max": r}
                         for p, (n, r) in res.items()}
        print(f"  {name}: load_pretrained {loads[name]:.2f}s; every tensor "
              f"equal to the file, merged within {MERGE_REL_TOL:.0e}: "
              + ", ".join(f"{p} {n} tensors (merged rel max {r:.1e})"
                          for p, (n, r) in res.items()), flush=True)
        del kw
    return {"reads": {k: {"bytes": n, "seconds": dt, "gb_per_s":
                          n / 1e9 / dt} for k, (n, dt) in reads.items()},
            "read_total": {"bytes": total_b, "seconds": total_s,
                           "gb_per_s": total_b / 1e9 / total_s},
            "load_pretrained_s": loads, "checked": checked}


def _cli_counts():
    from img2img_turbo_tpu_torch.ops import _build
    counts = dict(_build.launch_counts)
    counts["conv3x3_input_grad"] = sum(_shapes("conv3x3_input_grad")
                                       .values())
    return counts


INFERENCE_KERNELS = ("fused_gn_silu_conv3x3", "flash_attention_folded",
                     "fused_matmul", "upsample2x_conv3x3",
                     "group_norm_stats", "group_norm_combine",
                     "downsample2x_conv3x3")


def inference_clis(dev, cfgs, snap, ckpt_dir, pkl_cyc, root):
    """Both inference CLIs in-process through `main` with --use_fp16 on a
    517x389 PNG: edge_to_image, sketch at --gamma 0.4, and CycleGAN by
    --model_path --prompt --direction a2b. Each PNG must exist at its
    size, equal bit for bit the pipeline called directly (loaded anew) on
    the same prepared input and seed, stay within PATH_REL_L2_TOL of the
    same pipeline's plain path, and come from a run that launched K1-K6
    and no backward kernel."""
    import os
    import numpy as np
    import torch
    from PIL import Image
    from img2img_turbo_tpu_torch.cli import (inference_paired,
                                             inference_unpaired)
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.ops import image as image_mod
    from img2img_turbo_tpu_torch.pipelines.cyclegan import CycleGANTurbo
    from img2img_turbo_tpu_torch.pipelines.pix2pix import Pix2PixTurbo

    h, w = CLI_IMAGE_HW
    png = os.path.join(root, "input.png")
    Image.fromarray(synth_image(h, w, 9)[0]).save(png)
    runs = {}
    for name, cli, argv in (
            # seed 0: the generator accept_parity's pipeline call draws
            # from, so that the tools phase holds it to this PNG
            ("edge", inference_paired,
             ["--prompt", PROMPT, "--model_name", "edge_to_image",
              "--seed", "0"]),
            ("sketch", inference_paired,
             ["--prompt", PROMPT, "--model_name",
              "sketch_to_image_stochastic", "--gamma", "0.4"]),
            ("cyclegan", inference_unpaired,
             ["--prompt", CAPTION, "--model_path", pkl_cyc, "--direction",
              "a2b"])):
        out_dir = os.path.join(root, "out_" + name)
        args = cli.build_parser().parse_args(
            ["--input_image", png, "--sd_turbo_path", snap, "--ckpt_folder",
             ckpt_dir, "--output_dir", out_dir, "--use_fp16"] + argv)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = cli.main(args, device=dev, cfgs=cfgs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _cli_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        missing = [k for k in INFERENCE_KERNELS if not counts.get(k)]
        if missing or counts.get("flash_attention_folded_bwd") \
                or counts["conv3x3_input_grad"]:
            _fail(f"{name} CLI: launches {counts}: kernels {missing} did not "
                  f"run, or a backward kernel did")
        got = np.asarray(Image.open(res["output"]))
        want_hw = (h, w) if name == "cyclegan" else (h - h % 8, w - w % 8)
        if got.shape != want_hw + (3,) or got.dtype != np.uint8 \
                or got.std() == 0:
            _fail(f"{name} CLI: PNG {got.shape} {got.dtype}, expected "
                  f"{want_hw + (3,)}, or constant")

        # the pipeline called directly on the same prepared input and seed
        if name == "cyclegan":
            pipe = CycleGANTurbo.from_pretrained(
                snap, pkl_cyc, CAPTION, "a2b", cfgs, torch.bfloat16,
                device=dev)
            x, size = inference_unpaired.prepare(args, png)
            outs = {}
            for k in (True, False):
                pipe.use_kernels = k
                outs[k] = pipe(x.to(torch.bfloat16))
            direct = np.asarray(Image.fromarray(image_mod.signed_to_uint8(
                outs[True])[0].cpu().numpy()).resize(size, Image.LANCZOS))
        else:
            pipe = Pix2PixTurbo.from_pretrained(
                snap, args.model_name, cfgs=cfgs, dtype=torch.bfloat16,
                ckpt_folder=ckpt_dir, device=dev)
            _, arr = inference_paired.load_multiple_of_8(png)
            outs = {}
            for k in (True, False):
                pipe.use_kernels = k
                c_t, kw = inference_paired.prepare(args, arr, torch.bfloat16,
                                                   dev)
                outs[k] = pipe(c_t, prompt=PROMPT, **kw)
            direct = image_mod.signed_to_uint8(outs[True])[0].cpu().numpy()
        del pipe
        if not np.array_equal(direct, got):
            _fail(f"{name} CLI: the PNG differs from the direct pipeline "
                  f"call ({int((direct != got).sum())} values)")
        rel = _rel_l2(outs[True], outs[False])
        if not rel <= PATH_REL_L2_TOL:
            _fail(f"{name} CLI: kernel path vs plain path rel L2 {rel:.3e}")
        runs[name] = {"wall_s": wall, "load_s": res["load_seconds"],
                      "first_image_s": res["image_seconds"],
                      "peak_gib": peak, "png": list(got.shape),
                      "kernel_vs_plain_rel_l2": rel, "launches": counts}
        print(f"  {name} CLI: wall {wall:.2f}s (load {res['load_seconds']:.2f}"
              f"s, first image after load {res['image_seconds']:.3f}s), peak "
              f"{peak:.2f} GiB; PNG {got.shape[1]}x{got.shape[0]} equal to "
              f"the direct call; kernel vs plain rel L2 {rel:.2e}; launches "
              f"{counts}", flush=True)
    return runs


def weights_phase(dev, summary, root: str):
    """The weights phase (module docstring, phase 8): a full-width
    snapshot and three pkls written under `root`, loaded and checked, and
    both inference CLIs run on them. Returns the snapshot's path, which
    the CLI phase's pix2pix runs train from."""
    import os
    import torch
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs

    cfgs = GeneratorConfigs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    snap, ckpt_dir = (os.path.join(root, n) for n in ("sd-turbo",
                                                     "checkpoints"))
    os.makedirs(ckpt_dir)
    t0 = time.perf_counter()
    sds, files = write_snapshot(snap, cfgs, dev)
    pkls = write_pkls(ckpt_dir, cfgs, sds, dev)
    n_params = sum(v.numel() for sd in sds.values() for v in sd.values())
    print(f"weights phase: wrote a full-width SD-Turbo snapshot (fp16, "
          f"{n_params / 1e9:.3f} G values: "
          + ", ".join(f"{p} {n / 1e9:.3f} GB in {dt:.2f}s"
                      for p, (_, n, dt) in files.items())
          + ") and pkls (" + ", ".join(
              f"{k} {os.path.getsize(p) / 1e9:.3f} GB"
              for k, (p, _) in pkls.items())
          + f") in {time.perf_counter() - t0:.1f}s", flush=True)
    out = load_checks(dev, cfgs, snap, ckpt_dir, sds, pkls)
    del sds, pkls
    torch.cuda.synchronize()
    out["peak_gib_load"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.empty_cache()
    print(f"  peak device memory (write + load checks): "
          f"{out['peak_gib_load']:.2f} GiB", flush=True)
    out["cli"] = inference_clis(dev, cfgs, snap, ckpt_dir,
                                os.path.join(ckpt_dir, "cyclegan.pkl"), root)
    out["snapshot_bytes"] = {p: n for p, (_, n, _) in files.items()}
    summary["weights"] = out
    return snap


CLI_STEPS = 3   # training steps of each CLI's first run


def _write_datasets(root: str):
    """The CLI phase's two datasets, from seeded synthetic images: paired
    (train_A / train_B, 4 pairs at 512x512, test_A / test_B, 2 pairs, with
    prompt files) and unpaired (4 + 4 train and 2 + 2 test images at
    256x256, with the fixed prompts)."""
    import json as json_mod
    import os
    from PIL import Image
    paired_dir, unpaired_dir = (os.path.join(root, n)
                                for n in ("paired", "unpaired"))
    seed = 100
    for split, n in (("train", 4), ("test", 2)):
        prompts = {}
        for i in range(n):
            name = f"{split}_{i}.png"
            for d, hw, folder in (("A", 512, paired_dir),
                                  ("B", 512, paired_dir),
                                  ("A", 256, unpaired_dir),
                                  ("B", 256, unpaired_dir)):
                os.makedirs(os.path.join(folder, f"{split}_{d}"),
                            exist_ok=True)
                seed += 1
                Image.fromarray(synth_image(hw, hw, seed)[0]).save(
                    os.path.join(folder, f"{split}_{d}", name))
            prompts[name] = f"a photo of scene {i}"
        with open(os.path.join(paired_dir, f"{split}_prompts.json"),
                  "w") as f:
            json_mod.dump(prompts, f)
    for ab, text in (("a", "driving in the day"),
                     ("b", "driving in the night")):
        with open(os.path.join(unpaired_dir, f"fixed_prompt_{ab}.txt"),
                  "w") as f:
            f.write(text)
    return paired_dir, unpaired_dir


def _metrics_rows(out_dir: str):
    import json as json_mod
    import os
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json_mod.loads(line) for line in f]
    for row in rows:
        bad = {k: v for k, v in row.items()
               if not isinstance(v, (int, float)) or not math.isfinite(v)}
        if bad:
            _fail(f"{out_dir}/metrics.jsonl: non-finite values {bad}")
    return rows


def _row_with(rows, step: int, keys) -> dict:
    """The metrics row of `step` that carries all of `keys`."""
    for row in rows:
        if row["step"] == step and set(keys) <= set(row):
            return row
    _fail(f"no metrics row at step {step} with keys {sorted(keys)}: {rows}")


def _cli_run(name, main_fn, args, dev, steps, per_step, summary):
    """One CLI run with the counters zeroed just before it: its wall time,
    peak memory and launches; K7's and the du's launches must be `steps`
    times `per_step`'s, and every other kernel's at least that."""
    import gc
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    gc.collect()   # an earlier run's models sit in reference cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) / 2 ** 30
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = main_fn(args, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    counts = dict(_build.launch_counts)
    du = sum(_shapes("conv3x3_input_grad").values())
    if out["steps_run"] != steps:
        _fail(f"{name}: {out['steps_run']} steps, expected {steps}")
    want = {k: steps * v for k, v in per_step.items()}
    got = dict(counts, conv3x3_input_grad=du)
    for k, v in want.items():
        exact = k in ("flash_attention_folded_bwd", "conv3x3_input_grad")
        if (got.get(k, 0) != v) if exact else (got.get(k, 0) < v):
            _fail(f"{name}: {k} launched {got.get(k, 0)} times, expected "
                  f"{'exactly' if exact else 'at least'} {v} ({steps} steps "
                  f"x {per_step[k]})")
    print(f"  {name}: steps {out['start_step']}->{out['end_step']}, wall "
          f"{wall:.1f}s, eval/validation {out['eval_seconds']:.1f}s, peak "
          f"memory {peak:.2f} GiB ({held:.2f} GiB held before the run); "
          f"launches {counts}, du {du}", flush=True)
    summary["paths"][name] = counts
    summary["cli"][name] = {"wall_s": wall, "eval_s": out["eval_seconds"],
                            "peak_gib": peak, "held_gib": held,
                            "start_step": out["start_step"],
                            "end_step": out["end_step"],
                            "steps_run": out["steps_run"], "launches": counts,
                            "du_launches": du}
    return out


def cli_phase(dev, summary, sd_turbo_path: str):
    """Both training CLIs through their `main` at full width (module
    docstring, phase 9), the pix2pix runs from the weights phase's
    snapshot `sd_turbo_path` (its UNet, VAE and text encoder, prompts
    through its BPE tokenizer). The per-step launches of phases 6 and 7
    (one paired step at 512x512 and one unpaired step at 256x256, both b1)
    set what each run must launch."""
    import os
    import tempfile
    import torch
    from img2img_turbo_tpu_torch.cli import (train_cyclegan_turbo,
                                             train_pix2pix_turbo)
    from img2img_turbo_tpu_torch.training import runner
    from img2img_turbo_tpu_torch.utils import config_args

    per_step = {}
    for path in ("train", "unpaired"):
        counts = dict(summary["paths"][path])
        counts["conv3x3_input_grad"] = sum(summary["du_shapes"][path]
                                           .values())
        per_step[path] = counts
    summary["cli"] = {}
    print("CLI phase: both training CLIs at SD-Turbo width, random weights",
          flush=True)
    with tempfile.TemporaryDirectory() as root:
        paired_dir, unpaired_dir = _write_datasets(root)

        # ---- pix2pix-turbo: 3 steps, then resumed to 4 ------------------
        out = os.path.join(root, "out_pix2pix")
        common = ["--dataset_folder", paired_dir, "--output_dir", out,
                  "--train_batch_size", "1", "--mixed_precision", "bf16",
                  "--gradient_checkpointing", "--checkpointing_steps", "2",
                  "--eval_freq", "3", "--num_samples_eval", "2",
                  "--track_val_fid", "--viz_freq", "3",
                  "--sd_turbo_path", sd_turbo_path]
        # what the CLI's loader returned: the snapshot's BPE tokenizer
        load_base_models, loaded = runner.load_base_models, []

        def recording(cfgs, generator, path=None):
            out_ = load_base_models(cfgs, generator, path)
            loaded.append((path, type(out_[3]).__name__))
            return out_
        runner.load_base_models = recording
        try:
            _cli_run("cli_pix2pix", train_pix2pix_turbo.main,
                     config_args.parse_args_paired_training(
                         common + ["--max_train_steps", str(CLI_STEPS)]),
                     dev, CLI_STEPS, per_step["train"], summary)
        finally:
            runner.load_base_models = load_base_models
        if loaded != [(sd_turbo_path, "CLIPTokenizer")]:
            _fail(f"the pix2pix CLI loaded {loaded}, not the snapshot and "
                  f"its BPE tokenizer")
        print(f"  pix2pix CLI trained from the snapshot {sd_turbo_path} with "
              f"its BPE tokenizer", flush=True)
        if sorted(os.listdir(os.path.join(out, "state"))) != ["2.pt", "3.pt"]:
            _fail(f"pix2pix checkpoints: {os.listdir(out + '/state')}")
        res = _cli_run("cli_pix2pix_resume", train_pix2pix_turbo.main,
                       config_args.parse_args_paired_training(
                           common + ["--max_train_steps", "4", "--resume"]),
                       dev, 1, per_step["train"], summary)
        if (res["start_step"], res["end_step"]) != (CLI_STEPS, 4):
            _fail(f"the resumed pix2pix run ran {res}")
        rows = _metrics_rows(out)
        step_keys = ("loss_l2", "loss_lpips", "loss_clipsim", "loss_gan_g",
                     "loss_d_real", "loss_d_fake", "steps_per_sec")
        for step in (1, 4):   # the first step of each run
            _row_with(rows, step, step_keys)
        ev = _row_with(rows, 3, ("val_l2", "val_lpips", "val_clipsim",
                                 "val_fid"))
        saved = torch.load(os.path.join(out, "state", "4.pt"),
                           map_location="cpu", weights_only=True)
        if saved["step"] != 4:
            _fail(f"pix2pix state 4.pt holds step {saved['step']}")
        for step in (2, 3, 4):
            pkl = torch.load(os.path.join(out, "checkpoints",
                                          f"model_{step}.pkl"),
                             map_location="cpu", weights_only=True)
            keys = {"unet_lora_target_modules", "vae_lora_target_modules",
                    "rank_unet", "rank_vae", "state_dict_unet",
                    "state_dict_vae"}
            sd_u, sd_v = pkl.get("state_dict_unet", {}), \
                pkl.get("state_dict_vae", {})
            if set(pkl) != keys or "conv_in.weight" not in sd_u \
                    or not any(".lora_A.default." in k for k in sd_u) \
                    or "decoder.skip_conv_1.base_layer.weight" not in sd_v \
                    or not any(".lora_A.vae_skip." in k for k in sd_v):
                _fail(f"pix2pix model_{step}.pkl: keys {sorted(pkl)}")
        if not os.path.exists(os.path.join(out, "viz", "step_3.png")):
            _fail("no pix2pix viz panel at step 3")
        print(f"  pix2pix eval at step 3: {ev}; pkl state_dict_unet "
              f"{len(sd_u)} tensors, state_dict_vae {len(sd_v)}", flush=True)

        # ---- CycleGAN-Turbo: 3 steps with validation, then resumed ------
        out = os.path.join(root, "out_cyclegan")
        common = ["--dataset_folder", unpaired_dir, "--output_dir", out,
                  "--tracker_project_name", "chip_smoke",
                  "--train_img_prep", "no_resize", "--val_img_prep",
                  "no_resize", "--train_batch_size", "1",
                  "--validation_steps", "3", "--validation_num_images", "2",
                  "--checkpointing_steps", "3", "--viz_freq", "3",
                  "--max_train_steps", str(CLI_STEPS)]
        _cli_run("cli_cyclegan", train_cyclegan_turbo.main,
                 config_args.parse_args_unpaired_training(common), dev,
                 CLI_STEPS, per_step["unpaired"], summary)
        res = _cli_run("cli_cyclegan_resume", train_cyclegan_turbo.main,
                       config_args.parse_args_unpaired_training(
                           common + ["--resume"]),
                       dev, 0, per_step["unpaired"], summary)
        if res["start_step"] != CLI_STEPS:
            _fail(f"the resumed CycleGAN run started at {res}")
        rows = _metrics_rows(out)
        _row_with(rows, 1, ("cycle_a", "cycle_b", "gan_a", "gan_b", "idt_a",
                            "idt_b", "disc_fake", "disc_real",
                            "steps_per_sec"))
        val = _row_with(rows, 3, ("fid_a2b", "fid_b2a", "dino_struct_a2b",
                                  "dino_struct_b2a"))
        pkl = torch.load(os.path.join(out, "checkpoints", "model_3.pkl"),
                         map_location="cpu", weights_only=True)
        keys = {"l_target_modules_encoder", "l_target_modules_decoder",
                "l_modules_others", "rank_unet", "sd_encoder", "sd_decoder",
                "sd_other", "rank_vae", "vae_lora_target_modules",
                "sd_vae_enc", "sd_vae_dec"}
        sd_v = pkl.get("sd_vae_enc", {})
        if set(pkl) != keys or pkl["rank_unet"] != 128 \
                or not pkl["sd_encoder"] or not pkl["sd_decoder"] \
                or not pkl["sd_other"] \
                or "vae.decoder.skip_conv_1.base_layer.weight" not in sd_v \
                or "vae_b2a.decoder.skip_conv_1.base_layer.weight" not in sd_v:
            _fail(f"CycleGAN model_3.pkl: keys {sorted(pkl)}")
        pngs = {d: sorted(os.listdir(os.path.join(out, "fid-3",
                                                  f"samples_{d}")))
                for d in ("a2b", "b2a")}
        if any(len(v) != 2 for v in pngs.values()) or not os.path.exists(
                os.path.join(out, "viz", "step_3.png")):
            _fail(f"CycleGAN validation / viz files: {pngs}")
        print(f"  CycleGAN validation at step 3: {val}; pkl sd_vae_enc "
              f"{len(sd_v)} tensors", flush=True)
    summary["cli"]["pix2pix_eval"] = ev
    summary["cli"]["cyclegan_validation"] = val


# ---------------------------------------------------------------------------
# DP phase: data parallelism on torch.distributed
# ---------------------------------------------------------------------------

DP_WORLD = 2        # gloo ranks sharing the one card


def _state_all(state) -> dict:
    """Every tensor of a train state by name: the trainables, the heads,
    the spectral-norm vectors and both AdamW moments."""
    out = dict(_state_tensors(state))
    for part, opt, params in (("gen", state.gen_opt, state.gen),
                              ("disc", state.disc_opt, state.disc)):
        for k, p_ in params.items():
            for m, v in opt.state.get(p_, {}).items():
                if hasattr(v, "shape"):
                    out[f"{part}_opt.{m}.{k}"] = v
    return out


def _same_state(a, b) -> list:
    """Names of the tensors that differ between two train states."""
    import torch
    a, b = _state_all(a), _state_all(b)
    if set(a) != set(b):
        return sorted(set(a) ^ set(b))
    return [n for n in a if not torch.equal(a[n], b[n])]


def _dp_setup(rank: int, world: int, init_file: str):
    """A rank's process: the card, the smoke's numerics flags, the kernels
    (built by the parent), the gloo group and the data mesh."""
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _build.build()
    mesh_mod.init_distributed("file://" + init_file, world, rank,
                              device=dev, backend="gloo")
    return dev, mesh_mod.make_mesh(device=dev)


def _timed_step(step, state, batch, noise, mesh):
    """One step with the launch counters and the mesh's all-reduce stats
    reset before it; returns (metrics as floats, ms by CUDA events, launch
    counts, all-reduce stats)."""
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    if mesh is not None:
        mesh.reset_stats()
    s_ev = torch.cuda.Event(enable_timing=True)
    e_ev = torch.cuda.Event(enable_timing=True)
    s_ev.record()
    m, _ = step(state, batch, noise)
    e_ev.record()
    e_ev.synchronize()
    return ({n: float(v) for n, v in m.items()}, s_ev.elapsed_time(e_ev),
            dict(_build.launch_counts),
            dict(mesh.stats) if mesh is not None else None)


def _paired_row(cfgs, dev, i: int):
    """Row i of the DP phase's paired batches: row 0 is the train phase's
    (synth images 3 and 4, ids from a generator seeded 4322)."""
    import torch
    from img2img_turbo_tpu_torch.ops import canny as canny_mod
    h = w = TRAIN_HW
    img = torch.as_tensor(synth_image(h, w, 3 + 10 * i), device=dev)
    g = torch.Generator(device=dev).manual_seed(4322 + i)
    return {"conditioning_pixel_values":
            canny_mod.canny_3ch_unit(img, 100, 200),
            "output_pixel_values": torch.as_tensor(
                synth_image(h, w, 4 + 10 * i), device=dev).float()
            / 127.5 - 1.0,
            "input_ids": torch.randint(0, cfgs.text.vocab_size, (1, 77),
                                       generator=g, device=dev)}


def _dp_paired(mesh, dev) -> dict:
    """(a) the paired step at full width, 512x512, each rank b1, seeds as
    the train phase's: tiled (both ranks the train phase's row and noise),
    held against this process's one-process step; distinct (rank r row r,
    the global noise's row r), a warm-up and TRAIN_STEPS timed steps with
    the all-reduce timed; (c) rank 0: NCCL at world size 1 through a
    one-rank NCCL group, against the step without a mesh."""
    import torch
    import torch.distributed as dist
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import losses, paired, runner
    cfgs = GeneratorConfigs()
    t0 = time.perf_counter()
    models, state0, meta = runner.build_paired_run(
        cfgs, clip_vit.CLIP_VIT_B32, seed=4321, device=dev)
    frozen_differ = mesh_mod.differing(
        {n: getattr(models, n) for n in ("unet", "vae", "text", "lpips",
                                         "disc_backbone", "clip")}, mesh)

    def make(m):
        return paired.make_paired_train_step(
            models, cfgs, losses.PairedLossConfig(), meta, kernels=True,
            remat=True, dtype=torch.bfloat16, mesh=m)

    def noise(i, b=1):
        g = torch.Generator(device=dev).manual_seed(1000 + i)
        return tuple(paired.draw_noise(g, b, TRAIN_HW, TRAIN_HW, cfgs,
                                       torch.bfloat16) for _ in range(2))

    out = {"setup_s": time.perf_counter() - t0, "frozen_differ":
           frozen_differ, "trainable": sum(v.numel()
                                           for v in state0.gen.values())}
    row0 = _paired_row(cfgs, dev, 0)
    one = _snapshot(state0)
    out["one_metrics"], out["one_ms"], out["one_counts"], _ = _timed_step(
        make(None), one, row0, noise(0), None)
    step = make(mesh)
    tiled = mesh_mod.replicate(_snapshot(state0), mesh)
    out["tiled_metrics"], out["tiled_ms"], out["tiled_counts"], \
        out["tiled_allreduce"] = _timed_step(step, tiled, row0, noise(0),
                                             mesh)
    out["tiled_vs_one_differ"] = _same_state(tiled, one)
    out["tiled_metrics_equal"] = out["tiled_metrics"] == out["one_metrics"]
    out["tiled_ranks_differ"] = mesh_mod.differing(
        {"state": _state_all(tiled)}, mesh)
    del tiled

    # distinct rows: rank r takes row r of the global batch and its noise
    row = _paired_row(cfgs, dev, mesh.rank)
    st = mesh_mod.replicate(_snapshot(state0), mesh)
    mesh.timed = True
    runs = [_timed_step(step, st, row, mesh_mod.shard_batch(
        noise(100 + i, DP_WORLD), mesh), mesh)
        for i in range(1 + TRAIN_STEPS)]
    mesh.timed = False
    out["distinct_metrics"] = [r[0] for r in runs]
    out["distinct_ms"] = [r[1] for r in runs]
    out["distinct_counts"] = runs[0][2]
    out["distinct_allreduce"] = [r[3] for r in runs]
    out["distinct_ranks_differ"] = mesh_mod.differing(
        {"state": _state_all(st)}, mesh)
    out["gen_pass_bytes"] = 4 * (out["trainable"] + 3)
    del st

    # (c) NCCL at world size 1: a one-rank NCCL group beside the gloo world
    nccl = dist.new_group([0], backend="nccl")
    if mesh.rank == 0:
        m1 = mesh_mod.make_mesh(device=dev, group=nccl)
        m1.timed = True
        st = _snapshot(state0)
        out["nccl_metrics"], out["nccl_ms"], out["nccl_counts"], \
            out["nccl_allreduce"] = _timed_step(make(m1), st, row0,
                                                noise(0), m1)
        out["nccl_backend"] = str(m1.backend)
        out["nccl_vs_one_differ"] = _same_state(st, one)
        del st
    mesh_mod.barrier(mesh)
    return out


def _dp_unpaired(mesh, dev) -> dict:
    """(b) the unpaired step at full width, 256x256, each rank b1, tiled
    (the unpaired phase's row and noise), against this process's
    one-process step."""
    import torch
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import losses, runner, unpaired
    cfgs = GeneratorConfigs()
    t0 = time.perf_counter()
    models, state0, meta = runner.build_unpaired_run(
        cfgs, clip_vit.CLIP_VIT_B32, seed=5432, device=dev)
    out = {"frozen_differ": mesh_mod.differing(
        {n: getattr(models, n) for n in ("unet", "vae_a2b", "vae_b2a",
                                         "lpips", "disc_backbone")}, mesh),
        "trainable": sum(v.numel() for v in state0.gen.values())}
    batch, noise_of = _unpaired_inputs(cfgs, dev)
    noise = noise_of(0)
    out["setup_s"] = time.perf_counter() - t0

    def make(m):
        return unpaired.make_unpaired_train_step(
            models, cfgs, losses.UnpairedLossConfig(), meta, kernels=True,
            remat=True, dtype=torch.bfloat16, mesh=m)

    one = _snapshot(state0)
    out["one_metrics"], out["one_ms"], out["one_counts"], _ = _timed_step(
        make(None), one, batch, noise, None)
    tiled = mesh_mod.replicate(_snapshot(state0), mesh)
    del state0
    mesh.timed = True
    out["tiled_metrics"], out["tiled_ms"], out["tiled_counts"], \
        out["tiled_allreduce"] = _timed_step(make(mesh), tiled, batch, noise,
                                             mesh)
    mesh.timed = False
    out["tiled_vs_one_differ"] = _same_state(tiled, one)
    out["tiled_metrics_equal"] = out["tiled_metrics"] == out["one_metrics"]
    out["tiled_ranks_differ"] = mesh_mod.differing(
        {"state": _state_all(tiled)}, mesh)
    return out


def _dp_engine(mesh, dev) -> dict:
    """(d) `ServingEngine(mode="edge_to_image", mesh=...)` at full width,
    a global batch of 2 at 512x512: each rank's rows against the engine
    without a mesh on those rows with the global noise's rows; the
    gathered batch the same on every rank."""
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    from img2img_turbo_tpu_torch.weights import from_jax
    cfgs = GeneratorConfigs()
    g = torch.Generator(device=dev).manual_seed(1234)
    params = {"unet": from_jax.random_model(cfgs.unet, g),
              "vae": from_jax.random_model(cfgs.vae, g)}
    caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim, generator=g,
                          device=dev)
    eng = ServingEngine(params, cfgs, dtype=torch.bfloat16, mesh=mesh)
    out = {"params_differ": mesh_mod.differing(params, mesh)}
    imgs = torch.cat([torch.as_tensor(synth_image(512, 512, i), device=dev)
                      for i in range(DP_WORLD)])
    eng.run(imgs, caption, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    got = eng.run(imgs, caption,
                  torch.Generator(device=dev).manual_seed(0))["out"]
    torch.cuda.synchronize()
    out["mesh_s"] = time.perf_counter() - t0
    out["mesh_counts"] = dict(_build.launch_counts)
    lat = (DP_WORLD, 64, 64, cfgs.vae.latent_channels)
    noise = torch.randn(lat, generator=torch.Generator(device=dev)
                        .manual_seed(0), device=dev, dtype=torch.bfloat16)
    eng.mesh = None
    rows = mesh_mod.shard_batch({"img": imgs, "noise": noise}, mesh)
    _build.reset_launch_counts()
    one = eng.run(rows["img"], caption, noise=rows["noise"])["out"]
    out["one_counts"] = dict(_build.launch_counts)
    out["rows_equal"] = bool(torch.equal(
        mesh_mod.shard_batch(got, mesh), one))
    out["gathered_differ"] = mesh_mod.differing({"out": got}, mesh)
    out["shape"] = list(got.shape)
    return out


def _dp_rank(rank: int, world: int, init_file: str, out_dir: str):
    """One spawned rank of the DP phase: (a), (c), (b), (d) in turn, its
    results written as JSON for the parent to check."""
    import gc
    import os
    import torch
    import torch.distributed as dist
    dev, mesh = _dp_setup(rank, world, init_file)
    res = {"backend": mesh.backend, "world": mesh.world}
    for name, fn in (("paired", _dp_paired), ("unpaired", _dp_unpaired),
                     ("engine", _dp_engine)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        res[name] = fn(mesh, dev)
        res[name]["wall_s"] = time.perf_counter() - t0
        res[name]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dp_phase(dev, summary):
    """The DP phase (module docstring, phase 10): DP_WORLD gloo ranks
    sharing the card, spawned with a file:// rendezvous in a temporary
    directory; every check's failure fails the smoke."""
    import gc
    import os
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_dp_rank, args=(DP_WORLD, os.path.join(d, "rendezvous"), d),
                 nprocs=DP_WORLD, join=True)
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    print(f"DP phase: {DP_WORLD} gloo ranks sharing one card (the exchange "
          f"goes through the host; not NCCL), spawned, wall {wall:.1f}s; "
          f"{smi}", flush=True)
    for r, res in enumerate(ranks):
        p_, u_, e_ = res["paired"], res["unpaired"], res["engine"]
        for what, bad in (("paired frozen modules", p_["frozen_differ"]),
                          ("unpaired frozen modules", u_["frozen_differ"]),
                          ("engine weights", e_["params_differ"])):
            if bad:
                _fail(f"DP rank {r}: {what} differ across ranks: {bad}")
        for name, part, expected in (("paired", p_, EXPECTED_TRAIN_LAUNCHES),
                                     ("unpaired", u_,
                                      EXPECTED_UNPAIRED_LAUNCHES)):
            if part["tiled_vs_one_differ"] or not part["tiled_metrics_equal"]:
                _fail(f"DP rank {r}: the tiled {name} step differs from the "
                      f"one-process step: {part['tiled_vs_one_differ'][:8]} "
                      f"{part['tiled_metrics']} {part['one_metrics']}")
            if part["tiled_ranks_differ"]:
                _fail(f"DP rank {r}: the tiled {name} state differs across "
                      f"ranks")
            if not part["tiled_counts"] == part["one_counts"] == expected:
                _fail(f"DP rank {r}: {name} launches {part['tiled_counts']}, "
                      f"one-process {part['one_counts']}, expected "
                      f"{expected}")
        if p_["distinct_ranks_differ"] or not all(
                np.isfinite(v) for m in p_["distinct_metrics"]
                for v in m.values()):
            _fail(f"DP rank {r}: distinct-row paired steps: state differs "
                  f"across ranks or metrics not finite "
                  f"{p_['distinct_metrics']}")
        if p_["distinct_counts"] != EXPECTED_TRAIN_LAUNCHES:
            _fail(f"DP rank {r}: distinct-row launches "
                  f"{p_['distinct_counts']}")
        if r == 0 and (p_["nccl_vs_one_differ"] or p_["nccl_backend"] !=
                       "nccl" or not p_["nccl_allreduce"]["calls"] or
                       p_["nccl_metrics"] != p_["one_metrics"]):
            _fail(f"DP rank 0: the NCCL world-size-1 step differs from the "
                  f"step without a mesh: {p_['nccl_vs_one_differ'][:8]}, "
                  f"{p_['nccl_backend']}, {p_['nccl_allreduce']}")
        if not e_["rows_equal"] or e_["gathered_differ"] \
                or e_["mesh_counts"] != e_["one_counts"] \
                or e_["mesh_counts"] != EXPECTED_LAUNCHES:
            _fail(f"DP rank {r}: engine rows equal {e_['rows_equal']}, "
                  f"gathered differ {e_['gathered_differ']}, launches "
                  f"{e_['mesh_counts']} vs {e_['one_counts']}")
        times = sorted(p_["distinct_ms"][1:])
        ar = p_["distinct_allreduce"][1:]
        calls = sum(a["calls"] for a in ar)
        ar_pass_ms = 1e3 * sum(a["seconds"] for a in ar) / max(calls, 1)
        uar = u_["tiled_allreduce"]
        print(f"  rank {r}: paired 512x512 b1 a rank: tiled step "
              f"{p_['tiled_ms']:.2f} ms (one-process "
              f"{p_['one_ms']:.2f} ms) bit-identical to the one-process "
              f"step and across ranks; distinct rows p50 "
              f"{times[len(times) // 2]:.2f} ms over {len(times)} steps "
              f"{[round(t, 2) for t in p_['distinct_ms']]}; all-reduce "
              f"{ar_pass_ms:.2f} ms a pass ({calls // len(ar)} a step, "
              f"{ar[0]['bytes'] / 1e6:.2f} MB a step, the generator pass "
              f"{p_['gen_pass_bytes'] / 1e6:.2f} MB) through gloo via the "
              f"host; peak {p_['peak_gib']:.2f} GiB", flush=True)
        print(f"  rank {r}: unpaired 256x256 b1 a rank: tiled step "
              f"{u_['tiled_ms']:.2f} ms (one-process {u_['one_ms']:.2f} ms) "
              f"bit-identical to the one-process step and across ranks; "
              f"all-reduce {1e3 * uar['seconds']:.2f} ms over "
              f"{uar['calls']} passes, {uar['bytes'] / 1e6:.2f} MB a step "
              f"({u_['trainable'] / 1e6:.2f}M trainables); peak "
              f"{u_['peak_gib']:.2f} GiB", flush=True)
        print(f"  rank {r}: engine edge_to_image global batch "
              f"{e_['shape'][0]} at 512x512 in {1e3 * e_['mesh_s']:.2f} ms; "
              f"rows bit-identical to the one-process b1 call, gathered "
              f"batch the same on every rank; launches {e_['mesh_counts']}",
              flush=True)
        if r == 0:
            print(f"  rank 0: NCCL at world size 1: step "
                  f"{p_['nccl_ms']:.2f} ms, bit-identical to the step "
                  f"without a mesh; all-reduce {p_['nccl_allreduce']}",
                  flush=True)
    summary["dp"] = {"wall_s": wall, "card": smi, "ranks": [
        {"paired": {k: res["paired"][k] for k in (
            "tiled_ms", "one_ms", "distinct_ms", "distinct_allreduce",
            "tiled_allreduce", "gen_pass_bytes", "peak_gib", "wall_s")},
         "unpaired": {k: res["unpaired"][k] for k in (
             "tiled_ms", "one_ms", "tiled_allreduce", "peak_gib", "wall_s")},
         "engine": {k: res["engine"][k] for k in ("mesh_s", "wall_s")},
         "nccl_world1": {k: res["paired"][k] for k in (
             "nccl_ms", "nccl_allreduce") if k in res["paired"]}}
        for res in ranks]}


# ---------------------------------------------------------------------------
# model-axis phase: the UNet sharded over two model ranks sharing the card
# ---------------------------------------------------------------------------

TP_WORLD = 2        # gloo model ranks sharing the one card: a (1, 2) mesh


def _param_bytes(module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _sha(t) -> str:
    """A tensor's bytes, hashed: equal on two ranks only if bit-identical."""
    import hashlib
    import torch
    b = t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(b.tobytes()).hexdigest()


def _shard_mismatch(model, cfgs, n_model: int, vae: bool = False) -> list:
    """Names of `model`'s parameters (the SD-Turbo UNet's, or with `vae` a
    VAE's) whose shape is not this rank's shard of the whole model's (a
    meta model) by `parallel.tensor`'s rule, or whose module is sharded
    and not marked so."""
    import torch
    from img2img_turbo_tpu_torch.models.unet import UNet2DConditionModel
    from img2img_turbo_tpu_torch.models.vae import AutoencoderKL
    from img2img_turbo_tpu_torch.parallel import tensor as tensor_mod
    with torch.device("meta"):
        whole = dict((AutoencoderKL(cfgs.vae) if vae else
                      UNet2DConditionModel(cfgs.unet)).named_parameters())
    specs = tensor_mod.param_shardings(
        whole, n_model, tensor_mod.vae_head_dim(cfgs.vae) if vae else
        tensor_mod.head_dim(cfgs.unet))
    modules = dict(model.named_modules())
    bad = []
    for name, p in model.named_parameters():
        shape, dim = list(whole[name].shape), specs[name]
        if dim is not None:
            shape[dim] //= n_model
        marked = getattr(modules[name.rsplit(".", 1)[0]], "tp_sharded",
                         False)
        if list(p.shape) != shape or (dim is not None and not marked):
            bad.append(name)
    return bad


def _tp_serve(tp, dev, params, caption, img, mode: str, timed: bool) -> dict:
    """One mode under the model axis: the one-process kernel-path engine on
    `params` first (a warm-up and one request on fixed posterior noise),
    then `ServingEngine(mesh=tp)` on the same weights (the UNet sharded in
    place): its UNet parameters against its shards, a warm-up, one request
    with the launch counters read around it, a repeat, and the request
    against the one-process one; with `timed`, the p50 of 5 requests (CUDA
    events) and one request with the collectives timed."""
    import collections
    import torch
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.serving.engine import ServingEngine
    cfgs, bf = GeneratorConfigs(), torch.bfloat16

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    noise = torch.randn(1, 64, 64, 4, generator=gen(7), device=dev, dtype=bf)
    one = ServingEngine(params, cfgs, mode=mode, dtype=bf, device=dev)
    whole_bytes = _param_bytes(one.unet)
    one.run(img, caption, noise=noise)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    ref = one.run(img, caption, noise=noise)
    torch.cuda.synchronize()
    out = {"one_counts": dict(_build.launch_counts),
           "one_k2": [[list(sh), n] for (k, sh), n in
                      _build.launch_shapes.items()
                      if k == "flash_attention_folded"],
           "one_shapes": [[k, list(sh)] for k, sh in _build.launch_shapes]}
    ref = {k: ref[k].clone() for k in ("x0", "img", "out")}
    del one

    eng = ServingEngine(params, cfgs, mode=mode, dtype=bf, device=dev,
                        mesh=tp)
    out.update(unet_bytes=_param_bytes(eng.unet), whole_bytes=whole_bytes,
               shard_mismatch=_shard_mismatch(eng.unet, cfgs, tp.n_model))
    eng.run(img, caption, noise=noise)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = eng.run(img, caption, noise=noise)
    torch.cuda.synchronize()
    out["counts"] = dict(_build.launch_counts)
    out["shapes"] = [[k, list(sh), n]
                     for (k, sh), n in _build.launch_shapes.items()]
    k2 = collections.Counter()
    for sh, n in out["one_k2"]:   # K2 on the local heads where they split
        heads = sh[3] // tp.n_model if sh[3] % tp.n_model == 0 else sh[3]
        k2[(*sh[:3], heads, sh[4])] += n
    out["k2_local_heads"] = dict(k2) == {
        tuple(sh): n for k, sh, n in out["shapes"]
        if k == "flash_attention_folded"}
    again = eng.run(img, caption, noise=noise)
    out["repeat_equal"] = all(torch.equal(again[k], got[k])
                              for k in ("x0", "img", "out"))
    out["rel_l2"] = {k: _rel_l2(got[k], ref[k]) for k in ("x0", "img")}
    diff = (got["out"].int() - ref["out"].int()).abs()
    out["uint8"] = {"max": int(diff.max()),
                    "frac_differ": float((diff > 0).float().mean())}
    out["sha"] = {k: _sha(got[k]) for k in ("x0", "img", "out")}
    out["finite"] = bool(torch.isfinite(got["img"].float()).all())
    if timed:
        times = []
        for i in range(5):
            s_ev = torch.cuda.Event(enable_timing=True)
            e_ev = torch.cuda.Event(enable_timing=True)
            s_ev.record()
            eng(img, caption, gen(100 + i))
            e_ev.record()
            e_ev.synchronize()
            times.append(s_ev.elapsed_time(e_ev))
        out["ms"] = times
        tp.reset_stats()
        tp.timed = True
        t0 = time.perf_counter()
        eng(img, caption, gen(200))
        torch.cuda.synchronize()
        out["timed_request_ms"] = 1e3 * (time.perf_counter() - t0)
        tp.timed = False
        out["collectives"] = dict(tp.stats)
    return out


def _tp_rank(rank: int, world: int, init_file: str, out_dir: str):
    """One spawned rank of the model-axis phase: edge_to_image on phase 4's
    weights (seed 1234), then image a2b on phase 5's CycleGAN (seed 2345),
    its results written as JSON for the parent to check."""
    import gc
    import os
    import torch
    import torch.distributed as dist
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.weights import from_jax
    dev, _ = _dp_setup(rank, world, init_file)
    tp = mesh_mod.make_mesh(1, world, device=dev)
    cfgs = GeneratorConfigs()
    res = {"backend": tp.backend, "model_rank": tp.model_rank,
           "n_model": tp.n_model}
    for name in ("edge", "image_a2b"):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        if name == "edge":
            g = torch.Generator(device=dev).manual_seed(1234)
            params = {"unet": from_jax.random_model(cfgs.unet, g),
                      "vae": from_jax.random_model(cfgs.vae, g)}
            img = synth_image(512, 512, 0)
        else:
            g = torch.Generator(device=dev).manual_seed(2345)
            cyc = from_jax.random_cyclegan_model(cfgs, g)
            params = {"unet": cyc["unet"], "vae": cyc["vae_a2b"]}
            del cyc
            img = synth_image(512, 512, 5)
        caption = torch.randn(1, 77, cfgs.unet.cross_attention_dim,
                              generator=g, device=dev)
        res[name] = _tp_serve(tp, dev, params, caption,
                              torch.as_tensor(img, device=dev),
                              "edge_to_image" if name == "edge" else "image",
                              timed=name == "edge")
        res[name]["wall_s"] = time.perf_counter() - t0
        res[name]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        del params
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def tp_phase(dev, summary) -> dict:
    """The model-axis phase (module docstring, phase 12): TP_WORLD gloo
    ranks sharing the card at a (1, TP_WORLD) mesh, spawned with a file://
    rendezvous in a temporary directory; every check's failure fails the
    smoke. Returns {kernel: the launch shapes the ranks ran that the
    one-process requests did not}, for the new kernel cases."""
    import gc
    import os
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_tp_rank, args=(TP_WORLD, os.path.join(d, "rendezvous"), d),
                 nprocs=TP_WORLD, join=True)
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    print(f"model-axis phase: mesh (1, {TP_WORLD}), {TP_WORLD} gloo ranks "
          f"sharing one card (the exchange goes through the host; not "
          f"NCCL), spawned, wall {wall:.1f}s; {smi}", flush=True)
    expected = {"edge": EXPECTED_LAUNCHES, "image_a2b": EXPECTED_LAUNCHES_IMAGE}
    shapes: dict = {}
    one_process: set = set()
    for r, res in enumerate(ranks):
        for mode, want in expected.items():
            m = res[mode]
            what = f"model axis rank {r} {mode}"
            if m["shard_mismatch"] or not m["unet_bytes"] < \
                    0.6 * m["whole_bytes"]:
                _fail(f"{what}: the UNet holds {m['unet_bytes']} bytes of "
                      f"{m['whole_bytes']}, not only its shards: "
                      f"{m['shard_mismatch'][:8]}")
            if not m["counts"] == m["one_counts"] == want:
                _fail(f"{what}: launches {m['counts']}, one-process "
                      f"{m['one_counts']}, expected {want}")
            if not m["k2_local_heads"]:
                _fail(f"{what}: K2 did not run the local heads")
            if not (m["repeat_equal"] and m["finite"]):
                _fail(f"{what}: a repeated request differs or the image is "
                      f"not finite")
            if not m["rel_l2"]["img"] <= PATH_REL_L2_TOL:
                _fail(f"{what}: the image is off the one-process kernel "
                      f"path's by rel L2 {m['rel_l2']} (tol "
                      f"{PATH_REL_L2_TOL:.0e})")
            if m["sha"] != ranks[0][mode]["sha"]:
                _fail(f"{what}: the ranks' results differ")
            for k, sh, n in m["shapes"]:
                shapes.setdefault(k, set()).add(tuple(sh))
            for k, sh in m["one_shapes"]:
                one_process.add((k, tuple(sh)))
            print(f"  rank {r} {mode}: UNet parameters "
                  f"{m['unet_bytes'] / 1e9:.3f} GB of the whole "
                  f"{m['whole_bytes'] / 1e9:.3f} GB (bf16), only its shards; "
                  f"vs the one-process kernel path rel L2 x0 "
                  f"{m['rel_l2']['x0']:.3e}, img {m['rel_l2']['img']:.3e}, "
                  f"uint8 max {m['uint8']['max']} on "
                  f"{100 * m['uint8']['frac_differ']:.3f}% of values; "
                  f"bit-identical across ranks and on a repeat; launches "
                  f"{m['counts']} (K2 on the local heads); wall "
                  f"{m['wall_s']:.1f}s, peak {m['peak_gib']:.2f} GiB",
                  flush=True)
        e = res["edge"]
        times = sorted(e["ms"])
        col = e["collectives"]
        print(f"  rank {r} edge_to_image 512x512 b1: p50 "
              f"{times[len(times) // 2]:.2f} ms over 5 requests "
              f"{[round(t, 2) for t in e['ms']]}; collectives a request "
              f"{col['calls']} calls, {col['bytes'] / 1e6:.2f} MB, "
              f"{1e3 * col['seconds']:.2f} ms when timed (a request "
              f"{e['timed_request_ms']:.2f} ms then), through gloo via the "
              f"host", flush=True)
    summary["paths"]["model_axis"] = ranks[0]["edge"]["counts"]
    summary["model_axis"] = {"wall_s": wall, "card": smi, "ranks": [
        {mode: {k: res[mode][k] for k in (
            "unet_bytes", "whole_bytes", "rel_l2", "uint8", "wall_s",
            "peak_gib") + (("ms", "collectives", "timed_request_ms")
                           if mode == "edge" else ())}
         for mode in expected} for res in ranks]}
    return {k: {sh for sh in v if (k, sh) not in one_process}
            for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# model-axis training phase: both train steps with the UNet sharded over two
# model ranks sharing the card
# ---------------------------------------------------------------------------

# The gate of the model-axis step against the one-process kernel-path step
# at the same seeds (phases 6 and 7's first step), stated before the first
# chip run; its yardstick is phase 6's kernel-vs-plain gap (losses within
# 1.3e-3 relative, pass-1 gradients 4.6e-2 rel L2 against GRAD_REL_L2_TOL).
TP_LOSS_TOL = 1e-2      # each loss of the step, relative
# the trainables and heads after the step: AdamW's first updates move an
# element by about lr, of either sign where its gradient is near zero; the
# gate is that fewer than TP_FLIP_FRAC of them are off the one-process
# value by more than one lr. Every element within 2.1 lr an update is a
# sanity bound only: two first AdamW updates cannot differ by more than
# about 2 lr each. change_rel_l2 (the change's rel L2 against the
# one-process change) is reported, not gated.
TP_FLIP_FRAC = 0.05
TP_GEN_UPDATES = {"paired": 2, "unpaired": 3}   # the heads: 2 in both
# untimed steps after the compared one: with the VAE sharded too, a step
# moves 12.7 GB (paired) / 14.1 GB (unpaired) through the host (counted by
# `DataMesh.stats`), so one keeps the smoke well inside its time limit
TP_TRAIN_STEPS = 1


def _tp_expected(kind: str) -> dict:
    """The du's and K7's launches by shape in a model-axis step at a
    (1, 2) mesh: the one-process step's (tools/time_kernels.py's DU and K7
    tables), the du on the UNet's and the VAE's Co slices (every conv the
    rule shards: an even Co; the VAE decoder's conv_out, Co = 3, whole)
    and K7 on the UNet's local heads where they split (SD-Turbo's level 0
    has 5 heads: whole; the VAE's one head: whole)."""
    import collections
    from img2img_turbo_tpu_torch.tools.time_kernels import (
        DU_CASES, DU_UNPAIRED, K7_CASES, K7_UNPAIRED)
    du, k7 = collections.Counter(), collections.Counter()
    rows = ((DU_CASES, K7_CASES) if kind == "paired"
            else (DU_UNPAIRED, K7_UNPAIRED))
    for c in rows[0]:
        b, h, w, ci, co, n = c[1:7]
        if n:
            split = co % 2 == 0 and co % TP_WORLD == 0
            du[(b, h, w, ci, co // TP_WORLD if split else co)] += n
    for c in rows[1]:
        b, sq, skv, heads, hd, n = c[1:7]
        if c[0].startswith("unet") and heads % TP_WORLD == 0:
            heads //= TP_WORLD
        k7[(b, sq, skv, heads, hd)] += n
    return {"du": dict(du), "k7": dict(k7)}


def _tp_train_step(kind: str, tp, dev, out_dir: str) -> dict:
    """One kind of model-axis step on this rank: the run built from the
    phase-6 (paired, seed 4321, 512x512) or phase-7 (unpaired, seed 5432,
    256x256) seeds, its UNet sharded
    (`runner.shard_for_training`), then the step from the fresh state on
    that phase's first row and noise (the compared step: its metrics,
    first-pass gradients and state after it saved to `out_dir` by model
    rank 0, launches by shape, the collectives' calls and bytes), then
    TP_TRAIN_STEPS more (CUDA events; the step time is theirs: one step's,
    or their p50 when there are more) and a last one with the collectives timed (each one
    synchronised, so that step is not among them); the state checked
    bit-identical across the model ranks after the
    first and the last step."""
    import gc
    import os
    import torch
    from img2img_turbo_tpu_torch.models import clip_vit
    from img2img_turbo_tpu_torch.ops import _build
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    from img2img_turbo_tpu_torch.pipelines.pix2pix import GeneratorConfigs
    from img2img_turbo_tpu_torch.training import (losses, paired, runner,
                                                  unpaired)
    cfgs = GeneratorConfigs()
    t0 = time.perf_counter()
    if kind == "paired":
        models, state, meta = runner.build_paired_run(
            cfgs, clip_vit.CLIP_VIT_B32, seed=4321, device=dev)
        batch = _paired_row(cfgs, dev, 0)

        def noise(i):
            g = torch.Generator(device=dev).manual_seed(1000 + i)
            return tuple(paired.draw_noise(g, 1, TRAIN_HW, TRAIN_HW, cfgs,
                                           torch.bfloat16) for _ in range(2))
        make, loss_cfg = (paired.make_paired_train_step,
                          losses.PairedLossConfig())
    else:
        models, state, meta = runner.build_unpaired_run(
            cfgs, clip_vit.CLIP_VIT_B32, seed=5432, device=dev)
        batch, noise = _unpaired_inputs(cfgs, dev)
        make, loss_cfg = (unpaired.make_unpaired_train_step,
                          losses.UnpairedLossConfig())
    vaes = [n for n in runner.VAE_MODULES if hasattr(models, n)]
    whole_bytes = _param_bytes(models.unet)
    vae_whole = {n: _param_bytes(getattr(models, n)) for n in vaes}
    runner.shard_for_training(models, tp, state)
    out = {"setup_s": time.perf_counter() - t0, "whole_bytes": whole_bytes,
           "unet_bytes": _param_bytes(models.unet),
           "vae_whole_bytes": vae_whole,
           "vae_bytes": {n: _param_bytes(getattr(models, n)) for n in vaes},
           "shard_mismatch": _shard_mismatch(models.unet, cfgs, tp.n_model)
           + [f"{n}.{k}" for n in vaes for k in _shard_mismatch(
               getattr(models, n), cfgs, tp.n_model, vae=True)]}
    step = make(models, cfgs, loss_cfg, meta, kernels=True, remat=True,
                dtype=torch.bfloat16, mesh=tp)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    times, stats = [], []
    for i in range(2 + TP_TRAIN_STEPS):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        tp.reset_stats()
        tp.timed = i == 1 + TP_TRAIN_STEPS
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        m, grads = step(state, batch, noise(i), keep_grads=i == 0)
        e_ev.record()
        e_ev.synchronize()
        tp.timed = False
        times.append(s_ev.elapsed_time(e_ev))
        stats.append(dict(tp.stats))
        if i == 0:
            out["metrics"] = {n: float(v) for n, v in m.items()}
            out["counts"] = dict(_build.launch_counts)
            out["shapes"] = [[k, list(sh), n] for (k, sh), n in
                             _build.launch_shapes.items()]
            out["du"] = [[list(sh), n] for sh, n in
                         _shapes("conv3x3_input_grad").items()]
            out["k7"] = [[list(sh), n] for sh, n in
                         _shapes("flash_attention_folded_bwd").items()]
            out["differ_first"] = mesh_mod.differing(
                {"state": _state_all(state)}, tp, axis="model")
            if tp.model_rank == 0:
                torch.save({"grads": {n: v.detach().float().cpu()
                                      for n, v in grads.items()},
                            "after": {n: v.detach().float().cpu() for n, v
                                      in _state_tensors(state).items()}},
                           os.path.join(out_dir, f"tp_{kind}.pt"))
            del grads
    out["differ_last"] = mesh_mod.differing({"state": _state_all(state)}, tp,
                                            axis="model")
    out.update(ms=times, collectives=stats,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               wall_s=time.perf_counter() - t0)
    del models, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_train_rank(rank: int, world: int, init_file: str, out_dir: str):
    """One spawned rank of the model-axis training phase: the paired step,
    then the unpaired one, its results written as JSON for the parent."""
    import os
    import torch.distributed as dist
    from img2img_turbo_tpu_torch.parallel import mesh as mesh_mod
    dev, _ = _dp_setup(rank, world, init_file)
    tp = mesh_mod.make_mesh(1, world, device=dev)
    res = {"model_rank": tp.model_rank, "n_model": tp.n_model}
    for kind in ("paired", "unpaired"):
        res[kind] = _tp_train_step(kind, tp, dev, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _tp_compare(kind: str, ref: dict, got: dict, metrics: dict) -> dict:
    """The model-axis step (`got`: model rank 0's first-pass gradients and
    state after the step, `metrics`) against the one-process kernel-path
    step from the same state (`ref`, `_reference`), by TP_LOSS_TOL,
    GRAD_REL_L2_TOL and the trainables' rule; fails the run outside."""
    import torch
    from img2img_turbo_tpu_torch.training import runner
    lr = runner.LEARNING_RATE
    loss_rel = {n: abs(metrics[n] - v) / max(abs(v), 1e-3)
                for n, v in ref["metrics"].items()}
    if set(metrics) != set(ref["metrics"]) or \
            not max(loss_rel.values()) <= TP_LOSS_TOL:
        _fail(f"model-axis {kind} step: losses {metrics} against the "
              f"one-process step's {ref['metrics']} (tol {TP_LOSS_TOL})")
    parts = sorted({n.rsplit(":", 1)[0] if n.startswith("unet_lora:")
                    else n.split(":")[0] for n in ref["grads"]})
    grad_rel, by_part = _grad_agreement(
        got["grads"], ref["grads"], parts,
        "model-axis " + ("pass-1" if kind == "paired" else "cycle-pass"),
        vs="model axis vs one process, kernel path")
    out = {"loss_rel": loss_rel, "grad_rel_l2": grad_rel,
           "grad_rel_l2_by_part": by_part}
    for what, prefix, updates in (
            ("trainables", "gen.", TP_GEN_UPDATES[kind]),
            ("heads", "disc.", 2)):
        names = [n for n in ref["after"] if n.startswith(prefix)]
        diff = torch.cat([(got["after"][n] - ref["after"][n]).abs()
                          .reshape(-1) for n in names])
        d_ref = torch.cat([(ref["after"][n] - ref["start"][n]).reshape(-1)
                           for n in names])
        d_got = torch.cat([(got["after"][n] - ref["start"][n]).reshape(-1)
                           for n in names])
        r = {"max_lr": float(diff.max() / lr),
             "frac_over_lr": float((diff > lr).float().mean()),
             "change_rel_l2": float((d_got - d_ref).norm()
                                    / max(float(d_ref.norm()), 1e-30))}
        if not (r["max_lr"] <= 2.1 * updates
                and r["frac_over_lr"] < TP_FLIP_FRAC):
            _fail(f"model-axis {kind} step: the {what} after the step are "
                  f"off the one-process step's: {r} (every element within "
                  f"{2.1 * updates:.1f} lr, fewer than "
                  f"{TP_FLIP_FRAC:.0%} off by more than lr)")
        out[what] = r
    return out


def tp_train_phase(dev, summary) -> dict:
    """The model-axis training phase (module docstring, phase 13): TP_WORLD
    gloo ranks sharing the card at a (1, TP_WORLD) mesh, spawned as phase
    12's; every check's failure fails the smoke. Returns {kernel: the
    launch shapes the ranks ran}, for the kernel cases no case ran yet."""
    import gc
    import os
    import torch
    import torch.multiprocessing as mp
    gc.collect()
    torch.cuda.empty_cache()
    smi = _smi()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_tp_train_rank, args=(TP_WORLD, os.path.join(d, "rdv"), d),
                 nprocs=TP_WORLD, join=True)
        ranks = []
        for r in range(TP_WORLD):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        saved = {kind: torch.load(os.path.join(d, f"tp_{kind}.pt"))
                 for kind in ("paired", "unpaired")}
    wall = time.perf_counter() - t0
    print(f"model-axis training phase: mesh (1, {TP_WORLD}), {TP_WORLD} gloo "
          f"ranks sharing one card (the exchange goes through the host; "
          f"not NCCL), spawned, wall {wall:.1f}s; {smi}", flush=True)
    expected = {"paired": EXPECTED_TRAIN_LAUNCHES,
                "unpaired": EXPECTED_UNPAIRED_LAUNCHES}
    hw = {"paired": TRAIN_HW, "unpaired": UNPAIRED_HW}
    shapes: dict = {}
    report = {}
    for kind, want in expected.items():
        ref = summary["tp_reference"].pop(kind)
        cmp = _tp_compare(kind, ref, saved[kind], ranks[0][kind]["metrics"])
        tables = _tp_expected(kind)
        for r, res in enumerate(ranks):
            m = res[kind]
            what = f"model axis rank {r} {kind} step"
            if m["shard_mismatch"] or not m["unet_bytes"] < \
                    0.6 * m["whole_bytes"] or not all(
                        m["vae_bytes"][n] < 0.6 * w
                        for n, w in m["vae_whole_bytes"].items()):
                _fail(f"{what}: the UNet holds {m['unet_bytes']} bytes of "
                      f"{m['whole_bytes']} and the VAEs {m['vae_bytes']} of "
                      f"{m['vae_whole_bytes']}, not only their shards: "
                      f"{m['shard_mismatch'][:8]}")
            if m["differ_first"] or m["differ_last"]:
                _fail(f"{what}: the state differs across the model ranks: "
                      f"{m['differ_first']} {m['differ_last']}")
            if m["metrics"] != ranks[0][kind]["metrics"]:
                _fail(f"{what}: metrics differ from rank 0's")
            if not m["counts"] == ref["counts"] == want:
                _fail(f"{what}: launches {m['counts']}, one-process "
                      f"{ref['counts']}, expected {want}")
            for key in ("du", "k7"):
                got = {tuple(sh): n for sh, n in m[key]}
                if got != tables[key]:
                    _fail(f"{what}: {key} launches by shape {got} are not "
                          f"the one-process table's on Co slices and local "
                          f"heads {tables[key]}")
            if not any(sh[4] == 2 for sh, _ in m["du"]) or \
                    not any(sh[4] == 4 for sh, _ in m["du"]):
                _fail(f"{what}: K8's du never ran the UNet conv_out's Co = 2 "
                      f"or the VAE encoder conv_out's Co = 4 slice")
            for k, sh, n in m["shapes"]:
                shapes.setdefault(k, set()).add(tuple(sh))
            first, times, timed_ms = (m["ms"][0], m["ms"][1:-1],
                                      m["ms"][-1])
            col = m["collectives"][0]
            timed = m["collectives"][-1]
            step_time = (f"one step {times[0]:.2f} ms" if len(times) == 1
                         else f"step p50 "
                              f"{sorted(times)[len(times) // 2]:.2f} ms over "
                              f"{len(times)} steps "
                              f"{[round(t, 2) for t in times]}")
            vae_gb = ", ".join(
                f"{n} {m['vae_bytes'][n] / 1e9:.3f} GB of "
                f"{w / 1e9:.3f}" for n, w in m["vae_whole_bytes"].items())
            print(f"  rank {r} {kind} {hw[kind]}x{hw[kind]} b1: UNet "
                  f"parameters {m['unet_bytes'] / 1e9:.3f} GB of the whole "
                  f"{m['whole_bytes'] / 1e9:.3f} GB, {vae_gb} (fp32 "
                  f"masters), only their shards; {step_time} after the "
                  f"compared first step ({first:.2f} ms); "
                  f"collectives a step {col['calls']} calls, "
                  f"{col['bytes'] / 1e6:.2f} MB, "
                  f"{1e3 * timed['seconds']:.2f} ms on a separate step with "
                  f"each timed (that step {timed_ms:.2f} ms); peak "
                  f"{m['peak_gib']:.2f} GiB; "
                  f"launches {m['counts']} (the one-process step's; the du "
                  f"on the UNet's and VAE's Co slices, K7 on the local "
                  f"heads); state "
                  f"bit-identical across the model ranks; set-up "
                  f"{m['setup_s']:.1f}s, wall {m['wall_s']:.1f}s", flush=True)
        print(f"  {kind}: vs the one-process kernel-path step at the same "
              f"seeds: losses rel max {max(cmp['loss_rel'].values()):.3e} "
              f"(tol {TP_LOSS_TOL:.0e}); trainables "
              f"{cmp['trainables']}, heads {cmp['heads']} (lr units)",
              flush=True)
        summary["paths"]["model_axis_" + kind] = ranks[0][kind]["counts"]
        report[kind] = {**cmp, "ranks": [
            {k: res[kind][k] for k in ("unet_bytes", "whole_bytes",
                                       "vae_bytes", "vae_whole_bytes", "ms",
                                       "collectives", "peak_gib", "setup_s",
                                       "wall_s")} for res in ranks]}
    summary["model_axis_train"] = {"wall_s": wall, "card": smi, **report}
    return shapes


# ---------------------------------------------------------------------------
# tools phase: profiling helpers, the web demo, convert_weights and
# accept_parity
# ---------------------------------------------------------------------------


def _post(port: int, path: str, body: dict) -> dict:
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def _png_array(data_url: str):
    import numpy as np
    from img2img_turbo_tpu_torch.serving import web_demo
    return np.asarray(web_demo._decode_data_url(data_url).convert("RGB"))


def tools_phase(dev, summary, root: str, snap: str):
    """The tools phase (module docstring, phase 11) on the weights phase's
    snapshot and pkls under `root`."""
    import gc
    import os
    import numpy as np
    import torch
    from PIL import Image
    from img2img_turbo_tpu_torch.cli import accept_parity, convert_weights
    from img2img_turbo_tpu_torch.pipelines.pix2pix import (GeneratorConfigs,
                                                           Pix2PixTurbo)
    from img2img_turbo_tpu_torch.serving import demo, web_demo
    from img2img_turbo_tpu_torch.training import profile_step
    from img2img_turbo_tpu_torch.utils import profiling
    from img2img_turbo_tpu_torch.weights import native

    out = {"card": _smi()}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tools phase: {out['card']}", flush=True)

    # device time of one 512x512 request: the helper beside the profile
    _, fn = next(profile_step._request(dev))
    fn()
    dt = profiling.device_time_per_call(fn, (), iters=10)
    if not dt.get("device_p50_per_call_s"):
        _fail(f"device_time_per_call found no device time: {dt}")
    print(f"  device_time_per_call, one 512x512 edge_to_image request "
          f"(10 calls): p50 {1e3 * dt['device_p50_per_call_s']:.3f} ms, p90 "
          f"{1e3 * dt['device_p90_per_call_s']:.3f} ms, span a call "
          f"{1e3 * dt['device_span_per_call_s']:.3f} ms, "
          f"{dt['kernels_per_call']:.0f} GPU kernels a call; "
          f"training/profile_step.py's profile of the same request:",
          flush=True)
    prof = profile_step._profile(fn)
    out["device_time_per_call"] = dt
    out["profile_step_request"] = prof
    mem = profiling.device_memory_stats()
    if not mem:
        _fail("device_memory_stats found no card")
    print(f"  device_memory_stats: {mem}", flush=True)
    out["device_memory_stats"] = mem
    del fn
    gc.collect()
    torch.cuda.empty_cache()

    # the web demo on the full-width pipelines: edge_to_image merged, the
    # sketch model factored, one pipeline holding both
    cfgs = GeneratorConfigs()
    ckpt_dir = os.path.join(root, "checkpoints")
    edge_pkl = os.path.join(ckpt_dir, "edge_to_image_loras.pkl")
    kw = Pix2PixTurbo.load_pretrained(snap, "sketch_to_image_stochastic",
                                      ckpt_folder=ckpt_dir, device=dev)
    kw["params"] = Pix2PixTurbo.load_pretrained(snap, edge_pkl,
                                                device=dev)["params"]
    pipe = Pix2PixTurbo(**kw, dtype=torch.bfloat16, device=dev)
    del kw
    server, port = web_demo.launch_in_thread(pipe)
    img = Image.fromarray(synth_image(512, 512, 11)[0])
    url = web_demo._encode_data_url(img)
    t0 = time.perf_counter()
    got = _post(port, "/api/canny", {"image": url, "prompt": PROMPT,
                                     "low": 100, "high": 200})
    canny_s = time.perf_counter() - t0
    edges, want = demo.CannyDemo(pipe).process(img, PROMPT, 100, 200)
    t0 = time.perf_counter()
    got_s = _post(port, "/api/sketch", {"image": url, "prompt": PROMPT,
                                        "style": "Anime", "seed": 7,
                                        "r": 0.4})
    sketch_s = time.perf_counter() - t0
    want_s = demo.SketchDemo(pipe).run(img, PROMPT, "Anime", 7, 0.4)
    server.shutdown()
    server.server_close()
    same = {"canny edges": np.array_equal(_png_array(got["edges"]),
                                          np.asarray(edges.convert("RGB"))),
            "canny image": np.array_equal(_png_array(got["image"]),
                                          np.asarray(want)),
            "sketch image": np.array_equal(_png_array(got_s["image"]),
                                           np.asarray(want_s))}
    print(f"  web demo (full width, 512x512): POST /api/canny "
          f"{canny_s:.2f}s, POST /api/sketch {sketch_s:.2f}s; each "
          f"response equal bit for bit to the direct call: {same}",
          flush=True)
    if not all(same.values()) or np.asarray(want).std() == 0:
        _fail(f"web demo responses differ from the direct calls: {same}")
    out["web_demo"] = {"canny_s": canny_s, "sketch_s": sketch_s}
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # convert_weights on the snapshot and the edge pkl, read back
    native_dir = os.path.join(root, "native_edge")
    res = convert_weights.main(["--sd_turbo_path", snap, "--ckpt_path",
                                edge_pkl, "--out", native_dir], device=dev)
    t0 = time.perf_counter()
    back = native.load_native(native_dir, device=dev)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    want = Pix2PixTurbo.load_pretrained(snap, edge_pkl, device=dev)
    bad = []
    for part, a, b in (("unet", back["params"]["unet"],
                        want["params"]["unet"]),
                       ("vae", back["params"]["vae"], want["params"]["vae"]),
                       ("text", back["text"], want["text"])):
        sa, sb = a.state_dict(), b.state_dict()
        if set(sa) != set(sb):
            bad.append(part)
        bad += [f"{part}.{k}" for k in sb if not torch.equal(sa[k], sb[k])]
    gb = res["bytes"] / 1e9
    print(f"  convert_weights: {res['values'] / 1e6:.1f}M values, "
          f"{res['tensors']} tensors, {gb:.3f} GB; load_pretrained "
          f"{res['load_seconds']:.2f}s, write {res['write_seconds']:.2f}s "
          f"({gb / res['write_seconds']:.2f} GB/s), read back "
          f"{read_s:.2f}s ({gb / read_s:.2f} GB/s); equal to "
          f"load_pretrained tensor for tensor: {not bad}", flush=True)
    if bad:
        _fail(f"the native checkpoint differs from load_pretrained: "
              f"{bad[:8]}")
    out["convert_weights"] = {"gb": gb, "write_s": res["write_seconds"],
                              "read_s": read_s,
                              "load_s": res["load_seconds"]}
    del back, want
    gc.collect()
    torch.cuda.empty_cache()

    # accept_parity against phase 8's edge PNG (the same image)
    args = accept_parity.build_parser().parse_args(
        ["--sd_turbo_path", snap, "--model_path", edge_pkl, "--input_image",
         os.path.join(root, "input.png"), "--prompt", PROMPT,
         "--reference_output", os.path.join(root, "out_edge", "input.png")])
    t0 = time.perf_counter()
    line = accept_parity.main(args, device=dev)
    if not line["lpips"] < 1e-3:
        _fail(f"accept_parity on phase 8's own edge PNG: {line}")
    out["accept_parity"] = dict(line, wall_s=time.perf_counter() - t0)
    print(f"  accept_parity: LPIPS {line['lpips']} against phase 8's edge "
          f"PNG (random LPIPS weights; the same image), "
          f"{out['accept_parity']['wall_s']:.2f}s", flush=True)
    summary["tools"] = out


if __name__ == "__main__":
    main()
