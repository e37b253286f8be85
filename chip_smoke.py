#!/usr/bin/env python3
# ------------------------------------------------------------------
"""Smoke run of the PyTorch/CUDA port (idee_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build       the card's name and power limit, then nvcc builds every
                 kernel source of every kernel module from this checkout,
                 one nvcc per source, all started together
  2. kernel      each kernel against its plain PyTorch version at the shapes
                 the main paths give it (max abs error, stated tolerance),
                 then both timed with CUDA events beside the card's least
                 possible time: the fused scan forward; the linear scan
                 forward and reverse at the d_state=2 path's shapes (plus a
                 long L=200 check); the fused scan's backward kernel alone,
                 two runs compared bit for bit, beside the PyTorch
                 composition it replaced (ops around the reverse linear
                 scan), and the autograd Function against autograd through
                 the plain forward loop; then the window-attention forward,
                 backward and dbias sum at the Swin_3D stage shapes (stage 0
                 unshifted and shifted with the real shift mask, stage 1),
                 two forward and two backward runs compared bit for bit,
                 both kernels' shared memory per block and resident blocks
                 per SM, and PyTorch's scaled_dot_product_attention timed on
                 the same inputs as the yardstick; the dbias sum also by its
                 profiler device time and host us per launch, beside
                 torch.sum's; the attention kernels also at Swin_3D's
                 delta_t 4 shapes (phase 15d)
  3. main        synthetic evaluation (train.evaluate.test_synthetic) with
                 the Mamba encoder at the bench width: 6 variables x 1
                 channel, delta_t=8, 200x200, batch 1, random weights from
                 a seed. The launch counters are zeroed just before and read
                 just after; then steady-state steps/s, a profile, and one
                 forward of the same weights and batch with the plain scan
  4. train       synthetic training (train.driver.train_synthetic) with
                 Mamba at the same width for N_EPOCHS (1) epoch, counters
                 zeroed around it; checkpoints, history and a resumed
                 second epoch;
                 steady train steps/s, peak memory, a profile of one train
                 step, and one train step's gradients with the kernels
                 against the plain scans
  5. train_mamba_dstate2
                 phase 4 with d_state=[2,2] for 1 epoch, no resume: the
                 linear-scan kernel forward and reverse, no fused scan
  6. main_swin   phase 3 with the Swin_3D encoder (the attention forward
                 kernel, no scan), plain attention for the comparison
  7. train_swin  phase 4 with Swin_3D (attention forward, backward and
                 dbias-sum kernels), without the resume (Mamba's covers the
                 encoder-agnostic driver)
  8. main_cnn, train_cnn
                 phases 3 and 4 with the CNN_3D encoder (1 epoch, no
                 resume): no kernel, so every counter must stay 0 and there
                 is no plain-op comparison
  9. train_vq_ema
                 phase 4 with the VQ codebook of BASELINE.md's anchored
                 VQ-EMA arm (EMA, k-means init, dead-code expiry at 2.0,
                 commitment 0.25) on the generic VQModel path, 1 epoch and
                 a resumed second: the k-means init runs once, in the first
                 step; initted and both codes' cluster sizes checked after
                 each run; a restore gives back the saved buffers; the step
                 gradients from the trained codebook state, with the share
                 of equal code indices
 10. main_FSQ, main_LatentQuantize, main_Random_VQ, main_VQ, main_LFQ_4,
     codebooks
                 phase 3 with each other codebook (LFQ with codebook_size
                 4), then one train step each: launches, a finite loss,
                 nonzero gradients except where the JAX package has none
 11. cerra_fixture
                 the real-world path: data/fake.py::write_fake_reanalysis
                 writes a CERRA tree (6 variables, year 1984, seed 0,
                 NetCDF3) on the reference's published 512x832 Europe grid
                 into a temporary directory under build/, removed at the
                 end, while train_space's ranks run; its seconds and bytes
 12. train_cerra train.driver_real.train_real on it with the config
                 defaults (Mamba, in_channels=2, the 200x200 crop, weekly
                 climatology normalisation), batch 1, N_EPOCHS (1) epoch of
                 9 train and 9 val steps, counters zeroed around it;
                 checkpoints, history and a resumed second epoch; steady
                 train steps/s,
                 peak memory, a profile, one step's gradients against the
                 plain scan
 12b. train_cerra_space, train_cerra_space_device
                 train_real with Swin_3D float32 and recompute at the full
                 512x832 crop of the fixture under mesh_shape [1, 2] (two
                 gloo ranks of tests/torch_parallel_worker.py on this
                 card), one epoch of the first 4 train
                 and 1 val week against train_real without a mesh on the
                 same weeks (losses rtol 2e-4, parameters, launches per
                 rank); each rank's steps/s and peak bytes (beside
                 memory_fit's single-device probe of the configuration);
                 in the same launch of the ranks the config's Mamba at the
                 200x200 crop with device_data (the per-step device loop,
                 augmentation on: each rank gathers its 100 rows of the
                 week slabs on the card) against the world-1 device-data
                 run in the same way
 13. test_cerra  train.driver_real.test_real at the full 512x832 crop on
                 train_cerra's latest weights, launches counted; steady
                 eval steps/s, busy share and peak memory; the forward
                 against the plain scan on one batch; the fused scan
                 forward alone at its two 512x832 shapes (kernel_cerra);
                 then cli/predict_real.py's predict_real on the same tree
                 (predict_cerra), its payload checked
 14. main_mamba_bf16, train_mamba_bf16, main_swin_bf16, train_swin_bf16,
     main_cnn_bf16, train_cnn_bf16
                 phases 3 and 4 at cfg.dtype "bfloat16" (1 epoch, no
                 resume): the Swin attention through its bf16 kernels, the
                 scans through their float32 ones, CNN_3D none; the plain-op
                 logits held where no code bit flipped; then
                 predict_synthetic (cli/predict_synthetic.py) over the cube
                 with train_swin_bf16's weights, its payload checked; and
                 bf16_vs_float32, each bf16 phase's steps/s, device ms, busy
                 share and peak memory beside its float32 phase's. The
                 kernel phase also holds the bf16 attention kernels against
                 their plain bf16 versions (one bf16 ulp), reruns them bit
                 for bit, times them beside SDPA on bf16 inputs and reads
                 their shared memory, blocks per SM and registers
 15. train_deepmil, train_arnet, train_rtfm, train_mgfn, train_rtfm_mamba,
     train_deepmil_swin, train_simplenet, train_steal, train_uniad
                 the baseline zoo (idee_tpu_torch/baselines/) at the bench
                 width with its configs' defaults: each trains 1 epoch
                 through its driver, launch counters zeroed around it
                 (exact: the MIL four over CNN_3D, STEAL and UniAD none;
                 RTFM over Mamba the fused scan forward and backward;
                 DeepMIL over Swin_3D the three attention kernels;
                 SimpleNet's frozen Swin_3D backbone, train_swin's encoder
                 loaded by load_backbone_params, the attention forward
                 only), then its test driver on the latest checkpoint
                 (test_<name>, launches counted; not for the two encoder
                 variants); train steps/s, peak memory, a profile of 3
                 train steps; RTFM over Mamba and DeepMIL over Swin_3D
                 also one step's gradients against the plain op, at the
                 seeded and at the trained weights
 15b. train_deepmil_swin_bf16, train_rtfm_mamba_bf16, train_mgfn_bf16,
     train_simplenet_bf16, train_steal_bf16, train_uniad_bf16
                 phase 15 at cfg.dtype "bfloat16": the MIL models and
                 SimpleNet's backbone compute in bf16 (DeepMIL over Swin_3D
                 through the bf16 attention kernels, RTFM over Mamba
                 through the float32 scans, both with their step gradients
                 against the plain op under pinned top-k selections, held
                 as one relative L2 distance); MGFN's head, SimpleNet's
                 head, STEAL and UniAD compute in float32, as JAX builds
                 them (STEAL's and UniAD's parameters and outputs checked
                 float32); then baselines_bf16_vs_float32, each one's train
                 steps/s, device ms per step, busy share and peak memory
                 beside its float32 phase's
 15c. train_ddp  data parallelism (idee_tpu_torch/parallel/mesh.py): (a)
                 train_synthetic under a mesh of one rank (mesh_shape [1],
                 NCCL), Mamba float32, 1 epoch, exact launches, its epoch
                 steps/s beside phase train's (no mesh); (b) two processes
                 of tests/torch_parallel_worker.py on this card (gloo
                 named: NCCL takes one rank per device), Mamba float32, 3
                 train steps on global batches of 2 cube rows, dropout 0:
                 both ranks' parameters equal each other and the
                 single-device steps', 3 + 3 fused-scan launches per step
                 on each rank; (c) the same for VQ-EMA, its codebook
                 buffers equal to the single-device run's
 15d. train_swin_dt4, main_swin_dt4, train_swin_dt4_bf16,
     main_swin_dt4_bf16
                 Swin_3D at delta_t 4 (6 x 1 x 4 x 200 x 200), whose
                 stage-1 window (8,1,1) shrinks to (4,1,1): DeepMIL over
                 Swin_3D (the composite model's classifier collapses
                 T = 8 only) as phase 15 runs it, float32 and bf16, 1 train
                 epoch and the test driver over the cube, launches exact;
                 the eval scores and the step gradients at the seeded
                 weights against the plain op's. The kernel phase holds
                 and times the attention kernels at these shapes too
                 (5,000 windows of 32, unshifted and shifted; 40,000 of 4)
 15e. train_ddp_fused
                 train_synthetic with device_data and the fused epochs
                 under a mesh of one NCCL rank, Mamba float32,
                 DDP_FUSED_EPOCHS (2) epochs,
                 launches exact (credited per replay), the first epoch
                 against the per-step device loop under the same mesh;
                 the fused rates and capture seconds on train_device's cut
                 beside train_device's (no mesh), the collectives each
                 graph captured, and a replay of each graph profiled: its
                 NCCL kernels (NCCL's one-rank AVG reduction), none failing
 15f. train_space (after profile_step)
                 the space mesh axis (parallel/spatial.py) through
                 train_synthetic at mesh_shape [1, 2]: two ranks of
                 tests/torch_parallel_worker.py on this card (gloo),
                 each on 100 of the 200 rows, one epoch of 2
                 train and 2 val steps of Mamba, Swin_3D and CNN_3D
                 float32 and Swin_3D bf16 against train_synthetic without
                 a mesh (the same model on both ranks; parameters as
                 train_ddp holds them, losses rtol 2e-4, bf16 2e-2;
                 launches per rank equal world 1's; rank 0 alone writes),
                 every kernel held against its plain version at a rank's
                 shapes (the fused scan at half the windows, the attention
                 at 5,000 windows of 32 with the shift mask cut to rank
                 1's window rows, 20,000 of 8; the bf16 at one ulp);
                 train_space_device, in the same launch of the ranks:
                 Mamba float32 and Swin_3D bf16 with device_data (the
                 per-step device loop, augmentation on: each rank holds
                 the cube and gathers its 100 rows on the card, reversed
                 where a sample flips H) against the world-1 device-data
                 driver by the same rules
 16. synthetic_netcdf
                 the reference's synthetic directory schema: a
                 make_fake_cube at the bench width over 104 weeks (two
                 years: the weekly climatology has two samples per week),
                 written as NetCDF3 by data/fake.py::write_synthetic_netcdf
                 into a directory with no .npz; cli/convert_synthetic.py on
                 a copy, the cube read from the tree against the one read
                 from the .npz bit for bit; then train_synthetic with Mamba
                 for 1 epoch from root_synthetic (SyntheticDataset's NetCDF
                 branch, the config's weekly-climatology scaling), launches
                 counted; the host seconds to read the tree
 17. accuracy, accuracy_zoo
                 cli/train_benchmark_accuracy.py in-process: Mamba at
                 BASELINE.md's 48x48 geometry (batch 8, bf16, the stable
                 recipe) on a 4-year make_benchmark_cube for 3 epochs,
                 writing a --cube_npz cache that must equal the generated
                 cube; exact launches, both best F1 (finite or null, no
                 threshold), epochs/s; then cli/train_baselines_zoo.py with
                 STEAL and DeepMIL for 1 epoch (no kernel)
 18. train_device, train_device_swin_bf16, train_cerra_device,
     accuracy_device
                 the device-resident epoch (device_data, fused_epoch): the
                 data on the card (data/device.py), each step one replay of
                 a CUDA graph (train/steps.py::FusedEpoch). Mamba float32
                 at the bench width for N_EPOCHS (1) epoch and a resumed
                 second (a new capture after the restore); Swin_3D bf16 for
                 1 epoch (the bf16 attention kernels and the dbias sum
                 inside the graph); train_real on the CERRA fixture at the
                 200x200 crop for N_EPOCHS epochs (RealDeviceLoader); the
                 accuracy
                 geometry (48x48, batch 8, bf16) with CNN_3D for 3 epochs.
                 Each: launches exact (credited per replay), the first
                 epoch's mean train and val loss against the per-step loop
                 over the same device batches (fused_epoch=False), the
                 sample order against the host loader's, set-up seconds
                 (upload, host precompute, capture), steady fused train and
                 val steps/s, busy share and peak memory beside the host
                 loader's numbers of this run; Mamba also shows that
                 dropout draws new bits at every replay
 19. profile_hook
                 train_synthetic for 1 epoch of Mamba with profile_dir and
                 device_data + fused_epoch: the hook traces the fused first
                 epoch whole; its Chrome trace names the fused scan's
                 forward and backward kernels (3 of each a step) and each
                 step's span marks (a count at most one step's short: a
                 trace can lose a record at its edges), the losses are
                 within DEVICE_LOSS_RTOL
                 of train_device's per-step loop's, and the image panels
                 (a writer stand-in keeps them) have JAX's shapes and
                 values in [0, 1]. Since this slice every train_synthetic
                 and train_real epoch ends with the panels' one more eval
                 forward, which the launch counts include (PANEL_STEPS)
 20. reference_checkpoint
                 for Mamba (d_state 1 and 2), Swin_3D and CNN_3D: a seeded
                 model exported by cli/export_reference_checkpoint.py to a
                 reference .pth and imported back by
                 cli/import_reference_checkpoint.py, then test_synthetic
                 on the imported weights: weights, logits and metrics
                 bit-equal to the original's, exact launches, the export's
                 keys in the key map's order; .pth bytes, export and
                 import seconds
 21. native_loader, native_vhi
                 the host batch engine (idee_tpu_torch/native): its g++
                 build seconds, shuffled epochs bit-equal to the numpy
                 path's with augmentation off and on and 0 and 8 loader
                 workers, host ms per batch of each path, engine_threads,
                 Mamba's train steps/s and busy share fed by each path;
                 after the CERRA fixture, vhi_mask against its numpy
                 version on 512x832 NOAA weeks with host ms for each
 22. memory_fit, profile_step
                 cli/memory_fit.py's probes (200x200 for the three
                 encoders, within 10 % of this run's train-phase peaks;
                 512x832 CNN_3D, Swin_3D with and without recompute,
                 Mamba with recompute; Swin_3D at batch 2; an
                 out-of-memory row is a finding; CNN_3D at batch 2, the
                 case for the space axis), memory_fit_space
                 (cli/memory_fit.py --mesh 1x2 under torchrun, two gloo
                 ranks on this card, 512x832: CNN_3D without recompute,
                 each rank at most 0.6 x this run's single-device probe;
                 Swin_3D's with recompute is train_cerra_space's) and
                 cli/profile_step.py
                 per encoder at float32 and bf16, its fused step span
                 within 10 % of the profile phase's device ms per step,
                 the step's children covering 97 % of it
 23. kernels     one line listing every kernel: route, source, launches by
                 path, error and times
Each "profile" line gives a path's device ms per step by operator and by
kind of kernel (disjoint: cuDNN wgrad, dgrad, other GEMMs and implicit
GEMMs, the rest); for the synthetic eval and train paths also, from one
more step profiled with input shapes, the ms by pass (forward, backward,
optimizer) and kind and each top kernel's launching operators. The bf16
eval phases also hold the encoder's output before the quantizer with the
kernels against the plain op's.
The card's name and power limit stand on a line of their own, and the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero before
that line; without a CUDA card the script exits non-zero at once.
"""# ------------------------------------------------------------------

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(REPO, "build", "chip_smoke_log")

# (L, M) of the fused scan per launch at the bench width, batch 1: stage 0
# (window (2,4,4): 10,000 windows x 6 variables x 16 channels) runs once per
# block, twice per forward; stage 1 (window (8,1,1): 40,000 windows x 96)
# once. A train step's backward runs the backward kernel at the same
# shapes, once per forward launch.
SCAN_SHAPES = {"stage0": (32, 960_000), "stage1": (8, 3_840_000)}
LAUNCHES_PER_STEP = {"stage0": 2, "stage1": 1}
# the linear scan on the d_state=2 path: the same folds with a trailing
# state axis of 2, forward once per block and in a train step once more in
# reverse
D_STATE2 = 2
LINEAR_SCAN_SHAPES = {stage: (L, M * D_STATE2)
                      for stage, (L, M) in SCAN_SHAPES.items()}
# no model window has L > 64; the long check is the TPU's two-level
# _scan_pallas_2d shape, which the CUDA kernel walks in one pass
LONG_SCAN = (200, 1_000_000)
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5
# a step's gradients with the kernels against the plain op's; both runs
# take cuDNN's deterministic algorithms (deterministic_convolutions)
STEP_GRAD_REL = 1e-4

# window attention per launch at the bench width, Swin_3D defaults (16
# channels, 2 heads per variable -> G = 12 heads of width 8): stage 0,
# window (2,4,4), 10,000 windows of 32 tokens, once unshifted and once
# shifted by (1,2,2) with the mask of the 8x200x200 grid; stage 1, window
# (8,1,1), 40,000 windows of 8 (its one block's shift is zeroed: T = 8
# fills the window). Each forward launches all three once; a train step's
# backward launches the backward and the dbias sum once for each.
ATTN_G, ATTN_HD = 12, 8
ATTN_SHAPES = {"stage0": (10_000, 32, None),
               "stage0_shifted": (10_000, 32,
                                  (8, 200, 200, (2, 4, 4), (1, 2, 2))),
               "stage1": (40_000, 8, None)}
# Swin_3D at delta_t 4 (6 x 1 x 4 x 200 x 200, the DeepMIL path): stage
# 0, 5,000 windows of 32, unshifted and shifted; stage 1's window shrunk to
# (4,1,1), 40,000 windows of 4, unshifted
ATTN_SHAPES_DT4 = {"stage0": (5_000, 32, None),
                   "stage0_shifted": (5_000, 32,
                                      (4, 200, 200, (2, 4, 4), (1, 2, 2))),
                   "stage1": (40_000, 4, None)}
ATTN_RTOL, ATTN_ATOL = 1e-5, 1e-5
ATTN_GRAD_RTOL, ATTN_GRAD_ATOL = 1e-4, 1e-5
# the bf16 instantiations against the plain bf16 versions: both round
# float32 values that sum in other orders, so an output may sit one bf16
# ulp (2^(floor(log2 |x|) - 7)) off, plus the float32 kernels' absolute
# tolerances; dbias stays float32 and is held as at float32
ATTN_BF16_ULPS = 1
# dbias sums ds over 10,000-40,000 windows whose terms cancel: its rounding
# error scales with the sum's size, so its absolute tolerance is this
# fraction of max |dbias|
DBIAS_REL = 1e-5

# the bf16 paths (cfg.dtype "bfloat16") against their plain ops: a kernel
# output one bf16 ulp off flips an LFQ code bit where the latent lies within
# bf16 noise of 0, and a flipped code moves every logit in view of the
# classifier (7x7 pixels, every variable and week). So the logits are held
# at BF16_LOGIT_REL x max |logit| on the pixels with no flipped code in
# view, the bits at BF16_BITS_AGREE, one step's gradients at BF16_GRAD_REL
# x max |grad| (tests/test_torch_bf16*.py's tolerances against JAX). The
# encoder's output before the quantizer, where the attention kernels act
# and no code flip enters, at BF16_ENCODER_REL x max |output| (the module
# tolerance of tests/test_torch_bf16.py)
BF16_ENCODER_REL = 2e-2
BF16_LOGIT_REL = 5e-2
BF16_BITS_AGREE = 0.99
BF16_GRAD_REL = 5e-2
# the MIL baselines' bf16 step gradients, kernels against the plain op, as
# one relative L2 distance over every parameter (compare_mil_gradients)
MIL_BF16_GRAD_L2 = BF16_GRAD_REL
BF16 = dict(dtype="bfloat16")
# phase results that the bf16_vs_float32 line sets side by side
SUMMARY = {}

N_WEEKS = 40  # fake cube length: 33 eval samples at delta_t=8
# global (not weekly-climatology) normalisation: a cube shorter than two
# years has one sample per week of year, so its climatology-scaled inputs
# are exactly 0
IS_CLIMA_SCALE = False
# 13 train, 9 val samples (weeks 1-20: cut from 1-24, 17 train samples,
# to keep the script's time when the space axis's device-data phases came)
TRAIN_WEEKS, VAL_WEEKS = (1, 20), (25, 40)
# epochs of the train phases with a resume (train, train_swin,
# train_device, the CERRA paths; one, to keep the script's time), then the
# resumed one
N_EPOCHS = 1
N_EPOCHS_SHORT = 1  # the d_state=2 and CNN_3D training paths
DDP_FUSED_EPOCHS = 2  # train_ddp_fused: a capture, then an epoch of replays
# train_synthetic and train_real end each epoch with the TensorBoard image
# panels: one more eval forward, of the last val batch
PANEL_STEPS = 1


def _finite(obj):
    """NaN/inf -> None, so every line is strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


# the script's start, from which each phase line gives its end
T_START = time.perf_counter()


def emit(**obj):
    if "phase" in obj:
        obj["elapsed_s"] = time.perf_counter() - T_START
    print(json.dumps(_finite(obj), allow_nan=False), flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fused_inputs(L: int, M: int, seed: int):
    """Inputs in the ranges the Mamba block produces: softplus deltas,
    A = -exp(A_log) < 0, unit-scale u, B, C, z, D."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    delta = torch.rand(L, M, device=dev, generator=g) * 0.7 + 0.01
    u, B, C, z = (torch.randn(L, M, device=dev, generator=g)
                  for _ in range(4))
    A = -torch.rand(M, device=dev, generator=g) * 2.0 - 0.1
    D = torch.randn(M, device=dev, generator=g)
    return delta, u, B, C, z, A, D


def scan_inputs(L: int, M: int, seed: int):
    """Coefficients in (0, 1) as exp(delta A) gives them, and unit-scale
    increments."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(L, M, device="cuda", generator=g) * 0.9 + 0.05
    b = torch.randn(L, M, device="cuda", generator=g)
    return a, b


def max_err(got, want, name, rtol, atol) -> float:
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return (got - want).abs().max().item()


def kernel_modules():
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.kernels import window_attention as wa

    return ss, wa


def phase_build():
    from idee_tpu_torch import native
    from idee_tpu_torch.kernels import build

    sources = sorted({src for mod in kernel_modules()
                      for src in mod.SOURCES.values()})
    seconds = build.build(sources)
    # the host batch engine (g++), which the host loader calls from the
    # first phase on
    SUMMARY["native_build_s"] = native.build()
    emit(phase="build", seconds=seconds,
         libraries=[os.path.relpath(build.library_path(s), REPO)
                    for s in sources],
         native_engine_build_s=SUMMARY["native_build_s"],
         native_engine=os.path.relpath(native.library_path(), REPO))


def check_fused_forward(ss, bounds, shapes=SCAN_SHAPES):
    per_shape = {}
    for i, (stage, (L, M)) in enumerate(shapes.items()):
        args = fused_inputs(L, M, seed=i)
        y_p, h_p = ss.fused_selective_scan_n1_plain(*args)
        y = ss.fused_selective_scan_n1(*args)
        y_h, h = ss.fused_selective_scan_n1(*args, return_h=True)
        torch.cuda.synchronize()
        err = max(max_err(y, y_p, f"{stage} y", SCAN_RTOL, SCAN_ATOL),
                  max_err(y_h, y_p, f"{stage} y_with_h", SCAN_RTOL,
                          SCAN_ATOL),
                  max_err(h, h_p, f"{stage} h", SCAN_RTOL, SCAN_ATOL))
        del y, y_h, h, h_p, y_p
        ms = cuda_ms(lambda: ss.fused_selective_scan_n1(*args), iters=50)
        plain_ms = cuda_ms(lambda: ss.fused_selective_scan_n1_plain(*args),
                           iters=5, warmup=1)
        bound_ms, bound_by = bounds.fused_scan_fwd(L, M, with_h=False)
        per_shape[stage] = dict(L=L, M=M, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by,
                                share_of_bound=bound_ms / ms)
        del args
        torch.cuda.empty_cache()
    return per_shape


def check_linear_scan(ss, bounds):
    per_shape = {}
    shapes = dict(LINEAR_SCAN_SHAPES, long=LONG_SCAN)
    for i, (stage, (L, M)) in enumerate(shapes.items()):
        a, b = scan_inputs(L, M, seed=10 + i)
        row = dict(L=L, M=M)
        for direction, rev in (("forward", False), ("reverse", True)):
            h = ss.linear_scan_2d(a, b, reverse=rev)
            torch.cuda.synchronize()
            err = max_err(h, ss.linear_scan_plain(a, b, rev),
                          f"{stage} {direction}", SCAN_RTOL, SCAN_ATOL)
            del h
            row[direction] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: ss.linear_scan_2d(a, b, reverse=rev),
                           iters=50),
                plain_ms=cuda_ms(lambda: ss.linear_scan_plain(a, b, rev),
                                 iters=3, warmup=1))
        row["bound_ms"], row["bound_by"] = bounds.linear_scan(L, M)
        row["share_of_bound"] = row["bound_ms"] / row["reverse"]["ms"]
        per_shape[stage] = row
        del a, b
    return per_shape


def fused_scan_bwd_composition(ss, delta, u, B, C, z, A, D, h, g):
    """The backward the kernel replaced: PyTorch elementwise ops and
    two column sums around one reverse linear-scan launch. Timed beside the
    kernel, used nowhere in the port."""
    sig = torch.sigmoid(z)
    dy = g * (z * sig)
    dz = g * (C * h + D * u) * (sig * (1.0 + z * (1.0 - sig)))
    dC = dy * h
    dD = torch.sum(dy * u, dim=0)
    a = torch.exp(delta * A)
    a_next = torch.cat([a[1:], torch.zeros_like(a[:1])])
    G = ss.linear_scan_2d(a_next, (dy * C).contiguous(), reverse=True)
    da = G * torch.cat([torch.zeros_like(h[:1]), h[:-1]])
    ddelta = da * a * A + G * u * B
    du = dy * D + G * delta * B
    dB = G * delta * u
    dA = torch.sum(da * a * delta, dim=0)
    return ddelta, du, dB, dC, dz, dA, dD


def check_fused_backward(ss, bounds, shapes=SCAN_SHAPES):
    """The backward kernel alone against its plain version, twice bit for
    bit, timed beside the composition it replaced; then the autograd
    Function (forward and backward kernels) against autograd through the
    plain forward loop."""
    names = ("ddelta", "du", "dB", "dC", "dz", "dA", "dD")
    per_shape = {}
    for i, (stage, (L, M)) in enumerate(shapes.items()):
        args = fused_inputs(L, M, seed=20 + i)
        _, h = ss.fused_selective_scan_n1(*args, return_h=True)
        g = torch.randn(L, M, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        runs = [ss.fused_scan_n1_bwd(*args, h, g) for _ in range(2)]
        want = ss.fused_selective_scan_n1_bwd_plain(*args, h, g)
        torch.cuda.synchronize()
        err = max(max_err(a, b, f"{stage} {n}", GRAD_RTOL, GRAD_ATOL)
                  for n, a, b in zip(names, runs[0], want))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise SystemExit(f"{stage}: two fused backward runs differ")
        del runs, want
        ms = cuda_ms(lambda: ss.fused_scan_n1_bwd(*args, h, g), iters=20)
        composition_ms = cuda_ms(
            lambda: fused_scan_bwd_composition(ss, *args, h, g), iters=5)
        plain_ms = cuda_ms(
            lambda: ss.fused_selective_scan_n1_bwd_plain(*args, h, g),
            iters=3, warmup=1)

        leaves = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(ss.fused_selective_scan_n1(*leaves),
                                  leaves, g)
        want = torch.autograd.grad(
            ss.fused_selective_scan_n1_plain(*leaves)[0], leaves, g)
        torch.cuda.synchronize()
        function_err = max(max_err(a, b, f"{stage} Function {n}", GRAD_RTOL,
                                   GRAD_ATOL)
                           for n, a, b in zip(names, got, want))
        del got, want, leaves
        bound_ms, bound_by = bounds.fused_scan_bwd(L, M)
        per_shape[stage] = dict(
            L=L, M=M, max_abs_err=err, bitwise_deterministic=True,
            function_vs_autograd_max_abs_err=function_err, ms=ms,
            plain_ms=plain_ms, composition_ms=composition_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms)
        del args, h, g
        torch.cuda.empty_cache()
    return per_shape


def attention_inputs(BW: int, n: int, geom, seed: int):
    """q, k, v and an output gradient [BW, n, G, hd], unit-scale like the
    Swin block's normalised activations; a bias [G, n, n] of scale 0.5;
    the shift mask's (bank, idx) on the card, or None. ``geom``: (D, H,
    W, window, shift) of the grid, and (a, b) to cut the mask to window
    rows [a, b) (a rank's windows under the space axis)."""
    from idee_tpu_torch.nn.swin3d import shift_mask_on

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, go = (torch.randn(BW, n, ATTN_G, ATTN_HD, device="cuda",
                               generator=g) for _ in range(4))
    bias = 0.5 * torch.randn(ATTN_G, n, n, device="cuda", generator=g)
    mask = None
    if geom is not None:
        mask = shift_mask_on(*geom[:5], "cuda", *geom[5:])
        if mask[1].shape[0] != BW:
            raise SystemExit(f"mask of {geom} has {mask[1].shape[0]} "
                             f"windows, not {BW}")
    return q, k, v, go, bias, mask


def sdpa_times(q, k, v, go, bias, mask, scale, o_plain):
    """PyTorch's scaled_dot_product_attention on the same inputs, the
    additive mask (bias + shift mask, [BW, G, n, n], made outside the
    timing) with a gradient: (forward ms, backward ms, max abs error of
    its forward against the plain one, ``o_plain``). A yardstick only: the
    port never calls it."""
    import torch.nn.functional as F

    BW, n = q.shape[:2]
    add = bias[None].expand(BW, -1, -1, -1)
    if mask is not None:
        bank, idx = mask
        add = add + bank[idx.long()][:, None]
    # SDPA takes a mask of q's dtype
    add = add.to(q.dtype).contiguous().requires_grad_()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gt = go.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add,
                                                  scale=scale)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add,
                                             scale=scale)
        torch.autograd.grad(out, (qt, kt, vt, add), gt)

    err = (fwd().transpose(1, 2).float() - o_plain.float()).abs().max()
    fwd_ms = cuda_ms(fwd, iters=20)
    return fwd_ms, cuda_ms(fwd_bwd, iters=10) - fwd_ms, err.item()


def host_us_per_call(fn, iters: int = 300) -> float:
    """Host microseconds per fn() call: a loop of ``iters`` calls after a
    synchronise, timed before the one synchronise that ends it (the
    enqueue cost; the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def dbias_sum_costs(wa, part):
    """The dbias sum on ``part`` beside torch.sum(part, 0), its library
    call. CUDA-event ms per call back to back: ``ms`` of the kernel's launch
    into a ready output (as the backward's own launch, whose output the
    backward allocates), ``call_ms`` of ``dbias_sum`` (allocation included,
    as torch.sum's), ``library_ms``. The device ms per call from
    torch.profiler's CUDA rows. The host us per call of the same three."""
    n_blocks, E = part.shape[0], part[0].numel()
    dbias = torch.empty_like(part[0])
    shape = wa.dbias_sum_shape(n_blocks, E)

    def launch():
        wa._launch(wa.DBIAS_SUM, part.device, part, dbias, n_blocks, E,
                   *shape)

    def call():
        wa.dbias_sum(part)

    def library():
        part.sum(0)

    # host-bound back to back: 200 calls average out the host's jitter
    return dict(
        outputs_per_block=shape[0], chunks=shape[1],
        ms=cuda_ms(launch, iters=200), call_ms=cuda_ms(call, iters=200),
        library_ms=cuda_ms(library, iters=200),
        device_ms=profile_steps(launch, n=50)["device_ms_per_step"],
        library_device_ms=profile_steps(library, n=50)["device_ms_per_step"],
        host_us_per_launch=host_us_per_call(launch),
        host_us_per_call=host_us_per_call(call),
        library_host_us_per_call=host_us_per_call(library))


def check_attention(bounds, shapes=ATTN_SHAPES):
    """Forward, backward and dbias sum against their plain versions, timed,
    at each stage shape; the backward twice, bit for bit."""
    wa = kernel_modules()[1]
    per_shape = {}
    for i, (stage, (BW, n, geom)) in enumerate(shapes.items()):
        q, k, v, go, bias, mask = attention_inputs(BW, n, geom, seed=30 + i)
        scale = ATTN_HD ** -0.5
        # forward, no gradient
        o = wa.window_attention(q, k, v, bias, mask, scale)
        o_p = wa.window_attention_fwd_plain(q, k, v, bias, mask, scale)
        torch.cuda.synchronize()
        fwd_err = max_err(o, o_p, f"{stage} forward", ATTN_RTOL, ATTN_ATOL)
        if not torch.equal(o, wa.window_attention(q, k, v, bias, mask,
                                                  scale)):
            raise SystemExit(f"{stage}: two forward runs differ")

        # backward through the Function, twice
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        runs = [torch.autograd.grad(
            wa.window_attention(*leaves, mask, scale), leaves, go)
            for _ in range(2)]
        want = wa.window_attention_bwd_plain(q, k, v, bias, mask, scale,
                                             o_p, go)
        torch.cuda.synchronize()
        bwd_err = max(max_err(
            a, b, f"{stage} {name}", ATTN_GRAD_RTOL,
            DBIAS_REL * b.abs().max().item() if name == "dbias"
            else ATTN_GRAD_ATOL)
            for name, a, b in zip(("dq", "dk", "dv", "dbias"), runs[0], want))
        bitwise = all(torch.equal(a, b) for a, b in zip(*runs))
        if not bitwise:
            raise SystemExit(f"{stage}: two backward runs differ")
        del runs, want, leaves

        # the dbias sum alone, on partials of the backward's shape
        n_blocks = wa.bwd_blocks(BW, n, ATTN_G)
        part = torch.randn(n_blocks, ATTN_G, n, n, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(i))
        sum_err = max_err(wa.dbias_sum(part), wa.dbias_sum_plain(part),
                          f"{stage} dbias sum", 0.0, 0.0)
        dbias_sum = dbias_sum_costs(wa, part)

        def fwd():
            wa.window_attention(q, k, v, bias, mask, scale)

        def bwd():
            wa._backward(q, k, v, bias, *(mask or (None, None)), scale, o,
                         go)

        def plain_bwd():
            wa.window_attention_bwd_plain(q, k, v, bias, mask, scale, o_p,
                                          go)

        ms = cuda_ms(fwd, iters=50)
        # the backward kernel alone: the backward's two launches less the
        # dbias sum's
        bwd_ms = cuda_ms(bwd, iters=20) - dbias_sum["ms"]
        sdpa_fwd, sdpa_bwd, sdpa_err = sdpa_times(q, k, v, go, bias, mask,
                                                  scale, o_p)
        row = dict(BW=BW, n=n, G=ATTN_G, hd=ATTN_HD, shifted=geom is not None)
        fwd_smem, fwd_per_sm = wa.fwd_occupancy(n, ATTN_HD, geom is not None)
        row["forward"] = dict(
            max_abs_err=fwd_err, bitwise_deterministic=True, ms=ms,
            plain_ms=cuda_ms(lambda: wa.window_attention_fwd_plain(
                q, k, v, bias, mask, scale), iters=5, warmup=1),
            library_ms=sdpa_fwd, library_max_abs_err=sdpa_err,
            smem_bytes_per_block=fwd_smem, blocks_per_sm=fwd_per_sm)
        smem, per_sm = wa.bwd_occupancy(n, ATTN_HD, geom is not None)
        row["backward"] = dict(
            max_abs_err=bwd_err, bitwise_deterministic=bitwise, ms=bwd_ms,
            plain_ms=cuda_ms(plain_bwd, iters=5, warmup=1),
            library_ms=sdpa_bwd, smem_bytes_per_block=smem,
            blocks_per_sm=per_sm)
        row["dbias_sum"] = dict(
            n_blocks=n_blocks, max_abs_err=sum_err,
            plain_ms=cuda_ms(lambda: wa.dbias_sum_plain(part), iters=5,
                             warmup=1), **dbias_sum)
        for key, fn, shape in (
                ("forward", bounds.window_attention_fwd,
                 (BW, n, ATTN_G, ATTN_HD)),
                ("backward", bounds.window_attention_bwd,
                 (BW, n, ATTN_G, ATTN_HD)),
                ("dbias_sum", bounds.window_attention_dbias_sum,
                 (n_blocks, ATTN_G, n))):
            r = row[key]
            r["bound_ms"], r["bound_by"] = fn(*shape)
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        per_shape[stage] = row
        del q, k, v, go, bias, mask, o, o_p, part
        torch.cuda.empty_cache()
    return per_shape


def bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at |x|; 0 at 0."""
    m, e = torch.frexp(x.float().abs())
    return torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


def max_err_bf16(got, want, name, atol) -> float:
    """Max |got - want| of two bf16 tensors, each entry within
    ATTN_BF16_ULPS bf16 ulps of want plus ``atol``: raises where one is
    not."""
    err = (got.float() - want.float()).abs()
    lim = ATTN_BF16_ULPS * bf16_ulp(want) + atol
    if not bool((err <= lim).all()):
        over = (err - lim).flatten()
        worst = int(over.argmax())
        raise SystemExit(f"{name}: " + str(dict(
            entries=int((over > 0).sum()), of=err.numel(),
            tolerance=f"{ATTN_BF16_ULPS} bf16 ulp + {atol}",
            worst_excess=over[worst].item(),
            worst_want=want.flatten()[worst].item(),
            worst_got=got.flatten()[worst].item())))
    return err.max().item()


def check_attention_bf16(bounds, f32_rows, shapes=ATTN_SHAPES):
    """The bf16 forward and backward kernels against their plain bf16
    versions at each stage shape (q, k, v and the output gradient rounded
    to bf16; bias and mask float32), each run twice and compared bit for
    bit; timed beside SDPA on the same bf16 inputs and their bounds; their
    shared memory, blocks per SM and registers per thread. The backward's
    time is its two launches less the float32 row's dbias sum (the same
    launch on the same shape)."""
    wa = kernel_modules()[1]
    bf16 = torch.bfloat16
    per_shape = {}
    for i, (stage, (BW, n, geom)) in enumerate(shapes.items()):
        q, k, v, go, bias, mask = attention_inputs(BW, n, geom, seed=60 + i)
        q, k, v, go = (t.to(bf16) for t in (q, k, v, go))
        scale = ATTN_HD ** -0.5
        before = dict(wa.launches)
        o = wa.window_attention(q, k, v, bias, mask, scale)
        o_p = wa.window_attention_fwd_plain(q, k, v, bias, mask, scale)
        torch.cuda.synchronize()
        fwd_err = max_err_bf16(o, o_p, f"{stage} bf16 forward", ATTN_ATOL)
        if not torch.equal(o, wa.window_attention(q, k, v, bias, mask,
                                                  scale)):
            raise SystemExit(f"{stage}: two bf16 forward runs differ")

        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        runs = [torch.autograd.grad(
            wa.window_attention(*leaves, mask, scale), leaves, go)
            for _ in range(2)]
        want = wa.window_attention_bwd_plain(q, k, v, bias, mask, scale,
                                             o_p, go)
        torch.cuda.synchronize()
        launched = {kk: wa.launches[kk] - before[kk] for kk in wa.launches}
        expect_launches(launched, {wa.ATTN_FWD_BF16: 4, wa.ATTN_BWD_BF16: 2,
                                   wa.DBIAS_SUM: 2}, f"{stage} bf16 check")
        bwd_err = max(max_err_bf16(a, b, f"{stage} bf16 {name}",
                                   ATTN_GRAD_ATOL)
                      for name, a, b in zip(("dq", "dk", "dv"), runs[0],
                                            want))
        bwd_err = max(bwd_err, max_err(
            runs[0][3], want[3], f"{stage} bf16 dbias", ATTN_GRAD_RTOL,
            DBIAS_REL * want[3].abs().max().item()))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise SystemExit(f"{stage}: two bf16 backward runs differ")
        del runs, want, leaves

        def fwd():
            wa.window_attention(q, k, v, bias, mask, scale)

        def bwd():
            wa._backward(q, k, v, bias, *(mask or (None, None)), scale, o,
                         go)

        def plain_bwd():
            wa.window_attention_bwd_plain(q, k, v, bias, mask, scale, o_p,
                                          go)

        sdpa_fwd, sdpa_bwd, sdpa_err = sdpa_times(q, k, v, go, bias, mask,
                                                  scale, o_p)
        row = dict(BW=BW, n=n, G=ATTN_G, hd=ATTN_HD, shifted=geom is not None,
                   dtype="bfloat16")
        smem, per_sm = wa.fwd_occupancy(n, ATTN_HD, geom is not None, bf16)
        fwd_regs, bwd_regs = wa.bf16_registers(n, ATTN_HD)
        row["forward"] = dict(
            max_abs_err=fwd_err, bitwise_deterministic=True,
            ms=cuda_ms(fwd, iters=50),
            plain_ms=cuda_ms(lambda: wa.window_attention_fwd_plain(
                q, k, v, bias, mask, scale), iters=5, warmup=1),
            library_ms=sdpa_fwd, library_max_abs_err=sdpa_err,
            smem_bytes_per_block=smem, blocks_per_sm=per_sm,
            registers=fwd_regs)
        smem, per_sm = wa.bwd_occupancy(n, ATTN_HD, geom is not None, bf16)
        row["backward"] = dict(
            max_abs_err=bwd_err, bitwise_deterministic=True,
            ms=cuda_ms(bwd, iters=20) - f32_rows[stage]["dbias_sum"]["ms"],
            plain_ms=cuda_ms(plain_bwd, iters=5, warmup=1),
            library_ms=sdpa_bwd, smem_bytes_per_block=smem,
            blocks_per_sm=per_sm, registers=bwd_regs)
        for key, fn in (("forward", bounds.window_attention_fwd),
                        ("backward", bounds.window_attention_bwd)):
            r = row[key]
            r["bound_ms"], r["bound_by"] = fn(BW, n, ATTN_G, ATTN_HD,
                                              "bfloat16")
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
        per_shape[stage] = row
        del q, k, v, go, bias, mask, o, o_p
        torch.cuda.empty_cache()
    return per_shape


def phase_kernel():
    from idee_tpu_torch.kernels import bounds

    ss, wa = kernel_modules()
    fused = check_fused_forward(ss, bounds)
    scan = check_linear_scan(ss, bounds)
    backward = check_fused_backward(ss, bounds)
    attention = check_attention(bounds)
    attention_bf16 = check_attention_bf16(bounds, attention)
    # the same at Swin_3D's delta_t 4 shapes (phase swin_dt4)
    attention_dt4 = check_attention(bounds, ATTN_SHAPES_DT4)
    attention_bf16_dt4 = check_attention_bf16(bounds, attention_dt4,
                                              ATTN_SHAPES_DT4)
    emit(phase="kernel", rtol=SCAN_RTOL, atol=SCAN_ATOL,
         grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
         attention_rtol=ATTN_RTOL, attention_atol=ATTN_ATOL,
         attention_grad_rtol=ATTN_GRAD_RTOL,
         attention_grad_atol=ATTN_GRAD_ATOL,
         attention_dbias_atol_over_max=DBIAS_REL,
         attention_bf16_ulps=ATTN_BF16_ULPS,
         **{ss.FUSED_FWD: fused, ss.LINEAR_SCAN: scan,
            "fused_scan_backward": backward, "window_attention": attention,
            "window_attention_bf16": attention_bf16,
            "window_attention_delta_t_4": attention_dt4,
            "window_attention_bf16_delta_t_4": attention_bf16_dt4})
    return (fused, scan, backward, attention, attention_bf16,
            {"float32": attention_dt4, "bfloat16": attention_bf16_dt4})


def zero_launches():
    for mod in kernel_modules():
        for k in mod.launches:
            mod.launches[k] = 0


def read_launches():
    return {k: v for mod in kernel_modules() for k, v in mod.launches.items()}


def expect_launches(got, nonzero, what):
    """Every kernel's count equals ``nonzero``'s entry, or 0."""
    want = {k: nonzero.get(k, 0) for k in got}
    if got != want:
        raise SystemExit(f"{what} launches {got}, expected {want}")


@contextlib.contextmanager
def plain_ops(encoder: str):
    """The encoder's kernel op swapped for its plain PyTorch version at the
    name the encoder module calls."""
    ss, wa = kernel_modules()
    if encoder == "Mamba":
        import idee_tpu_torch.nn.mamba as mod

        name = "fused_selective_scan_n1"
        plain = lambda *a: ss.fused_selective_scan_n1_plain(*a)[0]  # noqa
    else:
        import idee_tpu_torch.nn.swin3d as mod

        name = "window_attention"
        plain = wa.window_attention_fwd_plain
    kernel_op = getattr(mod, name)
    setattr(mod, name, plain)
    try:
        yield
    finally:
        setattr(mod, name, kernel_op)


def kernel_launches_per_step(encoder: str, train: bool, d_state: int = 1,
                             dtype: str = "float32"):
    """Launches per train (or eval / val) step at the bench width: three
    blocks, one launch each of the forward kernel, and in a train step of
    each backward kernel (at d_state > 1 the linear scan is both). At
    bf16 the attention launches its bf16 kernels (and the float32 dbias
    sum); the scans take float32 inputs whatever the compute dtype."""
    ss, wa = kernel_modules()
    if encoder == "Mamba" and d_state == 1:
        return {ss.FUSED_FWD: 3, **({ss.FUSED_BWD: 3} if train else {})}
    if encoder == "Mamba":
        return {ss.LINEAR_SCAN: 6 if train else 3}
    if encoder == "Swin_3D":
        fwd, bwd = ((wa.ATTN_FWD, wa.ATTN_BWD) if dtype == "float32"
                    else (wa.ATTN_FWD_BF16, wa.ATTN_BWD_BF16))
        return {fwd: 3, **({bwd: 3, wa.DBIAS_SUM: 3} if train else {})}
    return {}  # CNN_3D runs no kernel


def steady_steps_per_s(run_step, batches, warmup: int = 3):
    """Steps/s of run_step(batch) over ``batches`` after ``warmup`` steps,
    host batch assembly included; (steps/s, steps timed)."""
    for _ in range(warmup):
        run_step(next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 0
    for batch in batches:
        run_step(batch)
        timed += 1
    torch.cuda.synchronize()
    return timed / (time.perf_counter() - t0), timed


# device kernels by kind, disjoint (a kernel counts under its first match):
# cuDNN's weight gradients, its data gradients, every other GEMM or
# implicit GEMM (cuBLAS, CUTLASS, cuDNN's forward convolutions), the rest
KERNEL_KINDS = (("wgrad", ("wgrad",)), ("dgrad", ("dgrad",)),
                ("gemm_or_implicit_gemm", ("gemm", "xmma", "cutlass",
                                           "wmma")))


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, words in KERNEL_KINDS:
        if any(w in low for w in words):
            return kind
    return "other"


def _kernel_sources(prof):
    """Each device kernel's launching operators from a profile taken with
    record_shapes: {kernel: {(pass, op, input shapes): us}}, the pass
    "backward" under an autograd node, "optimizer" under an optimizer's
    step, else "forward" (loss and metrics included). The kernel's name
    carries its dtypes."""
    out = {}
    for e in prof.events():
        if not e.kernels:
            continue
        where, p = "forward", e
        while p is not None:
            if p.name.startswith("autograd::engine::evaluate_function"):
                where = "backward"
                break
            if p.name.startswith("Optimizer."):
                where = "optimizer"
                break
            p = p.cpu_parent
        src = (where, e.name, str(e.input_shapes)[:160])
        for kern in e.kernels:
            by_src = out.setdefault(kern.name, {})
            by_src[src] = by_src.get(src, 0.0) + kern.duration
    return out


def profile_steps(run_step, n: int, attribute: bool = False,
                  warm: bool = True):
    """Where a steady step's time goes: torch.profiler over ``n`` calls of
    run_step(); device time by operator and by kind of kernel, and the
    device's busy share of the wall time (the profiler's own host cost
    included). With ``attribute``, one more call is profiled with its
    operators' input shapes (kept out of the timed calls): device ms of
    that step by pass and kind, and for each top kernel the operators that
    launched it. ``warm``: one unprofiled call first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    rows = []
    for e in prof.key_averages():
        # device activity only (kernels, copies): an operator's row repeats
        # the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        # the device side of the port's host ranges (utils/spans.py)
        # spans the kernels inside them
        if e.key.startswith("idee."):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.key))
    rows.sort(reverse=True)
    device_ms = sum(ms for ms, _ in rows)
    by_kind = {kind: 0.0 for kind, _ in KERNEL_KINDS + (("other", ()),)}
    for ms, k in rows:
        by_kind[kernel_kind(k)] += ms
    top = [{"op": k[:80], "ms_per_step": ms} for ms, k in rows[:14]]
    out = dict(steps=n, wall_ms_per_step=wall_ms,
               device_ms_per_step=device_ms,
               device_busy_share=device_ms / wall_ms,
               ms_per_step_by_kind=by_kind, top_device_ops=top)
    if attribute:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            run_step()
            torch.cuda.synchronize()
        sources = _kernel_sources(prof)
        by_pass = {}
        for k, by_src in sources.items():
            for (where, *_), us in by_src.items():
                kinds = by_pass.setdefault(where, {})
                kinds[kernel_kind(k)] = (kinds.get(kernel_kind(k), 0.0)
                                         + us / 1e3)
        out["attributed_ms_by_pass_and_kind"] = by_pass
        for row, (_, k) in zip(top, rows):
            srcs = sorted(sources.get(k, {}).items(), key=lambda t: -t[1])
            row["launched_by"] = [
                {"pass": w, "op": op, "shapes": sh, "ms": us / 1e3}
                for (w, op, sh), us in srcs[:3]]
    return out


EVAL_PHASES = {"Mamba": "main", "Swin_3D": "main_swin", "CNN_3D": "main_cnn"}


def bf16_logits_agree(out_k, out_p, what):
    """The bf16 forward with the kernels against the one with the plain op:
    (largest logit error over max |logit| on the pixels with no flipped
    code in view, the share of such pixels, the share of equal bits)."""
    import torch.nn.functional as F

    flipped = out_k.anomaly != out_p.anomaly                  # N,V,T,H,W
    bits = 1.0 - flipped.float().mean().item()
    seen = F.max_pool2d(flipped.any(2).any(1)[:, None].float(), 7, 1, 3)
    clean = (seen == 0).expand_as(out_k.z)
    err = (out_k.z - out_p.z).abs() / out_p.z.abs().max()
    worst = err[clean].max().item() if clean.any() else None
    if not (torch.isfinite(out_k.z).all() and bits >= BF16_BITS_AGREE
            and worst is not None and worst <= BF16_LOGIT_REL):
        raise SystemExit(f"{what}: bf16 kernel forward disagrees with the "
                         f"plain one: bits agree {bits}, logit error "
                         f"{worst} x max where no code flipped")
    return worst, clean.float().mean().item(), bits


def bf16_encoder_agrees(model, x, encoder: str, what):
    """The bf16 encoder's packed output (before the quantizer) with the
    kernels against the one with the plain op: its largest error over its
    max |output|."""
    with torch.inference_mode():
        xd = x.to(model.dtype)
        zk = model.encoder(xd, packed_out=True).float()
        with plain_ops(encoder):
            zp = model.encoder(xd, packed_out=True).float()
    err = ((zk - zp).abs().max() / zp.abs().max()).item()
    if not (torch.isfinite(zk).all() and err <= BF16_ENCODER_REL):
        raise SystemExit(f"{what}: bf16 encoder output with the kernels is "
                         f"{err} x max from the plain op's")
    return err


def phase_eval(cube, encoder: str, phase: str = None, **cfg_kw):
    """Phase main (Mamba), main_swin or main_cnn (or ``phase``, with the
    config overrides ``cfg_kw``, e.g. another codebook): test_synthetic at
    the bench width, launches counted; steady steps/s; a profile; the
    forward with the kernels against the forward with the plain op (CNN_3D
    has no kernel, so no plain op)."""
    from idee_tpu_torch.config import synthetic_config
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.data.synthetic import SyntheticDataset
    from idee_tpu_torch.models.vq_model import build_model, compute_dtype
    from idee_tpu_torch.train.evaluate import test_synthetic
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_eval_step


    phase = phase or EVAL_PHASES[encoder]
    cfg = synthetic_config(encoder=encoder, x_max=200, y_max=200,
                           times_test=(1, N_WEEKS), dir_log=LOG_DIR,
                           is_clima_scale=IS_CLIMA_SCALE,
                           name=f"chip_smoke_{phase}", **cfg_kw)
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    n_steps = N_WEEKS - cfg.delta_t + 1

    # --- the main path, with the launch counters zeroed around it
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    result = test_synthetic(cfg, cube=cube, params=params, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()

    expect_launches(launches, {
        k: v * n_steps for k, v in kernel_launches_per_step(
            encoder, train=False, dtype=cfg.dtype).items()},
        f"{encoder} eval")
    if not math.isfinite(result["mean_loss"]):
        raise SystemExit(f"non-finite mean loss: {result}")

    # --- steady state: the same eval step, host batch assembly included
    ds = SyntheticDataset(cube=cube, times=cfg.times_test,
                          variables=list(cfg.variables), delta_t=cfg.delta_t,
                          is_clima_scale=cfg.is_clima_scale, x_max=200,
                          y_max=200)
    model = build_model(cfg)
    model.load_state_dict(params)
    model.to("cuda")
    step = make_eval_step(model, cfg, t0=float(ds.timestep[0]))
    metrics = init_epoch_metrics(ds.anomaly.shape, "cuda")
    loader = DataLoader(ds, 1, device="cuda",
                        keys=["x", "mask_extreme", "mask_extreme_loss",
                              "timestep"], x_dtype=compute_dtype(cfg))
    steps_per_s, timed = steady_steps_per_s(lambda b: step(metrics, b),
                                            iter(loader))
    batches = iter(loader)
    profile = profile_steps(lambda: step(metrics, next(batches)), n=5,
                            attribute=True)

    # --- one forward with the plain op, against the kernel's
    logit_err = bits_agree = clean_share = encoder_err = None
    if encoder != "CNN_3D":
        x = torch.from_numpy(ds[0]["x"][None]).cuda()
        with torch.inference_mode():
            out_k = model(x)
            with plain_ops(encoder):
                out_p = model(x)
        if cfg.dtype == "bfloat16":
            encoder_err = bf16_encoder_agrees(model, x, encoder, phase)
            logit_err, clean_share, bits_agree = bf16_logits_agree(
                out_k, out_p, f"{phase}")
        else:
            logit_err = max((out_k.z - out_p.z).abs().max().item(),
                            (out_k.y - out_p.y).abs().max().item())
            bits_agree = (out_k.anomaly == out_p.anomaly).float().mean() \
                .item()
            if not (torch.isfinite(out_k.z).all() and logit_err <= 1e-4
                    and bits_agree >= 0.999):
                raise SystemExit(f"{encoder}: kernel forward disagrees with "
                                 f"the plain one: logit err {logit_err}, "
                                 f"bits agree {bits_agree}")

    SUMMARY[phase] = dict(
        steady_steps_per_s=steps_per_s,
        device_ms_per_step=profile["device_ms_per_step"],
        device_busy_share=profile["device_busy_share"],
        max_memory_allocated=peak_bytes)
    emit(phase=phase, encoder=cfg.encoder, codebook=cfg.codebook,
         codebook_size=cfg.codebook_size, dtype=cfg.dtype,
         shape=[1, 6, 1, 8, 200, 200],
         metrics=result, steps=n_steps, launches=launches,
         launches_per_step={k: v / n_steps for k, v in launches.items()},
         wall_s_with_setup=wall_s, steady_steps_per_s=steps_per_s,
         steady_samples_per_s=steps_per_s, steady_steps_timed=timed,
         max_memory_allocated=peak_bytes,
         plain_op_logit_max_abs_err=logit_err,
         plain_op_anomaly_bit_agreement=bits_agree,
         plain_op_clean_pixel_share=clean_share,
         plain_op_encoder_rel_err=encoder_err)
    emit(phase="profile", path=f"eval_{encoder}" if phase == EVAL_PHASES[
        encoder] else phase, **profile)
    return launches


def train_config(encoder: str, d_state: int = 1, n_epochs: int = N_EPOCHS,
                 **cfg_kw):
    from idee_tpu_torch.config import synthetic_config

    kw = dict(encoder=encoder, x_max=200, y_max=200,
              times_train=TRAIN_WEEKS, times_val=VAL_WEEKS,
              n_epochs=n_epochs, is_aug=False, batch_size=1,
              is_clima_scale=IS_CLIMA_SCALE, dir_log=LOG_DIR,
              d_state=[d_state, d_state],
              name=f"chip_smoke_train_{encoder}_n{d_state}")
    if cfg_kw:
        kw["name"] += "_" + cfg_kw.get("codebook", cfg_kw.get("dtype", ""))
    return synthetic_config(**kw, **cfg_kw)


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms, for the runs a gradient comparison
    holds against each other: its default backward convolutions sum in an
    order that changes from run to run, noise that would stand beside the
    kernels' own difference (seen at 1.5e-4 x max |grad| on a leaf whose
    gradients cancel, DeepMIL over Swin_3D; PERF.md §6)."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def step_gradients(cfg, params, batch, plain: bool, real: bool = False,
                   loss: list = None):
    """Every parameter's gradient of one train step (synthetic, or with
    ``real`` the real-world one) from ``params``, with the kernels or
    (plain) with autograd through the plain op; the step's loss is
    appended to ``loss`` when given."""
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step
    from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                                 make_train_step_real)

    model = build_model(cfg)
    model.load_state_dict(params)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=17)
    if real:
        step = make_train_step_real(model, cfg)
        metrics = init_epoch_metrics_real("cuda")
    else:
        step = make_train_step(model, cfg, t0=float(TRAIN_WEEKS[0]),
                               steps_per_epoch=17)
        metrics = init_epoch_metrics((6, N_WEEKS, 200, 200), "cuda")
    with plain_ops(cfg.encoder) if plain else contextlib.nullcontext(), \
            deterministic_convolutions():
        step(state, metrics, batch)
    torch.cuda.synchronize()
    if loss is not None:
        loss.append(metrics["loss_sums"]["loss"].item())
    return {k: p.grad for k, p in model.named_parameters()}


def index_agreement(cfg, params, batch) -> float:
    """Share of code indices equal between the forward with the kernels and
    with the plain op, from ``params`` (buffers included) on one batch;
    without sampling the train forward assigns the same codes."""
    from idee_tpu_torch.models.vq_model import build_model

    model = build_model(cfg)
    model.load_state_dict(params)
    model.to("cuda")
    with torch.inference_mode():
        got = model(batch["x"]).anomaly
        with plain_ops(cfg.encoder):
            want = model(batch["x"]).anomaly
    return (got == want).float().mean().item()


def hold_gradients(got, want, limit, what, zero=()):
    """Each gradient of ``got`` within ``limit`` x the max |grad| of its
    ``want``, every encoder parameter's nonzero; the names in ``zero``
    (gradients zero in exact arithmetic) held instead under 1e-9 x the
    largest max |grad|, on both sides. Returns the largest error over
    max |grad|."""
    floor = 1e-9 * max(w.abs().max().item() for w in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = w.abs().max().item()
        err = (got[k] - w).abs().max().item()
        if k in zero:
            if max(scale, got[k].abs().max().item()) >= floor:
                raise SystemExit(f"{what}: gradient of {k}: "
                                 f"{got[k].abs().max().item()} with the "
                                 f"kernels, {scale} with the plain op, "
                                 f"floor {floor}")
            continue
        if err > limit * scale:
            raise SystemExit(f"{what}: gradient of {k}: kernel vs plain "
                             f"error {err} > {limit} x max|grad| "
                             f"{scale}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
        if k.startswith("encoder.") and got[k].abs().max().item() == 0.0:
            raise SystemExit(f"{what}: encoder parameter {k} got no "
                             "gradient")
    return worst


def compare_step_gradients(cfg, params, batch, what: str, real: bool = False):
    """One train step's gradients with the kernels against the plain op:
    each parameter within STEP_GRAD_REL (BF16_GRAD_REL at bf16) x its max
    |grad|, every encoder parameter nonzero. Emits a train_gradients line;
    for a codebook other than the 1-bit LFQ also the share of equal code
    indices."""
    limit = BF16_GRAD_REL if cfg.dtype == "bfloat16" else STEP_GRAD_REL
    got = step_gradients(cfg, params, batch, plain=False, real=real)
    want = step_gradients(cfg, params, batch, plain=True, real=real)
    agree = None
    if cfg.codebook != "LFQ" or cfg.codebook_size != 2:
        agree = index_agreement(cfg, params, batch)
    worst = hold_gradients(got, want, limit, what)
    emit(phase="train_gradients", path=what, encoder=cfg.encoder,
         codebook=cfg.codebook, index_agreement=agree, parameters=len(want),
         encoder_parameters=sum(1 for k in got if k.startswith("encoder.")),
         max_err_over_max_abs_grad=worst, limit=limit, dtype=cfg.dtype)


def phase_train(cube, encoder: str, phase: str, resume: bool,
                d_state: int = 1, n_epochs: int = N_EPOCHS,
                compare_plain: bool = True, cfg_kw=None, check=None):
    """Phase ``phase``: train_synthetic at the bench width for ``n_epochs``
    (with the config overrides ``cfg_kw``), launches counted; losses,
    checkpoints, history; with ``resume`` one more epoch from latest;
    steady train steps/s; a profile; with ``compare_plain`` one step's
    gradients with the kernels against the plain op, from the trained
    weights when ``check`` is given. ``check(stage, cfg, run)`` runs after
    the first run ("trained") and after the resume ("resumed"); what it
    returns goes into the phase's line."""
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.models.vq_model import build_model, compute_dtype
    from idee_tpu_torch.train.driver import _make_datasets, train_synthetic
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

    cfg = train_config(encoder, d_state, n_epochs, **(cfg_kw or {}))
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    checked = {}
    train_cube, val_cube = cube.time_slice(*TRAIN_WEEKS), \
        cube.time_slice(*VAL_WEEKS)
    n_train = (TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 1) - cfg.delta_t + 1
    n_val = (VAL_WEEKS[1] - VAL_WEEKS[0] + 1) - cfg.delta_t + 1

    # --- the main path, with the launch counters zeroed around it
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    history = train_synthetic(cfg, train_cube=train_cube, val_cube=val_cube,
                              device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()

    train_steps, val_steps = n_epochs * n_train, n_epochs * n_val
    val = kernel_launches_per_step(encoder, train=False, d_state=d_state,
                                   dtype=cfg.dtype)
    trn = kernel_launches_per_step(encoder, train=True, d_state=d_state,
                                   dtype=cfg.dtype)
    want = {k: val.get(k, 0) * (val_steps + n_epochs * PANEL_STEPS)
            + trn.get(k, 0) * train_steps for k in set(val) | set(trn)}
    expect_launches(launches, want, phase)
    curves = history["train_loss"] + history["val_loss"]
    if len(curves) != 2 * n_epochs or not all(map(math.isfinite, curves)):
        raise SystemExit(f"bad loss history: {history}")
    ckpt_dir = os.path.join(cfg.log_dir, "model_checkpoints")
    written = sorted(os.listdir(ckpt_dir))
    for name in ("latest.pt", "best_loss_model.pt"):
        if name not in written:
            raise SystemExit(f"{name} not written: {written}")
    with open(os.path.join(cfg.log_dir, "history.json")) as fh:
        if json.load(fh)["train_loss"] != history["train_loss"]:
            raise SystemExit("history.json differs from the run's history")
    if check:
        checked["trained"] = check("trained", cfg, history)

    resumed = None
    if resume:  # one more epoch resumes from latest
        resumed = train_synthetic(cfg.replace(n_epochs=n_epochs + 1),
                                  train_cube=train_cube, val_cube=val_cube,
                                  device="cuda")
        if (resumed["train_loss"][:n_epochs] != history["train_loss"]
                or len(resumed["train_loss"]) != n_epochs + 1
                or resumed["state"].step != (n_epochs + 1) * n_train):
            raise SystemExit(f"resume did not continue at epoch {n_epochs}:"
                             f" {resumed['train_loss']}")
        if check:
            checked["resumed"] = check("resumed", cfg, resumed)
    trained = (resumed or history)["state"].model.state_dict()

    # --- steady state: train steps from fresh weights, host batch assembly
    # included
    train_ds, _ = _make_datasets(cfg, train_cube, val_cube)
    loader = DataLoader(train_ds, 1, device="cuda", shuffle=True,
                        keys=["x", "mask_extreme", "mask_extreme_loss",
                              "timestep"], x_dtype=compute_dtype(cfg))
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    model = build_model(cfg)
    model.load_state_dict(params)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=n_train)
    step = make_train_step(model, cfg, t0=float(TRAIN_WEEKS[0]),
                           steps_per_epoch=n_train)
    metrics = init_epoch_metrics(train_ds.anomaly.shape, "cuda")
    steps_per_s, timed = steady_steps_per_s(
        lambda b: step(state, metrics, b), iter(loader))
    batches = iter(loader)
    profile = profile_steps(lambda: step(state, metrics, next(batches)), n=3,
                            attribute=True)

    SUMMARY[phase] = dict(
        driver_steps_per_s=history["steps_per_sec"],
        steady_train_steps_per_s=steps_per_s,
        device_ms_per_step=profile["device_ms_per_step"],
        device_busy_share=profile["device_busy_share"],
        max_memory_allocated=peak_bytes,
        ms_per_step_by_kind=profile["ms_per_step_by_kind"])
    emit(phase=phase, encoder=cfg.encoder, shape=[1, 6, 1, 8, 200, 200],
         dtype=cfg.dtype,
         d_state=cfg.d_state, epochs=n_epochs, train_steps=train_steps,
         val_steps=val_steps, launches=launches,
         history={k: v for k, v in history.items() if k != "state"},
         resumed_train_loss=resumed and resumed["train_loss"],
         wall_s_with_setup=wall_s, steady_train_steps_per_s=steps_per_s,
         steady_steps_timed=timed, max_memory_allocated=peak_bytes,
         checkpoints=written, codebook=cfg.codebook, **checked)
    emit(phase="profile", path=phase, **profile)
    if not compare_plain:
        return launches

    # --- one train step's gradients, kernels against the plain op
    compare_step_gradients(cfg, trained if check else params,
                           next(iter(loader)), phase)
    return launches


# ------------------------------------------------------------------
# bf16 compute (cfg.dtype "bfloat16")

BF16_PHASES = {"Mamba": "mamba", "Swin_3D": "swin", "CNN_3D": "cnn"}


def phase_predict_synthetic(cube):
    """cli/predict_synthetic.py's predict_synthetic over the bench cube
    with train_swin_bf16's latest weights, at bf16: launches counted, the
    payload's keys, dtypes, shapes and NaN warm-up rows checked. Returns
    its launches."""
    from idee_tpu_torch.cli.predict_synthetic import predict_synthetic

    cfg = train_config("Swin_3D", n_epochs=N_EPOCHS_SHORT, **BF16).replace(
        times_test=(1, N_WEEKS))
    ckpt = os.path.join(cfg.log_dir, "model_checkpoints", "latest.pt")
    out_path = os.path.join(LOG_DIR, "chip_smoke_predictions.npz")
    n_steps = N_WEEKS - cfg.delta_t + 1
    zero_launches()
    t0 = time.perf_counter()
    payload = predict_synthetic(cfg, ckpt, out_path, cube=cube,
                                device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    expect_launches(launches, {
        k: v * n_steps for k, v in kernel_launches_per_step(
            "Swin_3D", train=False, dtype=cfg.dtype).items()},
        "predict_synthetic")
    T, V = N_WEEKS, 6
    want = {"extreme_prob": ("float32", (T, 200, 200)),
            "extreme_mask": ("uint8", (T, 200, 200)),
            "anomaly": ("float32", (V, T, 200, 200)),
            "timestep": ("int32", (T,)), "variables": (None, (V,))}
    if sorted(payload) != sorted(want):
        raise SystemExit(f"predict_synthetic keys {sorted(payload)}")
    for k, (dtype, shape) in want.items():
        a = payload[k]
        if (dtype and str(a.dtype) != dtype) or a.shape != shape:
            raise SystemExit(f"predict_synthetic {k}: {a.dtype} {a.shape}")
    prob, warm = payload["extreme_prob"], cfg.delta_t - 1
    if not (np.isnan(prob[:warm]).all() and np.isfinite(prob[warm:]).all()
            and prob[warm:].min() >= 0 and prob[warm:].max() <= 1):
        raise SystemExit("predict_synthetic: extreme_prob is not NaN on the "
                         "warm-up weeks and in [0, 1] after them")
    if not np.array_equal(payload["extreme_mask"],
                          (np.nan_to_num(prob) > 0.5).astype(np.uint8)):
        raise SystemExit("predict_synthetic: extreme_mask != prob > 0.5")
    anomaly = payload["anomaly"]
    if not np.isin(anomaly[~np.isnan(anomaly)], (0.0, 1.0)).all():
        raise SystemExit("predict_synthetic: anomaly votes outside {0, 1}")
    if not np.array_equal(payload["timestep"], np.arange(1, T + 1)):
        raise SystemExit(f"predict_synthetic timestep {payload['timestep']}")
    emit(phase="predict_synthetic", dtype=cfg.dtype, launches=launches,
         steps=n_steps, wall_s_with_setup=wall_s, keys=sorted(payload),
         extreme_mask_share=float(payload["extreme_mask"].mean()),
         anomaly_covered_share=float(np.isfinite(anomaly).mean()),
         anomaly_share=float(np.nanmean(anomaly)),
         bytes=os.path.getsize(out_path))
    os.remove(out_path)
    return launches


def phase_bf16(cube):
    """The three encoders at bf16: main_<enc>_bf16 (eval over the cube) and
    train_<enc>_bf16 (1 epoch), each as its float32 phase, then
    predict_synthetic with the bf16 Swin weights, and one line setting
    each bf16 phase's steps/s, device ms per step, busy share and peak
    memory beside its float32 phase's of this run. Returns the launches by
    path."""
    paths = {}
    for encoder, short in BF16_PHASES.items():
        paths[f"eval_{short}_bf16"] = phase_eval(
            cube, encoder, phase=f"main_{short}_bf16", **BF16)
        paths[f"train_{short}_bf16"] = phase_train(
            cube, encoder, f"train_{short}_bf16", resume=False,
            n_epochs=N_EPOCHS_SHORT, compare_plain=encoder != "CNN_3D",
            cfg_kw=BF16)
    paths["predict_synthetic"] = phase_predict_synthetic(cube)
    f32 = {"main_mamba": "main", "main_swin": "main_swin",
           "main_cnn": "main_cnn", "train_mamba": "train",
           "train_swin": "train_swin", "train_cnn": "train_cnn"}
    emit(phase="bf16_vs_float32", paths={
        name: {"float32": SUMMARY[f32_phase],
               "bfloat16": SUMMARY[f"{name}_bf16"]}
        for name, f32_phase in f32.items()})
    return paths


# ------------------------------------------------------------------
# the codebooks of cfg.codebook on the generic VQModel path


# BASELINE.md's anchored VQ-EMA arm (scripts/train_benchmark_accuracy.py:
# 108-116): EMA codebook, k-means init, dead-code expiry at 2.0; with the
# commitment weight of its "VQ-EMA, commitment 0.25" arm
VQ_EMA = dict(codebook="VQ", vq_ema_update=True, vq_kmeans_init=True,
              vq_threshold_ema_dead_code=2.0, lambda_commitment=0.25)
# every other codebook at the config defaults (codebook_size 2,
# codebook_dim 16), and LFQ with 2 bits
CODEBOOK_ARMS = {"FSQ": dict(codebook="FSQ"),
                 "LatentQuantize": dict(codebook="LatentQuantize"),
                 "Random_VQ": dict(codebook="Random_VQ"),
                 "VQ": dict(codebook="VQ"),
                 "LFQ_4": dict(codebook="LFQ", codebook_size=4)}


def _buffers(model):
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in model.state_dict().items() if k not in names}


def phase_train_vq_ema(cube):
    """Phase train_vq_ema: phase ``train`` for the VQ-EMA arm, 1 epoch and
    a resumed second. The k-means init runs once, in the first step, and
    never in the resumed epoch; initted is 1 and both codes hold
    cluster_size > 0 after each run; a restore gives back the saved buffers
    and the host flag; the step gradients (kernels against the plain scan)
    start from the trained codebook state."""
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.quant.vq import VQ
    from idee_tpu_torch.train.checkpoint import CheckpointManager
    from idee_tpu_torch.train.state import create_train_state

    calls = []
    kmeans = VQ.kmeans

    def counted(self, *a):
        calls.append(1)
        return kmeans(self, *a)

    def check(stage, cfg, run):
        vq = run["state"].model.vq
        want_calls = 1 if stage == "trained" else 0
        cluster = vq.cluster_size.cpu().tolist()
        if (len(calls) != want_calls or vq.initted.item() != 1.0
                or not vq._initted or not (vq.cluster_size > 0).all()):
            raise SystemExit(f"{stage}: k-means ran {len(calls)} times "
                             f"(want {want_calls}), initted "
                             f"{vq.initted.item()}, cluster_size {cluster}")
        calls.clear()
        if stage != "trained":
            return {"kmeans_runs": 0, "cluster_size": cluster}
        saved = torch.load(os.path.join(cfg.log_dir, "model_checkpoints",
                                        "latest.pt"), map_location="cpu",
                           weights_only=True)["model"]
        fresh = build_model(cfg)
        CheckpointManager(cfg.log_dir).restore(
            "latest", create_train_state(cfg, fresh, "cuda"))
        for k, v in _buffers(run["state"].model).items():
            if not (torch.equal(saved[k], v.cpu())
                    and torch.equal(_buffers(fresh)[k], v)):
                raise SystemExit(f"buffer {k} not saved or restored as is")
        if not fresh.vq._initted:
            raise SystemExit("the restored model would re-run k-means")
        return {"kmeans_runs": 1, "cluster_size": cluster,
                "buffers_restored": sorted(_buffers(fresh))}

    VQ.kmeans = counted
    try:
        return phase_train(cube, "Mamba", "train_vq_ema", resume=True,
                           n_epochs=N_EPOCHS_SHORT, cfg_kw=VQ_EMA,
                           check=check)
    finally:
        VQ.kmeans = kmeans


# parameters without a gradient path in the JAX package too: Random_VQ's
# output is stop-gradient (its encoder learns nothing), and LatentQuantize's
# level values reach the loss only through the straight-through estimator
NO_GRADIENT = {"Random_VQ": ("encoder.",),
               "LatentQuantize": ("vq.values_per_latent",)}


def codebook_train_step(cube, name: str, cfg_kw):
    """One train step of codebook ``name`` at the bench width from seeded
    weights, with the kernels (3 fused forward and 3 backward launches; no
    backward where the encoder gets no gradient) and with the plain scan:
    finite losses; each gradient within STEP_GRAD_REL x its max |grad| of
    the plain one, and zero in both or in neither; every encoder parameter
    nonzero and NO_GRADIENT's exactly 0. Which other parameters get no
    gradient depends on the codes: FSQ at 2 levels maps an encoder near 0
    onto the code 0, a zero vector, so the classifier sees zeros."""
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.driver import _make_datasets

    cfg = train_config("Mamba", **cfg_kw)
    train_ds, _ = _make_datasets(cfg, cube.time_slice(*TRAIN_WEEKS),
                                 cube.time_slice(*VAL_WEEKS))
    batch = next(iter(DataLoader(train_ds, 1, device="cuda", keys=[
        "x", "mask_extreme", "mask_extreme_loss", "timestep"])))
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    losses = []
    no_grad = NO_GRADIENT.get(name, ())
    launches = kernel_launches_per_step("Mamba", train=True)
    if "encoder." in no_grad:  # no backward reaches the encoder
        del launches[kernel_modules()[0].FUSED_BWD]
    zero_launches()
    got = step_gradients(cfg, params, batch, plain=False, loss=losses)
    expect_launches(read_launches(), launches, f"{name} train step")
    want = step_gradients(cfg, params, batch, plain=True, loss=losses)
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"{name}: train losses {losses}")
    worst, zero = 0.0, []
    for k, w in want.items():
        scale = w.abs().max().item()
        err = (got[k] - w).abs().max().item()
        if err > STEP_GRAD_REL * scale:
            raise SystemExit(f"{name}: gradient of {k}: kernel vs plain "
                             f"error {err} > {STEP_GRAD_REL} x {scale}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
        is_zero = got[k].abs().max().item() == 0.0
        if is_zero != (scale == 0.0):
            raise SystemExit(f"{name}: {k} is zero in one run only")
        if is_zero:
            zero.append(k)
        if k.startswith(no_grad) != is_zero and (
                k.startswith(no_grad) or k.startswith("encoder.")):
            raise SystemExit(f"{name}: {k} gradient zero={is_zero}")
    return {"train_loss": losses[0], "plain_train_loss": losses[1],
            "parameters": len(want), "max_err_over_max_abs_grad": worst,
            "limit": STEP_GRAD_REL, "zero_gradient": zero}


def phase_codebooks(cube):
    """Phase codebooks: per arm of CODEBOOK_ARMS, phase ``main`` with that
    codebook (test_synthetic over the cube with exact launch counts, steady
    eval steps/s, peak memory, a profile, the forward against the plain
    scan) and one train step (codebook_train_step). Returns the eval
    launches by path."""
    paths, steps = {}, {}
    for name, kw in CODEBOOK_ARMS.items():
        paths[f"eval_{name}"] = phase_eval(cube, "Mamba",
                                           phase=f"main_{name}", **kw)
        steps[name] = codebook_train_step(cube, name, kw)
    emit(phase="codebooks", train_steps=steps)
    return paths


# ------------------------------------------------------------------
# the real-world path: a CERRA tree at the published Europe geometry


# ------------------------------------------------------------------
# the baseline zoo (idee_tpu_torch/baselines/) at the bench width

# (phase, family, variant, encoder, the test driver on the checkpoint, the
# plain-op gradient check): the baseline configs' defaults
BASELINE_PHASES = (
    ("train_deepmil", "mil", "deepmil", "CNN_3D", True, False),
    ("train_arnet", "mil", "arnet", "CNN_3D", True, False),
    ("train_rtfm", "mil", "rtfm", "CNN_3D", True, False),
    ("train_mgfn", "mil", "mgfn", "CNN_3D", True, False),
    ("train_rtfm_mamba", "mil", "rtfm", "Mamba", False, True),
    ("train_deepmil_swin", "mil", "deepmil", "Swin_3D", False, True),
    ("train_simplenet", "oneclass", "simplenet", "Swin_3D", True, False),
    ("train_steal", "recon", "steal", None, True, False),
    ("train_uniad", "recon", "uniad", None, True, False),
)


def baseline_config(family: str, phase: str, **kw):
    """The family's config defaults at the bench width: 200x200, the 6
    variables, batch 1, 1 epoch over the fake cube's weeks, no
    augmentation, global normalisation; STEAL at delta_t 8, UniAD at the
    recon default delta_t 1 (feature_size (100, 100))."""
    from idee_tpu_torch.baselines.config import (mil_config,
                                                 oneclass_config,
                                                 recon_config)

    make = {"mil": mil_config, "oneclass": oneclass_config,
            "recon": recon_config}[family]
    base = dict(x_max=200, y_max=200, times_train=TRAIN_WEEKS,
                times_val=VAL_WEEKS, times_test=(1, N_WEEKS),
                n_epochs=N_EPOCHS_SHORT, batch_size=1, is_aug=False,
                is_clima_scale=IS_CLIMA_SCALE, dir_log=LOG_DIR,
                name=f"chip_smoke_{phase}")
    base.update(kw)
    return make(**base)


def baseline_drivers(family: str, which: str):
    """(train(cfg, train_cube, val_cube), test(cfg, cube), keys of a
    batch) of a baseline, on the card."""
    from idee_tpu_torch.baselines.mil import driver as mil
    from idee_tpu_torch.baselines.oneclass import driver as oc
    from idee_tpu_torch.baselines.recon import driver as recon

    keys = ["x", "mask_extreme_loss", "timestep"]
    if family == "mil":
        return (lambda c, a, b: mil.train_mil_synthetic(c, which, a, b,
                                                        device="cuda"),
                lambda c, t: mil.test_mil_synthetic(c, which, t,
                                                    device="cuda"), keys)
    if family == "oneclass":
        return (lambda c, a, b: oc.train_simplenet_synthetic(c, a, b,
                                                             device="cuda"),
                lambda c, t: oc.test_simplenet_synthetic(c, t, device="cuda"),
                keys)
    return (lambda c, a, b: recon.train_recon_synthetic(c, which, a, b,
                                                        device="cuda"),
            lambda c, t: recon.test_recon_synthetic(c, which, t,
                                                    device="cuda"),
            ["x", "mask_extreme_loss_t", "timestep"])


def baseline_train_step(family: str, which: str, cfg, history):
    """A train step of the trained state in ``history`` (the profile's)."""
    from idee_tpu_torch.baselines.mil.driver import make_mil_train_step
    from idee_tpu_torch.baselines.oneclass.driver import (Backbone,
                                                          make_oc_train_step)
    from idee_tpu_torch.baselines.recon.driver import build_recon_model

    model = history["state"].model
    t0 = float(TRAIN_WEEKS[0])
    if family == "mil":
        return make_mil_train_step(model, cfg, which, t0)
    if family == "oneclass":
        backbone = Backbone(cfg)
        backbone.load_state_dict(history["bb_variables"])
        backbone.requires_grad_(False)
        return make_oc_train_step(backbone.cuda().eval(), model, cfg)
    return build_recon_model(cfg, which, (200, 200))[1](model, cfg, t0)


def baseline_launches_per_step(family: str, encoder,
                               dtype: str = "float32"):
    """Kernel launches per (train, eval) step: the encoder's (a MIL
    encoder trains; SimpleNet's frozen backbone runs its forward only);
    STEAL and UniAD run no kernel."""
    if family == "mil":
        return (kernel_launches_per_step(encoder, train=True, dtype=dtype),
                kernel_launches_per_step(encoder, train=False, dtype=dtype))
    if family == "oneclass":
        fwd = kernel_launches_per_step(encoder, train=False, dtype=dtype)
        return fwd, fwd
    return {}, {}


@contextlib.contextmanager
def pinned_topk(selections, pin: bool):
    """The MIL losses' masked_topk recording each call's selection into
    ``selections`` or, with ``pin``, taking the recorded ones in call order
    (the same entries gathered, so the same gradient paths) and counting
    the calls whose own selection differs. Yields that count's list."""
    import idee_tpu_torch.baselines.mil.losses as mil_losses

    topk, calls, flips = mil_losses.masked_topk, [0], []

    def select(values, mask, k):
        top, idx, valid = topk(values, mask, k)
        if not pin:
            selections.append(idx)
            return top, idx, valid
        pinned = selections[calls[0]]
        calls[0] += 1
        if not torch.equal(idx, pinned):
            flips.append(calls[0])
        m = mask.reshape(mask.shape + (1,) * (values.dim() - 1))
        filled = torch.where(m, values, torch.full(
            (), mil_losses._FILL, dtype=values.dtype, device=values.device))
        top = torch.gather(filled, 0, pinned)
        return top, pinned, top > mil_losses._FILL + 0.5

    mil_losses.masked_topk = select
    try:
        yield flips
    finally:
        mil_losses.masked_topk = topk


def mil_step_gradients(cfg, variant, params, batch, plain: bool,
                       selections):
    """One MIL training forward and backward from ``params``, with the
    kernels (recording each top-k selection into ``selections``) or
    (plain) autograd through the plain op on those selections; dropout,
    drop path and instance drop from one seeded generator, the same draws
    either way. Returns ({name: grad}, loss, the plain run's calls whose
    own top-k differs)."""
    from idee_tpu_torch.baselines.mil.driver import mil_total_loss
    from idee_tpu_torch.baselines.mil.models import build_mil_model

    model = build_mil_model(cfg, variant)
    model.load_state_dict(params)
    model.to("cuda").train()
    g = torch.Generator(device="cuda").manual_seed(0)
    with plain_ops(cfg.encoder) if plain else contextlib.nullcontext(), \
            pinned_topk(selections, pin=plain) as flips, \
            deterministic_convolutions():
        out = model(batch["x"], train=True, generator=g)
        loss = mil_total_loss(cfg, variant, out, batch["mask_extreme_loss"],
                              True, g)
        loss.backward()
    torch.cuda.synchronize()
    return ({k: p.grad for k, p in model.named_parameters()}, loss.item(),
            flips)


def compare_mil_gradients(cfg, variant, params, batch, what: str):
    """The step gradients with the kernels against the plain op's
    (hold_gradients at STEP_GRAD_REL), the plain run on the kernel run's
    top-k selections: a score within float noise of the k-th can change
    places between the two, which moves a whole instance's gradient and
    says nothing of the kernels (the line counts such calls). The agent's
    rel-pos table has a zero gradient in exact arithmetic: it adds one
    constant to all of a query's scores, which softmax ignores."""
    selections = []
    got, loss_k, _ = mil_step_gradients(cfg, variant, params, batch, False,
                                        selections)
    want, loss_p, flips = mil_step_gradients(cfg, variant, params, batch,
                                             True, selections)
    zero = [k for k in want if k.startswith("agent.")
            and k.endswith("relative_position_bias_table")]
    if cfg.dtype == "bfloat16":
        # a kernel output one bf16 ulp off may move the bf16 network's
        # gradients through its ReLU kinks and BatchNorms, entry by entry:
        # held as one relative L2 distance over every parameter, as
        # tests/test_torch_baselines_bf16.py holds the port against JAX
        keys = [k for k in want if k not in zero]
        g = torch.cat([got[k].reshape(-1) for k in keys])
        w = torch.cat([want[k].reshape(-1) for k in keys])
        dist = ((g - w).norm() / w.norm()).item()
        if not dist <= MIL_BF16_GRAD_L2:
            raise SystemExit(f"{what}: step gradients {dist} (relative L2) "
                             f"from the plain op's > {MIL_BF16_GRAD_L2}")
        emit(phase="train_gradients", path=what, encoder=cfg.encoder,
             variant=variant, dtype=cfg.dtype, parameters=len(want),
             loss_kernels=loss_k, loss_plain=loss_p,
             relative_l2=dist, limit=MIL_BF16_GRAD_L2,
             max_err_over_max_abs_grad=max(
                 (got[k] - want[k]).abs().max().item()
                 / max(want[k].abs().max().item(), 1e-30) for k in keys),
             topk_calls=len(selections), topk_calls_reordered=len(flips))
        return
    worst = hold_gradients(got, want, STEP_GRAD_REL, what, zero)
    emit(phase="train_gradients", path=what, encoder=cfg.encoder,
         variant=variant, parameters=len(want), loss_kernels=loss_k,
         loss_plain=loss_p, max_err_over_max_abs_grad=worst,
         limit=STEP_GRAD_REL, zero_in_exact_arithmetic=zero,
         topk_calls=len(selections), topk_calls_reordered=len(flips))


def compare_mil_scores(cfg, variant, params, batch, what: str):
    """The eval forward's scores with the kernels against the plain op's
    from ``params``: within 1e-4 at float32 (the logits' gate of PERF.md
    §2), BF16_LOGIT_REL x max |score| at bf16. Emits a forward line."""
    from idee_tpu_torch.baselines.mil.models import build_mil_model

    model = build_mil_model(cfg, variant)
    model.load_state_dict(params)
    model.to("cuda").eval()
    with torch.inference_mode():
        got = model(batch["x"]).scores.float()
        with plain_ops(cfg.encoder):
            want = model(batch["x"]).scores.float()
    err = (got - want).abs().max().item()
    limit = (BF16_LOGIT_REL * want.abs().max().item()
             if cfg.dtype == "bfloat16" else 1e-4)
    if not (math.isfinite(err) and err <= limit):
        raise SystemExit(f"{what}: scores with the kernels {err} from the "
                         f"plain op's > {limit}")
    emit(phase="forward_vs_plain", path=what, encoder=cfg.encoder,
         variant=variant, dtype=cfg.dtype, delta_t=cfg.delta_t,
         scores_shape=list(got.shape), max_abs_err=err, limit=limit)


def phase_baseline(cube, phase, family, which, encoder, test: bool,
                   compare: bool, dtype: str = "float32",
                   test_phase: str = None, **cfg_kw):
    """One baseline at the bench width: its train driver for 1 epoch with
    the launch counters zeroed around it (exact counts: the encoder's
    kernels per step, none for CNN_3D, STEAL and UniAD); losses and
    checkpoints; its test driver on the latest checkpoint, launches
    counted; the driver's train steps/s (CUDA-synchronised), peak memory
    and a profile of 3 train steps; with ``compare`` one step's gradients
    against the plain op. At ``dtype`` "bfloat16" STEAL and UniAD, which
    JAX builds without a dtype, must keep float32 parameters and
    outputs. ``test_phase`` names the test driver's path (default
    test_<name>); ``cfg_kw`` overrides the config (delta_t). Returns
    {path: launches}."""
    from idee_tpu_torch.baselines import common
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.models.vq_model import compute_dtype

    kw = {"dtype": dtype, **cfg_kw}
    if encoder:
        kw["encoder"] = encoder
    if which == "steal":
        kw["delta_t"] = 8
    if family == "oneclass":
        # the frozen backbone: the Swin_3D encoder train_swin trained
        kw["model_pretrained"] = os.path.join(
            train_config("Swin_3D").log_dir, "model_checkpoints",
            "latest.pt")
    cfg = baseline_config(family, phase, **kw)
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    train, test_fn, keys = baseline_drivers(family, which)
    train_cube, val_cube = cube.time_slice(*TRAIN_WEEKS), \
        cube.time_slice(*VAL_WEEKS)
    n_train = TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 2 - cfg.delta_t
    n_val = VAL_WEEKS[1] - VAL_WEEKS[0] + 2 - cfg.delta_t
    n_test = N_WEEKS + 1 - cfg.delta_t
    per_train, per_eval = baseline_launches_per_step(family, encoder, dtype)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    history = train(cfg, train_cube, val_cube)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    expect_launches(launches, {
        k: per_train.get(k, 0) * n_train + per_eval.get(k, 0) * n_val
        for k in set(per_train) | set(per_eval)}, phase)
    curves = history["train_loss"] + history["val_loss"]
    if not all(map(math.isfinite, curves)):
        raise SystemExit(f"{phase}: bad loss history {curves}")
    ckpt_dir = os.path.join(cfg.log_dir, "model_checkpoints")
    written = sorted(os.listdir(ckpt_dir))
    if written != ["best_loss_model.pt", "latest.pt"]:
        raise SystemExit(f"{phase}: checkpoints {written}")
    paths = {phase: launches}

    tested = None
    if test:
        zero_launches()
        t0 = time.perf_counter()
        tested = test_fn(cfg.replace(en_de_pretrained=os.path.join(
            ckpt_dir, "latest.pt")), cube)
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = read_launches()
        expect_launches(test_launches, {k: v * n_test for k, v in
                                        per_eval.items()}, f"{phase} test")
        votes = tested.pop("anomaly")
        if (votes.shape != (6, N_WEEKS, cfg.y_max, cfg.x_max)
                or not math.isfinite(tested["mean_loss"])
                or not np.isfinite(votes[:, cfg.delta_t - 1:]).all()):
            raise SystemExit(f"{phase} test: {tested}, votes {votes.shape}")
        tested.update(wall_s_with_setup=test_s, steps=n_test,
                      launches=test_launches,
                      anomaly_share=float(np.nanmean(votes)))
        paths[test_phase or phase.replace("train_", "test_")] = \
            test_launches

    # profile: 3 steps of the trained state (host batch assembly included)
    train_ds, _ = common.make_datasets(
        cfg, train_cube, val_cube,
        getattr(cfg, "is_replace_anomaly", False) and family != "mil")
    batches = iter(DataLoader(
        train_ds, 1, device="cuda", keys=keys, shuffle=True, seed=cfg.seed,
        x_dtype=compute_dtype(cfg) if family == "mil" else torch.float32))
    step = baseline_train_step(family, which, cfg, history)
    metrics = common.init_vote_metrics(train_ds.anomaly.shape, "cuda")
    state = history["state"]
    if family == "recon" and dtype == "bfloat16":
        recon_float32(state.model, which, next(batches), phase)
    profile = profile_steps(lambda: step(state, metrics, next(batches)), n=3)
    SUMMARY[phase] = dict(
        train_steps_per_s=history["steps_per_sec"][-1],
        device_ms_per_step=profile["device_ms_per_step"],
        device_busy_share=profile["device_busy_share"],
        max_memory_allocated=peak_bytes)

    emit(phase=phase, family=family, variant=which, encoder=cfg.encoder
         if family != "recon" else None, dtype=cfg.dtype,
         shape=[1, 6, 1, cfg.delta_t, 200, 200],
         epochs=cfg.n_epochs, train_steps=n_train, val_steps=n_val,
         launches=launches,
         history={k: v for k, v in history.items()
                  if k not in ("state", "bb_variables")},
         train_steps_per_s=history["steps_per_sec"][-1],
         wall_s_with_setup=wall_s, max_memory_allocated=peak_bytes,
         device_ms_per_step=profile["device_ms_per_step"],
         device_busy_share=profile["device_busy_share"],
         checkpoints=written, test=tested)
    emit(phase="profile", path=phase, **profile)
    if compare:
        # at the seeded initial weights, as compare_step_gradients holds the
        # synthetic paths, and at float32 also at the trained ones (the
        # state after the epoch and the profile's steps), which differ from
        # run to run in the 8th digit (cuDNN's backward convolutions in
        # training). Both gradient runs take cuDNN's deterministic
        # algorithms: without them one DeepMIL / Swin_3D leaf whose
        # gradient cancels to 8e-4 (encoder.stage0.downsample.proj.kernel)
        # parted 1.2e-7-5.5e-7 at trained weights in some runs, beyond
        # 1e-4 x max |grad|; with them, and the training deterministic too,
        # 9.8e-8 x max (mil_gradient_drift.py; PERF.md §6)
        from idee_tpu_torch.baselines.mil.models import build_mil_model

        params = build_mil_model(
            cfg, which, torch.Generator().manual_seed(0)).state_dict()
        batch = next(batches)
        if test_phase:
            compare_mil_scores(cfg, which, params, batch, test_phase)
        compare_mil_gradients(cfg, which, params, batch, phase)
        if dtype == "float32":
            compare_mil_gradients(cfg, which, state.model.state_dict(),
                                  batch, f"{phase}_trained")
    del history, state, step, metrics
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


def recon_float32(model, which, batch, phase):
    """STEAL and UniAD at dtype "bfloat16" compute in float32, as JAX
    builds them without a dtype: float32 parameters and outputs."""
    bad = [k for k, p in model.named_parameters()
           if p.dtype != torch.float32]
    with torch.inference_mode():
        model.eval()
        if which == "steal":
            out = model(batch["x"][:, :, 0]).pred
        else:
            out = model(batch["x"][:, :, 0, 0],
                        batch["mask_extreme_loss_t"][:, 0]).loss_map
    if bad or out.dtype != torch.float32:
        raise SystemExit(f"{phase}: parameters {bad} or output {out.dtype} "
                         "not float32")


# Swin_3D at delta_t 4: stage 1's (8, 1, 1) window shrinks to (4, 1, 1).
# The composite VQModel runs at delta_t 8 only (its classifier's three
# stride-2 convolutions collapse T = 8 to 1, in JAX and the reference),
# so the path is DeepMIL over Swin_3D, whose scores keep T
SWIN_DT4 = 4


def phase_swin_dt4(cube):
    """Phases train_swin_dt4 and main_swin_dt4 at float32 and bf16:
    DeepMIL over Swin_3D at delta_t 4 as phase_baseline runs it, 1 train
    epoch and the test driver over the cube, launches exact (3 per
    forward, 3 + 3 per train step); the scores against the plain op's and
    the step gradients at the seeded weights against the plain op's.
    Returns {path: launches}."""
    paths = {}
    for dtype, tail in (("float32", ""), ("bfloat16", "_bf16")):
        paths.update(phase_baseline(
            cube, f"train_swin_dt4{tail}", "mil", "deepmil", "Swin_3D",
            True, True, dtype=dtype, test_phase=f"main_swin_dt4{tail}",
            delta_t=SWIN_DT4))
    return paths


def phase_baselines(cube):
    paths = {}
    for args in BASELINE_PHASES:
        paths.update(phase_baseline(cube, *args))
    return paths


# ------------------------------------------------------------------
# data parallelism (idee_tpu_torch/parallel/mesh.py)

DDP_STEPS = 3  # train steps of the two-rank runs, global batch 2
VQ_BUFFER_RTOL = 1e-4
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def world1_steps(cfg, state_dict, batches):
    """The single-device train steps on the global batches: the state_dict
    after them and each step's loss."""
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

    model = build_model(cfg)
    model.load_state_dict(state_dict)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=3)
    step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
    losses = []
    for b in batches:
        metrics = init_epoch_metrics((6, 20, 200, 200), "cuda")
        state, metrics = step(state, metrics, {
            k: torch.from_numpy(v).cuda() for k, v in b.items()})
        losses.append(metrics["loss_sums"]["loss"].item())
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}, \
        losses


def same_update(got, want, lr, what, steps=DDP_STEPS):
    """The world-2 state after ``steps`` steps against world 1's: max
    |difference| and the share of entries beyond 2e-5
    (tests/test_parallel.py's atol). An entry whose gradient is a few
    float eps takes an Adam step of either sign (a step of lr * g / (|g|
    + 1e-8)), so beyond 2e-5 are allowed only entries within 2 lr per
    step, at most 0.5 % of them."""
    worst, far, n = 0.0, 0, 0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        worst = max(worst, d.max().item())
        far += int((d > 2e-5).sum())
        n += d.numel()
    ok = worst <= 2e-5 or (worst <= 2 * lr * steps and far <= 5e-3 * n)
    if not ok:
        raise SystemExit(f"{what}: world 2 against world 1: max |diff| "
                         f"{worst}, {far} of {n} entries beyond 2e-5")
    return {"max_abs_diff": worst, "entries_beyond_2e-5": far,
            "entries": n}


def torchrun(args, what, timeout=600):
    """``python -m torch.distributed.run --nproc_per_node 2 <args>`` from
    the checkout (rendezvous on a free localhost port), in a session of
    its own that is killed whole when it ends; raises unless it exits 0.
    Returns its standard output."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(free_port())] + list(args)
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=REPO))
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
    if proc.returncode != 0:
        raise SystemExit(f"{what}: torchrun exited {proc.returncode}:\n"
                         f"{out[-2000:]}\n{err[-3000:]}")
    return out


def two_ranks(jobs, what, meanwhile=None):
    """The jobs on two processes of tests/torch_parallel_worker.py, both
    on this card, the gloo backend named (NCCL takes one rank per
    device), each started as torchrun starts a rank (RANK, WORLD_SIZE,
    LOCAL_RANK) without its agent, which costs seconds a launch;
    ``meanwhile()`` runs here while they do. Their results by rank."""
    out = _scratch("chip_smoke_ddp_")
    try:
        torch.save(jobs, os.path.join(out, "jobs.pt"))
        init = "file://" + os.path.join(out, "store")
        logs = [open(os.path.join(out, f"rank{r}.log"), "w+")
                for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, WORKER, os.path.join(out, "jobs.pt"), init, out,
             "gloo"],
            env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                     LOCAL_RANK=str(r)),
            stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(2)]
        try:
            if meanwhile is not None:
                meanwhile()
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            text = log.read()
            log.close()
            if p.returncode != 0:
                raise SystemExit(f"{what}: rank {r} exited {p.returncode}:"
                                 f"\n{text[-3000:]}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_train_ddp(cube):
    """Phase train_ddp. (a) train_synthetic under a mesh of one rank
    (mesh_shape [1], NCCL): Mamba float32 at the bench width, 1 epoch,
    exact launches, its steps/s beside phase train's (no mesh, epoch 1). (b) Two
    ranks on this card (gloo): DDP_STEPS train steps of Mamba float32 on
    global batches of 2 rows of the cube, dropout 0, each rank on its row;
    both ranks' parameters equal, and equal to the single-device steps on
    the global batches; each rank launches the fused scan forward and
    backward 3 + 3 times per step. (c) The same for VQ-EMA (k-means init,
    dead-code expiry; lambda_anomaly 0, as tests/test_torch_parallel.py
    explains): the codebook buffers equal on both ranks and to world 1's.
    Returns {path: launches}."""
    import idee_tpu_torch.kernels.selective_scan as ss
    from idee_tpu_torch.data.loader import collate
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.parallel.mesh import make_mesh
    from idee_tpu_torch.train.driver import _make_datasets, train_synthetic

    # (a) one rank under NCCL
    cfg = train_config("Mamba", n_epochs=N_EPOCHS_SHORT).replace(
        name="chip_smoke_train_ddp", mesh_shape=[1])
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    train_cube, val_cube = cube.time_slice(*TRAIN_WEEKS), \
        cube.time_slice(*VAL_WEEKS)
    n_train = (TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 1) - cfg.delta_t + 1
    n_val = (VAL_WEEKS[1] - VAL_WEEKS[0] + 1) - cfg.delta_t + 1
    mesh = make_mesh([1], ["data"], device="cuda:0", backend="nccl",
                     init_method=f"tcp://localhost:{free_port()}")
    try:
        torch.cuda.synchronize()
        zero_launches()
        history = train_synthetic(cfg, train_cube, val_cube, mesh=mesh)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        mesh.close()
    trn = kernel_launches_per_step("Mamba", train=True)
    val = kernel_launches_per_step("Mamba", train=False)
    expect_launches(launches, {
        k: cfg.n_epochs * (trn.get(k, 0) * n_train
                           + val.get(k, 0) * (n_val + PANEL_STEPS))
        for k in set(trn) | set(val)}, "train_ddp world 1")
    curves = history["train_loss"] + history["val_loss"]
    if not all(map(math.isfinite, curves)):
        raise SystemExit(f"train_ddp world 1: bad losses {curves}")
    paths = {"train_ddp_world1": launches}
    shutil.rmtree(cfg.log_dir, ignore_errors=True)

    # (b), (c) two ranks on global batches of 2
    base = train_config("Mamba")
    vq = train_config("Mamba", **VQ_EMA).replace(lambda_anomaly=0.0)
    train_ds, _ = _make_datasets(base, train_cube, val_cube)
    keys = ("x", "mask_extreme", "mask_extreme_loss", "timestep")
    batches = [{k: v for k, v in collate([train_ds.item(i, None)
                                          for i in (2 * b, 2 * b + 1)]
                                         ).items() if k in keys}
               for b in range(DDP_STEPS)]
    jobs, want = [], []
    for c in (base, vq):
        sd = build_model(c, torch.Generator().manual_seed(0)).state_dict()
        jobs.append(dict(kind="steps", cfg=c.to_dict(), state_dict=sd,
                         batches=batches, device="cuda:0"))
        want.append(world1_steps(c, sd, batches))
    torch.cuda.empty_cache()  # room for the two ranks on this card
    ranks = two_ranks(jobs, "train_ddp")
    per_step = {k: v * DDP_STEPS for k, v in trn.items()}
    rows = {}
    for j, name in enumerate(("mamba", "vq_ema")):
        w_sd, w_losses = want[j]
        got = [r[j] for r in ranks]
        for r, g in enumerate(got):
            expect_launches({k: g["launches"].get(k, 0)
                             for k in ss.launches}, per_step,
                            f"train_ddp {name} rank {r}")
            paths[f"train_ddp_{name}_rank{r}"] = {
                k: g["launches"].get(k, 0) for k in read_launches()}
        for k, v in got[0]["state_dict"].items():
            if not torch.equal(v, got[1]["state_dict"][k]):
                raise SystemExit(f"train_ddp {name}: ranks differ at {k}")
        params = [k for k in w_sd if not k.startswith("vq.")]
        rows[name] = same_update({k: got[0]["state_dict"][k]
                                  for k in params},
                                 {k: w_sd[k] for k in params}, base.lr,
                                 f"train_ddp {name}")
        rows[name].update(losses_world2=got[0]["losses"],
                          losses_world1=w_losses)
        if not np.allclose(got[0]["losses"], w_losses, rtol=2e-4):
            raise SystemExit(f"train_ddp {name}: losses {got[0]['losses']}"
                             f" against world 1's {w_losses}")
    # the codebook state: a token within float noise of two codes' boundary
    # may take the other code on a card, whose products round by batch size
    # (cuBLAS picks its algorithm by shape), and shifts its bin by one: so
    # each buffer is held at VQ_BUFFER_RTOL of its largest entry
    buffers = [k for k in want[1][0] if k.startswith("vq.")]
    rows["vq_ema"]["buffers_rel_diff"] = {}
    for k in buffers:
        a, b = ranks[0][1]["state_dict"][k].float(), want[1][0][k].float()
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        rows["vq_ema"]["buffers_rel_diff"][k] = rel
        if not rel <= VQ_BUFFER_RTOL:
            raise SystemExit(f"train_ddp vq_ema: {k} {rel} x max from "
                             "world 1's")
    if float(ranks[0][1]["state_dict"]["vq.initted"]) != 1.0:
        raise SystemExit("train_ddp vq_ema: the k-means init did not run")
    emit(phase="train_ddp", encoder="Mamba", shape=[1, 6, 1, 8, 200, 200],
         world1=dict(backend="nccl", mesh_shape=[1], epochs=cfg.n_epochs,
                     launches=launches,
                     history={k: v for k, v in history.items()
                              if k != "state"},
                     steps_per_s=history["steps_per_sec"],
                     no_mesh_steps_per_s=SUMMARY["train"][
                         "driver_steps_per_s"]),
         world2=dict(backend="gloo", global_batch=2, steps=DDP_STEPS,
                     launches_per_rank=[g["launches"] for g in
                                        (ranks[0][0], ranks[1][0])],
                     vq_buffers=buffers, **rows))
    return paths


def replay_kernels(epoch) -> dict:
    """The device kernels of one more replay of a FusedEpoch's graph (its
    device position set back to the epoch's first batch: after an epoch
    it points past the last), by the profiler: every kernel's count and
    NCCL's among them (a name holding "nccl", or NCCL's one-rank reduction
    "oneRankReduce": at one rank NCCL launches a kernel for an AVG
    all-reduce, none for an in-place SUM)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    epoch.pos.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    nccl = [n for n in names if "nccl" in n.lower()
            or "onerank" in n.lower()]
    return {"kernels": len(names), "nccl_kernels": len(nccl),
            "nccl_names": sorted({n[:120] for n in nccl})}


@contextlib.contextmanager
def captured_collectives():
    """Counts the collective calls made while a CUDA graph captures (by
    name), over the block."""
    import torch.distributed as dist

    counts = {}
    saved = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "broadcast")}

    def counted(name, fn):
        def call(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def phase_train_ddp_fused(cube):
    """Phase train_ddp_fused: train_synthetic with device_data and the
    fused epochs (the defaults) under a mesh of one NCCL rank, Mamba
    float32 at the bench width, DDP_FUSED_EPOCHS epochs (a capture, then
    an epoch of replays), launches exact (credited
    per replay); its first epoch against the per-step device loop under
    the same mesh (hold_first_epoch); then on the rate cut of
    train_device the fused epochs under the mesh: their steady train and
    val steps/s and capture seconds beside train_device's fused numbers
    (no mesh), the collectives each graph captured, and each graph's
    replay profiled: its NCCL kernels (a capture that dropped them fails).
    Returns {path: launches}."""
    from idee_tpu_torch.data.device import DeviceLoader
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.parallel.mesh import make_mesh
    from idee_tpu_torch.train.driver import _make_datasets, train_synthetic
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import make_eval_epoch, make_train_epoch

    phase = "train_ddp_fused"
    cfg = train_config("Mamba", n_epochs=DDP_FUSED_EPOCHS,
                       device_data=True).replace(
        name=f"chip_smoke_{phase}", mesh_shape=[1])
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    train_cube, val_cube = cube.time_slice(*TRAIN_WEEKS), \
        cube.time_slice(*VAL_WEEKS)
    n_train = (TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 1) - cfg.delta_t + 1
    n_val = (VAL_WEEKS[1] - VAL_WEEKS[0] + 1) - cfg.delta_t + 1
    trn = kernel_launches_per_step("Mamba", train=True)
    val = kernel_launches_per_step("Mamba", train=False)
    mesh = make_mesh([1], ["data"], device="cuda:0", backend="nccl",
                     init_method=f"tcp://localhost:{free_port()}")
    try:
        def run(c):
            return train_synthetic(c, train_cube, val_cube, mesh=mesh)

        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        history = run(cfg)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        expect_launches(launches, {
            k: cfg.n_epochs * (val.get(k, 0) * (n_val + PANEL_STEPS)
                               + trn.get(k, 0) * n_train)
            for k in set(val) | set(trn)}, phase)
        curves = history["train_loss"] + history["val_loss"]
        if not all(map(math.isfinite, curves)):
            raise SystemExit(f"{phase}: bad losses {curves}")
        eager = eager_first_epoch(run, cfg, phase, n_train, n_val, trn, val)
        diff = hold_first_epoch(history, eager, phase)

        # the fused epochs under the mesh on train_device's rate cut
        rtrain, rval = _make_datasets(cfg, cube.time_slice(*RATE_TRAIN_WEEKS),
                                      cube.time_slice(*RATE_VAL_WEEKS))
        tl = DeviceLoader(rtrain, 1, seed=cfg.seed, device="cuda",
                          mesh=mesh)
        vl = DeviceLoader(rval, 1, seed=cfg.seed, device="cuda", mesh=mesh)
        model = build_model(cfg)
        state = create_train_state(cfg, model, "cuda",
                                   steps_per_epoch=len(tl))
        train_epoch = make_train_epoch(model, cfg, tl, rtrain.anomaly.shape,
                                       t0=float(rtrain.timestep[0]),
                                       steps_per_epoch=len(tl))
        eval_epoch = make_eval_epoch(model, cfg, vl, rval.anomaly.shape,
                                     t0=float(rval.timestep[0]))
        with captured_collectives() as collectives:
            rates = measure_fused(train_epoch, eval_epoch, state, len(tl),
                                  len(vl))
        replays = {"train": replay_kernels(train_epoch),
                   "val": replay_kernels(eval_epoch)}
        if not (replays["train"]["nccl_kernels"] > 0
                and replays["val"]["nccl_kernels"] > 0):
            raise SystemExit(f"{phase}: a replay holds no NCCL kernel: "
                             f"{replays}")
    finally:
        mesh.close()
    no_mesh = SUMMARY["train_device_fused"]
    emit(phase=phase, encoder="Mamba", dtype="float32",
         shape=[1, 6, 1, 8, 200, 200], backend="nccl", mesh_shape=[1],
         epochs=cfg.n_epochs, train_steps=n_train, val_steps=n_val,
         launches=launches, wall_s_with_setup=wall_s,
         history={k: v for k, v in history.items() if k != "state"},
         per_step_device_loop={k: eager[k] for k in
                               ("train_loss", "val_loss", "steps_per_sec")},
         first_epoch_rel_diff=diff, loss_rtol=DEVICE_LOSS_RTOL,
         collectives_captured=collectives, replays=replays,
         fused=rates,
         no_mesh_fused={k: no_mesh[k] for k in (
             "train_steps_per_s", "eval_steps_per_s", "capture_s",
             "device_busy_share")})
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    shutil.rmtree(cfg.replace(name=cfg.name + "_eager").log_dir,
                  ignore_errors=True)
    return {phase: launches}


# the zoo at bf16 (cfg.dtype "bfloat16"): the MIL models and SimpleNet's
# backbone compute in bf16; MGFN, SimpleNet's head, STEAL and UniAD in
# float32, as JAX builds them
BASELINE_BF16_PHASES = (
    ("train_deepmil_swin_bf16", "mil", "deepmil", "Swin_3D", True, True),
    ("train_rtfm_mamba_bf16", "mil", "rtfm", "Mamba", True, True),
    ("train_mgfn_bf16", "mil", "mgfn", "CNN_3D", True, False),
    ("train_simplenet_bf16", "oneclass", "simplenet", "Swin_3D", True,
     False),
    ("train_steal_bf16", "recon", "steal", None, True, False),
    ("train_uniad_bf16", "recon", "uniad", None, True, False),
)


# ------------------------------------------------------------------
# the space axis (idee_tpu_torch/parallel/spatial.py)

# the space axis at [1, 2]: two gloo ranks on this card, each on half of
# H (100 of the bench width's 200 rows): the fused scan at half the
# windows, the attention at 5,000 windows of 32 (the shifted mask cut to
# rank 1's window rows 25-50 of 50, which hold the wrap) and 20,000 of 8.
# train_synthetic runs one epoch of SPACE_STEPS train and val steps (the
# bench cube's weeks 1-9 and 25-33 at delta_t 8); train_real one of
# SPACE_CERRA_STEPS (the fixture's sets cut to their first weeks: the
# driver's rate counts the train steps after 3)
SPACE_STEPS = 2
SPACE_TRAIN_WEEKS, SPACE_VAL_WEEKS = (1, 9), (25, 33)
SPACE_CERRA_STEPS = (4, 1)
SPACE_SCAN_SHAPES = {stage: (L, M // 2)
                     for stage, (L, M) in SCAN_SHAPES.items()}
SPACE_ATTN_SHAPES = {"stage0": (5_000, 32, None),
                     "stage0_shifted": (5_000, 32, (8, 200, 200, (2, 4, 4),
                                                    (1, 2, 2), (25, 50))),
                     "stage1": (20_000, 8, None)}
SPACE_BF16_LOSS_REL = 2e-2
SPACE_LOSS_RTOL = 2e-4
# memory_fit --mesh 1x2 at 512x832: each rank's CNN_3D peak at most this
# share of the single-device probe's (Swin_3D with recompute: its rank
# peak is train_cerra_space's, the same configuration, beside its probe)
SPACE_MEMORY_SHARE = 0.6


def world1_driver(run):
    """A driver run on this card without a mesh, measured as a rank of
    tests/torch_parallel_worker.py measures its own: the history, final
    step and state_dict, the launches, the peak allocated bytes above what
    the process held before (a rank's are a fresh process's) and the
    seconds."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_launches()
    t0 = time.perf_counter()
    hist = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    state = hist.pop("state")
    out = {"history": hist, "step": state.step, "seconds": seconds,
           "state_dict": {k: v.detach().cpu()
                          for k, v in state.model.state_dict().items()},
           "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated() - base}
    del state
    torch.cuda.empty_cache()
    return out


def hold_space_ranks(ranks, world1, cfg, what, float32=True,
                     steps=SPACE_STEPS):
    """Both ranks' driver runs against the single-device one: the same
    model on both, the launches per rank equal world 1's, the train and
    val losses (rtol SPACE_LOSS_RTOL at float32, SPACE_BF16_LOSS_REL at
    bf16) and at float32 the parameters (``same_update`` after ``steps``
    train steps); rank 0 alone
    writes files where the run counts its writes."""
    for r, g in enumerate(ranks):
        launched = {k: g["launches"].get(k, 0) for k in world1["launches"]}
        expect_launches(launched, {k: v for k, v in world1["launches"].items()
                                   if v}, f"{what} rank {r}")
        if g["step"] != world1["step"]:
            raise SystemExit(f"{what} rank {r}: {g['step']} steps, world 1 "
                             f"{world1['step']}")
    for k, v in ranks[0]["state_dict"].items():
        if not torch.equal(v, ranks[1]["state_dict"][k]):
            raise SystemExit(f"{what}: ranks differ at {k}")
    if "calls" in ranks[0] and (not ranks[0]["calls"]["save"] or any(
            ranks[1]["calls"].values())):
        raise SystemExit(f"{what}: file writes by rank "
                         f"{[g['calls'] for g in ranks]}")

    def curves(h):
        return np.asarray(h["train_loss"] + h["val_loss"])
    got, want = curves(ranks[0]["history"]), curves(world1["history"])
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    limit = SPACE_LOSS_RTOL if float32 else SPACE_BF16_LOSS_REL
    if not (np.all(np.isfinite(got)) and rel <= limit):
        raise SystemExit(f"{what}: train and val losses {got.tolist()} "
                         f"against world 1's {want.tolist()} (rel {rel}, "
                         f"limit {limit})")
    row = dict(losses_space=got.tolist(), losses_world1=want.tolist(),
               loss_max_rel_diff=rel,
               launches_per_rank=[g["launches"] for g in ranks],
               launches_world1={k: v for k, v in world1["launches"].items()
                                if v},
               peak_bytes_per_rank=[g["peak_bytes"] for g in ranks],
               peak_bytes_world1=world1["peak_bytes"],
               seconds_per_rank=[g["seconds"] for g in ranks],
               seconds_world1=world1["seconds"],
               steps_per_s_per_rank=[g["history"]["steps_per_sec"]
                                     for g in ranks],
               steps_per_s_world1=world1["history"]["steps_per_sec"])
    if float32:
        row.update(same_update(ranks[0]["state_dict"], world1["state_dict"],
                               cfg.lr, what, steps))
    return row


def driver_launches(encoder, steps, val_steps, **kw):
    """A driver epoch's launches: ``steps`` train steps, ``val_steps`` val
    steps and the image panels' eval forward (PANEL_STEPS)."""
    trn = kernel_launches_per_step(encoder, train=True, **kw)
    val = kernel_launches_per_step(encoder, train=False, **kw)
    return {k: trn[k] * steps + val.get(k, 0) * (val_steps + PANEL_STEPS)
            for k in trn}


def check_space_kernels(ss, wa):
    """Every kernel of the [1, 2] paths at a rank's shapes against its plain
    version (and timed, beside its bound), at the limits of the kernel
    phase: the fused scan forward and backward, the float32 and bf16
    attention (forward, backward, dbias sum; the bf16 dq, dk and dv within
    one bf16 ulp + ATTN_GRAD_ATOL)."""
    from idee_tpu_torch.kernels import bounds

    attention = check_attention(bounds, SPACE_ATTN_SHAPES)
    return {ss.FUSED_FWD: check_fused_forward(ss, bounds, SPACE_SCAN_SHAPES),
            "fused_scan_backward": check_fused_backward(
                ss, bounds, SPACE_SCAN_SHAPES),
            "window_attention": attention,
            "window_attention_bf16": check_attention_bf16(
                bounds, attention, SPACE_ATTN_SHAPES)}


# the device-resident data under the space axis (train_space_device,
# train_cerra_space_device): the per-step device loop, augmentation on (so
# that samples flip H and a rank gathers its rows reversed)
SPACE_DEVICE = dict(device_data=True, fused_epoch=False, is_aug=True)


def h_flips(n: int, seed: int) -> int:
    """How many of the n samples of a device loader's first epoch (batch
    1) flip H: its flip bits (data/device.py)."""
    from idee_tpu_torch.data.device import _EpochLoader, _flip_bits

    bits = _EpochLoader(n, 1, seed, True, "cpu").epoch_flips(1)
    return int(_flip_bits(torch.from_numpy(bits))[0].sum())


def phase_train_space(root: str, meanwhile=None):
    """Phases train_space and train_space_device: the space axis
    (parallel/spatial.py) through train_synthetic at mesh_shape [1, 2] over
    ["data", "space"], two ranks of tests/torch_parallel_worker.py on this
    card (gloo, ``two_ranks``, one launch for both phases), each on 100 of
    the bench width's 200 rows, one epoch of SPACE_STEPS train and val
    steps on the bench cube written under ``root``: with the host loader
    (which keeps a rank's rows) Mamba, Swin_3D and CNN_3D float32 and
    Swin_3D bf16; with the device-resident data (SPACE_DEVICE: each rank
    holds the cube and gathers its rows on the card) Mamba float32 and
    Swin_3D bf16. Each against train_synthetic on the card without a mesh
    on the same cube with the same loader: the same model on both ranks,
    its parameters ``same_update``'s and its losses within SPACE_LOSS_RTOL
    of world 1's (bf16: SPACE_BF16_LOSS_REL), each rank's launches equal
    world 1's, rank 0 alone writing; every kernel of the paths held against
    its plain version at a rank's shapes. ``meanwhile()`` runs in this
    process while the ranks do. The card's one H100 proves the arithmetic
    and the per-rank memory, not the speed. Returns {path: launches}."""
    from idee_tpu_torch.train.driver import train_synthetic

    ss, wa = kernel_modules()
    kernels = check_space_kernels(ss, wa)
    cases = {"mamba": train_config("Mamba"), "swin": train_config("Swin_3D"),
             "cnn": train_config("CNN_3D"),
             "swin_bf16": train_config("Swin_3D", **BF16),
             "mamba_device": train_config("Mamba").replace(**SPACE_DEVICE),
             "swin_bf16_device": train_config(
                 "Swin_3D", **BF16).replace(**SPACE_DEVICE)}
    cases = {name: cfg.replace(
        root_synthetic=os.path.join(root, "cube"),
        dir_log=os.path.join(root, "log"), times_train=SPACE_TRAIN_WEEKS,
        times_val=SPACE_VAL_WEEKS, name=f"chip_smoke_space_{name}")
        for name, cfg in cases.items()}
    world1 = {}
    for name, cfg in cases.items():
        world1[name] = world1_driver(lambda: train_synthetic(
            cfg.replace(name=cfg.name + "_world1"), device="cuda"))
        expect_launches(world1[name]["launches"], driver_launches(
            cfg.encoder, SPACE_STEPS, SPACE_STEPS, dtype=cfg.dtype),
            f"train_space {name} world 1")
    jobs = [dict(kind="driver", mesh_shape=[1, 2], device="cuda:0",
                 cfg=cfg.replace(mesh_shape=[1, 2],
                                 mesh_axes=["data", "space"]).to_dict())
            for cfg in cases.values()]
    ranks = two_ranks(jobs, "train_space", meanwhile)
    rows, paths = {}, {}
    for j, (name, cfg) in enumerate(cases.items()):
        got = [r[j] for r in ranks]
        rows[name] = hold_space_ranks(got, world1[name], cfg,
                                      f"train_space {name}",
                                      float32=cfg.dtype == "float32")
        for r, g in enumerate(got):
            paths[f"train_space_{name}_rank{r}"] = {
                k: g["launches"].get(k, 0) for k in read_launches()}
    shutil.rmtree(os.path.join(root, "log"), ignore_errors=True)
    common = dict(mesh_shape=[1, 2], backend="gloo",
                  entry_point="train_synthetic", shape=[1, 6, 1, 8, 200, 200],
                  train_steps=SPACE_STEPS, val_steps=SPACE_STEPS,
                  loss_rtol=SPACE_LOSS_RTOL,
                  bf16_loss_rel=SPACE_BF16_LOSS_REL,
                  card=card_name_and_power())
    device = [name for name in rows if name.endswith("_device")]
    for name in device:
        rows[name]["train_samples_flipping_h"] = h_flips(
            SPACE_TRAIN_WEEKS[1] - SPACE_TRAIN_WEEKS[0] + 2
            - cases[name].delta_t, cases[name].seed)
    emit(phase="train_space", kernels_at_rank_shapes=kernels, **common,
         **{k: v for k, v in rows.items() if k not in device})
    emit(phase="train_space_device", loader="data/device.py::DeviceLoader",
         **SPACE_DEVICE, **common, **{k: rows[k] for k in device})
    return paths


def phase_train_cerra_space(root: str, single):
    """Phases train_cerra_space and train_cerra_space_device: train_real
    under mesh_shape [1, 2] on the CERRA fixture (two ranks of
    tests/torch_parallel_worker.py on this card, gloo, ``two_ranks``, one
    launch for both phases), one epoch on the first SPACE_CERRA_STEPS
    weeks of the training and validation sets: Swin_3D float32 with
    en_use_checkpoint at the full 512x832 crop (256 rows a rank; the host
    loader keeps them), and the config's Mamba at the 200x200 crop with
    the device-resident data (SPACE_DEVICE: each rank holds the week slabs
    and masks and gathers its 100 rows on the card). Each against
    train_real on the card without a mesh on the same weeks with the same
    loader: losses within SPACE_LOSS_RTOL, parameters ``same_update``'s,
    launches per rank equal world 1's (Swin_3D's forward kernel twice a
    train step: the recompute); each rank's steps/s and peak bytes beside
    world 1's, Swin_3D's beside the single-device memory_fit probe of the
    same configuration (``single``: phase memory_fit's rows), and the
    card's name and power limit. Returns {path: launches}."""
    from idee_tpu_torch.train.driver_real import (make_reanalysis_dataset,
                                                  train_real)

    H, W = CERRA_GRID
    n_train, n_val = SPACE_CERRA_STEPS
    cases = {"swin": cerra_config(root, "chip_smoke_train_cerra_space",
                                  encoder="Swin_3D", en_use_checkpoint=True,
                                  x_max=W, y_max=H),
             "mamba_device": cerra_config(
                 root, "chip_smoke_train_cerra_space_device",
                 **SPACE_DEVICE)}
    fwd = kernel_modules()[1].ATTN_FWD
    world1 = {}
    for name, cfg in cases.items():
        def first_weeks(years, aug, n, cfg=cfg):
            ds = make_reanalysis_dataset(cfg, "CERRA", years, aug)
            ds.files = ds.files[:n]
            return ds
        world1[name] = world1_driver(lambda: train_real(
            cfg.replace(name=cfg.name + "_world1"), "CERRA",
            train_ds=first_weeks(cfg.years_train, cfg.is_aug, n_train),
            val_ds=first_weeks(cfg.years_val, False, n_val), device="cuda"))
        want = driver_launches(cfg.encoder, n_train, n_val)
        if cfg.en_use_checkpoint:
            # each block's forward runs again in the backward
            want[fwd] += kernel_launches_per_step(
                "Swin_3D", train=True)[fwd] * n_train
        expect_launches(world1[name]["launches"], want,
                        f"train_cerra_space {name} world 1")
    ranks = two_ranks([dict(
        kind="train_real", mesh_shape=[1, 2], device="cuda:0",
        items=SPACE_CERRA_STEPS, cfg=cfg.replace(
            mesh_shape=[1, 2], mesh_axes=["data", "space"]).to_dict())
        for cfg in cases.values()], "train_cerra_space")
    paths = {}
    for j, (name, cfg) in enumerate(cases.items()):
        got = [r[j] for r in ranks]
        row = hold_space_ranks(got, world1[name], cfg,
                               f"train_cerra_space {name}", steps=n_train)
        common = dict(entry_point="train_real", encoder=cfg.encoder,
                      mesh_shape=[1, 2], backend="gloo",
                      hw=[cfg.y_max, cfg.x_max], train_steps=n_train,
                      val_steps=n_val, card=card_name_and_power())
        phase = "train_cerra_space"
        if name == "swin":
            probe = single_probe(single, "Swin_3D", remat=True)
            row["memory_fit_single_device_peak_bytes"] = probe["peak_bytes"]
            row["share_of_single_device_per_rank"] = [
                g["peak_bytes"] / probe["peak_bytes"] for g in got]
            emit(phase=phase, remat=True, **common, **row)
        else:
            phase += "_device"
            row["train_samples_flipping_h"] = h_flips(n_train, cfg.seed)
            emit(phase=phase, loader="data/device.py::RealDeviceLoader",
                 **SPACE_DEVICE, **common, **row)
        for r, g in enumerate(got):
            paths[f"{phase}_rank{r}"] = {
                k: g["launches"].get(k, 0) for k in read_launches()}
        shutil.rmtree(cfg.log_dir, ignore_errors=True)
        shutil.rmtree(cfg.replace(name=cfg.name + "_world1").log_dir,
                      ignore_errors=True)
    return paths


MEMORY_SPACE_PROBES = (("CNN_3D", False),)


def single_probe(single, encoder: str, remat: bool) -> dict:
    """Phase memory_fit's single-device row of ``encoder`` at the
    reference CERRA configuration on 512x832, batch 1."""
    return [r for r in single if r["encoder"] == encoder
            and r["family"] == "real" and r["batch"] == 1
            and r["hw"] == "512x832" and r["remat"] == remat][0]


def phase_memory_fit_space(single):
    """cli/memory_fit.py --mesh 1x2 under torchrun (two gloo ranks on this
    card) at the reference CERRA configuration on 512x832, CNN_3D without
    recompute: each rank's peak beside this run's single-device probe of
    the same configuration (``single``: phase memory_fit's rows), at most
    SPACE_MEMORY_SHARE of it. (Swin_3D with recompute: train_cerra_space's
    ranks.)"""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for encoder, remat in MEMORY_SPACE_PROBES:
        args = ["-m", "idee_tpu_torch.cli.memory_fit", "--family", "real",
                "--encoder", encoder, "--hw", "512x832", "--mesh", "1x2",
                "--backend", "gloo", "--device", "cuda:0"]
        args += ["--remat"] if remat else []
        t0 = time.perf_counter()
        out = torchrun(args, f"memory_fit --mesh 1x2 {encoder}")
        seconds = time.perf_counter() - t0
        ranks = sorted((json.loads(line) for line in out.splitlines()
                        if line.startswith("{")), key=lambda r: r["rank"])
        base = single_probe(single, encoder, remat)
        for r in ranks:
            r["single_device_peak_bytes"] = base["peak_bytes"]
            r["share_of_single_device"] = r["peak_bytes"] / base["peak_bytes"]
            r["seconds"] = seconds
        if len(ranks) != 2 or not all(r["fits"] and r["loss_finite"]
                                      for r in ranks):
            raise SystemExit(f"memory_fit --mesh 1x2 {encoder}: {ranks}")
        if encoder == "CNN_3D" and not all(
                r["share_of_single_device"] <= SPACE_MEMORY_SHARE
                for r in ranks):
            raise SystemExit(f"memory_fit --mesh 1x2 CNN_3D: rank peaks "
                             f"{[r['peak_bytes'] for r in ranks]} above "
                             f"{SPACE_MEMORY_SHARE} x {base['peak_bytes']}")
        rows += ranks
    emit(phase="memory_fit_space", mesh="1x2", backend="gloo",
         share_limit_cnn=SPACE_MEMORY_SHARE, probes=rows,
         card=card_name_and_power())


def phase_baselines_bf16(cube):
    """Each bf16 baseline as phase_baseline at dtype "bfloat16" (DeepMIL
    over Swin_3D and RTFM over Mamba also their step gradients against the
    plain op under pinned top-k selections), then one line of each one's
    train steps/s, device ms per step, busy share and peak memory beside
    its float32 phase's of this run."""
    paths = {}
    for args in BASELINE_BF16_PHASES:
        paths.update(phase_baseline(cube, *args, dtype="bfloat16"))
    float32 = {"train_deepmil_swin_bf16": "train_deepmil_swin",
               "train_rtfm_mamba_bf16": "train_rtfm_mamba",
               "train_mgfn_bf16": "train_mgfn",
               "train_simplenet_bf16": "train_simplenet",
               "train_steal_bf16": "train_steal",
               "train_uniad_bf16": "train_uniad"}
    emit(phase="baselines_bf16_vs_float32",
         rows={b: {"bfloat16": SUMMARY[b], "float32": SUMMARY[f]}
               for b, f in float32.items()})
    return paths


# ------------------------------------------------------------------
# the synthetic benchmark path: the reference's NetCDF schema, the
# benchmark cube and the accuracy drivers

# two years, so that each week of the climatology holds two samples (with
# one the climatology-scaled inputs are all 0), at the bench width
NC_WEEKS, NC_HW = 104, 200


def _scratch(prefix: str) -> str:
    """A new directory under the checkout's git-ignored build/."""
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=os.path.join(REPO, "build"))


def _same_synthetic_cube(got, want, what, masks_by_value=False):
    """Every field bit for bit (the masks by value only with
    ``masks_by_value``: a NetCDF3 tree stores them as signed bytes, the
    .npz as unsigned)."""
    for k in ("dynamic", "anomaly", "extreme", "static", "clima_median",
              "clima_std"):
        a, b = getattr(got, k), getattr(want, k)
        by_value = masks_by_value and k in ("anomaly", "extreme")
        if not (np.array_equal(a, b) and (by_value or a.dtype == b.dtype)):
            err = (np.abs(a.astype(np.float64) - b).max()
                   if a.shape == b.shape else None)
            raise SystemExit(f"{what}: {k} differs: {a.dtype} {a.shape} "
                             f"against {b.dtype} {b.shape}, max abs {err}")
    if got.stats != want.stats:
        raise SystemExit(f"{what}: stats differ")


def phase_synthetic_netcdf():
    """A make_fake_cube at the bench width (6 variables, 200x200) over
    NC_WEEKS weeks, written in the reference's directory schema as NetCDF3
    (data/fake.py::write_synthetic_netcdf) into a directory with no .npz;
    cli/convert_synthetic.py on a copy; the cube read from the NetCDF tree
    (load_cube_netcdf) against the one read from the .npz, bit for bit;
    then train_synthetic with Mamba for 1 epoch from root_synthetic (the
    NetCDF branch) with the config's own weekly-climatology scaling,
    launches counted. Returns its launches."""
    from idee_tpu_torch.cli.convert_synthetic import main as convert
    from idee_tpu_torch.config import synthetic_config
    from idee_tpu_torch.data.fake import (make_fake_cube,
                                          write_synthetic_netcdf)
    from idee_tpu_torch.data.synthetic import (SyntheticDataset,
                                               cube_npz_path,
                                               load_cube_netcdf,
                                               load_cube_npz)
    from idee_tpu_torch.train.driver import train_synthetic

    base = _scratch("chip_smoke_synthetic_")
    try:
        root = os.path.join(base, "nc", "synthetic_bench")
        copy = os.path.join(base, "npz", "synthetic_bench")
        t0 = time.perf_counter()
        write_synthetic_netcdf(root, make_fake_cube(
            n_vars=6, n_time=NC_WEEKS, height=NC_HW, width=NC_HW, seed=0))
        write_s = time.perf_counter() - t0
        tree_bytes = sum(os.path.getsize(os.path.join(root, f))
                         for f in os.listdir(root))
        shutil.copytree(root, copy)
        t0 = time.perf_counter()
        convert(["--root", copy])
        convert_s = time.perf_counter() - t0

        cfg = synthetic_config(
            encoder="Mamba", x_max=NC_HW, y_max=NC_HW, times_train=TRAIN_WEEKS,
            times_val=VAL_WEEKS, n_epochs=1, is_aug=False, batch_size=1,
            root_synthetic=root, dir_log=LOG_DIR,
            name="chip_smoke_synthetic_netcdf")
        if not cfg.is_clima_scale:
            raise SystemExit("the config default is not climatology scaling")
        window = (list(cfg.variables), list(cfg.variables_static),
                  (1, NC_WEEKS), 0, NC_HW, 0, NC_HW)
        t0 = time.perf_counter()
        from_nc = load_cube_netcdf(root, *window, need_stats=True,
                                   need_clima=True)
        read_s = time.perf_counter() - t0
        _same_synthetic_cube(from_nc, load_cube_npz(cube_npz_path(copy),
                                                    *window),
                             "synthetic_netcdf: NetCDF tree vs .npz",
                             masks_by_value=True)
        if os.path.exists(cube_npz_path(root)):
            raise SystemExit("synthetic_netcdf: the tree holds a .npz")
        # the host's read of the tree as the training set reads it
        t0 = time.perf_counter()
        ds = SyntheticDataset(
            root_datacube=root, times=cfg.times_train,
            variables=list(cfg.variables),
            variables_static=list(cfg.variables_static),
            delta_t=cfg.delta_t, is_clima_scale=True, x_max=NC_HW,
            y_max=NC_HW)
        dataset_read_s = time.perf_counter() - t0
        x_std = float(ds.datacube_dynamic.std())
        if not (np.isfinite(ds.datacube_dynamic).all() and x_std > 0.1):
            raise SystemExit(f"synthetic_netcdf: climatology-scaled inputs "
                             f"std {x_std}")
        del ds, from_nc

        n_train = TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 1 - cfg.delta_t + 1
        n_val = VAL_WEEKS[1] - VAL_WEEKS[0] + 1 - cfg.delta_t + 1
        shutil.rmtree(cfg.log_dir, ignore_errors=True)
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        history = train_synthetic(cfg, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    trn = kernel_launches_per_step("Mamba", train=True)
    val = kernel_launches_per_step("Mamba", train=False)
    expect_launches(launches, {
        k: trn.get(k, 0) * n_train + val.get(k, 0) * (n_val + PANEL_STEPS)
        for k in set(trn) | set(val)}, "synthetic_netcdf")
    curves = history["train_loss"] + history["val_loss"]
    if len(curves) != 2 or not all(map(math.isfinite, curves)):
        raise SystemExit(f"synthetic_netcdf: bad history {history}")
    emit(phase="synthetic_netcdf", encoder=cfg.encoder,
         shape=[1, 6, 1, 8, NC_HW, NC_HW], weeks=NC_WEEKS,
         is_clima_scale=cfg.is_clima_scale, tree_bytes=tree_bytes,
         write_s=write_s, convert_s=convert_s,
         host_s_read_tree=read_s, host_s_read_train_set=dataset_read_s,
         clima_scaled_x_std=x_std, train_steps=n_train, val_steps=n_val,
         launches=launches, wall_s_with_setup=wall_s,
         train_steps_per_s=history["steps_per_sec"][0],
         history={k: v for k, v in history.items() if k != "state"})
    return launches


def latent_health(cfg, weights: str, train_cube, n_batches: int = 4):
    """The weights at ``weights`` on the first ``n_batches`` batches of
    ``train_cube`` (no augmentation), forward with train=True under
    no_grad, as a train step sees them: the packed LFQ's latent s before
    the sign (max |s|, share of +1 codes), the encoder output's max |x|,
    |w_out| of the frozen project_out, and each term of
    total_loss_synthetic averaged over the batches (None where not
    finite), with the commitment term mean((s - q)^2) that the stable
    recipe weights by 0."""
    from idee_tpu_torch import losses
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.models.vq_model import build_model, compute_dtype
    from idee_tpu_torch.train.checkpoint import load_pretrained_weights
    from idee_tpu_torch.train.driver import _make_datasets

    cfg = cfg.replace(is_aug=False)
    model = build_model(cfg)
    model.load_state_dict(load_pretrained_weights(cfg, weights))
    model.to("cuda").train()
    seen = {}
    core = model.vq._scalar_core

    def record_s(s_lat, train):
        seen.setdefault("s", []).append(s_lat.detach().float())
        return core(s_lat, train)

    model.vq._scalar_core = record_s
    hook = model.encoder.register_forward_hook(
        lambda mod, inp, out: seen.setdefault("enc", []).append(
            out.detach().float().abs().amax()))
    train_ds, _ = _make_datasets(cfg, train_cube, train_cube)
    loader = DataLoader(train_ds, cfg.batch_size, device="cuda",
                        keys=["x", "mask_extreme", "mask_extreme_loss"],
                        x_dtype=compute_dtype(cfg))
    terms = {}
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if i == n_batches:
                break
            out = model(batch["x"], train=True,
                        mask_extreme_loss=batch["mask_extreme_loss"])
            _, comps = losses.total_loss_synthetic(
                out, batch["mask_extreme"], batch["mask_extreme_loss"],
                cfg.lambda_anomaly)
            for k, v in comps.items():
                terms.setdefault(k, []).append(float(v))
    hook.remove()
    s_all = torch.cat([t.reshape(-1) for t in seen.get("s", [])]) \
        if "s" in seen else None
    mean = {k: float(np.mean(v)) for k, v in terms.items()}
    health = {
        "weights": os.path.basename(weights), "batches": n_batches,
        "loss_terms": {k: (v if math.isfinite(v) else None)
                       for k, v in mean.items()},
        "encoder_max_abs": max(float(e) for e in seen["enc"]),
        "w_out_norm": float(model.vq.out_proj_params()[0].norm())
        if hasattr(model.vq, "out_proj_params") else None,
    }
    if s_all is not None:
        q = torch.where(s_all > 0, 1.0, -1.0)
        health.update(
            s_max_abs=float(s_all.abs().max()),
            s_median_abs=float(s_all.abs().median()),
            plus_code_share=float((s_all > 0).float().mean()),
            commitment_term=float(((s_all - q) ** 2).mean()))
    return health


# BASELINE.md's 48x48 accuracy geometry, cut to 4 years and 3 epochs
ACC_FLAGS = ["--encoder", "Mamba", "--hw", "48", "--batch", "8", "--years",
             "4", "--epochs", "3", "--seed", "0"]


def phase_accuracy():
    """cli/train_benchmark_accuracy.py in-process with ACC_FLAGS at bf16,
    writing a --cube_npz cache, launches counted; the cache against a cube
    generated here; then cli/train_baselines_zoo.py with STEAL and DeepMIL
    for 1 epoch (accuracy_zoo; no kernel: DeepMIL over CNN_3D). Returns
    the launches of both."""
    from idee_tpu_torch.cli import train_baselines_zoo as zoo
    from idee_tpu_torch.cli import train_benchmark_accuracy as acc
    from idee_tpu_torch.data.fake import load_cube_npz

    base = _scratch("chip_smoke_accuracy_")
    cache = os.path.join(base, "cube.npz")
    flags = ACC_FLAGS + ["--cube_npz", cache, "--dir_log", base,
                         "--out", os.path.join(base, "acc.json")]
    args = acc.parse_args(flags)
    n_time, t_train = acc.split_weeks(args.years)
    try:
        t0 = time.perf_counter()
        # the CLI's own generator and density, without the cache
        cube = acc.benchmark_cube(acc.parse_args(ACC_FLAGS))
        generate_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        payload = acc.main(flags + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {"accuracy": read_launches()}
        _same_synthetic_cube(load_cube_npz(cache), cube,
                             "accuracy: the cube cache")
        launches["accuracy_device"] = phase_accuracy_device(cube, args, acc)
        cfg = acc.build_config(args)
        health = latent_health(cfg, os.path.join(
            cfg.log_dir, "model_checkpoints", "latest.pt"),
            cube.time_slice(1, t_train))

        zoo_out = os.path.join(base, "zoo.json")
        zero_launches()
        t0 = time.perf_counter()
        zoo_rows = zoo.main(["--which", "steal,deepmil", "--hw",
                             str(args.hw), "--years", str(args.years),
                             "--epochs", "1", "--dir_log", base, "--out",
                             zoo_out, "--device", "cuda"])
        torch.cuda.synchronize()
        zoo_wall_s = time.perf_counter() - t0
        launches["accuracy_zoo"] = read_launches()
        with open(zoo_out) as fh:
            written = json.load(fh)
    finally:
        shutil.rmtree(base, ignore_errors=True)

    # windows of delta_t weeks, partial batches dropped
    batch, dt = args.batch, cfg.delta_t
    n_train = (t_train - dt + 1) // batch
    n_val = (n_time - t_train - dt + 1) // batch
    trn = kernel_launches_per_step("Mamba", train=True)
    val = kernel_launches_per_step("Mamba", train=False)
    expect_launches(launches["accuracy"], {
        k: args.epochs * (trn.get(k, 0) * n_train
                          + val.get(k, 0) * (n_val + PANEL_STEPS))
        for k in set(trn) | set(val)}, "accuracy")
    history = payload["history"]
    if not all(map(math.isfinite, history["train_loss"]
                   + history["val_loss"])):
        raise SystemExit(f"accuracy: bad history {history}")
    for key in ("best_val_f1", "best_val_anom_f1"):
        v = payload[key]
        if v is not None and not (math.isfinite(v) and 0 <= v <= 1):
            raise SystemExit(f"accuracy: {key} {v}")
    emit(phase="accuracy", flags=ACC_FLAGS, dtype="bfloat16",
         shape=[batch, 6, 1, 8, args.hw, args.hw], train_steps=n_train,
         val_steps=n_val, launches=launches["accuracy"],
         cube_generate_s=generate_s, wall_s_with_setup=wall_s,
         epochs_per_s=args.epochs / wall_s,
         best_val_f1=payload["best_val_f1"],
         best_val_anom_f1=payload["best_val_anom_f1"], history=history,
         latent_health=health)

    expect_launches(launches["accuracy_zoo"], {}, "accuracy_zoo")
    if [r["baseline"] for r in written] != ["steal", "deepmil"] or not all(
            math.isfinite(r["final_val_loss"]) for r in zoo_rows):
        raise SystemExit(f"accuracy_zoo: {written}")
    emit(phase="accuracy_zoo", baselines=[
        {k: r[k] for k in ("baseline", "best_val_anom_f1", "final_val_loss",
                           "steps_per_sec", "secs")} for r in zoo_rows],
         launches=launches["accuracy_zoo"], wall_s_with_setup=zoo_wall_s)
    return launches


# ------------------------------------------------------------------
# the device-resident epoch: device_data with the fused epochs (one CUDA
# graph replay per step), beside the per-step loop over the same device
# batches and the host loader's numbers of this run

# the first epoch's mean train and val loss, fused (graph replays) against
# the per-step eager loop over the same device batches: the same kernels in
# the same order, but cuDNN's backward convolutions are not
# bit-deterministic, so the parameters part in their last bits from step
# 1 on
DEVICE_LOSS_RTOL = 1e-3
# the fused paths' steady rates are timed on a cut of the cube: 7 train and
# 5 val samples (train_device_rates)
RATE_TRAIN_WEEKS, RATE_VAL_WEEKS = (1, 14), (25, 36)


def same_order_as_host(dev, seed: int, epochs: int = 3) -> int:
    """The sample order of ``dev``, a new device loader (batch 1) of
    ``seed``, against the host DataLoader's of its dataset over ``epochs``
    epochs; returns the samples compared."""
    from idee_tpu_torch.data.loader import DataLoader

    ds = dev.ds
    host = DataLoader(ds, 1, device="cpu", shuffle=True, seed=seed)
    for epoch in range(epochs):
        want = np.concatenate(list(host._index_batches()))
        got = dev.epoch_order()[0].reshape(-1)
        if not np.array_equal(got, want):
            raise SystemExit(f"device order of epoch {epoch + 1} differs "
                             f"from the host loader's: {got} {want}")
    return epochs * len(ds)


def dropout_replays_differ(loader) -> dict:
    """nn/layers.py's dropout at rate 0.5 on 4096 ones inside a FusedEpoch
    over ``loader``, drawing from the generator of a train state (which
    the graph registers): every step's mask (the eager warm-up steps' and
    each replay's) must differ from every other's."""
    from types import SimpleNamespace

    from idee_tpu_torch.nn.layers import dropout
    from idee_tpu_torch.train.steps import FusedEpoch

    state = SimpleNamespace(
        generator=torch.Generator(device="cuda").manual_seed(0), step=0,
        schedule=lambda step: 0.0, set_lr=lambda lr: None)
    nb = len(loader)
    masks = torch.zeros((nb, 4096), device="cuda")
    ones = torch.ones(4096, device="cuda")

    def body():
        masks.index_copy_(0, fused.pos, dropout(ones, 0.5, True,
                                                state.generator)[None])

    fused = FusedEpoch(loader, body, {"masks": masks})
    fused(state)
    rows = masks.cpu().numpy()
    distinct = len({r.tobytes() for r in rows})
    replays = nb - fused.warm_steps
    if fused.graph is None or replays < 2 or distinct != nb:
        raise SystemExit(f"dropout under replay: {distinct} distinct masks "
                         f"of {nb} steps, {replays} replays")
    return {"steps": nb, "replays": replays, "distinct_masks": distinct,
            "kept_share": float(rows.mean() / 2.0)}


def measure_fused(train_epoch, eval_epoch, state, n_train: int,
                  n_val: int) -> dict:
    """Steady rates of the fused epochs: one train and one val epoch warm
    up and capture, then one of each timed to a synchronise, then one of
    each under the profiler (busy share of the device over both)."""
    train_epoch(state)
    eval_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_epoch(state)
    torch.cuda.synchronize()
    train_sps = n_train / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    eval_epoch()
    torch.cuda.synchronize()
    eval_sps = n_val / (time.perf_counter() - t0)
    prof = profile_steps(lambda: (train_epoch(state), eval_epoch()), n=1,
                         warm=False)
    return {"train_steps_per_s": train_sps, "eval_steps_per_s": eval_sps,
            "device_busy_share": prof["device_busy_share"],
            "device_ms_per_train_and_val_epoch": prof["device_ms_per_step"],
            "capture_s": train_epoch.capture_s + eval_epoch.capture_s,
            # what one replay of each graph launches of the port's kernels
            "launches_per_replay": {
                name: {k: v for d in epoch.per_replay for k, v in d.items()}
                for name, epoch in (("train", train_epoch),
                                    ("val", eval_epoch))},
            "profile_top_device_ops": prof["top_device_ops"][:6]}


def eager_first_epoch(run, cfg, what: str, n_train: int, n_val: int,
                      trn: dict, val: dict):
    """The first epoch of ``cfg`` through the per-step device loop
    (fused_epoch=False), its launches exact; returns its history."""
    eager_cfg = cfg.replace(name=cfg.name + "_eager", fused_epoch=False,
                            n_epochs=1)
    shutil.rmtree(eager_cfg.log_dir, ignore_errors=True)
    zero_launches()
    eager = run(eager_cfg)
    torch.cuda.synchronize()
    expect_launches(read_launches(), {
        k: val.get(k, 0) * (n_val + PANEL_STEPS) + trn.get(k, 0) * n_train
        for k in set(val) | set(trn)}, f"{what} per-step")
    return eager


def hold_first_epoch(fused_hist, eager_hist, what: str) -> dict:
    """The fused run's first-epoch mean losses against the per-step loop's
    within DEVICE_LOSS_RTOL; returns their relative differences."""
    diff = {}
    for key in ("train_loss", "val_loss"):
        a, b = fused_hist[key][0], eager_hist[key][0]
        diff[key] = abs(a - b) / abs(b)
        if not diff[key] <= DEVICE_LOSS_RTOL:
            raise SystemExit(f"{what}: first-epoch {key} fused {a} against "
                             f"per-step {b}, rtol {DEVICE_LOSS_RTOL}")
    return diff


def phase_train_device(cube, phase: str, encoder: str, dtype: str,
                       n_epochs: int, resume: bool, host: tuple):
    """train_synthetic with device_data and the fused epochs at the bench
    width (``dtype`` compute), ``n_epochs`` epochs, launches exact;
    with ``resume`` one more epoch from latest (a new capture after the
    restore); the sample order against the host loader's; the first epoch
    against the per-step device loop; set-up seconds (upload, capture),
    steady fused train and val steps/s, busy share and peak memory beside
    the host loader's of this run (SUMMARY[host[0]] train, [host[1]]
    eval); the dropout replays (Mamba only). Returns the launches."""
    from idee_tpu_torch.data.device import DeviceLoader
    from idee_tpu_torch.models.vq_model import build_model, compute_dtype
    from idee_tpu_torch.train.driver import _make_datasets, train_synthetic
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import (WARMUP_STEPS, make_eval_epoch,
                                            make_train_epoch)

    cfg = train_config(encoder, n_epochs=n_epochs, dtype=dtype,
                       device_data=True).replace(name=f"chip_smoke_{phase}")
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    train_cube, val_cube = cube.time_slice(*TRAIN_WEEKS), \
        cube.time_slice(*VAL_WEEKS)
    n_train = (TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 1) - cfg.delta_t + 1
    n_val = (VAL_WEEKS[1] - VAL_WEEKS[0] + 1) - cfg.delta_t + 1
    trn = kernel_launches_per_step(encoder, train=True, dtype=dtype)
    val = kernel_launches_per_step(encoder, train=False, dtype=dtype)

    def run(c):
        return train_synthetic(c, train_cube=train_cube, val_cube=val_cube,
                               device="cuda")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    history = run(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    expect_launches(launches, {
        k: n_epochs * (val.get(k, 0) * (n_val + PANEL_STEPS)
                       + trn.get(k, 0) * n_train)
        for k in set(val) | set(trn)}, phase)
    curves = history["train_loss"] + history["val_loss"]
    if len(curves) != 2 * n_epochs or not all(map(math.isfinite, curves)):
        raise SystemExit(f"{phase}: bad loss history: {history}")
    resumed = None
    if resume:  # one more epoch from latest: a new capture after the restore
        zero_launches()
        resumed = run(cfg.replace(n_epochs=n_epochs + 1))
        torch.cuda.synchronize()
        expect_launches(read_launches(), {
            k: val.get(k, 0) * (n_val + PANEL_STEPS)
            + trn.get(k, 0) * n_train
            for k in set(val) | set(trn)}, f"{phase} resumed")
        if (resumed["train_loss"][:n_epochs] != history["train_loss"]
                or resumed["state"].step != (n_epochs + 1) * n_train):
            raise SystemExit(f"{phase}: resume did not continue: "
                             f"{resumed['train_loss']}")

    eager = eager_first_epoch(run, cfg, phase, n_train, n_val, trn, val)
    diff = hold_first_epoch(history, eager, phase)
    # for profile_hook: the same first epoch with profile_dir
    SUMMARY[f"{phase}_per_step"] = dict(
        cfg=cfg.replace(n_epochs=1), train_cube=train_cube,
        val_cube=val_cube, n_train=n_train, n_val=n_val,
        train_loss=eager["train_loss"], val_loss=eager["val_loss"])

    train_ds, _ = _make_datasets(cfg, train_cube, val_cube)
    compared = same_order_as_host(
        DeviceLoader(train_ds, 1, seed=cfg.seed, device="cuda"), cfg.seed)

    # --- set-up and steady rates on a cut of the cube
    rtrain, rval = _make_datasets(cfg, cube.time_slice(*RATE_TRAIN_WEEKS),
                                  cube.time_slice(*RATE_VAL_WEEKS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tl = DeviceLoader(rtrain, 1, seed=cfg.seed, dtype=compute_dtype(cfg),
                      device="cuda")
    vl = DeviceLoader(rval, 1, seed=cfg.seed, dtype=compute_dtype(cfg),
                      device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    model = build_model(cfg)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=len(tl))
    rates = measure_fused(
        make_train_epoch(model, cfg, tl, rtrain.anomaly.shape,
                         t0=float(rtrain.timestep[0]),
                         steps_per_epoch=len(tl)),
        make_eval_epoch(model, cfg, vl, rval.anomaly.shape,
                        t0=float(rval.timestep[0])),
        state, len(tl), len(vl))
    dropout = dropout_replays_differ(tl)
    SUMMARY[f"{phase}_fused"] = rates
    host_train, host_eval = SUMMARY[host[0]], SUMMARY[host[1]]
    emit(phase=phase, encoder=encoder, dtype=dtype,
         shape=[1, 6, 1, 8, 200, 200], epochs=n_epochs, train_steps=n_train,
         val_steps=n_val, launches=launches,
         eager_steps_per_graph=WARMUP_STEPS,
         history={k: v for k, v in history.items() if k != "state"},
         resumed_train_loss=resumed and resumed["train_loss"],
         per_step_device_loop={k: eager[k] for k in
                               ("train_loss", "val_loss", "steps_per_sec")},
         first_epoch_rel_diff=diff, loss_rtol=DEVICE_LOSS_RTOL,
         order_samples_compared=compared, wall_s_with_setup=wall_s,
         max_memory_allocated=peak_bytes, upload_s=upload_s,
         rate_cut={"train_samples": len(tl), "val_samples": len(vl)},
         fused=rates, dropout_replays=dropout,
         host_loader={"phases": list(host),
                      "train_steps_per_s":
                          host_train["steady_train_steps_per_s"],
                      "train_device_busy_share":
                          host_train["device_busy_share"],
                      "eval_steps_per_s": host_eval["steady_steps_per_s"],
                      "eval_device_busy_share":
                          host_eval["device_busy_share"],
                      "train_max_memory_allocated":
                          host_train["max_memory_allocated"]})
    return launches


def phase_train_cerra_device(root: str):
    """train_real with device_data on the CERRA fixture at the 200x200
    crop, N_EPOCHS epochs, fused, launches exact; the first epoch against
    the
    per-step device loop; the sample order against the host loader's;
    host precompute and upload seconds of the RealDeviceLoader, steady
    fused rates, busy share and peak memory beside train_cerra's host
    loader. Returns the launches."""
    from idee_tpu_torch.data.device import RealDeviceLoader
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.driver_real import (make_reanalysis_dataset,
                                                  train_real)
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps_real import (make_eval_epoch_real,
                                                 make_train_epoch_real)

    phase = "train_cerra_device"
    cfg = cerra_config(root, f"chip_smoke_{phase}", device_data=True)
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    trn = kernel_launches_per_step("Mamba", train=True)
    val = kernel_launches_per_step("Mamba", train=False)
    n = CERRA_SAMPLES

    def run(c):
        return train_real(c, "CERRA", device="cuda")

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    history = run(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    expect_launches(launches, {
        k: N_EPOCHS * ((n + PANEL_STEPS) * val.get(k, 0) + n * trn[k])
        for k in trn}, phase)
    if not all(map(math.isfinite, history["train_loss"]
                   + history["val_loss"])):
        raise SystemExit(f"{phase}: bad loss history: {history}")
    eager = eager_first_epoch(run, cfg, phase, n, n, trn, val)
    diff = hold_first_epoch(history, eager, phase)

    ds = make_reanalysis_dataset(cfg, "CERRA", cfg.years_train, False)
    t0 = time.perf_counter()
    loader = RealDeviceLoader(ds, 1, seed=cfg.seed, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    compared = same_order_as_host(loader, cfg.seed)
    model = build_model(cfg)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=n)
    rates = measure_fused(make_train_epoch_real(model, cfg, loader),
                          make_eval_epoch_real(model, cfg, loader), state,
                          n, n)
    dropout = dropout_replays_differ(loader)
    host = SUMMARY["train_cerra"]
    emit(phase=phase, encoder=cfg.encoder,
         shape=[1, 6, 2, cfg.delta_t, cfg.y_max, cfg.x_max],
         grid=CERRA_GRID, epochs=N_EPOCHS, train_steps=n, val_steps=n,
         launches=launches,
         history={k: v for k, v in history.items() if k != "state"},
         per_step_device_loop={k: eager[k] for k in
                               ("train_loss", "val_loss", "steps_per_sec")},
         first_epoch_rel_diff=diff, loss_rtol=DEVICE_LOSS_RTOL,
         order_samples_compared=compared, wall_s_with_setup=wall_s,
         max_memory_allocated=peak_bytes,
         precompute_and_upload_s=setup_s,
         unique_weeks=int(loader.xw.shape[0]),
         unique_noaa_lists=int(loader.d35.shape[0]), fused=rates,
         dropout_replays=dropout,
         host_loader={"phase": "train_cerra", **host})
    return launches


def phase_accuracy_device(cube, args, acc):
    """The accuracy geometry (48x48, batch 8, the stable recipe, bf16) with
    CNN_3D and device_data: 3 fused epochs, launches (none: CNN_3D runs no
    kernel); the first epoch against the per-step device loop; the sample
    order against the host loader's; upload and capture seconds, steady
    fused train and val steps/s, busy share and peak memory; the host
    loader's train steps/s of the same config (1 epoch); the dropout
    replays."""
    from idee_tpu_torch.data.device import DeviceLoader
    from idee_tpu_torch.models.vq_model import build_model, compute_dtype
    from idee_tpu_torch.train.driver import _make_datasets, train_synthetic
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import make_eval_epoch, make_train_epoch

    phase = "accuracy_device"
    n_time, t_train = acc.split_weeks(args.years)
    cfg = acc.build_config(args).replace(
        encoder="CNN_3D", name=f"chip_smoke_{phase}", device_data=True,
        dir_log=LOG_DIR)
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    cubes = dict(train_cube=cube.time_slice(1, t_train),
                 val_cube=cube.time_slice(t_train + 1, n_time))
    n_train = (t_train - cfg.delta_t + 1) // args.batch
    n_val = (n_time - t_train - cfg.delta_t + 1) // args.batch

    def run(c):
        return train_synthetic(c, device="cuda", **cubes)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    history = run(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    expect_launches(launches, {}, phase)
    eager = eager_first_epoch(run, cfg, phase, n_train, n_val, {}, {})
    diff = hold_first_epoch(history, eager, phase)
    host_cfg = cfg.replace(name=cfg.name + "_host", device_data=False,
                           n_epochs=1)
    shutil.rmtree(host_cfg.log_dir, ignore_errors=True)
    host = run(host_cfg)

    train_ds, val_ds = _make_datasets(cfg, cubes["train_cube"],
                                      cubes["val_cube"])
    compared = same_order_as_host(
        DeviceLoader(train_ds, 1, seed=cfg.seed, device="cuda"), cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tl = DeviceLoader(train_ds, args.batch, seed=cfg.seed,
                      dtype=compute_dtype(cfg), device="cuda")
    vl = DeviceLoader(val_ds, args.batch, seed=cfg.seed,
                      dtype=compute_dtype(cfg), device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    model = build_model(cfg)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=n_train)
    rates = measure_fused(
        make_train_epoch(model, cfg, tl, train_ds.anomaly.shape,
                         t0=float(train_ds.timestep[0]),
                         steps_per_epoch=n_train),
        make_eval_epoch(model, cfg, vl, val_ds.anomaly.shape,
                        t0=float(val_ds.timestep[0])),
        state, n_train, n_val)
    emit(phase=phase, encoder=cfg.encoder, dtype=cfg.dtype,
         shape=[args.batch, 6, 1, 8, args.hw, args.hw], epochs=cfg.n_epochs,
         train_steps=n_train, val_steps=n_val, launches=launches,
         history={k: v for k, v in history.items() if k != "state"},
         per_step_device_loop={k: eager[k] for k in
                               ("train_loss", "val_loss", "steps_per_sec")},
         first_epoch_rel_diff=diff, loss_rtol=DEVICE_LOSS_RTOL,
         order_samples_compared=compared, wall_s_with_setup=wall_s,
         max_memory_allocated=peak_bytes, upload_s=upload_s, fused=rates,
         dropout_replays=dropout_replays_differ(tl),
         host_loader={"train_steps_per_s": host["steps_per_sec"][0],
                      "train_loss": host["train_loss"][0]})
    return launches


# the reference's CERRA Europe crop (dataset/CERRA_dataset.py:100-101),
# one year of the fixture: the 1984 skip rule leaves target weeks 44-52
CERRA_GRID = (512, 832)
CERRA_YEAR = "1984"
CERRA_SAMPLES = 9
# the fused scan's (L, M) at 512x832: stage 0, 4 x 128 x 208 windows of
# (2,4,4) x 96 channels; stage 1, 512 x 832 windows of (8,1,1) x 96
CERRA_SCAN_SHAPES = {"stage0": (32, 10_223_616), "stage1": (8, 40_894_464)}
# the reference's loader, DataLoader(num_workers=8) (idee_tpu/config.py:50,
# 211), timed beside the config's default (one prefetch thread)
REFERENCE_LOADER_WORKERS = 8


def cerra_config(root: str, name: str, **kw):
    """The config defaults (Mamba, widths, in_channels=2, the 6 CERRA
    variables, delta_t=8, the 200x200 crop, climatology normalisation,
    the loader's one prefetch thread) on the fixture tree at ``root``,
    batch 1, no augmentation."""
    from idee_tpu_torch.config import Config

    base = dict(root_CERRA=os.path.join(root, "CERRA"),
                root_NOAA_CERRA=os.path.join(root, "NOAA_CERRA"),
                years_train=[CERRA_YEAR], years_val=[CERRA_YEAR],
                years_test=[CERRA_YEAR], grid_override=CERRA_GRID,
                n_epochs=N_EPOCHS, batch_size=1, is_aug=False,
                dir_log=LOG_DIR, name=name)
    base.update(kw)
    return Config(**base)


def phase_cerra_fixture(root: str):
    """write_fake_reanalysis: the 6 CERRA variables on the 512x832 grid,
    one year, seed 0, NetCDF3."""
    from idee_tpu_torch.config import CERRA_VARIABLES
    from idee_tpu_torch.data.fake import write_fake_reanalysis

    t0 = time.perf_counter()
    write_fake_reanalysis(os.path.join(root, "CERRA"),
                          os.path.join(root, "NOAA_CERRA"),
                          variables=CERRA_VARIABLES, years=(CERRA_YEAR,),
                          height=CERRA_GRID[0], width=CERRA_GRID[1], seed=0)
    seconds = time.perf_counter() - t0
    sizes = [os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(root) for f in files]
    emit(phase="cerra_fixture", seconds=seconds, bytes=sum(sizes),
         files=len(sizes), grid=CERRA_GRID, year=CERRA_YEAR)


def phase_train_cerra(root: str):
    """train_real on the CERRA tree at the 200x200 crop for N_EPOCHS
    epochs, launches counted; checkpoints, history, a resumed one more;
    steady
    train steps/s, a profile and one step's gradients against the plain
    scan. Returns (launches, path of the latest checkpoint)."""
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.driver_real import (TRAIN_KEYS,
                                                  make_reanalysis_dataset,
                                                  train_real)
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                                 make_train_step_real)

    cfg = cerra_config(root, "chip_smoke_train_cerra")
    shutil.rmtree(cfg.log_dir, ignore_errors=True)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    history = train_real(cfg, "CERRA", device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_bytes = torch.cuda.max_memory_allocated()

    steps = N_EPOCHS * CERRA_SAMPLES  # train steps, and as many val steps
    val = kernel_launches_per_step("Mamba", train=False)
    trn = kernel_launches_per_step("Mamba", train=True)
    expect_launches(launches, {
        k: val.get(k, 0) * (steps + N_EPOCHS * PANEL_STEPS) + trn[k] * steps
        for k in trn}, "train_cerra")
    curves = history["train_loss"] + history["val_loss"]
    if len(curves) != 2 * N_EPOCHS or not all(map(math.isfinite, curves)):
        raise SystemExit(f"bad loss history: {history}")
    written = sorted(os.listdir(os.path.join(cfg.log_dir,
                                             "model_checkpoints")))
    if written != ["best_F1_model.pt", "best_loss_model.pt", "latest.pt"]:
        raise SystemExit(f"checkpoints written: {written}")
    with open(os.path.join(cfg.log_dir, "history.json")) as fh:
        if json.load(fh)["train_loss"] != history["train_loss"]:
            raise SystemExit("history.json differs from the run's history")
    resumed = train_real(cfg.replace(n_epochs=N_EPOCHS + 1), "CERRA",
                         device="cuda")
    if (resumed["train_loss"][:N_EPOCHS] != history["train_loss"]
            or len(resumed["train_loss"]) != N_EPOCHS + 1
            or resumed["state"].step != (N_EPOCHS + 1) * CERRA_SAMPLES):
        raise SystemExit(f"resume did not continue at epoch {N_EPOCHS}: "
                         f"{resumed['train_loss']}")
    latest = os.path.join(cfg.log_dir, "model_checkpoints", "latest.pt")

    # --- steady state: train steps from fresh weights
    ds = make_reanalysis_dataset(cfg, "CERRA", cfg.years_train, False)
    loader = DataLoader(ds, 1, device="cuda", keys=TRAIN_KEYS, shuffle=True,
                        workers=cfg.loader_workers)
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    model = build_model(cfg)
    model.load_state_dict(params)
    state = create_train_state(cfg, model, "cuda",
                               steps_per_epoch=CERRA_SAMPLES)
    step = make_train_step_real(model, cfg)
    metrics = init_epoch_metrics_real("cuda")
    steps_per_s, timed = steady_steps_per_s(
        lambda b: step(state, metrics, b), iter(loader))
    batches = iter(loader)
    profile = profile_steps(lambda: step(state, metrics, next(batches)), n=3)
    SUMMARY["train_cerra"] = dict(
        train_steps_per_s=steps_per_s,
        train_device_busy_share=profile["device_busy_share"],
        max_memory_allocated=peak_bytes)
    emit(phase="train_cerra", encoder=cfg.encoder,
         shape=[1, 6, 2, cfg.delta_t, cfg.y_max, cfg.x_max],
         grid=CERRA_GRID, epochs=N_EPOCHS, train_steps=steps,
         val_steps=steps, launches=launches,
         history={k: v for k, v in history.items() if k != "state"},
         resumed_train_loss=resumed["train_loss"], wall_s_with_setup=wall_s,
         steady_train_steps_per_s=steps_per_s, steady_steps_timed=timed,
         max_memory_allocated=peak_bytes, checkpoints=written,
         loader_workers=cfg.loader_workers)
    emit(phase="profile", path="train_cerra", **profile)
    compare_step_gradients(cfg, params, next(iter(loader)), "train_cerra",
                           real=True)
    return launches, latest


def phase_test_cerra(root: str, weights: str):
    """test_real at the full 512x832 crop on the weights train_cerra
    saved, launches counted; the host's ms per item; steady eval steps/s
    and busy share with the config's loader and with the reference's 8
    workers; peak memory; the forward with the kernel against the plain scan on one
    batch; the fused forward alone at its two 512x832 shapes; then
    predict_real on the same tree. Returns ({path: launches}, the fused
    forward's rows)."""
    from idee_tpu_torch.cli.predict_real import predict_real
    from idee_tpu_torch.data.loader import DataLoader, collate
    from idee_tpu_torch.kernels import bounds
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.checkpoint import load_pretrained_weights
    from idee_tpu_torch.train.driver_real import (TEST_KEYS,
                                                  make_reanalysis_dataset,
                                                  test_real)
    from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                                 make_eval_step_real)

    H, W = CERRA_GRID
    cfg = cerra_config(root, "chip_smoke_test_cerra", x_max=W, y_max=H,
                       en_de_pretrained=weights)
    per_step = kernel_launches_per_step("Mamba", train=False)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    result = test_real(cfg, "CERRA", device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"test_cerra": read_launches()}
    peak_bytes = torch.cuda.max_memory_allocated()
    expect_launches(launches["test_cerra"],
                    {k: v * CERRA_SAMPLES for k, v in per_step.items()},
                    "test_cerra")
    if sorted(result) != ["drought_f1", "drought_iou", "mean_f1",
                          "mean_iou"] or not math.isfinite(result["mean_iou"]):
        raise SystemExit(f"test_real gave {result}")

    # --- the host's item build alone, on this thread
    ds = make_reanalysis_dataset(cfg, "CERRA", cfg.years_test, False)
    t0 = time.perf_counter()
    for i in range(3):
        ds[i]
    host_item_ms = 1e3 * (time.perf_counter() - t0) / 3

    # --- steady state, host batch assembly included: the config's loader
    # (the metric's setting) and the reference's 8 workers
    model = build_model(cfg)
    model.load_state_dict(load_pretrained_weights(cfg, weights))
    model.to("cuda")
    step = make_eval_step_real(model, cfg, test_mode=True)
    metrics = init_epoch_metrics_real("cuda")
    by_workers = {}
    for workers in (cfg.loader_workers, REFERENCE_LOADER_WORKERS):
        loader = DataLoader(ds, 1, device="cuda", keys=TEST_KEYS,
                            workers=workers)
        steps_per_s, timed = steady_steps_per_s(lambda b: step(metrics, b),
                                                iter(loader))
        batches = iter(loader)
        prof = profile_steps(lambda: step(metrics, next(batches)), n=5)
        batches.close()
        by_workers[workers] = dict(
            steady_steps_per_s=steps_per_s, steady_steps_timed=timed,
            device_busy_share=prof["device_busy_share"],
            device_ms_per_step=prof["device_ms_per_step"])
        if workers == cfg.loader_workers:
            profile = prof
    steps_per_s = by_workers[cfg.loader_workers]["steady_steps_per_s"]
    timed = by_workers[cfg.loader_workers]["steady_steps_timed"]

    # --- one forward with the plain scan on the same batch
    b = {k: torch.from_numpy(v).cuda() for k, v in collate([ds[0]]).items()
         if k in TEST_KEYS}
    kw = dict(mask_extreme_loss=b["mask_extreme_loss"],
              mask_exclude=b["mask_cold_surface_loss"])
    with torch.inference_mode():
        out_k = model(b["x"], **kw)
        with plain_ops("Mamba"):
            out_p = model(b["x"], **kw)
    logit_err = max((out_k.z - out_p.z).abs().max().item(),
                    (out_k.y - out_p.y).abs().max().item())
    bits_agree = (out_k.anomaly == out_p.anomaly).float().mean().item()
    if not (torch.isfinite(out_k.z).all() and logit_err <= 1e-4
            and bits_agree >= 0.999):
        raise SystemExit(f"CERRA: kernel forward disagrees with the plain "
                         f"one: logit err {logit_err}, bits agree "
                         f"{bits_agree}")
    del out_k, out_p, b, model, step, metrics
    torch.cuda.empty_cache()
    emit(phase="test_cerra", encoder=cfg.encoder,
         shape=[1, 6, 2, cfg.delta_t, H, W], metrics=result,
         steps=CERRA_SAMPLES, launches=launches["test_cerra"],
         wall_s_with_setup=wall_s, steady_steps_per_s=steps_per_s,
         steady_steps_timed=timed, max_memory_allocated=peak_bytes,
         plain_op_logit_max_abs_err=logit_err,
         plain_op_anomaly_bit_agreement=bits_agree,
         loader_workers=cfg.loader_workers, host_item_ms=host_item_ms,
         steady_by_loader_workers=by_workers)
    emit(phase="profile", path="test_cerra", **profile)

    # --- the fused forward alone at the 512x832 shapes
    fused = check_fused_forward(kernel_modules()[0], bounds,
                                CERRA_SCAN_SHAPES)
    emit(phase="kernel_cerra", rtol=SCAN_RTOL, atol=SCAN_ATOL,
         selective_scan_fused_n1_fwd=fused)

    # --- predict_real: the exported maps
    out_path = os.path.join(LOG_DIR, "chip_smoke_predictions_real.npz")
    zero_launches()
    t0 = time.perf_counter()
    payload = predict_real(cfg, "CERRA", weights, out_path, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches["predict_cerra"] = read_launches()
    expect_launches(launches["predict_cerra"],
                    {k: v * CERRA_SAMPLES for k, v in per_step.items()},
                    "predict_cerra")
    want = {"drought_prob": ("float32", (H, W)),
            "drought_mask": ("uint8", (H, W)),
            "anomaly": ("uint8", (6, cfg.delta_t, H, W)),
            "valid_mask": ("uint8", (H, W)), "name_code": ("int64", ())}
    for k, (dtype, shape) in want.items():
        a = payload[k]
        if str(a.dtype) != dtype or a.shape != (CERRA_SAMPLES,) + shape:
            raise SystemExit(f"predict_real {k}: {a.dtype} {a.shape}")
    prob = payload["drought_prob"]
    if not (np.isfinite(prob).all() and prob.min() >= 0 and prob.max() <= 1):
        raise SystemExit("predict_real: drought_prob outside [0, 1]")
    if payload["drought_mask"][payload["valid_mask"] == 0].any():
        raise SystemExit("predict_real: drought_mask set outside valid_mask")
    codes = payload["name_code"]
    if not ((codes // 1000 == int(CERRA_YEAR)).all()
            and (np.diff(codes) > 0).all()):
        raise SystemExit(f"predict_real: name codes {codes}")
    emit(phase="predict_cerra", launches=launches["predict_cerra"],
         wall_s_with_setup=wall_s,
         keys=sorted(payload), drought_mask_share=float(
             payload["drought_mask"].mean()),
         valid_share=float(payload["valid_mask"].mean()),
         anomaly_share=float(payload["anomaly"].mean()),
         bytes=os.path.getsize(out_path))
    os.remove(out_path)
    return launches, fused


# ------------------------------------------------------------------
# slice 13: the reference's checkpoints, the host batch engine, the
# profiler hook and image panels, memory_fit and profile_step

# (phase name, encoder, d_state) of the reference-checkpoint round trips
REFERENCE_CASES = (("Mamba", 1), ("Mamba", 2), ("Swin_3D", 1),
                   ("CNN_3D", 1))
# memory_fit probes: (family, encoder, batch, hw, remat); the 200x200
# batch-1 rows are held against this run's train phases' peaks
MEMORY_PROBES = (("synthetic", "Mamba", 1, "200", False),
                 ("synthetic", "Swin_3D", 1, "200", False),
                 ("synthetic", "CNN_3D", 1, "200", False),
                 ("real", "CNN_3D", 1, "512x832", False),
                 ("real", "Swin_3D", 1, "512x832", False),
                 ("real", "Swin_3D", 1, "512x832", True),
                 ("real", "Mamba", 1, "512x832", True),
                 ("synthetic", "Swin_3D", 2, "200", False),
                 # the case for the space axis: ~95 GB on one card
                 ("real", "CNN_3D", 2, "512x832", False))
MEMORY_TRAIN_PHASES = {"Mamba": "train", "Swin_3D": "train_swin",
                       "CNN_3D": "train_cnn"}
MEMORY_REL = 0.10
# profile_step's full step against the profile phase's device ms per step
PROFILE_STEP_ITERS = 5  # five keep the script's time
PROFILE_STEP_REL = 0.10
PROFILE_STEP_COVER = 0.97
PROFILE_TRAIN_PHASES = {("Mamba", "float32"): "train",
                        ("Swin_3D", "float32"): "train_swin",
                        ("CNN_3D", "float32"): "train_cnn",
                        ("Mamba", "bfloat16"): "train_mamba_bf16",
                        ("Swin_3D", "bfloat16"): "train_swin_bf16",
                        ("CNN_3D", "bfloat16"): "train_cnn_bf16"}
# host ms per batch: batches timed per path
HOST_BATCHES = 16
NATIVE_WORKERS = 8


def phase_reference_checkpoint(cube):
    """For Mamba (d_state 1 and 2), Swin_3D and CNN_3D at the bench width:
    a seeded model's checkpoint exported by cli/export_reference_checkpoint
    (from a run directory) to a reference .pth, imported back by
    cli/import_reference_checkpoint (with the run's config snapshot), then
    test_synthetic with --en_de_pretrained on the import: weights, logits
    and metrics bit-equal to the original model's, launches exact, the
    export's keys in the key map's order (JAX's). Returns the launches of
    the imported evaluations."""
    from idee_tpu_torch.cli import (export_reference_checkpoint,
                                    import_reference_checkpoint)
    from idee_tpu_torch.config import save_options, synthetic_config
    from idee_tpu_torch.models import interop
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.evaluate import test_synthetic

    base = _scratch("chip_smoke_reference_")
    rows, total = {}, {}
    n_steps = N_WEEKS - 8 + 1
    try:
        for encoder, d_state in REFERENCE_CASES:
            name = f"{encoder}_n{d_state}"
            cfg = synthetic_config(
                encoder=encoder, d_state=[d_state, d_state], x_max=200,
                y_max=200, times_test=(1, N_WEEKS), dir_log=base,
                is_clima_scale=IS_CLIMA_SCALE, name=name)
            model = build_model(cfg, torch.Generator().manual_seed(0))
            params = model.state_dict()
            save_options(cfg)
            os.makedirs(os.path.join(cfg.log_dir, "model_checkpoints"))
            torch.save({"model": params, "meta": {"epoch": 0}},
                       os.path.join(cfg.log_dir, "model_checkpoints",
                                    "seeded.pt"))
            pth = os.path.join(base, f"{name}.pth")
            exported = export_reference_checkpoint.main(
                ["--run_dir", cfg.log_dir, "--alias", "seeded", "--out",
                 pth, "--device", "cuda"])
            imported_pt = os.path.join(base, f"{name}_imported.pt")
            imported = import_reference_checkpoint.main(
                ["--checkpoint", pth, "--out", imported_pt, "--config_pkl",
                 os.path.join(cfg.log_dir, "config.json"), "--device",
                 "cuda"])
            ref = torch.load(pth, weights_only=True)["model_state_dict"]
            entries = interop.build_param_map(
                cfg, interop.state_dict_to_flax(params))
            mapped = [k for e in entries for k in e.torch_keys]
            if (list(ref)[:len(mapped)] != mapped
                    or not all(k.endswith(interop.IGNORED_TORCH_SUFFIXES)
                               for k in list(ref)[len(mapped):])):
                raise SystemExit(f"{name}: export keys out of the map's "
                                 f"order: {list(ref)[:8]}")
            back = torch.load(imported_pt, weights_only=True)["model"]
            if list(back) != list(params) or not all(
                    torch.equal(back[k], params[k]) for k in params):
                raise SystemExit(f"{name}: imported weights differ")

            # the imported weights' evaluation, launches counted
            torch.cuda.synchronize()
            zero_launches()
            got = test_synthetic(
                cfg.replace(en_de_pretrained=imported_pt, name=name + "_i"),
                cube=cube, device="cuda")
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(launches, {
                k: v * n_steps for k, v in kernel_launches_per_step(
                    encoder, train=False, d_state=d_state).items()},
                f"reference_checkpoint {name}")
            want = test_synthetic(cfg, cube=cube, params=params,
                                  device="cuda")
            same = all(got[k] == want[k] or (math.isnan(got[k])
                                             and math.isnan(want[k]))
                       for k in want)
            x = torch.from_numpy(cube.dynamic[:, :8][None, :, None]).cuda()
            loaded = build_model(cfg)
            loaded.load_state_dict(back)
            model.cuda().eval()
            loaded.cuda().eval()
            with torch.inference_mode():
                z0, z1 = model(x).z, loaded(x).z
            if not (same and torch.equal(z0, z1)):
                raise SystemExit(f"{name}: imported evaluation differs: "
                                 f"{got} {want}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            rows[name] = dict(
                pth_bytes=exported["bytes"], export_s=exported["seconds"],
                import_s=imported["seconds"], keys=len(ref),
                parameters=imported["parameters"], metrics=got,
                launches=launches, logits_bit_equal=True)
            del model, loaded
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit(phase="reference_checkpoint", shape=[1, 6, 1, 8, 200, 200],
         steps_per_eval=n_steps, cases=rows)
    return total


class _ItemsOnly:
    """A dataset's item interface without get_batch: the loader collates
    its items with numpy (the engine's plain version)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def draw_aug(self):
        return self.ds.draw_aug()

    def item(self, i, aug):
        return self.ds.item(i, aug)


def _host_ms(fn, n: int) -> float:
    """Median host ms of fn(i) over i < n."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def phase_native_loader(cube):
    """The host batch engine at the bench width: its g++ build seconds
    (phase build);
    every batch of a shuffled epoch bit-equal to the numpy path's
    (augmentation off and on, loader_workers 0 and 8); host ms per batch
    of each path and engine_threads(); then steady train steps/s and busy
    share of Mamba's train step fed by the host loader with the engine and
    with the numpy path."""
    from idee_tpu_torch import native
    from idee_tpu_torch.data.loader import DataLoader, collate
    from idee_tpu_torch.data.synthetic import SyntheticDataset
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

    def dataset(is_aug, times=(1, N_WEEKS)):
        return SyntheticDataset(
            cube=cube.time_slice(*times), times=times,
            variables=cube.variables, delta_t=8, is_aug=is_aug,
            is_clima_scale=IS_CLIMA_SCALE, x_max=200, y_max=200, seed=0)

    compared = 0
    for is_aug in (False, True):
        for workers in (0, NATIVE_WORKERS):
            kw = dict(device="cpu", shuffle=True, seed=1, workers=workers)
            got = DataLoader(dataset(is_aug), 1, **kw)
            want = DataLoader(_ItemsOnly(dataset(is_aug)), 1, device="cpu",
                              shuffle=True, seed=1, prefetch=0)
            for g, w in zip(got, want):
                for k in w:
                    if not torch.equal(g[k], w[k]):
                        raise SystemExit(f"native_loader: {k} differs "
                                         f"(aug {is_aug}, workers "
                                         f"{workers})")
                compared += 1
    ds = dataset(True)
    ref = dataset(True)
    n = min(HOST_BATCHES, len(ds))
    engine_ms = _host_ms(lambda i: ds.get_batch([i]), n)
    numpy_ms = _host_ms(lambda i: collate([ref[i]]), n)
    batch_bytes = sum(v.nbytes for v in ds.get_batch([0]).values())

    # the train step fed by each host path
    cfg = train_config("Mamba", n_epochs=1)
    rates = {}
    for path in ("engine", "numpy"):
        train_ds = dataset(False, TRAIN_WEEKS)
        src = train_ds if path == "engine" else _ItemsOnly(train_ds)
        loader = DataLoader(src, 1, device="cuda", shuffle=True,
                            keys=["x", "mask_extreme", "mask_extreme_loss",
                                  "timestep"])
        model = build_model(cfg, torch.Generator().manual_seed(0))
        state = create_train_state(cfg, model, "cuda",
                                   steps_per_epoch=len(loader))
        step = make_train_step(model, cfg, t0=float(TRAIN_WEEKS[0]))
        metrics = init_epoch_metrics(train_ds.anomaly.shape, "cuda")
        sps, timed = steady_steps_per_s(lambda b: step(state, metrics, b),
                                        iter(loader))
        batches = iter(loader)
        prof = profile_steps(lambda: step(state, metrics, next(batches)),
                             n=3)
        rates[path] = {"steady_train_steps_per_s": sps, "steps_timed": timed,
                       "device_busy_share": prof["device_busy_share"],
                       "device_ms_per_step": prof["device_ms_per_step"]}
        del model, state
    emit(phase="native_loader", build_s=SUMMARY["native_build_s"],
         library=os.path.relpath(native.library_path(), REPO),
         engine_threads=native.engine_threads(),
         batches_compared=compared, workers=[0, NATIVE_WORKERS],
         batch_shape=[1, 6, 1, 8, 200, 200], batch_bytes=batch_bytes,
         host_ms_per_batch={"engine": engine_ms, "numpy": numpy_ms},
         batches_timed=n, train=rates,
         train_phase=SUMMARY["train"]["steady_train_steps_per_s"])


def phase_native_vhi(root: str):
    """The engine's vhi_mask against vhi_drought_plain on the CERRA
    fixture's 512x832 NOAA weeks (the label engine's call: VHI = alpha
    VCI + (1 - alpha) TCI, the cold mask binarised), bit for bit, with
    host ms for each."""
    from idee_tpu_torch import native
    from idee_tpu_torch.data.netcdf import NetCDFFile
    from idee_tpu_torch.data.reanalysis import vhi_drought_plain

    noaa = os.path.join(root, "NOAA_CERRA", CERRA_YEAR)
    files = sorted(os.listdir(noaa))[:HOST_BATCHES]
    times = {"engine": [], "numpy": []}
    pixels = drought = 0
    for f in files:
        with NetCDFFile(os.path.join(noaa, f)) as nc:
            vci = nc.read("VCI").astype(np.float32)
            tci = nc.read("TCI").astype(np.float32)
            cold = nc.read("mask_cold_surface").astype(np.float32)
        vhi = np.ascontiguousarray(0.5 * vci + 0.5 * tci, np.float32)
        cold_eq1 = np.ascontiguousarray(cold == 1, np.float32)
        t0 = time.perf_counter()
        got = native.vhi_mask(vhi, vhi, cold_eq1, 0.5, 26.0)
        times["engine"].append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        want = vhi_drought_plain(vhi, cold, 26.0)
        times["numpy"].append(1e3 * (time.perf_counter() - t0))
        if not np.array_equal(got, want):
            raise SystemExit(f"native_vhi: {f} differs from the numpy "
                             "version")
        pixels += got.size
        drought += int(got.sum())
    emit(phase="native_vhi", weeks=len(files), shape=list(vhi.shape),
         drought_share=drought / pixels,
         host_ms_per_week={k: float(np.median(v)) for k, v in times.items()})


class PanelRecorder:
    """A SummaryWriter stand-in that keeps the image panels."""

    def __init__(self, log_dir):
        self.images = []
        PanelRecorder.last = self

    def add_scalars(self, *args, **kwargs):
        pass

    def add_images(self, tag, images, step, dataformats="HWC"):
        self.images.append((tag, np.asarray(images), step, dataformats))

    def flush(self):
        pass

    def close(self):
        pass


def phase_profile_hook():
    """train_synthetic for 1 epoch (Mamba, float32, bench width) with
    profile_dir and device_data + fused_epoch: the hook traces the fused
    first epoch whole (warm-up steps, capture, replays). The trace names
    the fused scan's forward and backward kernels and every step's span
    marks; the epoch's losses lie within DEVICE_LOSS_RTOL of
    train_device's per-step loop (the same run without profile_dir and
    fused_epoch); the image panels are made (shapes as JAX's, values in
    [0, 1]). Returns the launches."""
    import idee_tpu_torch.train.driver as driver

    ref = SUMMARY["train_device_per_step"]
    prof_dir = _scratch("chip_smoke_profile_")
    cfg = ref["cfg"].replace(name="chip_smoke_profile_hook",
                             profile_dir=prof_dir)
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    writer = driver.SummaryWriter
    driver.SummaryWriter = PanelRecorder
    try:
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        history = driver.train_synthetic(
            cfg, train_cube=ref["train_cube"], val_cube=ref["val_cube"],
            device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        path = os.path.join(prof_dir, f"{cfg.name}_train.trace.json")
        trace_bytes = os.path.getsize(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        driver.SummaryWriter = writer
        shutil.rmtree(prof_dir, ignore_errors=True)
    trn = kernel_launches_per_step("Mamba", train=True)
    val = kernel_launches_per_step("Mamba", train=False)
    n_train, n_val = ref["n_train"], ref["n_val"]
    expect_launches(launches, {
        k: val.get(k, 0) * (n_val + PANEL_STEPS) + trn.get(k, 0) * n_train
        for k in set(val) | set(trn)}, "profile_hook")
    kernels = {}
    for e in events:
        for name in ("fused_scan_n1_fwd_kernel", "fused_scan_n1_bwd_kernel",
                     "idee_span_step_begin"):
            if name in e.get("name", ""):
                kernels[name] = kernels.get(name, 0) + 1
    # the whole first epoch: three of each scan kernel and one step mark
    # a train step; a trace can lose a record at its edges (PERF.md §6,
    # PR 21), so a count may be one step's short
    per_step = {"fused_scan_n1_fwd_kernel": 3, "fused_scan_n1_bwd_kernel": 3,
                "idee_span_step_begin": 1}
    if set(kernels) != set(per_step) or not all(
            (n_train - 1) * w <= kernels[k] <= n_train * w
            for k, w in per_step.items()):
        raise SystemExit(f"profile_hook: trace kernels {kernels}")
    diff = {k: abs(history[k][0] - ref[k][0]) / abs(ref[k][0])
            for k in ("train_loss", "val_loss")}
    if not all(d <= DEVICE_LOSS_RTOL for d in diff.values()):
        raise SystemExit(f"profile_hook: losses {history['train_loss']} "
                         f"{history['val_loss']} against {ref}")
    images = PanelRecorder.last.images
    shapes = {tag: list(im.shape) for tag, im, _, _ in images}
    want = {"extremes": [1, 200, 600, 3],
            **{v: [400, 1600, 3] for v in cfg.variables}}
    if shapes != want or not all(0 <= im.min() and im.max() <= 1
                                 for _, im, _, _ in images):
        raise SystemExit(f"profile_hook: panels {shapes}")
    emit(phase="profile_hook", encoder=cfg.encoder, traced_steps=n_train,
         trace_bytes=trace_bytes, trace_events=len(events),
         trace_kernels=kernels, launches=launches,
         losses={k: history[k] for k in ("train_loss", "val_loss")},
         rel_diff_to_per_step=diff,
         losses_bit_equal=all(d == 0 for d in diff.values()),
         panels=shapes, wall_s_with_setup=wall_s)
    return launches


def phase_memory_fit():
    """cli/memory_fit.py's probes (MEMORY_PROBES): one train step each on
    the card, the 200x200 batch-1 peaks within MEMORY_REL of this run's
    train phases; an out-of-memory row is a finding. Returns the rows."""
    from idee_tpu_torch.cli import memory_fit

    rows = []
    for family, encoder, batch, hw, remat in MEMORY_PROBES:
        H, W = memory_fit.parse_hw(hw)
        t0 = time.perf_counter()
        row = memory_fit.probe(family, encoder, batch, H, W, remat=remat,
                               device="cuda")
        row["seconds"] = time.perf_counter() - t0
        if family == "synthetic" and batch == 1:
            train_peak = SUMMARY[MEMORY_TRAIN_PHASES[encoder]][
                "max_memory_allocated"]
            row["train_phase_peak_bytes"] = train_peak
            row["rel_to_train_phase"] = row["peak_bytes"] / train_peak - 1
            if not (row["fits"] and abs(row["rel_to_train_phase"])
                    <= MEMORY_REL):
                raise SystemExit(f"memory_fit: {row}")
        print(json.dumps(row), flush=True)
        rows.append(row)
    emit(phase="memory_fit", rel_tolerance=MEMORY_REL, probes=rows)
    return rows


def phase_profile_step():
    """cli/profile_step.py per encoder at float32 and bf16
    (PROFILE_STEP_ITERS replays traced): the step span's device ms within
    PROFILE_STEP_REL of the encoder's device ms per train step in this
    run's profile phase, its children covering PROFILE_STEP_COVER of
    it."""
    from idee_tpu_torch.cli import profile_step

    runs = []
    for (encoder, dtype), phase in PROFILE_TRAIN_PHASES.items():
        s = profile_step.profile(encoder, hw=200, iters=PROFILE_STEP_ITERS,
                                 dtype=dtype, device="cuda")
        ref = SUMMARY[phase]["device_ms_per_step"]
        rel = s["step_ms"] / ref - 1
        if abs(rel) > PROFILE_STEP_REL or \
                s["children_cover"] < PROFILE_STEP_COVER:
            raise SystemExit(f"profile_step {encoder} {dtype}: step "
                             f"{s['step_ms']} ms against {ref} ms, "
                             f"children {s['children_cover']}")
        runs.append({"encoder": encoder, "dtype": dtype,
                     "step_ms": s["step_ms"], "profile_phase": phase,
                     "profile_device_ms_per_step": ref,
                     "rel_to_profile": rel,
                     "children_cover": s["children_cover"],
                     "busy_cover": s["busy_cover"],
                     "marks_us_per_step": s["marks_us_per_step"],
                     "spans": {r["span"]: r["ms"] for r in s["spans"]}})
    emit(phase="profile_step", iters=PROFILE_STEP_ITERS,
         rel_tolerance=PROFILE_STEP_REL, runs=runs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import idee_tpu_torch  # noqa: F401 -- fails outside a checkout
    from idee_tpu_torch.data.fake import make_fake_cube, write_cube_npz

    ss, wa = kernel_modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products reduce in float32 (as resolve_device sets for every
    # entry point)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_name_and_power()
    print(card, flush=True)

    phase_build()
    fused, scan, backward, attn, attn_bf16, attn_dt4 = phase_kernel()
    cube = make_fake_cube(n_vars=6, n_time=N_WEEKS, height=200, width=200,
                          seed=0)
    paths = {
        "eval_mamba": phase_eval(cube, "Mamba"),
        "train_mamba": phase_train(cube, "Mamba", "train", resume=True),
        "train_mamba_dstate2": phase_train(
            cube, "Mamba", "train_mamba_dstate2", resume=False,
            d_state=D_STATE2, n_epochs=N_EPOCHS_SHORT, compare_plain=False),
        "eval_swin": phase_eval(cube, "Swin_3D"),
        "train_swin": phase_train(cube, "Swin_3D", "train_swin",
                                  resume=False),
        "eval_cnn": phase_eval(cube, "CNN_3D"),
        "train_cnn": phase_train(cube, "CNN_3D", "train_cnn", resume=False,
                                 n_epochs=N_EPOCHS_SHORT,
                                 compare_plain=False),
        "train_vq_ema": phase_train_vq_ema(cube)}
    paths.update(phase_codebooks(cube))
    paths.update(phase_bf16(cube))
    paths["train_device"] = phase_train_device(
        cube, "train_device", "Mamba", "float32", N_EPOCHS, resume=True,
        host=("train", "main"))
    paths["train_device_swin_bf16"] = phase_train_device(
        cube, "train_device_swin_bf16", "Swin_3D", "bfloat16",
        N_EPOCHS_SHORT, resume=False,
        host=("train_swin_bf16", "main_swin_bf16"))
    paths["profile_hook"] = phase_profile_hook()
    paths.update(phase_baselines(cube))
    paths.update(phase_baselines_bf16(cube))
    paths.update(phase_swin_dt4(cube))
    paths.update(phase_train_ddp(cube))
    paths.update(phase_train_ddp_fused(cube))
    cerra_root = _scratch("chip_smoke_cerra_")
    space_root = _scratch("chip_smoke_space_")
    try:
        write_cube_npz(os.path.join(space_root, "cube"), cube)
        paths["reference_checkpoint"] = phase_reference_checkpoint(cube)
        phase_native_loader(cube)
        del cube
        paths["synthetic_netcdf"] = phase_synthetic_netcdf()
        paths.update(phase_accuracy())
        memory_rows = phase_memory_fit()
        phase_memory_fit_space(memory_rows)
        phase_profile_step()
        # the host writes the CERRA fixture while the space ranks run
        paths.update(phase_train_space(
            space_root, lambda: phase_cerra_fixture(cerra_root)))
        phase_native_vhi(cerra_root)
        paths["train_cerra"], weights = phase_train_cerra(cerra_root)
        paths.update(phase_train_cerra_space(cerra_root, memory_rows))
        paths["train_cerra_device"] = phase_train_cerra_device(cerra_root)
        cerra_paths, fused_cerra = phase_test_cerra(cerra_root, weights)
        paths.update(cerra_paths)
    finally:
        shutil.rmtree(cerra_root, ignore_errors=True)
        shutil.rmtree(space_root, ignore_errors=True)
    shutil.rmtree(LOG_DIR, ignore_errors=True)

    def by_path(kernel):
        return {path: counts[kernel] for path, counts in paths.items()}

    def per_step(rows, key):
        # the launches of one Mamba step: two at the stage-0 shape, one at
        # the stage-1 shape
        return sum(key(rows[s]) * n for s, n in LAUNCHES_PER_STEP.items())

    def attn_row(name, key, source_line, path, rows=attn,
                 rows_dt4=attn_dt4["float32"]):
        # times per step: one launch at each of the three stage shapes
        def total(field, rows=rows):
            return sum(r[key][field] for r in rows.values())

        row = {
            "name": name, "route": "cuda",
            "source": f"idee_tpu_torch/kernels/csrc/{wa.SOURCES[name]}.cu",
            "replaces": f"idee_tpu/kernels/window_attention.py:{source_line}",
            "launches": paths[path][name], "launches_by_path": by_path(name),
            "max_abs_err": max(r[key]["max_abs_err"] for r in rows.values()),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": rows["stage0"][key]["bound_by"],
            "library_ms": total("library_ms"),
            # per step of Swin_3D at delta_t 4 (5,000 windows of 32, 40,000
            # of 4; phase swin_dt4's launches)
            "delta_t_4": {
                "max_abs_err": max(r[key]["max_abs_err"]
                                   for r in rows_dt4.values()),
                **{f: total(f, rows_dt4) for f in (
                    "ms", "plain_ms", "bound_ms", "library_ms")}},
        }
        if "registers" in rows["stage0"][key]:
            # by stage shape: registers per thread, shared memory per block,
            # resident blocks per SM
            row["occupancy"] = {stage: {f: r[key][f] for f in (
                "registers", "smem_bytes_per_block", "blocks_per_sm")}
                for stage, r in rows.items()}
        return row

    emit(kernels=[{
        "name": ss.FUSED_FWD, "route": "cuda",
        "source": "idee_tpu_torch/kernels/csrc/selective_scan.cu",
        "replaces": "idee_tpu/kernels/selective_scan.py:189",
        "launches": paths["train_mamba"][ss.FUSED_FWD],
        "launches_by_path": by_path(ss.FUSED_FWD),
        "max_abs_err": max(v["max_abs_err"] for v in fused.values()),
        # times per step: two stage-0 launches and one stage-1 launch
        "ms": per_step(fused, lambda r: r["ms"]),
        "plain_ms": per_step(fused, lambda r: r["plain_ms"]),
        "bound_ms": per_step(fused, lambda r: r["bound_ms"]),
        "bound_by": fused["stage0"]["bound_by"],
        "library_ms": None,
        # per step at the CERRA 512x832 crop (test_cerra's launches)
        "cerra_512x832": {
            "max_abs_err": max(v["max_abs_err"]
                               for v in fused_cerra.values()),
            "ms": per_step(fused_cerra, lambda r: r["ms"]),
            "plain_ms": per_step(fused_cerra, lambda r: r["plain_ms"]),
            "bound_ms": per_step(fused_cerra, lambda r: r["bound_ms"])},
    }, {
        # the custom VJP of the ported fused forward (XLA around the Pallas
        # linear scan in the TPU package)
        "name": ss.FUSED_BWD, "route": "cuda",
        "source": "idee_tpu_torch/kernels/csrc/selective_scan.cu",
        "replaces": "idee_tpu/kernels/selective_scan.py:288",
        "launches": paths["train_mamba"][ss.FUSED_BWD],
        "launches_by_path": by_path(ss.FUSED_BWD),
        "max_abs_err": max(v["max_abs_err"] for v in backward.values()),
        # times per train step: the backward of each forward launch
        "ms": per_step(backward, lambda r: r["ms"]),
        "plain_ms": per_step(backward, lambda r: r["plain_ms"]),
        "composition_ms": per_step(backward, lambda r: r["composition_ms"]),
        "bound_ms": per_step(backward, lambda r: r["bound_ms"]),
        "bound_by": backward["stage0"]["bound_by"],
        "library_ms": None,
    }, {
        "name": ss.LINEAR_SCAN, "route": "cuda",
        "source": "idee_tpu_torch/kernels/csrc/linear_scan.cu",
        "replaces": "idee_tpu/kernels/selective_scan.py:75",
        "launches": paths["train_mamba_dstate2"][ss.LINEAR_SCAN],
        "launches_by_path": by_path(ss.LINEAR_SCAN),
        "max_abs_err": max(r[d]["max_abs_err"] for r in scan.values()
                           for d in ("forward", "reverse")),
        # times per d_state=2 train step: three forward and three reverse
        # scans
        "ms": per_step(scan, lambda r: r["forward"]["ms"]
                       + r["reverse"]["ms"]),
        "plain_ms": per_step(scan, lambda r: r["forward"]["plain_ms"]
                             + r["reverse"]["plain_ms"]),
        "bound_ms": per_step(scan, lambda r: 2 * r["bound_ms"]),
        "bound_by": scan["stage0"]["bound_by"],
        "library_ms": None,
    },
        # library: scaled_dot_product_attention forward / its backward
        attn_row(wa.ATTN_FWD, "forward", 192, "train_swin"),
        attn_row(wa.ATTN_BWD, "backward", 240, "train_swin"),
        # library: torch.sum of the partials over the block axis
        attn_row(wa.DBIAS_SUM, "dbias_sum", 272, "train_swin"),
        # the bf16 kernels on the tensor cores (compute dtype "bfloat16");
        # library: SDPA on the same bf16 inputs
        attn_row(wa.ATTN_FWD_BF16, "forward", 192, "train_swin_bf16",
                 attn_bf16, attn_dt4["bfloat16"]),
        attn_row(wa.ATTN_BWD_BF16, "backward", 240, "train_swin_bf16",
                 attn_bf16, attn_dt4["bfloat16"]),
    ], card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
