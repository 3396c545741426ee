#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (quant_tpu_torch) on one GPU.

Drives the port's paths end to end on the card, the serving paths and
the chip-probe path:

1. prints the card's name and power limit (nvidia-smi) and builds the
   CUDA sources of quant_tpu_torch/csrc (xnor.cu, pool.cu, probe.cu)
   with nvcc (sm_90a), all at once;
2. holds each kernel against its plain PyTorch twin on the card: the
   serving kernels at the serving path's shapes and xnor_conv2d at the
   ragged CONV_CHECK_SHAPES; its multi-plane form (xnor_conv2d_planes)
   for every scheme pair of PLANE_X_SCHEMES x PLANE_W_SCHEMES at
   PLANES_CHECK_SHAPES (LeNet-5's conv2 added) and for every plane
   layout at PLANES_TILE_SHAPE, in bf16 and f32 out; the
   producer (pack_sign_planes) folded and unfolded, k = 1 to 4, at
   PLANES_PACK_SHAPES (PACK_CHECK_SHAPES and LeNet-5's conv2 input) with
   NaN and +-inf planted, offset views too;
   xnor_gemm at the ragged XNOR_GEMM_CHECK_SHAPES and at the layer4
   GEMM, the pool at POOL_CHECK_SHAPES (every load width, offset views)
   with NaN and +-inf planted, by a NaN-aware comparison; the probe
   kernels (add at the probe's shape, at the bandwidth shape
   ADD_BW_SHAPE and ragged; tiled wgmma matmul in bf16 and int8) at the
   probes' 4096^3, at a non-square shape and at K of one slice (TF32
   off everywhere);
3. the main path: builds the packed ls-1 XNOR ResNet-18 (224 px, 1000
   classes, the bench configuration of the JAX package) from seeded
   weights, prepares it with the port's own export, fold and strip,
   runs the bf16 chain at batch 128 and checks the launch counts (16
   xnor_conv2d, each with its block's tail, 16 producer, 1 pool per
   forward, no other kernel), then
   holds the fp32 chain on the card against the same model on the CPU,
   and holds xnor_conv2d (bf16 and f32 out) and the producer against
   their twins on every conv input the forward captured;
4. serves 16 requests through InferenceEngine on the card; then the API
   phase (API_PER_FORWARD's comment): the same model built through the
   package-level QResNet, its logits equal to the main path's and its
   launches counted (16 + 16 + 1 a forward), served through the
   package-level InferenceEngine;
   the grouped QAT block's step card against CPU and its packed-mode
   eval forward, which serves the dense conv as JAX's does; and a fresh
   interpreter's `import quant_tpu_torch.serving`, which must do no
   work; one JSON line {"api_phase": ...}; then the tail phase
   (TAIL_MODELS' comment): the served ResNet-18 and ResNet-50 with each
   block's tail in the binary convs' epilogue, their logits equal bit
   for bit to the eager chain's; one JSON line {"tail_phase": ...};
5. times each kernel, its plain twin and a library yardstick with CUDA
   events behind a head start (the card's time, not the host's launch
   time; the report's `call_ms` times each kernel back to back, host
   included), the add also at ADD_BW_SHAPE beside an empty launch, and
   the forward's images per second back to back (host included) and
   behind a head start sized from the back-to-back time (the card
   alone; not measured where the host still fell behind);
6. runs the serving stack (ResNet-18 of the main path, 224 px, 1000
   classes): (a) an in-process ServingFrontend over two InferenceEngines
   of the main-path model, 64 requests against predict, its launch counts
   read around it; (b) two engine worker processes of the spec
   WORKER_SPEC (spawn_engine_workers, an RPC secret) behind a frontend,
   64 requests against an in-process engine of the same spec, each
   worker's launch counts read from its stats; (c) one worker killed: it
   is evicted and the survivor serves the later requests;
7. runs the model phases (MODEL_PHASES), each with the launch counts
   zeroed just before its forward and checked just after, its fp32
   chain held against the CPU's and its forwards timed: ResNet-18 XNOR
   with ls-T x ls-1 (the int8 route through the multi-plane kernels;
   it also serves 16 requests), ls-2 x ls-1 under 'auto' (the bf16
   bake) and under sign_compute='int8', gf-2 x ls-1; the regular
   ls-1 ResNet-18 with the BN folded into the epilogue; the dense fp32
   twins of both (TF32 off); the regular_bottleneck ResNet-50 of
   cifar100_resnet50_ls2_tpu.yaml (ls-2 x ls-1, 32 px, 100 classes) and
   LeNet-5 ls-2 x ls-1 at 28 px, both as their recipes say, with
   per-batch scales (moving_average_mode 'off', opt_v1 exact); and
   ResNet-18 XNOR ls-2 x ls-1 'off' on the int8 route (OFF_PHASE: the
   multi-plane kernels under per-sample solved scales, its solves timed
   and held to the CPU's; the lloyd solve kernel held to its plain twin
   on the same inputs and both timed at LLOYD_BATCH). Each phase that
   launches the multi-plane conv (ls-T, ls-2 int8, and OFF_PHASE) holds
   it and the producer against their twins on its captured inputs and
   times them there: one kernels row a phase, with the registers and
   blocks an SM of the instance it takes;
8. runs the oracle phase (ORACLE_RUNS): apple/ml-quant's own small
   XNOR ResNet (ls-2 x ls-1) and LeNet-5 (ls-1 x ls-1) from
   tests/data_oracle, their state dicts imported through
   utils.torch_import onto the card: the dense forwards and the packed
   ones (the ResNet on the int8 route, 6 xnor_conv2d_planes and 6
   producers, and on JAX's 'auto' route, the bake; LeNet-5 1
   xnor_conv2d and 1 producer), launches read around each, held to the
   reference's logits (1e-3 dense, 5e-2 and equal argmax packed) and
   each kernel to its twin on the captured inputs; then the export ->
   import round trip (utils.torch_export) on the card;
9. calibrates the two recipe models (RECIPE_PHASES): EMA scales from
   four seeded batches on the card and on the CPU (held to
   CALIBRATION_REL_TOL), then folded, stripped and served;
10. trains (the train phase, TRAIN_CONFIGS): the QAT train step of the
   ImageNet KD recipes at full width (ResNet-18 XNOR student, 224 px,
   1000 classes, batch 256; a seeded regular fp ResNet-18 teacher in
   train mode; Adam under linear_lr, pure KD), after two checks: one
   step card against CPU in float32 (TRAIN_CPU_LIMITS) and remat on
   against off. Three configurations (ls-1 x ls-1 in float32; the same
   with bf16 train_dtype, remat and a bf16 teacher; the TPU recipe's
   ls-2 activations with lloyd solves) each take two warm-up and ten
   timed steps through make_train_step and train_epoch on one fixed
   seeded batch, one JSON line {"train_phase": ...} each (ms a step back
   to back and its split into forward, teacher, backward and optimizer
   by CUDA events, img/s, peak memory, the loss of each step, which must
   fall). The first trained student then runs evaluate (the stem pool
   kernel once a batch) and is calibrated, packed, folded, stripped and
   served through InferenceEngine (xnor_conv2d and the producer once a
   binary conv, the pool once; the packed float32 chain within 2% of
   the logit spread of its calibrated dense twin's, the served bf16
   logits within 5%);
11. runs the experiment phase, the port's entry point as users run it:
   the recipe drivers (quant_tpu_torch.examples) in process on the
   recipes' YAML files, cut as EXPERIMENT_MNIST and EXPERIMENT_IMAGENET
   say. (a) mnist_ls1.yaml on a seeded IDX-gz MNIST the phase writes:
   the experiment's files, --restore-experiment --skip-training equal to
   the last test.csv row, --auto-resume to checkpoint_4, serving.prepare
   --calibrate-dataset, the artifact served in process (its launches a
   forward), on the CPU and from an 'artifact' worker process; the
   loader's ms a step beside a fixed batch's and its idle share
   (torch.profiler); each worker's float32 logits are held to the CPU's
   (the worker serves with TF32 off) and bit for bit to an in-process
   engine. Then the pod phase: one DP train step of three small models
   (DP_STEP_CASES, BN and EMA statistics, one with remat) at a world of
   2 on gloo on the card, held to this process's step on the whole
   batch at the CPU test's step tolerance, with the local-statistics
   control shown to differ; the same recipe through
   PodComputePlatform on a smaller MNIST (POD_MNIST), a world of 1 on
   NCCL and a world of 2 on gloo (both ranks on the card), each equal
   to this process's run of the same logical batches, the ranks'
   metrics equal, and a world of 2 whose rank 1 gets SIGTERM (the gang
   stops at one step, one interrupt checkpoint). (b) The ImageNet KD
   pair at full width on the synthetic loader: the teacher
   imagenet_fp.yaml, then
   imagenet_ls1_kd.yaml from the teacher's config.yaml and checkpoint
   (the stem pool launched once an eval batch and once a step by the
   frozen teacher), the loaded teacher equal to its experiment's own
   model, serving.prepare --calibrate-synthetic, the artifact served as
   in (a) (16 xnor_conv2d, 16 pack_sign_planes, 1 pool a forward); one
   JSON line {"experiment_phase": ...};
12. runs the tensor-parallel phase (TP_WORLD's comment): a world of 2
   on gloo, both ranks on the card, mesh (1, 2), spawning
   `chip_smoke.py --tp-worker RANK PORT OUT SPEC` ranks: the packed
   ring GEMM (parallel.tp_packed_matmul_overlapped, xnor_gemm on each
   block) at the xnor_gemm row's shape against the twin, beside the
   naive form; the main path's ResNet-18 sharded over 'model' and
   served by the TP InferenceEngine against the unsharded engine, bf16
   and float32, its launches a forward a rank and its kernels on their
   captured O/P inputs; one TP train step against this process's and
   the summing-backward control; mnist_ls1.yaml at tensor_parallel 2
   through PodComputePlatform against tp = 1, restored at tp = 2 and 1;
   one JSON line {"tp_phase": ...};
13. runs the spatial phase (SPACE_WORLD's comment): the TP phase's
   served ResNet-18 banded over 'space' in a world of 2 on gloo (both
   ranks on the card, `chip_smoke.py --par-worker` ranks), served by the
   banded InferenceEngine against the unsharded engine, bf16 and
   float32, its launches a forward a rank and every kernel call of a
   banded forward against its twin on the same band, with the halo
   bytes a forward; and in this process the banded conv, multi-plane
   conv and pool at each band geometry of that path against their twins
   and the whole map's rows, and the raw-zero-edge control; then the
   pipeline phase (PIPE_STAGES' comment): layer1's packed blocks as two
   stages over 'pipe', equal to the blocks in sequence and to the eager
   chain, 2 xnor_conv2d (each with its block's tail) and 2 producers a
   stage a microbatch, and one step of JAX's quantized
   stage against the sequential one, with the summing-backward control;
   one JSON line {"spatial_phase": ...} and one {"pipeline_phase": ...};
14. runs the spatial train phase (SPACE_TRAIN's comment): the ls1_kd KD
   step of the ImageNet recipe's XNOR ResNet-18 banded over 'space' with
   its teacher banded alike, in a world of 2 on gloo, both ranks on the
   card, at batch 32 and 224 px: a float-activation step held to one
   process's (the loss within 2e-5, every gradient within 2e-4 of the
   largest, the step's float32 floor recorded), the three controls beyond
   1e-3 at 256 px, 1 + 3 ls1_kd steps within 2% of one process's loss
   with the ranks equal after every step and the sign flips a conv
   recorded, ms a step split by part, the collectives and bytes a step,
   peak memory a rank, the stem pool's calls on bands held to their twin
   (one launch a step), evaluate against the unsharded state, and the
   trained state packed and served banded against unsharded (16 + 16 +
   1 launches, every kernel call held to its twin); then remat under
   'space' (SPACE_REMAT_CONFIG's comment): the flagship TPU recipe
   ls2_ls1_kd_tpu banded with remat on and off, equal bit for bit at
   every step on both ranks, with ms, peak memory and the
   recomputation's collectives beside one process's, its state served
   banded on the int8 route (16 + 16 multi-plane launches, every call
   equal to its twin), the float-activation gate with remat and the
   remat_unbanded control; one JSON line {"spatial_train_phase": ...};
15. runs the probe path (the kernel probes, the cuBLAS bf16 and int8
   rates, the stem against its s2d form and the served model's batch
   sweep at 128 and 512) and checks that it launched each probe kernel.

Prints the card line, JSON lines {"api_phase": ...}, {"oracle_phase": ...},
{"experiment_phase": ...}, {"tp_phase": ...}, {"spatial_phase": ...},
{"pipeline_phase": ...}, {"spatial_train_phase": ...}, {"kernels": [...]}
and
{"probes": [...]}
and, last, {"ok": true, "device": {...}}. Any failed
phase raises and exits non-zero; without CUDA it exits 2 before printing
any result.

Usage: python3 chip_smoke.py [--batch 128] [--iters 10] [--seed 0]
                             [--report PATH]
"""

import argparse
import contextlib
import copy
import functools
import json
import os
import re
import subprocess
import sys
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from quant_tpu_torch.probes import models, train_profile
from quant_tpu_torch.probes.common import card_alone_ms, card_ms, tf32

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at 700 W
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak (2 ops/MAC)
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
DEVICE = 'cuda'

# tiled_matmul shapes (M, K, N) held against the twin; the first is the
# probes' and is also the one timed. Beside them, per type, K of one slice
# (half of one 128-byte stage in bf16, which TMA fills with zeros).
MATMUL_SHAPES = ((4096, 4096, 4096), (512, 1024, 384))
ONE_SLICE_SHAPES = {torch.bfloat16: (256, 32, 384), torch.int8: (256, 64, 384)}
# xnor_gemm shapes (M, K, N) held against the twin beside the layer4 GEMM
# (M = batch * 49, K = 4,608, N = 512): W = 1, 5 and 145 words (not a
# multiple of the 4 words a stage takes), K % 32 != 0 (pad bits), M and N
# off the 128x128 tile, N odd (unpaired stores). The same shapes hold the
# twin to JAX in tests/test_torch_port_ops.py.
XNOR_GEMM_CHECK_SHAPES = ((200, 20, 22), (200, 150, 22), (200, 100, 22),
                          (130, 160, 13), (256, 4640, 384))
ADD_SHAPE = (1024, 256)        # pallas_add's
# 805 MB moved, far past the 50 MB L2: bytes set the add's time there.
ADD_BW_SHAPE = (16384, 4096)
# Ragged xnor_conv2d cases held against the twin, beside the serving
# shapes: (N, H, W, C, O, k, stride, padding). Between them: C = 32, 33,
# 40, 70 (words with 1 and with 31 pad bits, and Wc of 1, 2 and 3, so
# every cp.async width of A); O = 5, 13, 22 and 96 (odd, 2 mod 4 and 0
# mod 4, so every cp.async width of B, and not a multiple of the
# 64-column tile); 7x7 inputs at stride 2; 1x1 with padding 0 (at
# stride 1 and 2); 5x5 with padding 2; batch 3; and M = N*OH*OW never a
# multiple of the 128-row tile.
CONV_CHECK_SHAPES = (
    (2, 9, 9, 32, 64, 3, 1, 1),
    (2, 9, 9, 33, 64, 3, 1, 1),
    (2, 9, 9, 64, 22, 3, 1, 1),
    (2, 8, 7, 40, 13, 3, 2, 1),
    (3, 7, 7, 70, 5, 3, 2, 1),
    (3, 7, 7, 512, 96, 3, 1, 1),
    (2, 14, 14, 64, 128, 1, 1, 0),
    (3, 14, 14, 128, 64, 1, 2, 0),
    (2, 11, 11, 96, 24, 5, 1, 2),
    (3, 15, 15, 128, 13, 3, 1, 1),
)
# Producer cases (N, H, W, C): ragged C on both of its paths (C % 8 == 0
# takes the 16-byte loads, with pad lanes when C % 32 != 0).
PACK_CHECK_SHAPES = ((2, 9, 9, 32), (2, 9, 9, 33), (2, 8, 7, 40),
                     (3, 7, 7, 70), (3, 5, 5, 8), (1, 3, 3, 520))
# The multi-plane forms at every CONV_CHECK_SHAPES case and LeNet-5's
# conv2 (12x12x20 -> 50, 5x5, no padding), for each activation scheme
# against each weight scheme but ls-1 x ls-1 (the single-plane kernel):
# two planes with one scale (ls-T), two or three with their own.
PLANES_CHECK_SHAPES = CONV_CHECK_SHAPES + ((3, 12, 12, 20, 50, 5, 1, 0),)
PLANE_X_SCHEMES = ('ls-1', 'ls-2', 'ls-T', 'gf-2', 'gf-3')
PLANE_W_SCHEMES = ('ls-1', 'ls-2', 'ls-T')
# The multi-plane kernel's tiles: 128, 64 and 32 pixels for 1, 2 and 3
# activation groups a pass, 64 channels. This shape fills several of each
# in M (338 pixels: 3, 6 and 11 tiles) and N (136 channels: 3), ragged
# at both edges, over Wc = 3. It runs every plane layout (planes, and
# planes a scale covers: `plane_layout`) against every weight scheme of
# PLANE_W_SCHEMES: activations of ls-1, ls-T, ls-2, gf-3, gf-4 (2 groups
# a pass, two passes) and gf-5 (3 a pass, the second with an idle group)
# against weights of ls-1, ls-T with a shared scale, and ls-2 (two
# planes with their own scales, as ls-T without w_planes_share_scale:
# two passes, the running sum between them).
PLANES_TILE_SHAPE = (2, 13, 13, 96, 136, 3, 1, 1)
PLANES_TILE_X_SCHEMES = ('ls-1', 'ls-T', 'ls-2', 'gf-3', 'gf-4', 'gf-5')
# Producer cases beside PACK_CHECK_SHAPES: LeNet-5's conv2 input.
PLANES_PACK_SHAPES = PACK_CHECK_SHAPES + ((3, 12, 12, 20),)
# Pool cases (N, H, W, C) held against the twin beside the serving map,
# NaN, +inf and -inf planted (`plant_specials`), each also as a view one
# element into its storage (the 2- or 4-byte route). C = 64, 8, 12, 3
# and 70 take every route of csrc/pool.cu: 16, 16, 8, 2 and 4 bytes a
# load in bf16, 16, 16, 16, 4 and 8 in f32. H or W of 2 is one output
# row or column (the -inf pad on both sides), 112 several row tiles and
# chunks of a row's items, 38 a ragged last row tile.
POOL_CHECK_SHAPES = ((1, 2, 2, 64), (2, 6, 6, 8), (3, 6, 112, 12),
                     (2, 112, 6, 3), (1, 6, 6, 70), (2, 2, 112, 70),
                     (1, 38, 10, 64))
# The load widths the pool checks must have taken, by dtype.
POOL_ROUTES = {torch.bfloat16: {16, 8, 4, 2}, torch.float32: {16, 8, 4}}
# The probe path: (module, probe, keyword arguments), in order.
PROBE_PHASE = (
    ('probe_r2', 'pallas_add', {}),
    ('probe_r2', 'pallas_matmul_bf16', {}),
    ('probe_r3', 'pallas_matmul_bf16_v2', {}),
    ('probe_r3', 'pallas_matmul_int8', {}),
    ('probe_r3', 'matmul_chain_bf16', {}),
    ('probe_r2', 'matmul_int8', {}),
    ('probe_r3', 'stem_vs_s2d_v2', {}),
    ('probe_r3', 'batch_sweep_model', {'batches': (128, 512)}),
)
PROBE_KERNELS = ('add_f32', 'tiled_matmul_bf16', 'tiled_matmul_int8')
# The kernels of the serving paths, launched by the model phases.
SERVING_KERNELS = ('xnor_conv2d', 'xnor_conv2d_planes', 'pack_sign_planes',
                   'max_pool_3x3_s2_p1', 'xnor_gemm')
# The per-sample solve's kernel, launched by lloyd solves only.
SOLVE_KERNELS = ('lloyd_solve_rows',)
# The binary convs' calls that carry a served block's tail
# (ops.binary_infer.Tail): one a binary conv of a folded ResNet served
# on the int8 route, unsharded and unbanded.
TAIL = 'xnor_conv2d_tail'
# Every counted kernel: a launch dict compares over all of them.
KERNELS = SERVING_KERNELS + PROBE_KERNELS + SOLVE_KERNELS + (TAIL,)
# Models of the model phases: key: (build(x_quant, w_quant, **kwargs),
# input (H, W, C), its QuantConv2d count, stem pool launches a forward).
PHASE_MODELS = {
    'resnet18': (models.bench_resnet18, (224, 224, 3), 16, 1),
    'resnet18_regular': (functools.partial(models.bench_resnet18,
                                           block='regular'),
                         (224, 224, 3), 16, 1),
    'resnet50': (models.resnet50_cifar, (32, 32, 3), 48, 0),
    'lenet': (models.lenet5, (28, 28, 1), 1, 0),
}
# The model phases, after the main path: (name, model, x_quant, w_quant,
# options, kernel launches per QuantConv2d). Each is seeded, prepared
# with the port's own export, fold and strip, and driven at the full
# batch in bf16 (the fp32 twins, inference_mode 'dense', in float32 with
# TF32 off, as bench.py's default_matmul_precision('highest')). Under
# 'auto', ls-T x ls-1 takes the int8 route through the multi-plane
# kernels (this slice's headline: the first phase); ls-2 and gf-2
# activations take the bf16 bake, no kernel of the port; regular ls-1
# the single-plane kernels. Activation scales are EMA ('eval_only')
# unless the options say 'off': the two recipes' models, as written, and
# OFF_PHASE solve every sample's scales per batch (the fp32 twins have
# no activation scales).
MODEL_PHASES = (
    ('resnet18_xnor_lsT_ls1', 'resnet18', 'ls-T', 'ls-1', {},
     {'xnor_conv2d_planes': 1, 'pack_sign_planes': 1, TAIL: 1}),
    ('resnet18_xnor_ls2_ls1', 'resnet18', 'ls-2', 'ls-1', {}, {}),
    ('resnet18_xnor_ls2_ls1_int8', 'resnet18', 'ls-2', 'ls-1',
     {'sign_compute': 'int8'},
     {'xnor_conv2d_planes': 1, 'pack_sign_planes': 1, TAIL: 1}),
    ('resnet18_xnor_gf2_ls1', 'resnet18', 'gf-2', 'ls-1', {}, {}),
    ('resnet18_regular_ls1', 'resnet18_regular', 'ls-1', 'ls-1', {},
     {'xnor_conv2d': 1, 'pack_sign_planes': 1, TAIL: 1}),
    ('resnet18_xnor_fp32', 'resnet18', 'fp', 'fp',
     {'inference_mode': 'dense'}, {}),
    ('resnet18_regular_fp32', 'resnet18_regular', 'fp', 'fp',
     {'inference_mode': 'dense'}, {}),
    ('resnet50_regular_bottleneck_ls2_ls1', 'resnet50', 'ls-2', 'ls-1',
     {'moving_average_mode': 'off'}, {}),
    ('lenet5_ls2_ls1', 'lenet', 'ls-2', 'ls-1',
     {'moving_average_mode': 'off'}, {}),
    ('resnet18_xnor_ls2_ls1_int8_off', 'resnet18', 'ls-2', 'ls-1',
     {'sign_compute': 'int8', 'moving_average_mode': 'off'},
     {'xnor_conv2d_planes': 1, 'pack_sign_planes': 1}),
)
# fp32 chain, card vs CPU: the binary convs, producers and pool are exact
# on both; the stem conv, BN, 1x1 shortcuts and head round differently
# (cuDNN vs CPU kernels, rsqrt), and an activation sitting within that
# rounding of its threshold flips its sign, moving the dots it feeds by
# 2; under per-batch scales ('off') such roundings also move the solved
# scales (see CALIBRATION_REL_TOL). Held to 2% of the logits' spread.
FP32_REL_TOL = 2e-2
# The model phase whose multi-plane kernels run under per-sample solved
# scales (the unfolded producer): held on its captured inputs, its solves
# timed and compared with the CPU's.
OFF_PHASE = 'resnet18_xnor_ls2_ls1_int8_off'
# The recipes' models, calibrated after the model phases: (PHASE_MODELS
# key, x_quant, w_quant, the recipe).
RECIPE_PHASES = (
    ('resnet50', 'ls-2', 'ls-1',
     'examples/cifar100/cifar100_resnet50_ls2_tpu.yaml'),
    ('lenet', 'ls-2', 'ls-1',
     'examples/mnist/mnist_ls1_weight_ls2_activation.yaml'),
)
CALIBRATION_BATCHES, CALIBRATION_BATCH = 4, 8
# Calibrated EMA, card vs CPU, relative. A per-sample solve takes the
# argmin of float32 closed-form costs, which are flat near the optimum
# to within their rounding, so an input a few ulps off (the card's cuDNN
# convs and reductions against the CPU's) moves v1 by far more than
# ulps (solve_phase measures the shift one ulp causes), and later layers
# see the flipped signs. The scales are statistics of that 'off' chain,
# whose logits are held to FP32_REL_TOL of their spread: the EMA is held
# to the same share.
CALIBRATION_REL_TOL = FP32_REL_TOL
# opt_v1 on the card against the CPU on the same rows: v1 within a few
# float32 ulps (the tests' tolerance against JAX), else a cost no higher
# than the CPU's v1's within 1e-5 of the row's norm.
SOLVE_TOL = dict(rtol=1e-5, atol=1e-6)
SOLVE_COST_TOL = 1e-5
SOLVE_CHECK_ROWS = 8  # samples of each conv input solved on both
# The lloyd solve kernel against its plain twin on the card, on OFF_PHASE's
# captured conv inputs with their samples repeated to LLOYD_BATCH rows (the
# flagship's 16 inputs at the KD cell's batch), ls-2 and ls-T, bf16 and
# float32: v1 within SOLVE_TOL, else its cost within SOLVE_COST_TOL of the
# twin's; ls-2's v2 within SOLVE_TOL where v1 is; two calls the same bits.
LLOYD_BATCH = 256
# The serving stack: requests a phase sends, and the worker spec
# (ResNet-18, 224 px, 1000 classes; the seed and device are added).
SERVING_REQUESTS = 64
WORKER_SPEC = {'model': 'resnet18_random', 'max_batch': 32,
               'input_shape': [224, 224, 3]}
# The train phase: the QAT train step of the ImageNet KD recipes at full
# width (probes.train_profile.CONFIGS: ResNet-18 XNOR student, 224 px,
# 1000 classes, batch 256, moving_average_mode 'off', Adam under
# linear_lr, pure KD from a frozen regular fp ResNet-18 teacher in train
# mode, seeded: no checkpoint).
TRAIN_CONFIGS = tuple(train_profile.CONFIGS)
# (student builder, teacher builder, input (H, W, C), classes).
TRAIN_MODELS = (models.bench_resnet18, models.imagenet_teacher,
                (224, 224, 3), 1000)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 256, 2, 10
# One step of the first configuration, card against CPU, float32 with
# TF32 off, on TRAIN_CHECK_BATCH images, from one set of weights. The
# card's cuDNN convs and reductions sum in another order than the CPU's,
# and an activation within that rounding of 0 flips its sign, which
# moves the dots it feeds by 2 v1 v_w and the gradients downstream by far
# more than the rounding: on the CPU alone, inputs one ulp apart move
# the loss by 1e-4, a BN statistic by 0.1% and the gradient of layer4's
# shortcut conv by 11%. Limits: the loss relative; the gradient over all
# leaves (relative norm of the difference), its median leaf and its
# worst leaf, a leaf's error over |cpu| + GRAD_FLOOR |all gradients| /
# GRAD_MEDIAN (a bias before a BN has a true gradient of 0 and holds
# noise); BN running statistics and w_vs relative to their largest
# element.
TRAIN_CHECK_BATCH = 4
TRAIN_CPU_LIMITS = dict(loss_rel=2e-3, grad_rel=0.1, grad_median=5e-2,
                        grad_worst=0.75, grad_floor=1e-3, stats_rel=3e-2,
                        w_vs_rel=1e-5)
# remat on against off on the card, the first configuration at this
# batch: the same forward, so the same loss (float32 rounding at most)
# and the same new state, bit for bit.
REMAT_CHECK_BATCH, REMAT_LOSS_REL = 32, 1e-6
# The eval step's batches; the trained student, calibrated on
# CALIBRATION_BATCHES batches of CALIBRATION_BATCH, serves
# TRAIN_SERVE_BATCH images. Its packed float32 chain on the card (the
# kernels, the threshold fold) is held to TRAIN_SERVE_REL_TOL of the
# logit spread of the calibrated twin's dense float32 eval forward
# (measured 2.9e-7). Its bf16 chain through InferenceEngine is held to
# TRAIN_SERVE_BF16_REL_TOL of that spread: bf16 rounding flips the
# signs of activations within an ulp of a threshold, as JAX's own bf16
# chain does (the port's equals it op by op), which puts it 1.93% (CPU,
# seeded init) to 2.16% (the card, trained) from float32; a fault in
# the route would be tens of %.
TRAIN_EVAL_BATCHES, TRAIN_SERVE_BATCH = 2, 4
TRAIN_SERVE_REL_TOL, TRAIN_SERVE_BF16_REL_TOL = FP32_REL_TOL, 5e-2
# The experiment phase (after the train phase): the port's recipe
# drivers (quant_tpu_torch.examples) run in process, main(argv), on the
# recipes under examples/ as written except for the cuts below, each
# written into a temporary copy of the YAML. (a) MNIST: mnist_ls1.yaml
# at its widths (LeNet-5, 20 and 50 filters, ls-1 x ls-1, 'off', Adadelta
# under step_lr, batch 64 / 5000) on a seeded dataset the phase writes in
# the IDX-gz format; cuts: epochs 10 -> 2, dataset_path,
# root_experiments_dir, tensorboard off. (b) ImageNet KD at full width:
# the teacher imagenet_fp.yaml, then imagenet_ls1_kd.yaml distilling
# from its checkpoint, both on the synthetic loader (224 px, 1000
# classes); cuts: epochs 100 and 240 -> 1, the data section. Each recipe
# is then prepared (serving.prepare, EMA calibration) and served from an
# 'artifact' worker process.
EXPERIMENT_MNIST = dict(recipe='examples/mnist/mnist_ls1.yaml', train=6000,
                        test=5000, epochs=2, name='mnist_ls1',
                        per_forward={'xnor_conv2d': 1,
                                     'pack_sign_planes': 1})
EXPERIMENT_IMAGENET = dict(
    teacher='examples/imagenet/imagenet_fp.yaml',
    student='examples/imagenet/imagenet_ls1_kd.yaml',
    data={'dataset': 'synthetic', 'image_shape': [224, 224, 3],
          'num_classes': 1000, 'train_size': 512, 'test_size': 256},
    epochs=1, calibrate_synthetic=4,
    per_forward={'xnor_conv2d': 16, 'pack_sign_planes': 16, TAIL: 16,
                 'max_pool_3x3_s2_p1': 1})
# Overrides of a recipe's sections beyond the cuts above, by recipe path
# ({section: {key: value}}): none on the card (the CPU rehearsal narrows
# the models and the batches here).
EXPERIMENT_OVERRIDES: dict = {}
EXPERIMENT_REQUESTS = 16
# A restored experiment's --skip-training eval against the last test.csv
# row of its run, relative (the same checkpoint, eval forward and batch).
EXPERIMENT_EVAL_REL_TOL = 1e-6
# Fixed-batch steps of the MNIST recipe's LeNet-5, timed beside the
# loader's steps; steps the profiler reads for the idle share.
EXPERIMENT_FIXED_STEPS, EXPERIMENT_PROFILE_STEPS = 20, 30
# The reference-checkpoint oracles: apple/ml-quant's own models (state
# dicts with warmed quantizer, EMA and BN buffers, an input, the
# reference's logits) in tests/data_oracle, imported through
# utils.torch_import and built as tests/nn/test_torch_import.py builds
# them. Held as there: dense within ORACLE_DENSE_TOL, packed within
# ORACLE_PACKED_TOL with equal argmax (allclose's atol = rtol = tol).
ORACLE_DIR = 'tests/data_oracle'
_ORACLE_LAYER = {'x_quant': 'ls-2', 'w_quant': 'ls-1',
                 'clamp': {'kind': 'symmetric', 'alpha': 2.0},
                 'double_shortcut': True}
ORACLES = {
    'resnet': dict(file='resnet_small_ls2_ls1.npz', num_blocks=[1, 1, 1],
                   config=dict(
                       block='xnor',
                       layer0={'n_in_channels': 8, 'kernel_size': 3,
                               'stride': 1, 'padding': 1, 'bias': False,
                               'maxpool': {'type': 'identity'}},
                       layer1=dict(_ORACLE_LAYER),
                       layer2=dict(_ORACLE_LAYER),
                       layer3=dict(_ORACLE_LAYER), layer4=None,
                       nonlins=['prelu', 'prelu'], num_blocks=[1, 1, 1],
                       output_classes=10, moving_average_mode='eval_only',
                       solver_mode='reference')),
    'lenet': dict(file='lenet_ls1_ls1.npz', conv2_filters=12, config=dict(
        conv1_filters=8, conv2_filters=12, output_classes=10,
        x_quant='ls-1', w_quant='ls-1', clamp={'kind': 'identity'},
        moving_average_mode='eval_only', solver_mode='reference')),
}
ORACLE_DENSE_TOL, ORACLE_PACKED_TOL = 1e-3, 5e-2
# (oracle, inference_mode, sign_compute, launches of the forward). The
# ResNet's three XNOR blocks hold two binary convs each: on the int8
# route, one producer (k = 2, ls-2) and one multi-plane conv a conv; on
# JAX's 'auto' route ls-2 x ls-1 takes the bf16 bake, PyTorch ops only,
# and its stem has no pool. LeNet-5's one binary conv (ls-1 x ls-1)
# takes the ls-1 conv on 'auto'. The dense forwards launch nothing.
ORACLE_RUNS = (
    ('resnet', 'dense', 'auto', {}),
    ('resnet', 'packed', 'int8', {'xnor_conv2d_planes': 6,
                                  'pack_sign_planes': 6}),
    ('resnet', 'packed', 'auto', {}),
    ('lenet', 'dense', 'auto', {}),
    ('lenet', 'packed', 'auto', {'xnor_conv2d': 1, 'pack_sign_planes': 1}),
)
# The pod phase: the MNIST recipe (EXPERIMENT_MNIST) through
# PodComputePlatform on a smaller seeded MNIST (POD_MNIST images: 20
# steps of the recipe's batch 64, one epoch), as a world of 1 on NCCL and
# a world of 2 on gloo with both ranks on the one card (NCCL refuses two
# ranks on one card), each against this process's single-process run of
# the same logical batches (the ranks' shards in rank order); then a
# world of 2 preempted: SIGTERM to rank 1 once checkpoint_3 exists, its
# third epoch (checkpoint_2 to checkpoint_3: 20 steps, the eval, the
# checkpoint) timed beside the single-process epoch.
POD_MNIST = dict(train=1280, test=1000, epochs=1, preempt_epochs=50)
POD_RUNS = ((1, None), (2, 'gloo'))
POD_TIMEOUT = 300
# The pod phase's runs, pods and this process's alike, take cuDNN's
# deterministic algorithms (pod_worker.DETERMINISTIC_ENV): with the
# default ones one process's run of this recipe against itself moves
# its test loss by several % in 20 steps (the phase measures it:
# 'default_cudnn_spread'): their backward sums in a run-dependent order,
# and the binary net's sign flips and Adadelta's near-constant early
# steps carry ulps that far. Deterministic, a run repeats itself.
POD_DETERMINISTIC = True
# Pod against the single-process run, {world: {part: (loss, relative;
# accuracies, in examples of the part's set)}}. A world of 1 is the
# single process's program on its batches: equal. A world of 2 sums its
# BN statistics, gradients and metrics as per-rank partial sums over
# half batches (other cuDNN shapes), a float32 order of its own, which
# the sign flips carry along the trajectory: the train metrics, a mean
# over the epoch's steps, stay close; the final model's test metrics
# move further (on an H100 80GB HBM3 at 700 W: train loss 1.7e-3, 3 and
# 3 examples of 1,280; test loss 3.5e-2, 2 and 0 examples of 1,000).
# These limits check the pod's plumbing end to end; a band this wide
# would not by itself catch a data-parallel fault such as statistics
# left local. The DP step below is the gate for that on the card.
POD_LIMITS = {1: {'train': (0.0, 0), 'test': (0.0, 0)},
              2: {'train': (1e-2, 12), 'test': (1e-1, 10)}}
# The DP step on the card: a world of 2 on gloo, both ranks on the card,
# each on half of one seeded batch of DP_STEP_BATCH, takes one train step
# with a mesh; its gradients, updated variables (params, BN statistics,
# EMA scales), loss and metrics are held to one step of this process on
# the whole batch at the CPU test's step tolerance
# (tests/test_torch_port_dp.py STEP_TOL: the global batch's sums taken as
# two partial sums, a few ulps). The cases are that test's: a LeNet-5
# with BatchNorm (float activations into its conv2), a small XNOR ResNet
# (BatchNorm and EMA activation scales) and the same ResNet with each
# block rematerialized. The control: the same ranks with their
# statistics left local move the BN running statistics by more than
# DP_LOCAL_MIN_DIFF from the whole batch's, so the gate can fail.
DP_STEP_CASES = {
    'lenet': ('lenet', 'fp', 'ls-1', 'nll_loss', (28, 28, 1), {}),
    'xnor_resnet': ('xnor', 'ls-1', 'ls-1', 'cross_entropy', (32, 32, 3),
                    {}),
    'xnor_resnet_remat': ('xnor', 'ls-1', 'ls-1', 'cross_entropy',
                          (32, 32, 3), {'remat': True})}
DP_STEP_BATCH, DP_STEP_WORLD = 8, 2
DP_STEP_TOL = dict(rtol=2e-5, atol=2e-6)
# cuDNN off for the DP step's convs, in the ranks and here alike: the
# step compares two ways of summing the same rows, and on the card
# cuDNN's deterministic weight-gradient algorithm for the LeNet-5's
# conv1 (one input channel, 5x5) at 8 rows lands 9.2e-4 of the
# gradient's largest entry from the float64 value, as two halves of 4
# rows 2.1e-7 (on an H100 80GB HBM3 at 700 W; the phase records both as
# 'cudnn_wgrad'), which alone moves that gradient past DP_STEP_TOL.
# PyTorch's own convs (cuBLAS, TF32 off) sum within 2e-7 at both sizes.
DP_STEP_CUDNN = False
DP_LOCAL_MIN_DIFF = 1e-3
# The tensor-parallel phase (tp_phase): a world of TP_WORLD ranks on gloo
# with every rank on the card (NCCL refuses two ranks on one card), mesh
# (1, TP_WORLD). (a) The packed ring GEMM at the xnor_gemm row's shape
# (M, K, N), each rank on its K/P words, held equal to the plain twin on
# the whole operands, beside the naive form (the whole local partial,
# then one all-reduce). (b) The main-path ResNet-18 sharded over 'model'
# and served by the TP InferenceEngine (TP_SERVING['batch'] images a
# forward: gloo moves the gathered maps through host memory, so a small
# batch keeps them short), against the unsharded engine: the float32
# chain (TF32 off) within JAX's TP test tolerance, the bf16 chain within
# TP_BF16_REL_TOL of the logit spread (a sharded cuDNN stem may take
# another algorithm, and a flipped sign cascades), the captured kernels
# equal to their twins at the O/P shapes. (c) One TP train step of
# TP_STEP_CASES (cuDNN off, as the DP step) within DP_STEP_TOL of this
# process's step, the summing-backward control beyond
# TP_SUMMING_MIN_DIFF; then the MNIST recipe at tensor_parallel TP_WORLD
# through PodComputePlatform on TP_POD_MNIST (4 steps of 64, the 4 steps
# of JAX's test_tp_task.py) against the same run at tp = 1 in this
# process, its checkpoint restored at TP_WORLD and at 1 and evaluated
# against the run's own test loss, all within TP_POD_LIMITS.
TP_WORLD = 2
TP_RING_SHAPE = (6272, 4608, 512)
TP_SERVING = dict(model='resnet18', batch=32, input=[224, 224, 3],
                  classes=1000, per_forward={
                      'xnor_conv2d': 16, 'pack_sign_planes': 16,
                      'max_pool_3x3_s2_p1': 1})
TP_ITERS = 5
TP_F32_TOL = dict(rtol=1e-4, atol=1e-4)
TP_BF16_REL_TOL = 2e-2
TP_SUMMING_MIN_DIFF = 1e-3
# The TP step's cases: DP_STEP_CASES' models with float activations into
# their binary-weight convs. With binary activations the card cannot
# hold a TP step to one process's: the stem conv sharded to O/P channels
# rounds its float32 sums in another order (4.8e-7 from O's, cuDNN off),
# one sign of layer1's binary activations flips and the flips cascade
# (TP_FLIP_CASE is measured beside the gate, not gated). The CPU test
# (tests/test_torch_port_tp.py) holds the binary-activation cases, where
# the sums agree, to the same 2e-5.
TP_STEP_CASES = {
    'lenet': DP_STEP_CASES['lenet'],
    'xnor_resnet_fp': ('xnor', 'fp', 'ls-1', 'cross_entropy', (32, 32, 3),
                       {}),
    'xnor_resnet_fp_remat': ('xnor', 'fp', 'ls-1', 'cross_entropy',
                             (32, 32, 3), {'remat': True})}
TP_FLIP_CASE = 'xnor_resnet'
TP_POD_MNIST = dict(train=256, test=1000, epochs=1)
# Relative loss limits of the TP pod: JAX's rtol (test_tp_task.py) on
# the train and test losses against tp = 1 and on the restored
# evaluations against the run's. The pods run cuDNN's deterministic
# algorithms, so a card repeats its figures (H100 80GB HBM3, 700 W: train
# 5.5e-5, test 3.8e-4). The recipe's binary conv2 feeds a 2x2 max pool
# whose windows hold tied values that a float order can break the other
# way, so other hardware moves further (the CPU: test 4.4e-3).
TP_POD_LIMITS = {'train': 2e-3, 'test': 2e-3, 'restored': 2e-3}

# The spatial phase (spatial_phase): a world of SPACE_WORLD on gloo with
# both ranks on the card, mesh ('space',), spawning `chip_smoke.py
# --par-worker RANK PORT OUT SPEC` ranks. The TP phase's served model
# (TP_SERVING: the main path's ResNet-18 at full width and depth, 224 px,
# batch 32) banded over 'space' (parallel.band_model) and served by the
# banded InferenceEngine, bf16 then float32, against the unsharded engine
# (the TP phase's gates: float32 within TP_F32_TOL, bf16 within
# TP_BF16_REL_TOL of the logit spread); the launches a forward a rank
# (TP_SERVING's: at 224 px over two bands the stem, the pool and
# layer1-3 run on bands, layer4 on the gathered map); every kernel call
# of the first banded forward held to its twin on the same band; the
# halo bytes a forward. In this process: the banded kernels at each
# band geometry of that path (BAND_CONVS, the multi-plane conv at
# BAND_PLANES, the stem pool at BAND_POOL_SHAPE with NaN and +-inf
# planted), each band cut from a whole map with the rows its halo
# exchange brings, against the twin on the band and the whole map's
# rows; and the control: raw activations exchanged with zero-filled
# edge rows (JAX's fill for an fp conv) into the binary conv must differ
# from the whole map's result.
SPACE_WORLD = 2
# (C in, H of the whole map, stride) of each banded 3x3 binary conv's
# input: layer1; layer2's first conv and the rest; layer3's.
BAND_CONVS = ((64, 56, 1), (64, 56, 2), (128, 28, 1), (128, 28, 2),
              (256, 14, 1))
BAND_PLANES = (64, 56, 1)  # ls-2 x ls-1 int8: two activation planes
BAND_CHECK_BATCH = 4
BAND_POOL_SHAPE = (4, 112, 112, 64)
# The pipeline phase (pipeline_phase): the same world over mesh
# ('pipe',), S = PIPE_STAGES. (a) layer1's two packed XnorBasicBlocks of
# that ResNet-18 as the two stages (torch.func.functional_call over each
# block's parameters and buffers, bf16, threshold-folded), its batch as
# PIPE_MICROBATCHES microbatches of its layer1 input: the outputs equal
# to the blocks applied in sequence and, bit for bit, to the blocks with
# every tail run by the eager ops (the stages are folded, unsharded,
# unbanded blocks: their binary convs take the block's tail), 2
# xnor_conv2d with their tails and 2 producers a stage a microbatch. (b)
# One step of JAX's quantized stage
# (tests/parallel/test_pipeline.py:90-113: ls-1 activations and weights
# by the STE, a 3x3 conv, x + tanh) at PIPE_STEP, float32 with cuDNN off
# as the DP step: the stacked weights' gradients within PIPE_STEP_TOL of
# the sequential composition's, the summing-backward control beyond
# PIPE_SUMMING_MIN_DIFF, both relative to the gradient's largest element
# (the pipeline sums its microbatches' weight gradients, the sequential
# step one batch's, in other orders).
PIPE_STAGES = 2
PIPE_MICROBATCHES = 4
PIPE_STEP = dict(microbatches=4, rows=8, hw=16, channels=16)
PIPE_STEP_TOL = 1e-5
PIPE_SUMMING_MIN_DIFF = 1e-3
PAR_ITERS = 5
# The spatial train phase (spatial_train_phase): the QAT train step of the
# ImageNet KD recipe's student banded over 'space' (parallel.band_model),
# its frozen teacher banded alike, in a world of SPACE_WORLD on gloo with
# both ranks on the card (`--par-worker` ranks, phase 'space_train'),
# float32 with TF32 off and cuDNN's deterministic algorithms, as the
# pods. Each rank steps on its row band of
# the same SPACE_TRAIN['batch'] seeded images (local_band: 112 rows of
# 224; the stem, the pool and layer1-3 on bands, layer4 and the head on
# the gathered map), and takes one process's step on the whole images
# too, from the same seeded weights (train_profile.build's). (a) The gate:
# one KD step of each SPACE_STEP_CASES student (the XNOR ResNet-18 at
# full width with float activations into ls-1 weights: binary
# activations flip their sign under another float order, TP_STEP_CASES'
# reason) within SPACE_STEP_LOSS_RTOL of one process's loss and, on every
# gradient, within SPACE_STEP_GRAD_TOL of the largest gradient. A band
# sums in another float32 order than the whole map: the sound banded
# steps read 5.39e-5 (224 px) and 3.66e-5 (256 px), and one process's own
# step with cuDNN off against it with cuDNN on 5.75e-5 and 4.06e-5 (the
# float32 floor, recorded each run beside the gate as
# floor_grad_rel_err); the smallest control reads 4.17e-3 (NVIDIA H100
# 80GB HBM3, 700 W). The limit sits between the two; the
# first case again at SPACE_TRAIN['control_input'] (256 px: layer4 bands
# too, so the average pool reduces the bands), under the same gate, and
# under each of SPACE_CONTROLS (space_control) beyond
# SPACE_CONTROL_MIN_DIFF of one process's. (b)
# train_profile's SPACE_KD_CONFIG (ls-1 x ls-1, the recipe's Adam):
# SPACE_TRAIN['warmup'] + ['steps'] steps banded and in one process, the
# ranks' variables equal after every step, each step's loss within
# SPACE_KD_LOSS_RTOL of one process's, the sign flips of each binary
# conv's input at the first step recorded; for the timed steps ms a step
# a rank split by part (CUDA events at make_train_step's phase_hook)
# beside one process's (each rank's one-process run alone on the card,
# the other rank waiting), the collectives a step by kind and their bytes,
# the peak memory a rank beside one process's, and the stem pool's
# launches (one a step: the teacher's, on its band), every call of the
# last step held to its twin. (c) evaluate of the trained state on
# SPACE_TRAIN['eval_images'] through the banded loaders against the same
# state unsharded: the logits within TP_F32_TOL.
SPACE_TRAIN = dict(model='resnet18', batch=32, input=[224, 224, 3],
                   control_input=[256, 256, 3], classes=1000, warmup=1,
                   steps=3, eval_images=64)
SPACE_STEP_CASES = {'xnor_resnet18_fp_ls1': ('fp', 'ls-1')}
SPACE_STEP_LOSS_RTOL = 2e-5
SPACE_STEP_GRAD_TOL = 2e-4
SPACE_CONTROLS = ('summing_avg_pool', 'no_space_sum', 'local_statistics',
                  'remat_unbanded')
# A control's student options beside the case's: remat_unbanded needs a
# recomputation to take the banded state from.
SPACE_CONTROL_OPTIONS = {'remat_unbanded': {'remat': True}}
SPACE_CONTROL_MIN_DIFF = 1e-3
SPACE_KD_CONFIG = 'ls1_kd'
SPACE_KD_LOSS_RTOL = 2e-2
# Remat under 'space', parts (d)-(g) of the spatial train phase. (d)
# train_profile's SPACE_REMAT_CONFIG (the flagship TPU recipe: ls-2
# activations with lloyd solves, ls-1 weights, bf16 train_dtype, remat,
# the bf16 teacher, Adam under linear_lr) banded over SPACE_WORLD ranks
# from one seeded state and batch, with remat on and off in
# SPACE_REMAT_ROUNDS, SPACE_TRAIN['warmup'] + ['steps'] steps each, the
# student also built with SPACE_REMAT_OPTIONS (the serving route, which
# training does not read): on each rank the loss, a sha256 of every gradient and one of
# the new variables equal bit for bit, remat on against off, at every
# step, and the ranks' variables equal after every step; ms a step, its
# split, peak memory, the collectives a step by kind (the recomputation's
# apart) and the stem pool's launches (one a step, the teacher's, every
# call of the last step equal to its twin), beside one process's run of
# each alone on the card (rank 0, the other rank waiting). (e) The state
# (d) trained with remat, packed and served banded on the int8 route
# against the same state served unsharded: SPACE_REMAT_SERVE launches a
# forward a rank (the recipe serves 'off': each conv's lloyd solve on the
# gathered samples), the producer at k = 2, every call equal to its twin,
# the float32 logits within TP_F32_TOL, bf16 within TP_BF16_REL_TOL of
# the spread. (f) Each SPACE_STEP_CASES student with remat, banded,
# under (a)'s gate against one process's remat step. (g) The
# remat_unbanded control among SPACE_CONTROLS, at control_input.
SPACE_REMAT_CONFIG = 'ls2_ls1_kd_tpu'
# Remat on, off, off, on: a drift of the shared host's speed cancels in
# each setting's mean (two processes on one card are host-bound); the
# first round of each is the one recorded and compared bit for bit, the
# last one's state is served.
SPACE_REMAT_ROUNDS = ('on', 'off', 'off', 'on')
SPACE_REMAT_OPTIONS = {'sign_compute': 'int8'}
SPACE_REMAT_SERVE = {'xnor_conv2d_planes': 16, 'pack_sign_planes': 16,
                     'max_pool_3x3_s2_p1': 1, 'lloyd_solve_rows': 16}

# The API phase (api_phase): (a) the main path's ResNet-18
# (seeded_serving_resnet18) built through the package-level
# quant_tpu_torch.nn.QResNet from bench_resnet18's arguments, seeded and
# prepared as the main path's: its bf16 logits equal to the main-path
# model's on the same input, API_PER_FORWARD launches a forward, then
# served (serve(): 16 requests through the package-level
# quant_tpu_torch.serving.InferenceEngine); (b) the grouped QAT block
# (API_GROUPED: a conv of 2 groups, BN, a depthwise conv, BN, the
# residual; ls-1 weights; ls-1 and then fp activations): one SGD step (lr
# API_LR) on the card against the same step on the CPU in float32 (TF32
# off, device.full_precision), the loss and every gradient within
# API_STEP_TOL of the largest gradient, each tensor of the new state
# (parameters, BN statistics, w_vs) within API_STEP_TOL of its own
# largest value, a parameter also within the step of the gradients'
# allowance (API_LR x API_STEP_TOL x the largest gradient: a conv bias
# before BN has a gradient of float noise alone), then its eval forward
# under inference_mode='packed', which serves the dense conv as JAX's
# does (no kernel launch), within API_STEP_TOL of the CPU's; (c) a fresh
# interpreter's `import quant_tpu_torch.serving` loads no kernel
# library, starts no process, opens no socket and no process group.
API_PER_FORWARD = {'xnor_conv2d': 16, 'pack_sign_planes': 16, TAIL: 16,
                   'max_pool_3x3_s2_p1': 1}
API_GROUPED = dict(batch=4, size=16, channels=16, x_quants=('ls-1', 'fp'))
API_STEP_TOL = 2e-5
API_LR = 0.1


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A kernel in one namespace as ptxas names it (`_ZN<ns><name>...`),
    demangled to its name and template arguments (`name<bf16,1,2,1>`)."""
    m = re.match(r'_ZN(\d+)', mangled)
    if m is None:
        return mangled
    at = m.end() + int(m.group(1))
    n = re.match(r'\d+', mangled[at:])
    if n is None:
        return mangled
    at += n.end()
    name, rest = mangled[at:at + int(n.group())], mangled[at + int(n.group()):]
    if not rest.startswith('I'):
        return name
    spell = {'f': 'f32', '13__nv_bfloat16': 'bf16'}
    args = re.findall(r'13__nv_bfloat16|L[ib]\d+E|f',
                      rest[1:rest.find('EE') + 1])
    return f'{name}<{",".join(spell.get(a, a[2:-1]) for a in args)}>'


def kernel_resources(log: str) -> dict[str, dict[str, int]]:
    """{kernel: registers, spill stores and loads in bytes} from nvcc's
    -Xptxas -v report."""
    out: dict[str, dict[str, int]] = {}
    func = None
    for line in log.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            func = kernel_name(m.group(1))
            out[func] = {}
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m and func:
            out[func].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers', line)
        if m and func:
            out[func]['registers'] = int(m.group(1))
    return out


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def valid_taps(size: int, out: int, stride: int, pad: int, k: int) -> int:
    """Sum over output positions of the kernel taps inside the input."""
    return sum(sum(0 <= o * stride - pad + i < size for i in range(k))
               for o in range(out))


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor,
                nan_ok: bool = False) -> float:
    """Raises unless got equals want element for element; returns the
    largest difference over the elements finite in both (0.0). With
    nan_ok, NaN must stand where want has NaN and nowhere else, and the
    other elements must be equal (torch.equal counts NaN unequal to
    itself, and NaN payloads may differ, so bits are not compared)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f'{name}: {got.shape}/{got.dtype} vs '
                             f'{want.shape}/{want.dtype}')
    if nan_ok:
        nan = want.isnan()
        if not torch.equal(got.isnan(), nan):
            raise AssertionError(f'{name}: NaN positions differ from the '
                                 f'plain twin\'s')
        got, want = got[~nan], want[~nan]
    both = got.isfinite() & want.isfinite()
    err = ((got[both].double() - want[both].double()).abs().max().item()
           if both.any() else 0.0)
    if not torch.equal(got, want):
        raise AssertionError(f'{name}: kernel differs from its plain twin '
                             f'(max abs err {err})')
    return err


def plant_specials(x: torch.Tensor, seed: int) -> torch.Tensor:
    """x with NaN, +inf and -inf written in place at one element in 64
    (at least three), chosen from `seed`, and -inf over rows and columns
    0-1 of channel 0, a window of the pool that holds -inf alone."""
    flat = x.view(-1)
    k = max(3, flat.numel() // 64)
    pos = np.random.default_rng(seed).choice(flat.numel(), k, replace=False)
    vals = torch.tensor([float('nan'), float('inf'), float('-inf')])
    flat[torch.from_numpy(pos).to(x.device)] = vals.repeat(k // 3 + 1)[
        :k].to(x.device, x.dtype)
    x[:, :2, :2, 0] = float('-inf')
    return x


def launch_counts() -> dict[str, int]:
    """This process's kernel launch counts, as _build counts them (the
    CPU rehearsal stands in its own: a CPU tensor launches no kernel)."""
    from quant_tpu_torch import _build

    return _build.launch_counts()


def pool_route(x: torch.Tensor, out: torch.Tensor) -> int:
    """The load width in bytes that csrc/pool.cu's launcher takes from x
    to out, held equal to ops/pool.py's `vector_bytes`."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.ops import pool as P

    lib = _build.load('pool', P._SIGNATURES)
    got = lib.qtt_max_pool_vector_bytes(x.shape[-1] * x.element_size(),
                                        _build.ptr(x), _build.ptr(out))
    want = P.vector_bytes(x.shape[-1], x.element_size(), x.data_ptr(),
                          out.data_ptr())
    if got != want:
        raise AssertionError(f'pool route {got} bytes, vector_bytes says '
                             f'{want}')
    return got


def kernel_phases(batch: int, gen: torch.Generator) -> dict[str, float]:
    """Each kernel against its plain twin at the serving path's shapes;
    returns {kernel: max abs error}."""
    from quant_tpu_torch.ops import binary_gemm as G
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops.conv import max_pool2d
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1

    dev = DEVICE

    def words(*shape: int) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    def rand(*shape: int, dtype: torch.dtype = torch.float32
             ) -> torch.Tensor:
        return torch.randn(shape, generator=gen).to(dev, dtype)

    errs = {}
    conv_err = 0.0
    for hw, cin, cout, stride in ((56, 64, 64, 1), (56, 64, 128, 2),
                                  (7, 512, 512, 1)):
        x = words(batch, hw, hw, cin // 32)
        w = words(3, 3, cin // 32, cout)
        n = torch.ones(batch, device=dev)
        o = torch.ones(cout, device=dev)
        kw = dict(in_channels=cin, stride=stride, padding=1)
        conv_err = max(conv_err, check_equal(
            f'xnor_conv2d int dot {hw}x{cin}->{cout}/s{stride}',
            B.xnor_conv2d(x, w, n, o, None, **kw),
            B.xnor_conv2d_plain(x, w, n, o, None, **kw)))
        vx = rand(batch).abs() + 0.1
        vw = rand(cout).abs() * 0.05 + 0.01
        bias = rand(cout)
        for dt in (torch.bfloat16, torch.float32):
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d epilogue {dt} {hw}x{cin}->{cout}/s{stride}',
                B.xnor_conv2d(x, w, vx, vw, bias, out_dtype=dt, **kw),
                B.xnor_conv2d_plain(x, w, vx, vw, bias, out_dtype=dt,
                                    **kw)))
    # Random words: pad bits are random too, and must add nothing.
    for n, h, w_, c, o, k, s, p in CONV_CHECK_SHAPES:
        wc = -(-c // 32)
        x, w = words(n, h, w_, wc), words(k, k, wc, o)
        kw = dict(in_channels=c, stride=s, padding=p)
        what = f'xnor_conv2d {(n, h, w_, c, o, k, s, p)}'
        ones_n = torch.ones(n, device=dev)
        ones_o = torch.ones(o, device=dev)
        conv_err = max(conv_err, check_equal(
            f'{what} int dot', B.xnor_conv2d(x, w, ones_n, ones_o, None, **kw),
            B.xnor_conv2d_plain(x, w, ones_n, ones_o, None, **kw)))
        vx, vw, bias = rand(n).abs() + 0.1, rand(o).abs() * 0.05, rand(o)
        for dt in (torch.bfloat16, torch.float32):
            conv_err = max(conv_err, check_equal(
                f'{what} {dt}',
                B.xnor_conv2d(x, w, vx, vw, bias, out_dtype=dt, **kw),
                B.xnor_conv2d_plain(x, w, vx, vw, bias, out_dtype=dt, **kw)))
    errs['xnor_conv2d'] = conv_err

    # Random words, pad bits included. The kernel and the twin do the
    # same float32 ops in the same order on an exact integer dot (the
    # twin's float32 matmul with TF32 off is exact below 2^24), so any
    # difference is a fault.
    gemm_err = 0.0
    for m, k, n_out in XNOR_GEMM_CHECK_SHAPES + ((batch * 49, 4608, 512),):
        a, bt = words(m, -(-k // 32)), words(-(-k // 32), n_out)
        ones_m, ones_n = torch.ones(m, device=dev), torch.ones(n_out,
                                                                device=dev)
        vx, vw = rand(m).abs() + 0.1, rand(n_out).abs() + 0.1
        for sx, sw, what in ((ones_m, ones_n, 'unit scales'),
                             (vx, vw, 'scaled')):
            gemm_err = max(gemm_err, check_equal(
                f'xnor_gemm {(m, k, n_out)} {what}',
                G.xnor_gemm(a, bt, sx, sw, k),
                G.xnor_gemm_plain(a, bt, sx, sw, k)))
    errs['xnor_gemm'] = gemm_err

    # The producer at k = 1 (ls-1) at the serving path's shapes; its
    # ragged shapes and k > 1 are planes_kernel_phases'.
    pack_err = 0.0
    for dt in (torch.bfloat16, torch.float32):
        for hw, c in ((56, 64), (28, 128), (7, 512)):
            x = rand(batch, hw, hw, c, dtype=dt)
            t = rand(c) * 0.5
            flip = torch.where(rand(c) < -0.5, -1.0, 1.0)
            x[:, 0, 0] = t.to(dt)  # values on the rounded threshold
            pack_err = max(pack_err, check_equal(
                f'pack_sign_planes {dt} {hw}x{c} k=1',
                B.pack_sign_planes(x, 1, None, t, flip),
                B.pack_sign_planes_plain(x, 1, None, t, flip)))
    errs['pack_sign_planes'] = pack_err

    pool_err = 0.0
    routes: dict[torch.dtype, set[int]] = {}
    for dt in (torch.bfloat16, torch.float32):
        x = rand(batch, 112, 112, 64, dtype=dt)
        pool_err = max(pool_err, check_equal(
            f'max_pool_3x3_s2_p1 {dt}', max_pool_3x3_s2_p1(x),
            max_pool2d(x, kernel_size=3, stride=2, padding=1)))
        cases = [((batch, 112, 112, 64), plant_specials(x, 0), '')]
        for i, shape in enumerate(POOL_CHECK_SHAPES):
            x = plant_specials(rand(*shape, dtype=dt), i + 1)
            # The same values one element into a buffer: contiguous, but
            # off 16 bytes, so the narrowest route of the dtype.
            view = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:]
            cases += [(shape, x, ''),
                      (shape, view.view(shape).copy_(x), ' offset view')]
        for shape, xin, where in cases:
            got = max_pool_3x3_s2_p1(xin)
            routes.setdefault(dt, set()).add(pool_route(xin, got))
            pool_err = max(pool_err, check_equal(
                f'max_pool_3x3_s2_p1 {dt} {shape}{where} NaN/inf', got,
                max_pool2d(xin, kernel_size=3, stride=2, padding=1),
                nan_ok=True))
    if routes != POOL_ROUTES:
        raise AssertionError(f'pool routes {routes}, expected {POOL_ROUTES}')
    print(f'pool routes checked (bytes a load): '
          f'{ {str(k): sorted(v) for k, v in routes.items()} }')
    errs['max_pool_3x3_s2_p1'] = pool_err
    torch.cuda.synchronize()
    return errs


def plane_layout(scheme: str) -> tuple[int, int]:
    """(sign planes, planes a scale covers) of a scheme, as the int8
    route passes them to the multi-plane conv: ls-T's two planes share
    one scale (weights with w_planes_share_scale)."""
    from quant_tpu_torch.ops import binary_infer as B

    return B.sign_planes(scheme), 2 if scheme == 'ls-T' else 1


def planes_kernel_phases(gen: torch.Generator) -> dict[str, float]:
    """The multi-plane producer and conv against their plain twins:
    every scheme pair of PLANE_X_SCHEMES x PLANE_W_SCHEMES at
    PLANES_CHECK_SHAPES and of PLANES_TILE_X_SCHEMES x PLANE_W_SCHEMES
    at PLANES_TILE_SHAPE, in bf16 and f32 out, with a scale of its own
    for every plane group (a swapped plane or scale shows); the producer
    folded and unfolded, k = 1 to 4 (each plane count of the wide
    kernel's instances), bf16 and f32 input, NaN and +-inf planted, as
    given and as an offset view (off 16 bytes, so the scalar path).
    Returns {kernel: max abs error}."""
    from quant_tpu_torch.ops import binary_infer as B

    dev = DEVICE

    def rand(*shape: int, dtype: torch.dtype = torch.float32
             ) -> torch.Tensor:
        return torch.randn(shape, generator=gen).to(dev, dtype)

    def words(*shape: int) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    cases = [(xs, ws, shape) for xs in PLANE_X_SCHEMES
             for ws in PLANE_W_SCHEMES for shape in PLANES_CHECK_SHAPES]
    cases += [(xs, ws, PLANES_TILE_SHAPE) for xs in PLANES_TILE_X_SCHEMES
              for ws in PLANE_W_SCHEMES]
    conv_err = 0.0
    for xs, ws, (n, h, w_, c, o, k, s, p) in cases:
        if xs == ws == 'ls-1':
            continue
        (k_a, xg), (k_w, wg) = plane_layout(xs), plane_layout(ws)
        wc = -(-c // 32)
        x, w = words(k_a, n, h, w_, wc), words(k_w, k, k, wc, o)
        vx = rand(k_a // xg, n).abs() + 0.1
        vw = rand(k_w // wg, o).abs() * 0.05 + 0.01
        bias = rand(o)
        kw = dict(in_channels=c, x_group=xg, w_group=wg, stride=s,
                  padding=p)
        for dt in (torch.bfloat16, torch.float32):
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d_planes {xs} x {ws} '
                f'{(n, h, w_, c, o, k, s, p)} {dt}',
                B.xnor_conv2d_planes(x, w, vx, vw, bias, out_dtype=dt,
                                     **kw),
                B.xnor_conv2d_planes_plain(x, w, vx, vw, bias,
                                           out_dtype=dt, **kw)))
    pack_err = 0.0
    for i, shape in enumerate(PLANES_PACK_SHAPES):
        n, c = shape[0], shape[-1]
        for dt in (torch.bfloat16, torch.float32):
            x = plant_specials(rand(*shape, dtype=dt), i)
            t = rand(c) * 0.5
            flip = torch.where(rand(c) < -0.5, -1.0, 1.0)
            x[0, 0, 0] = t.to(dt)  # values on the rounded threshold
            view = torch.empty(x.numel() + 1, dtype=dt, device=dev)[1:]
            view = view.view(shape).copy_(x)
            for k in (1, 2, 3, 4):
                va = rand(k, c).abs() * 0.3 + 0.2
                vs = rand(k, n).abs() * 0.3 + 0.2
                for xin, where in ((x, ''), (view, ' offset view')):
                    for mode, args in (('folded', (va, t, flip)),
                                       ('unfolded', (vs,))):
                        pack_err = max(pack_err, check_equal(
                            f'pack_sign_planes {dt} {shape} k={k} {mode}'
                            f'{where}', B.pack_sign_planes(xin, k, *args),
                            B.pack_sign_planes_plain(xin, k, *args)))
    torch.cuda.synchronize()
    return {'xnor_conv2d_planes': conv_err, 'pack_sign_planes': pack_err}


def probe_kernel_phases(gen: torch.Generator) -> dict[str, float]:
    """The probe kernels against their plain twins; returns {kernel: max
    abs error}. add and int8 must be equal. bf16 on random positive
    values may differ by one ulp: both sum in float32 but in another
    order (the tensor cores' f32 sums round differently from cuBLAS's
    f32 GEMM), so a sum near a rounding boundary can round either way;
    with no cancellation the f32 error stays below 2*K*2^-24 relative,
    well under one bf16 ulp (2^-8). On integer values whose sums are
    exact in float32 (|sum| < 2^24) bf16 must be equal too."""
    from quant_tpu_torch.probes import kernels as PK

    dev = DEVICE
    errs = {}
    add_err = 0.0
    # (1001, 37): a float past the last whole float4, which the same
    # launch adds.
    for shape in (ADD_SHAPE, ADD_BW_SHAPE, (1000, 37), (1001, 37)):
        x = torch.randn(shape, generator=gen).to(dev)
        y = torch.randn(shape, generator=gen).to(dev)
        add_err = max(add_err, check_equal(
            f'add {shape}', PK.add(x, y), PK.add_plain(x, y)))
    # A view one element into its storage takes the 4-byte loads.
    xv, yv = x.view(-1)[1:], y.view(-1)[1:]
    add_err = max(add_err, check_equal(
        'add offset view', PK.add(xv, yv), PK.add_plain(xv, yv)))
    errs['add_f32'] = add_err

    bf_err = i8_err = 0.0
    for m, k, n in MATMUL_SHAPES + (ONE_SLICE_SHAPES[torch.bfloat16],):
        a = torch.rand(m, k, generator=gen).to(dev, torch.bfloat16)
        b = torch.rand(k, n, generator=gen).to(dev, torch.bfloat16)
        got, want = PK.tiled_matmul(a, b), PK.tiled_matmul_plain(a, b)
        ulps = PK.bf16_ulps(got, want)
        if got.shape != (m, n) or got.dtype != torch.bfloat16 or ulps > 1:
            raise AssertionError(f'tiled_matmul bf16 {(m, k, n)}: '
                                 f'{ulps} ulps from its plain twin')
        bf_err = max(bf_err, (got.float() - want.float()).abs().max().item())
        a = torch.randint(-8, 9, (m, k), generator=gen).to(
            dev, torch.bfloat16)
        b = torch.randint(-8, 9, (k, n), generator=gen).to(
            dev, torch.bfloat16)
        bf_err = max(bf_err, check_equal(
            f'tiled_matmul bf16 integer-valued {(m, k, n)}',
            PK.tiled_matmul(a, b), PK.tiled_matmul_plain(a, b)))
    for m, k, n in MATMUL_SHAPES + (ONE_SLICE_SHAPES[torch.int8],):
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        b = torch.randint(-128, 128, (k, n), generator=gen,
                          dtype=torch.int8).to(dev)
        i8_err = max(i8_err, check_equal(
            f'tiled_matmul int8 {(m, k, n)}', PK.tiled_matmul(a, b),
            PK.tiled_matmul_plain(a, b)))
    errs['tiled_matmul_bf16'] = bf_err
    errs['tiled_matmul_int8'] = i8_err
    torch.cuda.synchronize()
    return errs


def time_probe_kernels(iters: int) -> list[dict]:
    """The probe kernels at the probes' shapes: kernel, plain twin and
    library ms, and the bound."""
    from quant_tpu_torch.probes import kernels as PK

    gen = torch.Generator().manual_seed(2)
    adds = []
    for shape in (ADD_SHAPE, ADD_BW_SHAPE):
        x = torch.randn(shape, generator=gen).to(DEVICE)
        y = torch.randn(shape, generator=gen).to(DEVICE)
        nb = 3 * x.numel() * 4
        b, by = bound_ms(nb, x.numel(), FP32_OPS_PER_S)
        adds.append(dict(
            ms=card_ms(lambda: PK.add(x, y), iters),
            call_ms=card_ms(lambda: PK.add(x, y), iters, head_start_ms=0),
            plain_ms=card_ms(lambda: PK.add_plain(x, y), iters),
            library_ms=card_ms(lambda: torch.add(x, y), iters),
            bound_ms=b, bound_by=by, bytes=nb, ops=x.numel(),
            shape=list(shape)))
        del x, y
    # The card time of a launch of a kernel that does nothing: the floor
    # under the add and torch.add at the probe's 3 MB.
    rows = [dict(name='add_f32', **adds[0], bandwidth=adds[1],
                 empty_launch_ms=card_ms(lambda: torch.cuda._sleep(0),
                                         iters))]
    m, k, n = MATMUL_SHAPES[0]
    for dt, peak, lib in ((torch.bfloat16, BF16_OPS_PER_S, torch.matmul),
                          (torch.int8, INT8_OPS_PER_S, torch._int_mm)):
        if dt == torch.int8:
            a = torch.randint(-128, 128, (m, k), generator=gen,
                              dtype=dt).to(DEVICE)
            bm = torch.randint(-128, 128, (k, n), generator=gen,
                               dtype=dt).to(DEVICE)
        else:
            a = torch.randn(m, k, generator=gen).to(DEVICE, dt)
            bm = torch.randn(k, n, generator=gen).to(DEVICE, dt)
        nb = (m * k + k * n + m * n) * a.element_size()
        b, by = bound_ms(nb, 2 * m * n * k, peak)
        name = 'tiled_matmul_' + ('int8' if dt == torch.int8 else 'bf16')
        rows.append(dict(
            name=name,
            ms=card_ms(lambda: PK.tiled_matmul(a, bm), iters),
            call_ms=card_ms(lambda: PK.tiled_matmul(a, bm), iters,
                            head_start_ms=0),
            plain_ms=card_ms(lambda: PK.tiled_matmul_plain(a, bm), iters),
            library_ms=card_ms(lambda: lib(a, bm), iters),
            bound_ms=b, bound_by=by, bytes=nb, ops=2 * m * n * k,
            shape=[m, k, n]))
    # cuBLASLt's int8 kernels take B column-major; the same values so
    # stored, for the report only (the yardstick above takes the kernel's
    # own row-major inputs).
    bcol = bm.t().contiguous().t()
    rows[-1]['library_b_col_major_ms'] = card_ms(
        lambda: torch._int_mm(a, bcol), iters)
    return rows


def probe_phase() -> tuple[list[dict], dict[str, int]]:
    """Runs PROBE_PHASE on the card with the launch counts zeroed just
    before; returns the probes' records and the counts just after."""
    import importlib

    from quant_tpu_torch import _build
    from quant_tpu_torch.probes import common

    probes = [(getattr(importlib.import_module(
        f'quant_tpu_torch.probes.{mod}'), 'PROBES')[name], kw)
        for mod, name, kw in PROBE_PHASE]
    common.RECORDS.clear()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for fn, kw in probes:
        fn(device=DEVICE, **kw)
    torch.cuda.synchronize()
    launches = launch_counts()
    records = list(common.RECORDS)
    missing = [k for k in PROBE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f'probe path never launched {missing}')
    for row in records:
        if row.get('correct') is False:
            raise AssertionError(f'probe result wrong: {row}')
        for key in ('tflops', 'tops', 'ips', 'ms'):
            if key in row and not (np.isfinite(row[key]) and row[key] > 0):
                raise AssertionError(f'probe rate not positive: {row}')
    if not any(r['probe'] == 'pallas_add' and r['correct']
               for r in records):
        raise AssertionError('pallas_add did not report a correct add')
    return records, launches


def capture_conv_inputs(model: torch.nn.Module) -> tuple[list, list]:
    """Forward pre-hooks that record each QuantConv2d's input and the
    block's tail it was handed (None where it took none), as (conv,
    input, tail)."""
    from quant_tpu_torch.nn.layers import QuantConv2d
    seen: list = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kw: seen.append((mod, args[0], kw.get('tail'))),
        with_kwargs=True)
        for m in model.modules() if isinstance(m, QuantConv2d)]
    return seen, hooks


def tail_as(tail: Any, dtype: torch.dtype) -> Any:
    """A captured tail (ops.binary_infer.Tail or None) for a conv of
    `dtype` out: its residual cast to dtype (the BN's raw input too)."""
    if tail is None or tail.residual is None:
        return tail
    return tail._replace(residual=tail.residual.to(dtype))


def tail_bytes(tail: Any) -> int:
    """The bytes a conv's tail adds to its traffic: the residual it
    reads."""
    if tail is None or tail.residual is None:
        return 0
    return tail.residual.numel() * tail.residual.element_size()


def captured_phases(conv_inputs: list) -> dict[str, float]:
    """The producer and xnor_conv2d against their twins on every conv
    input the forward captured: the real block inputs, thresholds, words,
    scales, biases and tails, the conv in bf16 and f32 out; returns
    {kernel: max abs error}."""
    from quant_tpu_torch.ops import binary_infer as B

    pack_err = conv_err = 0.0
    for i, (conv, xin, tail) in enumerate(conv_inputs):
        fold = (None, conv.x_thresh, conv.x_flip)
        for x in (xin, xin.float()):
            pack_err = max(pack_err, check_equal(
                f'pack_sign_planes captured {i} {x.dtype}',
                B.pack_sign_planes(x, 1, *fold),
                B.pack_sign_planes_plain(x, 1, *fold)))
        words = B.pack_sign_planes_plain(xin, 1, *fold)[0]
        args = (words, conv.w_packed[0].contiguous(), conv.x_quantizer(xin)[0],
                conv.w_scales[0], conv.bias)
        kw = dict(in_channels=xin.shape[-1], stride=conv.stride,
                  padding=conv.padding)
        for dt in (torch.bfloat16, torch.float32):
            t = tail_as(tail, dt)
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d captured {i} {dt}',
                B.xnor_conv2d(*args, out_dtype=dt, tail=t, **kw),
                B.xnor_conv2d_plain(*args, out_dtype=dt, tail=t, **kw)))
    _sync()
    return {'pack_sign_planes': pack_err, 'xnor_conv2d': conv_err}


def time_kernels(model: torch.nn.Module, x: torch.Tensor,
                 conv_inputs: list, iters: int) -> list[dict]:
    """Per kernel, summed over the launches of one forward at the path's
    shapes, xnor_conv2d with each conv's tail: kernel, plain twin and
    library ms (the conv alone), and the bound (the residual's read
    counted)."""
    from quant_tpu_torch.ops import binary_gemm as G
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops.conv import max_pool2d
    from quant_tpu_torch.ops.packing import packed_width, unpack_signs
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1

    dt = model.eval_dtype
    rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       bytes=0.0, ops=0.0, call_ms=0.0, shape_ms=[])
            for name in ('xnor_conv2d', 'pack_sign_planes')}

    def kernel(row: dict, fn: Callable[[], Any]) -> None:
        # Card time per call, and (call_ms) back to back, host included.
        t = card_ms(fn, iters)
        row['ms'] += t
        row['shape_ms'].append(t)
        row['call_ms'] += card_ms(fn, iters, head_start_ms=0)

    shapes = []
    for conv, xin, tail in conv_inputs:
        n, h, w, c = xin.shape
        wc = packed_width(c)
        fold = (None, conv.x_thresh, conv.x_flip)
        vx = conv.x_quantizer(xin)[0]
        wp = conv.w_packed[0].contiguous()
        vw = conv.w_scales[0]
        s = conv.stride
        words = B.pack_sign_planes(xin, 1, *fold)[0]
        r = rows['pack_sign_planes']
        kernel(r, lambda: B.pack_sign_planes(xin, 1, *fold))
        r['plain_ms'] += card_ms(
            lambda: B.pack_sign_planes_plain(xin, 1, *fold), iters)
        nb = xin.numel() * xin.element_size() + 8 * c + words.numel() * 4
        r['bytes'] += nb
        r['bound_ms'] += bound_ms(nb, 2 * xin.numel(), FP32_OPS_PER_S)[0]

        kw = dict(in_channels=c, stride=s, padding=1, out_dtype=dt,
                  tail=tail)
        out = B.xnor_conv2d(words, wp, vx, vw, conv.bias, **kw)
        oh, ow, o = out.shape[1:]
        r = rows['xnor_conv2d']
        kernel(r, lambda: B.xnor_conv2d(words, wp, vx, vw, conv.bias, **kw))
        r['plain_ms'] += card_ms(
            lambda: B.xnor_conv2d_plain(words, wp, vx, vw, conv.bias, **kw),
            iters)
        xs = unpack_signs(words, c, dtype=dt).permute(0, 3, 1, 2)
        ws = B.unpack_weights_int8(wp, c, dtype=dt).permute(3, 2, 0, 1)
        xs = xs.contiguous(memory_format=torch.channels_last)
        ws = ws.contiguous(memory_format=torch.channels_last)
        r['library_ms'] += card_ms(
            lambda: F.conv2d(xs, ws, stride=s, padding=1), iters)
        macs = n * o * c * valid_taps(h, oh, s, 1, 3) * valid_taps(
            w, ow, s, 1, 3)
        nb = (words.numel() + wp.numel()) * 4 + 4 * (n + 2 * o) \
            + out.numel() * out.element_size() + tail_bytes(tail)
        r['bytes'] += nb
        r['ops'] += 2 * macs
        r['bound_ms'] += bound_ms(nb, 2 * macs, INT8_OPS_PER_S)[0]
        shapes.append([n, h, w, c, o, s])
    for r in rows.values():
        r['bound_by'] = ('bytes' if r['bytes'] / HBM_BYTES_PER_S
                         >= r['ops'] / INT8_OPS_PER_S else 'operations')
    rows['pack_sign_planes']['library_ms'] = None

    with torch.inference_mode():
        stem = torch.relu(model.bn1(model.conv1(x.to(dt), dt), dt))
    stem_nchw = stem.permute(0, 3, 1, 2)
    pooled = max_pool_3x3_s2_p1(stem)
    nb = (stem.numel() + pooled.numel()) * stem.element_size()
    b, by = bound_ms(nb, 8 * pooled.numel(), FP32_OPS_PER_S)
    rows['max_pool_3x3_s2_p1'] = dict(
        ms=card_ms(lambda: max_pool_3x3_s2_p1(stem), iters),
        call_ms=card_ms(lambda: max_pool_3x3_s2_p1(stem), iters,
                        head_start_ms=0),
        plain_ms=card_ms(lambda: max_pool2d(stem, kernel_size=3, stride=2,
                                            padding=1), iters),
        library_ms=card_ms(lambda: F.max_pool2d(stem_nchw, 3, 2, 1), iters),
        bound_ms=b, bound_by=by, bytes=nb, ops=8 * pooled.numel())

    gen = torch.Generator().manual_seed(1)
    m, k, n_out = x.shape[0] * 49, 4608, 512
    a = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, k // 32), generator=gen,
                      dtype=torch.int32).to(DEVICE)
    bt = torch.randint(-2 ** 31, 2 ** 31 - 1, (k // 32, n_out),
                       generator=gen, dtype=torch.int32).to(DEVICE)
    vx, vw = torch.rand(m).to(DEVICE), torch.rand(n_out).to(DEVICE)
    a16 = unpack_signs(a, k, dtype=torch.bfloat16)
    b16 = unpack_signs(bt.t(), k, dtype=torch.bfloat16).t()
    nb = (a.numel() + bt.numel() + m + n_out + m * n_out) * 4
    b, by = bound_ms(nb, 2 * m * n_out * k, INT8_OPS_PER_S)
    rows['xnor_gemm'] = dict(
        ms=card_ms(lambda: G.xnor_gemm(a, bt, vx, vw, k), iters),
        call_ms=card_ms(lambda: G.xnor_gemm(a, bt, vx, vw, k), iters,
                        head_start_ms=0),
        plain_ms=card_ms(lambda: G.xnor_gemm_plain(a, bt, vx, vw, k), iters),
        library_ms=card_ms(lambda: torch.matmul(a16, b16), iters),
        bound_ms=b, bound_by=by, bytes=nb, ops=2 * m * n_out * k,
        shape=[m, k, n_out])
    rows['xnor_conv2d']['shapes'] = shapes
    return [dict(name=name, **row) for name, row in rows.items()]


def serve(model: torch.nn.Module, seed: int,
          input_shape: tuple[int, ...] = (224, 224, 3),
          classes: int = 1000) -> dict:
    """16 requests through InferenceEngine on the card, against predict."""
    from quant_tpu_torch.serving import InferenceEngine

    images = np.random.default_rng(seed).standard_normal(
        (16,) + tuple(input_shape)).astype(np.float32)
    engine = InferenceEngine(model, input_shape, max_batch=16,
                             max_wait_ms=5.0, device=DEVICE)
    engine.warmup([16])
    # All 16 are queued before the scheduler starts, so it serves them as
    # one batch of 16: the batch predict() runs, hence the same kernels.
    futures = [engine.submit(img) for img in images]
    engine.start()
    try:
        got = np.stack([f.result(timeout=120) for f in futures])
    finally:
        engine.stop()
    want = engine.predict(images)
    if not np.isfinite(got).all() or got.shape != (16, classes):
        raise AssertionError(f'served logits bad: {got.shape}')
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    stats = engine.stats
    if stats['requests'] != 16 or stats['batches'] != 1:
        raise AssertionError(f'unexpected engine stats {stats}')
    return dict(requests=16, batches=stats['batches'],
                latency_ms=stats['latency_ms'],
                max_abs_err=float(np.abs(got - want).max()))


def fp32_against_cpu(model: torch.nn.Module, cpu_model: torch.nn.Module,
                     x: torch.Tensor) -> tuple[float, float]:
    """The model's float32 chain on the card (TF32 off) against the same
    model on the CPU, on x: (max abs error, logit spread); raises beyond
    FP32_REL_TOL of the spread."""
    dt, model.eval_dtype = model.eval_dtype, None
    with torch.inference_mode(), tf32(False):
        got = model(x).cpu()
        want = cpu_model(x.cpu())
    model.eval_dtype = dt
    spread = (want.max() - want.min()).item()
    err = (got - want).abs().max().item()
    if not err <= FP32_REL_TOL * spread:
        raise AssertionError(f'fp32 chain disagrees with the CPU model: '
                             f'max abs err {err}, spread {spread}')
    return err, spread


def _ms_or_not(ms: Optional[float], calls: int) -> str:
    if ms is None:
        return 'not measured: the host fell behind'
    return f'{ms} ms over {calls} calls'


def model_phase(name: str, build: str, x_quant: str, w_quant: str,
                options: dict, per_conv: dict[str, int], batch: int,
                iters: int, seed: int) -> tuple[dict, torch.nn.Module, list]:
    """One model phase: seed and prepare the model on the CPU, copy it to
    the card, drive one forward at `batch` with the launch counts zeroed
    just before and read just after (each kernel `per_conv` times a
    QuantConv2d, the stem pool where the model has one, nothing else),
    hold its fp32 chain against the CPU's at batch 4, and time its
    forwards back to back and on the card alone. Returns (record, the
    card model, the (conv, input) pairs the forward captured)."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.nn.layers import QuantConv2d

    make, hwc, n_convs, pools = PHASE_MODELS[build]
    dense = options.get('inference_mode') == 'dense'
    cpu_model = models.seeded_model(
        make, x_quant, w_quant, 'cpu', seed, **{
            'moving_average_mode': 'off' if dense else 'eval_only',
            **options})
    convs = sum(isinstance(m, QuantConv2d) for m in cpu_model.modules())
    if convs != n_convs:
        raise AssertionError(f'{name}: {convs} QuantConv2d, not {n_convs}')
    model = copy.deepcopy(cpu_model).to(DEVICE)
    model.eval_dtype = None if dense else torch.bfloat16
    x = torch.randn((batch,) + hwc, generator=torch.Generator().manual_seed(
        seed)).to(DEVICE)
    want = {k: 0 for k in KERNELS}
    want.update({k: v * n_convs for k, v in per_conv.items()})
    want['max_pool_3x3_s2_p1'] = pools
    seen, hooks = capture_conv_inputs(model)
    # The bf16 chains' only float32 convs are the bake's and fp
    # activations', whose bf16 operands TF32 takes exactly; the fp32
    # twins run with TF32 off.
    with tf32(not dense):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with torch.inference_mode():
            logits = model(x)
        torch.cuda.synchronize()
        launches = launch_counts()
    for h in hooks:
        h.remove()
    if launches != want:
        raise AssertionError(f'{name}: launches {launches}, expected {want}')
    classes = logits.shape[-1]
    if logits.shape[0] != batch or not logits.isfinite().all():
        raise AssertionError(f'{name}: bad logits {tuple(logits.shape)}')
    err, spread = fp32_against_cpu(model, cpu_model, x[:4])
    with tf32(not dense), torch.inference_mode():
        ms = card_ms(lambda: model(x), iters, head_start_ms=0)
        ms_card, card_calls = card_alone_ms(lambda: model(x), iters, ms)
    record = dict(name=name, x_quant=x_quant, w_quant=w_quant,
                  dtype='float32' if dense else 'bfloat16', batch=batch,
                  input=list(hwc), classes=classes, launches={
                      k: v for k, v in launches.items() if v},
                  ms_per_forward=ms, images_per_s=batch / ms * 1e3,
                  ms_per_forward_card=ms_card, card_alone_calls=card_calls,
                  fp32_max_abs_err=err,
                  fp32_spread=spread, **options)
    print(f'{name}: {ms} ms/forward, {batch / ms * 1e3} img/s (card alone '
          f'{_ms_or_not(ms_card, card_calls)}); launches '
          f'{record["launches"]}; fp32 vs CPU {err} (spread {spread})',
          flush=True)
    return record, model, seen


def _producer_args(conv: torch.nn.Module, xin: torch.Tensor
                   ) -> tuple[torch.Tensor, tuple]:
    """The producer's input and (scales, thresh, flip) as the int8 route
    takes them for a conv's captured input: folded, the raw input with
    the per-channel va and thresholds; unfolded, clamp(x) with the
    batch's per-sample scales (solved here again under 'off')."""
    if conv.x_thresh is not None:
        return xin, (conv.x_va, conv.x_thresh, conv.x_flip)
    xc = conv.clamp_fn()(xin).contiguous()
    return xc, (conv.x_quantizer(xc),)


def planes_captured(seen: list) -> dict[str, float]:
    """The multi-plane producer and conv against their twins on every
    conv input a multi-plane forward captured (folded, or unfolded with
    per-sample scales), the conv in bf16 and f32 out; returns {kernel:
    max abs error}."""
    from quant_tpu_torch.ops import binary_infer as B

    pack_err = conv_err = 0.0
    for i, (conv, xin, tail) in enumerate(seen):
        k = B.sign_planes(conv.x_quant)
        xp, args = _producer_args(conv, xin)
        for x in (xp, xp.float()):
            pack_err = max(pack_err, check_equal(
                f'pack_sign_planes captured {i} {x.dtype}',
                B.pack_sign_planes(x, k, *args),
                B.pack_sign_planes_plain(x, k, *args)))
        conv_args, kw = _planes_conv_args(conv, xin)
        for dt in (torch.bfloat16, torch.float32):
            t = tail_as(tail, dt)
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d_planes captured {i} {dt}',
                B.xnor_conv2d_planes(*conv_args, out_dtype=dt, tail=t, **kw),
                B.xnor_conv2d_planes_plain(*conv_args, out_dtype=dt, tail=t,
                                           **kw)))
    torch.cuda.synchronize()
    return {'pack_sign_planes': pack_err, 'xnor_conv2d_planes': conv_err}


def _planes_conv_args(conv: torch.nn.Module, xin: torch.Tensor
                      ) -> tuple[tuple, dict]:
    """The multi-plane conv's arguments for a conv's captured input, as
    the int8 route builds them (the words from the plain producer)."""
    from quant_tpu_torch.ops import binary_infer as B

    k = B.sign_planes(conv.x_quant)
    xg = 2 if conv.x_quant == 'ls-T' else 1
    wp = conv.w_packed.contiguous()
    wg = 2 if conv.w_quant == 'ls-T' and wp.shape[0] == 2 else 1
    xp, args = _producer_args(conv, xin)
    words = B.pack_sign_planes_plain(xp, k, *args)
    vx = conv.x_quantizer(xp)[:k // xg]
    vw = conv.w_scales[:wp.shape[0] // wg]
    return ((words, wp, vx, vw, conv.bias),
            dict(in_channels=xin.shape[-1], x_group=xg, w_group=wg,
                 stride=conv.stride, padding=conv.padding))


def occupancy(out_dtype: torch.dtype, *layout: int) -> dict[str, int]:
    """Registers a thread and blocks an SM of the conv kernel that the
    plane layout (ga, pa, gw, pw) launches (none: the ls-1 conv), from
    the card's occupancy query."""
    from quant_tpu_torch.ops import binary_infer as B

    regs, blocks = B.conv_occupancy(out_dtype, *layout)
    return dict(registers=regs, blocks_per_sm=blocks)


def time_planes_kernels(seen: list, iters: int) -> tuple[dict, dict]:
    """The multi-plane conv and the producer of k planes summed over the
    launches of one forward at the captured inputs (bf16 out): card ms,
    plain twin ms, the bound, max of bytes / HBM rate and 2*MACs*scale-
    group pairs / the int8 peak, and the conv kernel's registers and
    blocks an SM. Where the scheme pair has one
    pair of scale groups (ls-T x ls-1), F.conv2d bf16 on the merged
    {-2, 0, 2} / {-1, 1} operands, channels-last, computes the same dots
    in one call and is the library yardstick; with more (ls-2), no one
    PyTorch call computes the sum of scaled terms and library_ms is None.
    Returns (the conv's kernel row, the producer's timings)."""
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops.packing import unpack_signs

    rows = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       bytes=0.0, ops=0.0, call_ms=0.0, shape_ms=[])
            for name in ('xnor_conv2d_planes', 'pack_sign_planes')}

    def kernel(row: dict, fn: Callable[[], Any]) -> None:
        t = card_ms(fn, iters)
        row['ms'] += t
        row['shape_ms'].append(t)
        row['call_ms'] += card_ms(fn, iters, head_start_ms=0)

    pairs = layout = None
    for conv, xin, tail in seen:
        n, h, w, c = xin.shape
        k = B.sign_planes(conv.x_quant)
        xp, args = _producer_args(conv, xin)
        r = rows['pack_sign_planes']
        kernel(r, lambda: B.pack_sign_planes(xp, k, *args))
        r['plain_ms'] += card_ms(
            lambda: B.pack_sign_planes_plain(xp, k, *args), iters)
        words = B.pack_sign_planes(xp, k, *args)
        nb = (xp.numel() * xp.element_size()
              + 4 * sum(a.numel() for a in args) + words.numel() * 4)
        r['bytes'] += nb
        r['bound_ms'] += bound_ms(nb, 2 * k * xp.numel(), FP32_OPS_PER_S)[0]

        (words, wp, vx, vw, bias), kw = _planes_conv_args(conv, xin)
        kw['tail'] = tail
        args_c = (words, wp, vx, vw, bias)
        out = B.xnor_conv2d_planes(*args_c, out_dtype=torch.bfloat16, **kw)
        r = rows['xnor_conv2d_planes']
        kernel(r, lambda: B.xnor_conv2d_planes(
            *args_c, out_dtype=torch.bfloat16, **kw))
        r['plain_ms'] += card_ms(lambda: B.xnor_conv2d_planes_plain(
            *args_c, out_dtype=torch.bfloat16, **kw), iters)
        # The function needs one int8 pass a pair of scale groups: planes
        # that share a scale merge into one {-2, 0, 2} operand, as JAX's
        # int8 route, the kernel and the library yardstick convolve them.
        ga, gw = k // kw['x_group'], wp.shape[0] // kw['w_group']
        pairs, layout = ga * gw, (ga, kw['x_group'], gw, kw['w_group'])
        if pairs == 1:
            xs = sum(unpack_signs(p, c, dtype=torch.bfloat16) for p in words)
            ws = sum(B.unpack_weights_int8(p, c) for p in wp)
            xs = xs.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            ws = ws.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            s, p = conv.stride, conv.padding
            r['library_ms'] += card_ms(
                lambda: F.conv2d(xs, ws, stride=s, padding=p), iters)
        oh, ow, o = out.shape[1:]
        kk, s, p = wp.shape[1], conv.stride, conv.padding
        macs = n * o * c * valid_taps(h, oh, s, p, kk) * valid_taps(
            w, ow, s, p, kk)
        nb = (words.numel() + wp.numel()) * 4 + 4 * (n * ga + gw * o) \
            + (0 if bias is None else bias.numel() * 2) \
            + out.numel() * out.element_size() + tail_bytes(tail)
        r['bytes'] += nb
        r['ops'] += 2 * macs * pairs
        r['bound_ms'] += bound_ms(nb, 2 * macs * pairs, INT8_OPS_PER_S)[0]
    for r in rows.values():
        r['bound_by'] = ('bytes' if r['bytes'] / HBM_BYTES_PER_S
                         >= r['ops'] / INT8_OPS_PER_S else 'operations')
    conv_row = rows['xnor_conv2d_planes']
    if pairs != 1:
        conv_row['library_ms'] = None
    conv_row.update(scale_group_pairs=pairs, layout=list(layout),
                    **occupancy(torch.bfloat16, *layout))
    rows['pack_sign_planes']['library_ms'] = None
    return dict(name='xnor_conv2d_planes', **conv_row), rows[
        'pack_sign_planes']


def _v1_cost(rows: np.ndarray, v1: np.ndarray, ternary: bool) -> np.ndarray:
    """The least-squares cost of each row's v1, in float64."""
    rows = rows.astype(np.float64)
    v1 = v1.astype(np.float64)[:, None]
    s2 = rows - v1 * np.where(rows < 0, -1.0, 1.0)
    v2 = v1 if ternary else np.abs(s2).mean(axis=1, keepdims=True)
    return np.linalg.norm(s2 - v2 * np.where(s2 < 0, -1.0, 1.0), axis=1)


def _solve_rows(seen: list) -> dict:
    """On the first SOLVE_CHECK_ROWS samples of every captured conv input
    (clamped, float32): the card's opt_v1 against the CPU's (SOLVE_TOL,
    else the card's v1 may cost no more than the CPU's), and how far v1
    moves on the card when every element moves one ulp away from zero."""
    from quant_tpu_torch.ops.optimal import opt_v1

    rel = shift = 0.0
    off_tol = 0
    for conv, xin, _ in seen:
        quant = conv.x_quantizer
        ternary = quant.scheme == 'ls-T'
        xc = conv.clamp_fn()(xin)
        rows = xc.reshape(xc.shape[0], -1)[:SOLVE_CHECK_ROWS].float()
        got = opt_v1(rows, ternary, quant.skip, quant.solver_mode)
        up = opt_v1(torch.nextafter(rows, rows.sign() * float('inf')),
                    ternary, quant.skip, quant.solver_mode)
        shift = max(shift, ((up - got).abs() / got.abs().clamp_min(
            1e-30)).max().item())
        cpu_rows = rows.cpu()
        got = got.cpu().numpy()
        want = opt_v1(cpu_rows, ternary, quant.skip,
                      quant.solver_mode).numpy()
        rel = max(rel, float((np.abs(got - want) / np.maximum(
            np.abs(want), 1e-30)).max()))
        far = ~np.isclose(got, want, **SOLVE_TOL)
        if far.any():
            sub = cpu_rows.numpy()[far][:, ::quant.skip]
            norms = np.linalg.norm(sub.astype(np.float64), axis=1)
            if not (_v1_cost(sub, got[far], ternary)
                    <= _v1_cost(sub, want[far], ternary)
                    + SOLVE_COST_TOL * norms).all():
                raise AssertionError('opt_v1 on the card costs more than '
                                     'on the CPU')
            off_tol += int(far.sum())
    return dict(v1_max_rel_err=rel, rows_past_tol=off_tol,
                v1_max_rel_shift_one_ulp=shift)


def _lloyd_check(rows: torch.Tensor, ternary: bool, skip: int) -> dict:
    """lloyd_solve on the card against its plain twin on the same CUDA
    rows (LLOYD_BATCH's comment); raises past the limits."""
    from quant_tpu_torch.ops import optimal as O

    with_v2 = not ternary
    got = O.lloyd_solve(rows, ternary, skip, with_v2)
    again = O.lloyd_solve(rows, ternary, skip, with_v2)
    if not torch.equal(got, again):
        raise AssertionError('lloyd_solve_rows gave other bits a second time')
    want = O.lloyd_solve_plain(rows, ternary, skip, with_v2)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    v1, v1_plain = (got[0], want[0]) if with_v2 else (got, want)
    close = np.isclose(v1, v1_plain, **SOLVE_TOL)
    far = ~close
    if far.any():
        sub = rows.float().cpu().numpy()[far][:, ::skip]
        norms = np.linalg.norm(sub.astype(np.float64), axis=1)
        if not (_v1_cost(sub, v1[far], ternary)
                <= _v1_cost(sub, v1_plain[far], ternary)
                + SOLVE_COST_TOL * norms).all():
            raise AssertionError('lloyd_solve_rows costs more than its twin')
    v2_err = 0.0
    if with_v2:
        if not np.allclose(got[1][close], want[1][close], **SOLVE_TOL):
            raise AssertionError('lloyd_solve_rows v2 off its twin')
        v2_err = float((np.abs(got[1] - want[1])[close]
                        / np.maximum(np.abs(want[1][close]), 1e-30)).max(
                            initial=0.0))
    return dict(v1_max_rel_err=float((np.abs(v1 - v1_plain) / np.maximum(
        np.abs(v1_plain), 1e-30)).max()), rows_past_tol=int(far.sum()),
        v2_max_rel_err=v2_err)


def lloyd_phase(seen: list, seen32: list, iters: int) -> dict:
    """The lloyd solve kernel (csrc/solve.cu) on the clamped conv inputs
    of an ls-2 model's bf16 forward (seen) and float32 chain (seen32):
    held to its plain twin (_lloyd_check: ls-2 and ls-T, each dtype, the
    float32 chain's few rows spread over clusters), then timed on the
    bf16 inputs with each sample repeated to LLOYD_BATCH rows, in bf16
    and in float32: card ms of the ls-2 solves of the 16 inputs summed,
    the twin's, the bound (each row's bytes read once at the HBM rate),
    the launches of one such forward and each distinct shape's layout
    (cluster, shared memory, registers, blocks an SM). Returns the
    record."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.ops import optimal as O

    checks: dict = {}
    for key, captured in (('bf16', seen), ('f32', seen32)):
        for ternary in (False, True):
            worst: dict = {}
            for conv, xin, _ in captured:
                xc = conv.clamp_fn()(xin)
                r = _lloyd_check(xc.reshape(xc.shape[0], -1), ternary,
                                 conv.x_quantizer.skip)
                for k, v in r.items():
                    worst[k] = max(worst.get(k, 0), v)
            checks[f'{key}_{"ls-T" if ternary else "ls-2"}'] = worst
    rows = []
    for conv, xin, _ in seen:
        xc = conv.clamp_fn()(xin).reshape(xin.shape[0], -1)
        reps = -(-LLOYD_BATCH // xc.shape[0])
        rows.append((xc.repeat(reps, 1)[:LLOYD_BATCH].contiguous(),
                     conv.x_quantizer.skip))
    timed: dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        batch = [(r.to(dtype), skip) for r, skip in rows]
        _build.reset_launch_counts()
        for r, skip in batch:
            O.lloyd_solve(r, False, skip, True)
        torch.cuda.synchronize()
        launches = launch_counts().get('lloyd_solve_rows', 0)
        if launches != len(batch):
            raise AssertionError(f'lloyd_solve_rows launched {launches} '
                                 f'times for {len(batch)} solves')
        layouts = {}
        for r, skip in batch:
            layouts.setdefault(str(r.shape[1]), O.lloyd_solve_layout(
                dtype, r.shape[0], r.shape[1], skip))
        n_bytes = sum(r.numel() * r.element_size() for r, _ in batch)
        timed[str(dtype).split('.')[-1]] = dict(
            ms=sum(card_ms(lambda r=r, s=s: O.lloyd_solve(r, False, s, True),
                           iters) for r, s in batch),
            plain_ms=sum(card_ms(lambda r=r, s=s: O.lloyd_solve_plain(
                r, False, s, True), max(1, iters // 5)) for r, s in batch),
            bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bytes=n_bytes,
            launches=launches, layouts=layouts)
    return dict(batch=LLOYD_BATCH, convs=len(rows), checks=checks,
                timed=timed)


def solve_phase(seen: list, seen32: list, iters: int) -> dict:
    """The per-sample activation solves of an 'off' model: card ms summed
    over the convs of its bf16 forward (the whole batch), _solve_rows
    on the inputs of that forward (bf16 values) and of its float32 chain
    (seen32), and lloyd_phase on the same inputs. Returns the record."""
    ms = 0.0
    for conv, xin, _ in seen:
        xc = conv.clamp_fn()(xin)
        ms += card_ms(lambda: conv.x_quantizer.solve(xc), iters)
    return dict(solve_ms=ms, convs=len(seen), bf16_rows=_solve_rows(seen),
                f32_rows=_solve_rows(seen32),
                lloyd=lloyd_phase(seen, seen32, iters))


def _timed_futures(submit: Callable, images: np.ndarray
                   ) -> tuple[list, list]:
    """Submit every image; returns the futures and, per request, [submit
    time, done time] as the caller's clock reads them."""
    futures, times = [], []
    for img in images:
        t = [time.perf_counter(), None]
        fut = submit(img)
        fut.add_done_callback(
            lambda f, t=t: t.__setitem__(1, time.perf_counter()))
        futures.append(fut)
        times.append(t)
    return futures, times


def _client_latency(times: list) -> dict:
    lats = np.asarray([b - a for a, b in times]) * 1e3
    return {'p50': float(np.percentile(lats, 50)),
            'p99': float(np.percentile(lats, 99)),
            'max': float(lats.max())}


def _warm_round(frontend: Any, images: np.ndarray) -> dict:
    """The same requests again through a running frontend, sent as fast
    as submit returns: the engines' threads have served before (PyTorch
    keeps cuDNN and cuBLAS handles per thread, made at a thread's first
    forward). Returns the logits, the client latency and the seconds."""
    t0 = time.perf_counter()
    futures, times = _timed_futures(frontend.submit, images)
    logits = np.stack([f.result(timeout=300) for f in futures])
    return dict(logits=logits, latency_ms=_client_latency(times),
                s=time.perf_counter() - t0)


def _serving_images(seed: int, shape: tuple = (224, 224, 3)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (SERVING_REQUESTS,) + tuple(shape)).astype(np.float32)


def frontend_phase(model: torch.nn.Module, seed: int) -> dict:
    """(a) An in-process ServingFrontend over two InferenceEngines of the
    main-path model on the card. The 64 requests are queued before the
    engines start, so least-loaded dispatch alternates and each engine
    serves one batch of 32, the bucket predict() runs; the launch counts
    are zeroed just before the engines start and read just after. Then
    the same requests again, through the running engines (_warm_round),
    held to FP32_REL_TOL of the spread (other batch sizes)."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.serving.engine import (
        InferenceEngine, ServingFrontend,
    )

    images = _serving_images(seed)
    half = SERVING_REQUESTS // 2
    engines = [InferenceEngine(model, (224, 224, 3), max_batch=half,
                               max_wait_ms=5.0, device=DEVICE)
               for _ in range(2)]
    for e in engines:
        e.warmup([half])
    frontend = ServingFrontend(engines)
    futures, times = _timed_futures(frontend.submit, images)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    frontend.start()
    try:
        got = np.stack([f.result(timeout=300) for f in futures])
        torch.cuda.synchronize()
        launches = launch_counts()
        stats = frontend.stats
        warm = _warm_round(frontend, images)
    finally:
        frontend.stop()
    batches = stats['batches']
    want = {k: 0 for k in KERNELS}
    want.update({'xnor_conv2d': 16 * batches,
                 'pack_sign_planes': 16 * batches, TAIL: 16 * batches,
                 'max_pool_3x3_s2_p1': batches})
    if launches != want:
        raise AssertionError(f'frontend: launches {launches}, expected '
                             f'{want}')
    if ([s['requests'] for s in stats['engines']] != [half, half]
            or batches != 2 or stats['requests'] != SERVING_REQUESTS
            or stats['latency_ms']['window'] != SERVING_REQUESTS):
        raise AssertionError(f'frontend stats do not aggregate both '
                             f'engines: {stats}')
    ref = engines[0].predict(images)
    if not np.isfinite(got).all() or got.shape[0] != SERVING_REQUESTS:
        raise AssertionError(f'frontend logits bad: {got.shape}')
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    warm_err = float(np.abs(warm['logits'] - ref).max())
    if not warm_err <= FP32_REL_TOL * float(ref.max() - ref.min()):
        raise AssertionError(f'frontend second round: max abs err '
                             f'{warm_err}')
    return dict(requests=SERVING_REQUESTS, batches=batches,
                launches={k: v for k, v in launches.items() if v},
                latency_ms=stats['latency_ms'],
                client_latency_ms=_client_latency(times),
                bitwise_equal=bool(np.array_equal(got, ref)),
                max_abs_err=float(np.abs(got - ref).max()),
                second_round=dict(client_latency_ms=warm['latency_ms'],
                                  s=warm['s'], max_abs_err=warm_err))


def _worker_launches(before: dict, after: dict,
                     per_batch: Optional[dict] = None) -> dict[str, int]:
    """A worker's launches between two of its stats, checked against its
    batches: per_batch's counts each, by default the ResNet-18's 16
    xnor_conv2d, 16 pack_sign_planes (16 with a tail) and 1 pool."""
    got = {k: after['kernel_launches'][k] - before['kernel_launches'][k]
           for k in after['kernel_launches']}
    n = after['batches'] - before['batches']
    want = {k: 0 for k in got}
    per_batch = per_batch or {'xnor_conv2d': 16, 'pack_sign_planes': 16,
                              TAIL: 16, 'max_pool_3x3_s2_p1': 1}
    want.update({k: v * n for k, v in per_batch.items()})
    if got != want:
        raise AssertionError(f'worker launches {got}, expected {want}')
    return got


def worker_phase(seed: int) -> dict:
    """(b) Two worker processes of WORKER_SPEC on the card, behind a
    frontend with an RPC secret: 64 requests against an in-process engine
    of the same spec, each worker's launches read from its stats around
    them, then the same requests again (_warm_round); (c) worker 0
    killed: the requests routed to it fail with transport errors until
    it is evicted, then the survivor serves every later request. Every
    worker process is stopped before this returns."""
    from quant_tpu_torch.serving.engine import ServingFrontend
    from quant_tpu_torch.serving.worker import (
        build_engine_from_spec, spawn_engine_workers,
    )

    spec = dict(WORKER_SPEC, seed=seed, device=DEVICE)
    images = _serving_images(seed + 1, spec['input_shape'])
    t0 = time.perf_counter()
    procs, clients = spawn_engine_workers(2, spec, secret=os.urandom(32),
                                          timeout=600)
    startup_s = time.perf_counter() - t0
    frontend = ServingFrontend(clients, max_failures=2).start()
    try:
        before = [c.stats for c in clients]
        futures, times = _timed_futures(frontend.submit, images)
        got = np.stack([f.result(timeout=300) for f in futures])
        stats = frontend.stats
        launches = [_worker_launches(b, s)
                    for b, s in zip(before, stats['engines'])]
        if stats['requests'] - sum(b['requests'] for b in before) \
                != SERVING_REQUESTS or min(
                    s['requests'] for s in stats['engines']) == 0:
            raise AssertionError(f'worker stats: {stats}')
        reference = build_engine_from_spec(spec)
        want = reference.predict(images)
        spread = float(want.max() - want.min())
        err = float(np.abs(got - want).max())
        if not np.isfinite(got).all() or not err <= FP32_REL_TOL * spread:
            raise AssertionError(f'worker logits vs in-process: max abs '
                                 f'err {err}, spread {spread}')
        equal_rows = int((got == want).all(axis=1).sum())
        warm = _warm_round(frontend, images)
        warm_err = float(np.abs(warm['logits'] - want).max())
        if not warm_err <= FP32_REL_TOL * spread:
            raise AssertionError(f'workers second round: max abs err '
                                 f'{warm_err}')

        procs[0].kill()
        procs[0].wait(timeout=60)
        failed = 0
        deadline = time.monotonic() + 120
        while frontend.alive != [False, True]:
            if time.monotonic() > deadline:
                raise AssertionError('killed worker never evicted')
            exc = frontend.submit(images[0]).exception(timeout=300)
            if exc is not None and not isinstance(
                    exc, ServingFrontend._TRANSPORT_ERRORS):
                raise AssertionError(f'failover: {exc!r}')
            failed += exc is not None
            time.sleep(0.05)  # the eviction is recorded in a callback
        served_before = clients[1].stats['requests']
        n_later = min(16, SERVING_REQUESTS)
        later = np.stack([frontend.submit(img).result(timeout=300)
                          for img in images[:n_later]])
        if clients[1].stats['requests'] - served_before != n_later:
            raise AssertionError('the survivor did not serve every later '
                                 'request')
        later_err = float(np.abs(later - want[:n_later]).max())
        if not later_err <= FP32_REL_TOL * spread:
            raise AssertionError(f'survivor logits: max abs err '
                                 f'{later_err}')
        dead_stats = frontend.stats['engines'][0]
        if 'error' not in dead_stats:
            raise AssertionError('the dead worker answered stats')
    finally:
        frontend._health_stop.set()
        for c, p in zip(clients, procs):
            if p.poll() is None:
                c.shutdown_server()
        frontend.stop()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
    return dict(workers=2, spec=spec, startup_s=startup_s,
                requests=SERVING_REQUESTS, batches=stats['batches'],
                launches=launches, latency_ms=stats['latency_ms'],
                client_latency_ms=_client_latency(times),
                max_abs_err=err, spread=spread,
                bitwise_equal_rows=equal_rows,
                second_round=dict(client_latency_ms=warm['latency_ms'],
                                  s=warm['s'], max_abs_err=warm_err,
                                  bitwise_equal_rows=int(
                                      (warm['logits'] == want).all(
                                          axis=1).sum())),
                failover=dict(failed_requests=failed, later_requests=n_later,
                              later_max_abs_err=later_err,
                              alive=frontend.alive,
                              dead_stats=dead_stats['error']),
                exit_codes=[p.returncode for p in procs])


def _ema_leaves(model: torch.nn.Module) -> list:
    from quant_tpu_torch.nn.layers import ActivationQuantizer

    return [(name, m.ema.cpu(), int(m.ema_count))
            for name, m in model.named_modules()
            if isinstance(m, ActivationQuantizer) and m.ema is not None]


def recipe_phase(build: str, x_quant: str, w_quant: str, recipe: str,
                 seed: int) -> dict:
    """A recipe's model as written (moving_average_mode 'off'), seeded,
    calibrated by calibrate_ema_scales on CALIBRATION_BATCHES seeded
    batches in float32 on the card and on the CPU (the EMA held to
    CALIBRATION_REL_TOL), then folded, stripped and served from the card
    with a bf16 chain."""
    from quant_tpu_torch.nn import export

    make, hwc, _, _ = PHASE_MODELS[build]
    cpu_model = models.seeded_model(make, x_quant, w_quant, 'cpu', seed,
                                    prepare=False, moving_average_mode='off')
    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randn((CALIBRATION_BATCH,) + hwc, generator=gen)
               for _ in range(CALIBRATION_BATCHES)]
    t0 = time.perf_counter()
    card = export.calibrate_ema_scales(
        copy.deepcopy(cpu_model).to(DEVICE), [b.to(DEVICE) for b in batches])
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - t0
    cpu = export.calibrate_ema_scales(cpu_model, batches)
    got, want = _ema_leaves(card), _ema_leaves(cpu)
    if [n for n, *_ in got] != [n for n, *_ in want] or not got:
        raise AssertionError(f'{build}: calibrated quantizers differ')
    rels = []
    for (name, g, gc), (_, w, wc) in zip(got, want):
        if gc != wc or gc != CALIBRATION_BATCHES:
            raise AssertionError(f'{build} {name}: ema_count {gc} vs {wc}')
        rels.append(((g - w).abs() / w.abs()).max().item())
    rel = max(rels)
    worst = got[int(np.argmax(rels))][0]
    if not rel <= CALIBRATION_REL_TOL:
        raise AssertionError(f'{build}: calibrated EMA card vs CPU, max '
                             f'relative err {rel} ({worst})')
    models.prepare_for_serving(card)
    if not card.bn_fold:
        raise AssertionError(f'{build}: the calibrated model did not fold')
    card.eval_dtype = torch.bfloat16
    head = card.fc2 if build == 'lenet' else card.fc
    served = serve(card, seed, hwc, head.kernel.shape[1])
    return dict(model=build, recipe=recipe, x_quant=x_quant,
                w_quant=w_quant, moving_average_mode='off',
                calibration_batches=CALIBRATION_BATCHES,
                calibration_batch=CALIBRATION_BATCH,
                calibrate_s=calibrate_s, ema_max_rel_err=rel,
                ema_worst_quantizer=worst,
                ema_median_rel_err=float(np.median(rels)),
                quantizers=len(got), serving=served)


class _HostEvent:
    """cuda_event's stand-in where DEVICE is the CPU (a rank of the CPU
    rehearsal): the host clock."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: '_HostEvent') -> float:
        return (end.t - self.t) * 1e3


def cuda_event() -> Any:
    """A CUDA event recorded on the current stream (timing enabled)."""
    if DEVICE != 'cuda':
        return _HostEvent()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _train_models(name: str, seed: int
                  ) -> tuple[torch.nn.Module, torch.nn.Module]:
    """(student, teacher) of a train configuration on the CPU."""
    make, teacher_make, _, _ = TRAIN_MODELS
    return train_profile.build(name, seed, 'cpu', make, teacher_make)


def _train_data(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """n seeded ImageNet-shaped images (N(0, 1), NHWC) and labels."""
    rng = np.random.default_rng(seed)
    _, _, hwc, classes = TRAIN_MODELS
    return (rng.standard_normal((n,) + hwc, dtype=np.float32),
            rng.integers(0, classes, n))


def _one_step(student: torch.nn.Module, teacher: torch.nn.Module,
              x: np.ndarray, y: np.ndarray, device: str) -> float:
    from quant_tpu_torch.train.metrics import init_metric_state

    step = train_profile.make_step(teacher)
    _, _, loss = step(train_profile.make_state(student),
                      torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device), init_metric_state())
    return loss.item()


def _state_tensors(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """BN running statistics and cached weight scales, on the CPU."""
    return {name: b.detach().cpu() for name, b in model.named_buffers()
            if name.rsplit('.', 1)[-1] in ('running_mean', 'running_var',
                                           'w_vs')}


def train_against_cpu(seed: int) -> dict:
    """One train step of the first configuration, card against CPU (TF32
    off) from one set of weights: the loss, every gradient leaf, the new
    BN statistics and w_vs, each held to TRAIN_CPU_LIMITS."""
    student_cpu, teacher_cpu = _train_models(TRAIN_CONFIGS[0], seed)
    student = copy.deepcopy(student_cpu).to(DEVICE)
    teacher = copy.deepcopy(teacher_cpu).to(DEVICE)
    x, y = _train_data(TRAIN_CHECK_BATCH, seed)
    lim = TRAIN_CPU_LIMITS
    with tf32(False):
        got = _one_step(student, teacher, x, y, DEVICE)
    want = _one_step(student_cpu, teacher_cpu, x, y, 'cpu')
    loss_rel = abs(got - want) / abs(want)
    grads = {n: p.grad.detach().cpu() for n, p in student.named_parameters()}
    wants = {n: p.grad for n, p in student_cpu.named_parameters()}
    total = torch.sqrt(sum(g.double().pow(2).sum() for g in wants.values()))
    diff = torch.sqrt(sum((grads[n] - w).double().pow(2).sum()
                          for n, w in wants.items()))
    grad_rel = (diff / total).item()
    floor = lim['grad_floor'] * total.item() / lim['grad_median']
    rels = {n: (grads[n] - w).double().norm().item()
            / (w.double().norm().item() + floor) for n, w in wants.items()}
    worst = max(rels, key=rels.get)
    grad_median = float(np.median(list(rels.values())))
    stats, w_vs = 0.0, 0.0
    card_state, cpu_state = _state_tensors(student), _state_tensors(
        student_cpu)
    for name, w in cpu_state.items():
        rel = ((card_state[name] - w).abs().max()
               / w.abs().max().clamp_min(1e-30)).item()
        if name.endswith('w_vs'):
            w_vs = max(w_vs, rel)
        else:
            stats = max(stats, rel)
    record = dict(batch=TRAIN_CHECK_BATCH, loss_card=got, loss_cpu=want,
                  loss_rel_err=loss_rel, grad_rel_err=grad_rel,
                  grad_median_leaf_err=grad_median,
                  grad_worst_leaf_err=rels[worst], grad_worst_leaf=worst,
                  grad_leaves=len(wants), stats_rel_err=stats,
                  w_vs_rel_err=w_vs, limits=lim)
    print(f'train step card vs CPU: {record}', flush=True)
    if not (loss_rel <= lim['loss_rel'] and grad_rel <= lim['grad_rel']
            and grad_median <= lim['grad_median']
            and rels[worst] <= lim['grad_worst']
            and stats <= lim['stats_rel'] and w_vs <= lim['w_vs_rel']):
        raise AssertionError(f'train step card vs CPU past its limits: '
                             f'{record}')
    return record


def remat_check(seed: int) -> dict:
    """The first configuration with remat on against off on the card at
    REMAT_CHECK_BATCH: loss within REMAT_LOSS_REL, new state equal."""
    student_cpu, teacher_cpu = _train_models(TRAIN_CONFIGS[0], seed)
    teacher = teacher_cpu.to(DEVICE)
    x, y = _train_data(REMAT_CHECK_BATCH, seed + 1)
    out = []
    for remat in (False, True):
        student = copy.deepcopy(student_cpu).to(DEVICE)
        student.remat = remat
        loss = _one_step(student, teacher, x, y, DEVICE)
        out.append((loss, _state_tensors(student)))
    (l0, s0), (l1, s1) = out
    rel = abs(l1 - l0) / abs(l0)
    equal = all(torch.equal(s0[k], s1[k]) for k in s0)
    record = dict(batch=REMAT_CHECK_BATCH, loss_off=l0, loss_on=l1,
                  loss_rel_err=rel, state_equal=equal, state_tensors=len(s0))
    print(f'remat on vs off: {record}', flush=True)
    if not (rel <= REMAT_LOSS_REL and equal):
        raise AssertionError(f'remat changes the step: {record}')
    return record


def lloyd_launches(convs: int, x_quant: str, w_quant: str,
                   options: dict) -> int:
    """lloyd_solve_rows launches a train step of a student of `convs`
    QuantConv2d, each inside a block: one a conv for its activation and
    one for its weight solve where that scheme is ls-2 or ls-T and the
    solver lloyd, twice under remat (the recomputation solves again)."""
    if options.get('solver_mode') != 'lloyd':
        return 0
    solved = sum(q in ('ls-2', 'ls-T') for q in (x_quant, w_quant))
    return convs * solved * (2 if options.get('remat') else 1)


def train_phase(name: str, seed: int) -> tuple[dict, Any]:
    """One train configuration at TRAIN_BATCH: TRAIN_WARMUP steps, then
    TRAIN_STEPS through make_train_step and train_epoch on one fixed
    seeded batch, timed with CUDA events at each part of the step. The
    loss must be finite at every step and fall from the first step to
    the last, and the timed steps launch the stem pool kernel once a
    step (the teacher's), the lloyd solve kernel lloyd_launches' times a
    step and no other kernel. Returns (record, the train state)."""
    from quant_tpu_torch import _build
    from quant_tpu_torch import train as T

    recipe, x_quant, w_quant, options, teacher_dtype = (
        train_profile.CONFIGS[name])
    student, teacher = (m.to(DEVICE) for m in _train_models(name, seed))
    x, y = _train_data(TRAIN_BATCH, seed)
    batch = (torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE))
    marks: list = []
    step = train_profile.make_step(teacher, lambda part: marks.append(
        (part, cuda_event())))
    state = train_profile.make_state(student)
    T.train_epoch(step, state, [batch] * TRAIN_WARMUP, epoch=1)
    torch.cuda.synchronize()
    marks.clear()
    sums: list = []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, _ = T.train_epoch(
        step, state, [batch] * TRAIN_STEPS, epoch=2, hooks=[
            lambda metrics, **kw: sums.append(
                metrics['train'].state['loss_sum'].clone())],
        lr_schedule=state.tx.schedule,
        steps_per_epoch=train_profile.STEPS_PER_EPOCH)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    cum = [float(v) for v in sums]
    losses = [(b - a) / TRAIN_BATCH for a, b in zip([0.0] + cum, cum)]
    parts = ('forward', 'teacher', 'backward', 'optimizer')
    split = {p: 0.0 for p in parts}
    for (part, ev), (_, nxt) in zip(marks, marks[1:]):
        if part in split:
            split[part] += ev.elapsed_time(nxt) / TRAIN_STEPS
    starts = [ev for part, ev in marks if part == 'forward']
    ends = [ev for part, ev in marks if part == 'end']
    ms = starts[0].elapsed_time(ends[-1]) / TRAIN_STEPS
    record = dict(
        name=name, recipe=recipe, x_quant=x_quant, w_quant=w_quant,
        teacher_dtype=teacher_dtype, batch=TRAIN_BATCH,
        input=list(TRAIN_MODELS[2]), steps=TRAIN_STEPS,
        warmup=TRAIN_WARMUP, ms_per_step=ms,
        images_per_s=TRAIN_BATCH / ms * 1e3, split_ms=split,
        max_memory_allocated=peak, losses=losses, wall_s=wall_s,
        launches=launches, **options)
    print(json.dumps({'train_phase': record}), flush=True)
    # The teacher's forward records no gradient, so its stem pool is the
    # kernel; the student's differentiable pool is not.
    from quant_tpu_torch.nn.layers import QuantConv2d
    want = {'max_pool_3x3_s2_p1': TRAIN_STEPS}
    solves = lloyd_launches(
        sum(isinstance(m, QuantConv2d) for m in student.modules()),
        x_quant, w_quant, options) * TRAIN_STEPS
    if solves:
        want['lloyd_solve_rows'] = solves
    if launches != want:
        raise AssertionError(f'{name}: launches {launches}, expected {want}')
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f'{name}: losses {losses}')
    if not losses[-1] < losses[0]:
        raise AssertionError(f'{name}: the loss did not fall: {losses}')
    return record, state


def eval_step_check(state: Any, seed: int) -> dict:
    """evaluate on TRAIN_EVAL_BATCHES seeded batches with the launch
    counts zeroed just before: the dense eval forward launches the stem
    pool kernel once a batch and no other kernel."""
    from quant_tpu_torch import _build
    from quant_tpu_torch import train as T

    x, y = _train_data(TRAIN_BATCH, seed)
    loader = [(x, y)] * TRAIN_EVAL_BATCHES
    step = T.make_eval_step(T.get_loss_fn('cross_entropy'))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    metrics = T.evaluate(step, state, loader)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    want = {'max_pool_3x3_s2_p1': TRAIN_EVAL_BATCHES}
    if launches != want or not np.isfinite(metrics['Loss']):
        raise AssertionError(f'eval step: launches {launches}, expected '
                             f'{want}; metrics {metrics}')
    return dict(batches=TRAIN_EVAL_BATCHES, batch=TRAIN_BATCH,
                metrics=metrics, launches=launches)


def serve_trained(model: torch.nn.Module, seed: int) -> dict:
    """The trained student calibrated (calibrate_ema_scales on
    CALIBRATION_BATCHES seeded batches), packed, folded, stripped and
    served through InferenceEngine with a bf16 chain: the packed float32
    chain within TRAIN_SERVE_REL_TOL and the served bf16 logits within
    TRAIN_SERVE_BF16_REL_TOL of the logit spread of the calibrated twin's
    dense float32 eval forward, and each packed forward launching
    xnor_conv2d and pack_sign_planes once a QuantConv2d and the stem
    pool once."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.nn import export
    from quant_tpu_torch.nn.layers import QuantConv2d
    from quant_tpu_torch.serving.engine import InferenceEngine

    hwc = TRAIN_MODELS[2]
    gen = torch.Generator().manual_seed(seed)
    batches = [torch.randn((CALIBRATION_BATCH,) + hwc, generator=gen)
               .to(DEVICE) for _ in range(CALIBRATION_BATCHES)]
    twin = export.calibrate_ema_scales(model, batches)
    x = np.random.default_rng(seed).standard_normal(
        (TRAIN_SERVE_BATCH,) + hwc, dtype=np.float32)
    served = copy.deepcopy(twin)
    for m in served.modules():
        if hasattr(m, 'inference_mode'):
            m.inference_mode = 'packed'
    export.export_packed_variables(served)
    if not export.fold_for_serving(served)[1]:
        raise AssertionError('the calibrated student did not fold')
    export.strip_for_deployment(served)
    with tf32(False):
        want = twin(torch.from_numpy(x).to(DEVICE)).cpu().numpy()
        got32 = served(torch.from_numpy(x).to(DEVICE)).cpu().numpy()
    served.eval_dtype = torch.bfloat16
    n_convs = sum(isinstance(m, QuantConv2d) for m in served.modules())
    engine = InferenceEngine(served, hwc, max_batch=TRAIN_SERVE_BATCH,
                             device=DEVICE)
    engine.warmup([TRAIN_SERVE_BATCH])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = engine.predict(x)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    expect = {'xnor_conv2d': n_convs, 'pack_sign_planes': n_convs,
              TAIL: n_convs, 'max_pool_3x3_s2_p1': 1}
    spread = float(want.max() - want.min())
    err = float(np.abs(got - want).max())
    err32 = float(np.abs(got32 - want).max())
    record = dict(calibration_batches=CALIBRATION_BATCHES,
                  calibration_batch=CALIBRATION_BATCH,
                  batch=TRAIN_SERVE_BATCH, spread=spread,
                  bf16_max_abs_err=err, bf16_rel_err=err / spread,
                  fp32_max_abs_err=err32, fp32_rel_err=err32 / spread,
                  limit=TRAIN_SERVE_REL_TOL,
                  bf16_limit=TRAIN_SERVE_BF16_REL_TOL, launches=launches)
    print(f'trained student served: {record}', flush=True)
    if launches != expect:
        raise AssertionError(f'served student: launches {launches}, '
                             f'expected {expect}')
    if not (np.isfinite(got).all()
            and err <= TRAIN_SERVE_BF16_REL_TOL * spread
            and err32 <= TRAIN_SERVE_REL_TOL * spread):
        raise AssertionError(f'served student past its limit: {record}')
    return record


def train_phases(seed: int) -> dict:
    """The train phase: the card-vs-CPU step, the remat check, the three
    configurations, the eval step and the trained student served."""
    t0 = time.perf_counter()
    out = dict(against_cpu=train_against_cpu(seed),
               remat=remat_check(seed), configs=[])
    trained = None
    for i, name in enumerate(TRAIN_CONFIGS):
        record, state = train_phase(name, seed + i)
        out['configs'].append(record)
        if i == 0:
            trained = state
        else:
            del state
    out['eval'] = eval_step_check(trained, seed)
    print(f'eval step: {out["eval"]}', flush=True)
    out['serve'] = serve_trained(trained.model, seed)
    out['s'] = time.perf_counter() - t0
    return out


class StepTimer:
    """A train hook: the host clock after each train step, the card
    synchronised first; `get_hooks` is a driver's get_hooks."""

    def __init__(self):
        self.marks: list[tuple[int, int, float]] = []

    def __call__(self, epoch: int, global_step: int, **_: Any) -> None:
        torch.cuda.synchronize()
        self.marks.append((epoch, global_step, time.perf_counter()))

    def get_hooks(self, config: dict, root: Any) -> tuple[list, list]:
        return [self], []

    def ms_per_step(self) -> Optional[float]:
        """Mean ms between consecutive steps of one epoch (the loader's
        next batch, its copy to the card and the step), each epoch's
        first step left out; None with fewer than 2 steps an epoch."""
        gaps = [(b[2] - a[2]) * 1e3 for a, b in zip(self.marks,
                                                      self.marks[1:])
                if a[0] == b[0]]
        return float(np.mean(gaps)) if gaps else None


def write_mnist(root: str, n_train: int, n_test: int, seed: int) -> None:
    """A seeded MNIST in the published IDX-gz format: ten random 28x28
    class prototypes, each image its class's plus noise, uint8."""
    import gzip
    import struct

    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 256, (10, 28, 28))
    for prefix, n in (('train', n_train), ('t10k', n_test)):
        labels = rng.integers(0, 10, n).astype(np.uint8)
        images = np.clip(protos[labels] + rng.normal(0, 48, (n, 28, 28)),
                         0, 255).astype(np.uint8)
        for kind, arr, magic in (('images-idx3', images, 0x803),
                                 ('labels-idx1', labels, 0x801)):
            with gzip.open(os.path.join(
                    root, f'{prefix}-{kind}-ubyte.gz'), 'wb') as f:
                f.write(struct.pack('>I', magic))
                f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
                f.write(arr.tobytes())


def recipe_copy(recipe: str, path: str, root: str, epochs: int,
                **sections: dict) -> str:
    """The recipe YAML with the phase's cuts: epochs, the experiments
    root, tensorboard off, and the given sections' keys, then
    EXPERIMENT_OVERRIDES; written to path."""
    import yaml

    with open(recipe) as f:
        cfg = yaml.safe_load(f)
    cfg['optimization']['epochs'] = epochs
    cfg['log'].update(root_experiments_dir=root, tensorboard=False)
    for overrides in (sections, EXPERIMENT_OVERRIDES.get(recipe, {})):
        for section, keys in overrides.items():
            node = cfg
            for part in section.split('.'):
                node = node[part]
            node.update(copy.deepcopy(keys))
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def _test_rows(exp_dir: str) -> list[dict]:
    import csv

    with open(os.path.join(exp_dir, 'metrics', 'test.csv')) as f:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(f)]


def _timed(fn: Callable, *args: Any, **kw: Any) -> tuple[Any, float]:
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loader_profile(train_step: Callable, state: Any, batches: list,
                   ) -> dict:
    """The card's kernel time over train steps on `batches` (host numpy
    batches, as a loader yields them) under torch.profiler: ms a step,
    kernel ms a step and the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from quant_tpu_torch import train as T

    T.train_epoch(train_step, state, batches[:3], epoch=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        T.train_epoch(train_step, state, batches, epoch=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    busy = sum(evt.device_time_total for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA)
    busy_ms = busy / 1e3 / len(batches)
    if busy_ms <= 0:
        raise AssertionError('the profiler saw no device time')
    return dict(steps=len(batches), ms_per_step=wall_ms,
                kernel_ms_per_step=busy_ms,
                idle_share=max(0.0, 1 - busy_ms / wall_ms))


def _serve_artifact(out: str, shape: tuple, per_forward: dict,
                    seed: int) -> dict:
    """The artifact in process on the card (one forward of
    EXPERIMENT_REQUESTS images, its launches read around it) and on the
    CPU (its logits within FP32_REL_TOL of the spread), then from one
    'artifact' worker process: the same requests, one at a time, within
    FP32_REL_TOL of the CPU's spread and equal to the in-process
    engine's answers (the worker serves with TF32 off, as this process
    runs), the worker's launches from its stats. Both engines pad every
    batch to one bucket of EXPERIMENT_REQUESTS, so each forward takes one
    cuDNN algorithm: the float32 stem's rounding flips binary
    activations near their thresholds."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.serving.engine import InferenceEngine
    from quant_tpu_torch.serving.prepare import load_serving_artifact
    from quant_tpu_torch.serving.worker import spawn_engine_workers

    images = np.random.default_rng(seed).standard_normal(
        (EXPERIMENT_REQUESTS,) + tuple(shape)).astype(np.float32)
    model, art_shape = load_serving_artifact(out, DEVICE)
    if tuple(art_shape) != tuple(shape):
        raise AssertionError(f'artifact shape {art_shape}, not {shape}')
    bucket = [EXPERIMENT_REQUESTS]
    engine = InferenceEngine(model, shape, max_batch=EXPERIMENT_REQUESTS,
                             batch_buckets=bucket, device=DEVICE)
    engine.warmup([EXPERIMENT_REQUESTS])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    want = engine.predict(images)
    torch.cuda.synchronize()
    launches = {k: v for k, v in launch_counts().items() if v}
    if launches != per_forward:
        raise AssertionError(f'{out}: launches {launches} a forward, '
                             f'expected {per_forward}')
    cpu_model, _ = load_serving_artifact(out, 'cpu')
    cpu = cpu_model(torch.from_numpy(images)).numpy()
    spread = float(cpu.max() - cpu.min())
    cpu_err = float(np.abs(want - cpu).max())
    if not (np.isfinite(want).all() and want.shape[0] == len(images)
            and cpu_err <= FP32_REL_TOL * spread):
        raise AssertionError(f'{out}: card vs CPU max abs err {cpu_err}, '
                             f'spread {spread}')
    spec = {'model': 'artifact', 'artifact_dir': out, 'device': DEVICE,
            'max_batch': EXPERIMENT_REQUESTS, 'batch_buckets': bucket}
    t0 = time.perf_counter()
    procs, clients = spawn_engine_workers(1, spec, timeout=600)
    startup_s = time.perf_counter() - t0
    try:
        before = clients[0].stats
        futures = [clients[0].submit(img) for img in images]
        got = np.stack([f.result(timeout=300) for f in futures])
        after = clients[0].stats
        worker = _worker_launches(before, after, per_forward)
    finally:
        for c in clients:
            c.shutdown_server()
            c.stop()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
    err = float(np.abs(got - want).max())
    worker_cpu_err = float(np.abs(got - cpu).max())
    print(f'{out}: worker vs CPU max abs err {worker_cpu_err} '
          f'({worker_cpu_err / spread} of the spread), vs in-process '
          f'engine {err}', flush=True)
    if not worker_cpu_err <= FP32_REL_TOL * spread:
        raise AssertionError(f'{out}: worker vs CPU max abs err '
                             f'{worker_cpu_err}, spread {spread}')
    if not np.array_equal(got, want):
        raise AssertionError(f'{out}: worker vs in-process engine max abs '
                             f'err {err}, spread {spread}')
    return dict(requests=len(images), launches_per_forward=launches,
                cpu_max_abs_err=cpu_err, spread=spread,
                cpu_rel_err=cpu_err / spread, worker_startup_s=startup_s,
                worker_batches=after['batches'] - before['batches'],
                worker_launches=worker, worker_max_abs_err=err,
                worker_cpu_max_abs_err=worker_cpu_err,
                worker_cpu_rel_err=worker_cpu_err / spread,
                exit_codes=[p.returncode for p in procs])


def mnist_experiment(root: str, seed: int) -> dict:
    """(a) mnist_ls1.yaml through quant_tpu_torch.examples.mnist: the
    experiment's files, --restore-experiment --skip-training against the
    last test.csv row, --auto-resume to checkpoint_4, then
    serving.prepare --calibrate-dataset and an 'artifact' worker; the
    loader's ms a step beside a fixed batch's and the idle share."""
    import yaml

    from quant_tpu_torch import train as T
    from quant_tpu_torch.data import MNISTDataLoader
    from quant_tpu_torch.examples import mnist
    from quant_tpu_torch.serving import prepare
    from quant_tpu_torch.train.task import init_model_variables

    cut = EXPERIMENT_MNIST
    data = os.path.join(root, 'mnist')
    os.makedirs(data)
    write_mnist(data, cut['train'], cut['test'], seed)
    cfg = recipe_copy(cut['recipe'], os.path.join(root, 'mnist.yaml'),
                      os.path.join(root, 'experiments'), cut['epochs'],
                      data={'dataset_path': data})
    exp = os.path.join(root, 'experiments', cut['name'])
    run = ['--config', cfg, '--experiment-name', cut['name'],
           '--device', DEVICE]
    timer = StepTimer()
    (train_m, test_m), train_s = _timed(mnist.main, run, timer.get_hooks)
    ckpts = os.path.join(exp, 'checkpoints')
    files = sorted(os.listdir(exp)) + sorted(os.listdir(ckpts))
    for name in ('config.yaml', 'metrics', 'checkpoints',
                 f'checkpoint_{cut["epochs"]}'):
        if name not in files:
            raise AssertionError(f'mnist experiment: no {name} ({files})')
    last = _test_rows(exp)[-1]
    if len(train_m) != cut['epochs'] or not all(
            np.isfinite(m['Loss']) for m in train_m + test_m):
        raise AssertionError(f'mnist metrics {train_m} {test_m}')

    _, eval_s = _timed(mnist.main, ['--restore-experiment', exp,
                                    '--skip-training', '--device', DEVICE])
    again = _test_rows(exp)[-1]
    eval_err = max(abs(again[k] - v) / max(abs(v), 1e-30)
                   for k, v in last.items())
    if not eval_err <= EXPERIMENT_EVAL_REL_TOL:
        raise AssertionError(f'restored eval {again} vs {last}')

    (resumed, _), resume_s = _timed(mnist.main, run + ['--auto-resume'])
    final = 2 * cut['epochs']
    if not (os.path.exists(os.path.join(ckpts, f'checkpoint_{final}'))
            and len(resumed) == cut['epochs']):
        raise AssertionError(f'auto-resume: {os.listdir(ckpts)}')

    out, prepare_s = _timed(prepare.main, [
        '--experiment', exp, '--input-shape', '28,28,1', '--device', DEVICE,
        '--calibrate-dataset', data])
    meta = yaml.safe_load(open(os.path.join(out, 'serving.yaml')))
    if not meta['bn_fold']:
        raise AssertionError('the calibrated LeNet-5 did not fold')
    served = _serve_artifact(str(out), (28, 28, 1), cut['per_forward'],
                             seed)

    # The recipe's step on one fixed batch, then on the loader's batches
    # under the profiler.
    with open(cfg) as f:
        recipe = yaml.safe_load(f)
    model = init_model_variables('lenet5', recipe['model']['arch_config'],
                                 seed, DEVICE)
    loader = MNISTDataLoader(**{k: v for k, v in recipe['data'].items()
                                if k != 'dataset'}).get_train_loader()
    tx, _ = T.make_optimizer(recipe['optimization'], cut['epochs'],
                             len(loader))
    state = T.TrainState.create(model, tx)
    step = T.make_train_step(T.get_loss_fn(recipe['model']['loss']))
    batches = list(loader)[:EXPERIMENT_PROFILE_STEPS]
    fixed = [tuple(torch.from_numpy(a).to(DEVICE) for a in batches[0])]
    T.train_epoch(step, state, fixed * 3, epoch=1)
    _, fixed_s = _timed(T.train_epoch, step, state,
                        fixed * EXPERIMENT_FIXED_STEPS, 1)
    profiled = loader_profile(step, state, batches)
    return dict(recipe=cut['recipe'], train_images=cut['train'],
                test_images=cut['test'], epochs=cut['epochs'],
                steps_per_epoch=len(loader), train_s=train_s,
                restore_eval_s=eval_s, auto_resume_s=resume_s,
                prepare_s=prepare_s, test_metrics=test_m,
                restored_eval_rel_err=eval_err,
                ms_per_step_loader=timer.ms_per_step(),
                ms_per_step_fixed_batch=fixed_s * 1e3
                / EXPERIMENT_FIXED_STEPS,
                loader_profile=profiled, serving=served)


def imagenet_experiment(root: str, seed: int, train_record: dict) -> dict:
    """(b) The ImageNet KD pair through quant_tpu_torch.examples.imagenet:
    the teacher imagenet_fp.yaml, then imagenet_ls1_kd.yaml from the
    teacher's config.yaml and checkpoint, launches read around each run;
    the teacher as the student's teacher_apply loads it against the
    teacher experiment's own model; serving.prepare
    --calibrate-synthetic and an 'artifact' worker."""
    import yaml

    from quant_tpu_torch import _build
    from quant_tpu_torch.examples import imagenet
    from quant_tpu_torch.serving import prepare
    from quant_tpu_torch.train.kd import make_teacher_apply
    from quant_tpu_torch.train.task import get_teacher_apply

    cut = EXPERIMENT_IMAGENET
    exps = os.path.join(root, 'experiments')
    runs = {}
    for name in ('teacher', 'student'):
        sections = {'data': cut['data']}
        if name == 'student':
            teacher = os.path.join(exps, 'teacher')
            sections['model.kd_config'] = {
                'teacher_config_path': os.path.join(teacher, 'config.yaml'),
                'teacher_checkpoint_path': os.path.join(
                    teacher, 'checkpoints', f'checkpoint_{cut["epochs"]}')}
        cfg = recipe_copy(cut[name], os.path.join(root, f'{name}.yaml'),
                          exps, cut['epochs'], **sections)
        timer = StepTimer()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        (train_m, test_m), run_s = _timed(
            imagenet.main, ['--config', cfg, '--experiment-name', name,
                            '--device', DEVICE], timer.get_hooks)
        launches = {k: v for k, v in launch_counts().items() if v}
        steps = len(timer.marks)
        with open(os.path.join(exps, name, 'config.yaml')) as f:
            written = yaml.safe_load(f)
        batches = -(-cut['data']['test_size']
                    // written['data']['test_batch_size'])
        # The eval forward's stem pool (no gradient) once a batch, and
        # the student's frozen teacher's once a step.
        pools = batches + (steps if name == 'student' else 0)
        if launches != {'max_pool_3x3_s2_p1': pools}:
            raise AssertionError(f'{name}: launches {launches}, expected '
                                 f'{pools} pools')
        if not (os.path.exists(os.path.join(
                exps, name, 'checkpoints', f'checkpoint_{cut["epochs"]}'))
                and len(train_m) == cut['epochs'] and all(
                    np.isfinite(m['Loss']) for m in train_m + test_m)):
            raise AssertionError(f'{name}: {train_m} {test_m}')
        runs[name] = dict(s=run_s, steps=steps, launches=launches,
                          ms_per_step_loader=timer.ms_per_step(),
                          train_metrics=train_m, test_metrics=test_m)
    runs['student']['ms_per_step_fixed_batch'] = train_record['ms_per_step']

    # The teacher the student distilled from, as get_teacher_apply loads
    # it, against the teacher experiment's own model on one batch (both
    # in the recipe's train mode).
    kd = written['model']['kd_config']
    teacher_apply, _ = get_teacher_apply(kd, written.get('seed'), DEVICE)
    own, _, _ = prepare.load_experiment_model(os.path.join(exps, 'teacher'),
                                              DEVICE)
    own_apply = make_teacher_apply(own, bool(kd.get('train_mode')))
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (8,) + tuple(cut['data']['image_shape']), dtype=np.float32)).to(
            DEVICE)
    got, want = teacher_apply(x), own_apply(x)
    if not torch.equal(got, want):
        raise AssertionError('the loaded teacher differs from its '
                             'experiment: max abs err '
                             f'{(got - want).abs().max().item()}')
    del teacher_apply, own, own_apply

    shape = tuple(cut['data']['image_shape'])
    out, prepare_s = _timed(prepare.main, [
        '--experiment', os.path.join(exps, 'student'), '--input-shape',
        ','.join(map(str, shape)), '--device', DEVICE,
        '--calibrate-synthetic', str(cut['calibrate_synthetic'])])
    served = _serve_artifact(str(out), shape, cut['per_forward'], seed + 1)
    return dict(data=cut['data'], epochs=cut['epochs'], runs=runs,
                teacher_equal=True, prepare_s=prepare_s, serving=served)


def load_oracle(name: str) -> tuple[dict, np.ndarray, np.ndarray]:
    """(the reference's state dict, its input NHWC, its logits)."""
    data = np.load(os.path.join(ORACLE_DIR, ORACLES[name]['file']))
    sd = {k[4:]: data[k] for k in data.files if k.startswith('sd::')}
    return (sd, np.ascontiguousarray(np.transpose(data['input'],
                                                  (0, 2, 3, 1))),
            data['logits'])


def _oracle_tree(name: str, sd: dict) -> dict:
    from quant_tpu_torch.utils import torch_import as TI

    spec = ORACLES[name]
    if name == 'resnet':
        return TI.import_resnet_state_dict(sd, num_blocks=spec['num_blocks'])
    return TI.import_lenet_state_dict(sd, conv2_filters=spec['conv2_filters'])


def oracle_model(name: str, device: str, sd: Optional[dict] = None,
                 **kw: Any) -> torch.nn.Module:
    """The oracle's model on `device` holding the reference's state dict
    (the oracle's own unless sd is given), imported through
    utils.torch_import and merged onto the model's variables."""
    from quant_tpu_torch.nn import MODEL_REGISTRY
    from quant_tpu_torch.utils.jax_import import (
        from_jax_variables, to_jax_variables,
    )
    from quant_tpu_torch.utils.torch_import import merge_imported

    if sd is None:
        sd = load_oracle(name)[0]
    cls = MODEL_REGISTRY['lenet5' if name == 'lenet' else 'resnet']
    model = cls(**ORACLES[name]['config'], device=device, **kw)
    return from_jax_variables(model, merge_imported(
        to_jax_variables(model), _oracle_tree(name, sd)))


def _within(got: np.ndarray, want: np.ndarray, tol: float) -> bool:
    """np.testing.assert_allclose(got, want, rtol=tol, atol=tol)'s test."""
    return bool(np.all(np.abs(got - want) <= tol + tol * np.abs(want)))


def oracle_captured(seen: list) -> dict[str, float]:
    """The producer and the conv kernels against their twins on every
    conv input an oracle's packed forward captured (unfolded, EMA
    scales): ls-1 x ls-1 convs through xnor_conv2d, the others through
    planes_captured; returns {kernel: max abs error}."""
    from quant_tpu_torch.ops import binary_infer as B

    errs = {'pack_sign_planes': 0.0}
    multi = [(c, x, t) for c, x, t in seen
             if B.sign_planes(c.x_quant) > 1 or c.w_packed.shape[0] > 1]
    if multi:
        errs.update(planes_captured(multi))
    for i, (conv, xin, tail) in enumerate(seen):
        if any(conv is c for c, *_ in multi):
            continue
        xp, args = _producer_args(conv, xin)
        for x in (xp, xp.float()):
            errs['pack_sign_planes'] = max(
                errs['pack_sign_planes'], check_equal(
                    f'pack_sign_planes oracle {i} {x.dtype}',
                    B.pack_sign_planes(x, 1, *args),
                    B.pack_sign_planes_plain(x, 1, *args)))
        conv_args = (B.pack_sign_planes_plain(xp, 1, *args)[0],
                     conv.w_packed[0].contiguous(), args[0][0],
                     conv.w_scales[0], conv.bias)
        kw = dict(in_channels=xin.shape[-1], stride=conv.stride,
                  padding=conv.padding)
        for dt in (torch.bfloat16, torch.float32):
            t = tail_as(tail, dt)
            errs['xnor_conv2d'] = max(errs.get('xnor_conv2d', 0.0),
                                      check_equal(
                f'xnor_conv2d oracle {i} {dt}',
                B.xnor_conv2d(*conv_args, out_dtype=dt, tail=t, **kw),
                B.xnor_conv2d_plain(*conv_args, out_dtype=dt, tail=t,
                                    **kw)))
    torch.cuda.synchronize()
    return errs


def _oracle_round_trip(name: str) -> dict:
    """The oracle imported into a model on the card, exported back
    (utils.torch_export) and imported into a fresh model: the export
    equals the reference's state dict (its BN batch counters, which the
    tree does not track, aside) and the fresh model's tree the source's,
    leaf for leaf."""
    from quant_tpu_torch.utils import torch_export as TE
    from quant_tpu_torch.utils.jax_import import to_jax_variables

    sd = load_oracle(name)[0]
    spec = ORACLES[name]
    source = to_jax_variables(oracle_model(name, DEVICE,
                                           inference_mode='dense'))
    if name == 'resnet':
        exported = TE.export_resnet_state_dict(
            source, num_blocks=spec['num_blocks'], momentum=0.99)
    else:
        exported = TE.export_lenet_state_dict(
            source, conv2_filters=spec['conv2_filters'], momentum=0.99)
    if set(exported) != set(sd):
        raise AssertionError(f'{name} export: keys differ from the '
                             'reference state dict')
    for k, v in exported.items():
        counter = (k.endswith('num_batches_tracked')
                   and 'moving_avg_module' not in k)
        if v.shape != sd[k].shape or not (
                counter or np.array_equal(v, sd[k])):
            raise AssertionError(f'{name} export: {k} differs')
    back = to_jax_variables(oracle_model(name, DEVICE, sd=exported,
                                         inference_mode='dense'))
    paths = dict(_tree_leaves(source))
    for path, leaf in _tree_leaves(back):
        if not (leaf.dtype == paths[path].dtype
                and np.array_equal(leaf, paths[path])):
            raise AssertionError(f'{name} round trip: {path} differs')
    if len(paths) != len(_tree_leaves(back)):
        raise AssertionError(f'{name} round trip: leaves differ')
    return dict(keys=len(exported), leaves=len(paths))


def _tree_leaves(tree: dict, prefix: str = '') -> list:
    if not isinstance(tree, dict):
        return [(prefix, np.asarray(tree))]
    return [leaf for k, v in tree.items()
            for leaf in _tree_leaves(v, f'{prefix}/{k}')]


def oracle_phase() -> tuple[dict, dict[str, float]]:
    """The reference-checkpoint oracles on the card (ORACLE_RUNS): each
    forward's launches read around it, held to the reference's logits;
    each packed forward's kernels held to their twins on the captured
    inputs; each dense forward beside the CPU's. A dense forward past
    ORACLE_DENSE_TOL of the reference (the card's float32 sum order) is
    held instead to FP32_REL_TOL of the spread against the CPU's, with
    the reference's argmax. Then the export -> import round trip on the
    card. Returns (record, {kernel: max abs error})."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.nn.export import export_packed_variables

    t0 = time.perf_counter()
    runs, errs = [], {}
    for name, mode, route, want in ORACLE_RUNS:
        _, x, ref = load_oracle(name)
        model = oracle_model(name, DEVICE, inference_mode=mode,
                             sign_compute=route)
        if mode == 'packed':
            export_packed_variables(model)
        seen, hooks = capture_conv_inputs(model)
        xt = torch.from_numpy(x).to(DEVICE)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        with torch.inference_mode():
            out = model(xt)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        for h in hooks:
            h.remove()
        out = out.cpu().numpy()
        run = dict(oracle=name, mode=mode, sign_compute=route,
                   launches=launches,
                   max_abs_err=float(np.abs(out - ref).max()),
                   argmax_equal=bool(np.array_equal(out.argmax(-1),
                                                    ref.argmax(-1))))
        label = f'oracle {name} {mode} {route}'
        if launches != want:
            raise AssertionError(f'{label}: launches {launches}, expected '
                                 f'{want}')
        if mode == 'packed':
            run['held_to'] = 'reference'
            if not (_within(out, ref, ORACLE_PACKED_TOL)
                    and run['argmax_equal']):
                raise AssertionError(f'{label}: {run}')
            if launches:
                with torch.inference_mode():
                    captured = oracle_captured(seen)
                for kname, err in captured.items():
                    errs[kname] = max(errs.get(kname, 0.0), err)
                run['captured'] = captured
        else:
            with torch.inference_mode():
                cpu = oracle_model(name, 'cpu', inference_mode=mode)(
                    torch.from_numpy(x)).numpy()
            run['cpu_max_abs_err'] = float(np.abs(out - cpu).max())
            spread = float(cpu.max() - cpu.min())
            if _within(out, ref, ORACLE_DENSE_TOL):
                run['held_to'] = 'reference'
            elif (run['cpu_max_abs_err'] <= FP32_REL_TOL * spread
                  and run['argmax_equal']):
                run['held_to'] = 'cpu'
            else:
                raise AssertionError(f'{label}: {run}')
        print(f'{label}: {run}', flush=True)
        runs.append(run)
    round_trip = {name: _oracle_round_trip(name) for name in ORACLES}
    record = dict(runs=runs, round_trip=round_trip,
                  s=time.perf_counter() - t0)
    print(json.dumps({'oracle_phase': record}), flush=True)
    return record, errs


def _pod_config(cfg_path: str, name: str, **over: Any) -> dict:
    """The recipe copy's config as the MNIST driver parses it."""
    from quant_tpu_torch.config import get_base_argument_parser, parse_config

    config = parse_config(get_base_argument_parser('pod').parse_args(
        ['--config', cfg_path, '--experiment-name', name, '--device',
         DEVICE]))
    for section, keys in over.items():
        config[section] = {**config[section], **keys}
    return config


def pod_reference(config: dict, world: int) -> tuple[dict, dict, dict]:
    """The single-process run of the pod's logical batches (the ranks'
    shards in rank order) in this process: (train metrics, test
    metrics, {'s': the run's seconds, 'epoch_s': its train and eval})."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.data import MNISTDataLoader
    from quant_tpu_torch.parallel.multihost import shard_loader_for_host
    from quant_tpu_torch.train.task import init_model_variables

    t0 = time.perf_counter()
    data = MNISTDataLoader(**{k: v for k, v in config['data'].items()
                              if k != 'dataset'})
    shards = [shard_loader_for_host(data.get_train_loader(), pi, world)
              for pi in range(world)]
    logical = [(np.concatenate([b[0] for b in step]),
                np.concatenate([b[1] for b in step]))
               for step in zip(*shards)]
    model_cfg = config['model']
    model = init_model_variables(model_cfg['architecture'],
                                 model_cfg['arch_config'], config.get('seed'),
                                 DEVICE)
    tx, _ = T.make_optimizer(config['optimization'],
                             config['optimization']['epochs'], len(logical))
    state = T.TrainState.create(model, tx)
    loss = T.get_loss_fn(model_cfg['loss'])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, train_m = T.train_epoch(T.make_train_step(loss), state, logical,
                                   epoch=1, log_interval=10 ** 6)
    test_m = T.evaluate(T.make_eval_step(loss), state,
                        data.get_test_loader())
    torch.cuda.synchronize()
    done = time.perf_counter()
    return train_m, test_m, dict(s=done - t0, epoch_s=done - t1,
                                 steps=len(logical))


def _pod_preempt(cfg_path: str, exps: str, env: dict) -> dict:
    """A world of 2 (gloo) on POD_MNIST['preempt_epochs'] epochs, SIGTERM
    to rank 1 once checkpoint_3 exists: both ranks stop at one step (a
    rank left in a step's collectives would hold the run to its
    timeout), rank 0 writes one interrupt checkpoint, both exit 0. The
    third epoch's seconds come from the checkpoints' times."""
    import signal
    import threading

    from quant_tpu_torch.experiment import Experiment
    from quant_tpu_torch.parallel.multihost import BACKEND_ENV
    from quant_tpu_torch.platform import PodComputePlatform
    from quant_tpu_torch.train.task import classification_task
    from quant_tpu_torch.utils.checkpoints import (
        get_path_to_checkpoint, restore_checkpoint,
    )

    epochs = POD_MNIST['preempt_epochs']
    config = _pod_config(cfg_path, 'pod_preempt',
                         optimization={'epochs': epochs},
                         log={'save_model_freq': 1})
    ckpts = os.path.join(exps, 'pod_preempt', 'checkpoints')
    fired: dict = {}

    def preempt_rank_1(procs: list) -> None:
        def fire() -> None:
            deadline = time.monotonic() + POD_TIMEOUT / 2
            while (not os.path.exists(os.path.join(ckpts, 'checkpoint_3'))
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            fired['t'] = time.perf_counter()
            procs[1].send_signal(signal.SIGTERM)
        threading.Thread(target=fire, daemon=True).start()

    platform = PodComputePlatform(2, env={**env, BACKEND_ENV: 'gloo'},
                                  timeout=POD_TIMEOUT)
    platform.on_spawn = preempt_rank_1
    t0 = time.perf_counter()
    platform.run(Experiment(classification_task, config))
    done = time.perf_counter()
    tag = os.path.basename(str(get_path_to_checkpoint(os.path.dirname(
        ckpts))))
    payload = restore_checkpoint(os.path.join(ckpts, tag))
    interrupted = int(tag.rsplit('_', 1)[1])
    written = sorted(os.listdir(ckpts))
    # Stopped in training, the payload resumes the interrupted epoch;
    # stopped in its eval, the next (train.task).
    if not (int(payload['epoch']) in (interrupted - 1, interrupted)
            and interrupted < epochs and len(written) == interrupted):
        raise AssertionError(f'pod preemption: {tag}, payload epoch '
                             f'{payload["epoch"]}, checkpoints {written}')
    epoch_s = (os.path.getmtime(os.path.join(ckpts, 'checkpoint_3'))
               - os.path.getmtime(os.path.join(ckpts, 'checkpoint_2')))
    return dict(epochs=epochs, interrupted_epoch=interrupted,
                checkpoint_step=int(payload['step']), checkpoints=written,
                s=done - t0, stop_s=done - fired['t'], epoch3_s=epoch_s)


def _dp_step(case: str, rows: slice, mesh: Any = None,
             shard: bool = False, trace: bool = False) -> dict:
    """One train step of a DP_STEP_CASES model on rows of its seeded
    batch, on the card: {'leaves': {path: array}} of the gradients and
    the variables after the step (a model sharded over the mesh's
    'model' axis with `shard`, gathered), the loss and the metrics; with
    `trace`, also {'trace': {module: array}}: the stem conv's output and
    each binary conv's input in the step's forward."""
    from quant_tpu_torch import train as T
    from quant_tpu_torch.nn.layers import QuantConv2d
    from quant_tpu_torch.parallel.sharding import (
        gather_model_variables, shard_model,
    )
    from quant_tpu_torch.train.metrics import init_metric_state

    family, xq, wq, loss_name, shape, kw = {**DP_STEP_CASES,
                                            **TP_STEP_CASES}[case]
    gen = torch.Generator().manual_seed(0)
    model = models.build(family, models.small_config(family, xq, wq),
                         device='cpu', generator=gen, **kw)
    models.seed_state(model, gen)
    model = model.to(DEVICE)
    if shard:
        shard_model(model, mesh)
    traced: dict = {}

    def keep(name: str) -> Callable:
        def hook(mod: Any, args: tuple, out: torch.Tensor) -> None:
            traced[name] = (out if name == 'conv1'
                            else args[0]).detach().cpu()
        return hook
    hooks = [m.register_forward_hook(keep(name))
             for name, m in model.named_modules()
             if trace and (name == 'conv1' or isinstance(m, QuantConv2d))]
    tx, _ = T.make_optimizer(
        {'epochs': 1, 'optimizer': {'algorithm': 'sgd', 'lr': 0.1},
         'lr_scheduler': {'scheduler': 'step_lr', 'step_size': 1,
                          'gamma': 1.0}}, 1, 1)
    state = T.TrainState.create(model, tx)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (DP_STEP_BATCH,) + shape).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, DP_STEP_BATCH))
    step = T.make_train_step(T.get_loss_fn(loss_name), mesh=mesh)
    state, metric_state, loss = step(state, x[rows].to(DEVICE),
                                     y[rows].to(DEVICE), init_metric_state())
    for h in hooks:
        h.remove()
    leaves: dict = {}

    def walk(tree: Any, prefix: str) -> None:
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f'{prefix}/{k}')
        else:
            leaves[prefix] = np.asarray(tree)
    walk(gather_model_variables(model), 'tree')
    saved = [(p, p.data) for p in model.parameters()]
    try:  # the gradients, gathered as the parameters are
        for p in model.parameters():
            p.data = (p.grad if p.grad is not None
                      else torch.zeros_like(p.data))
        walk(gather_model_variables(model)['params'], 'grad')
    finally:
        for p, data in saved:
            p.data = data
    return dict(leaves=leaves, loss=float(loss), trace=traced,
                metrics=T.MetricAccumulator(state=metric_state).compute())


def dp_step_worker(rank: int, port: int, out: str, device: str,
                   cudnn: bool) -> int:
    """One rank of the DP step (chip_smoke.py --dp-step-worker): joins a
    gloo world of DP_STEP_WORLD on `device` (DEVICE of the process that
    spawned it), steps each case on its half of the batch, then again
    with its statistics left local (the control), and saves the results
    at `out`."""
    import contextlib

    from quant_tpu_torch.parallel import make_mesh, multihost
    from quant_tpu_torch.train import engine

    global DEVICE
    DEVICE = device
    if device == 'cuda' and not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    os.environ[multihost.BACKEND_ENV] = 'gloo'
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.enabled = cudnn
    multihost.initialize(f'127.0.0.1:{port}', DP_STEP_WORLD, rank,
                         device=DEVICE)
    mesh = make_mesh(device_type=DEVICE)
    per = DP_STEP_BATCH // DP_STEP_WORLD
    rows = slice(rank * per, (rank + 1) * per)
    results = {}
    global_over = engine.global_stats.over
    try:
        for case in DP_STEP_CASES:
            results[case] = _dp_step(case, rows, mesh)
            engine.global_stats.over = (
                lambda group: contextlib.nullcontext())
            results[case + '_local'] = _dp_step(case, rows, mesh)
            engine.global_stats.over = global_over
    finally:
        engine.global_stats.over = global_over
        torch.distributed.destroy_process_group()
    torch.save(results, out)
    return 0


def cudnn_wgrad_check() -> dict:
    """The LeNet-5 conv1's weight gradient (1 -> 8 channels, 5x5, 28 px)
    at 8 rows and as the sum of two halves of 4, each relative to the
    float64 value on the CPU (the largest entry's error over the largest
    entry), with cuDNN on and off."""
    gen = torch.Generator().manual_seed(0)
    x, w, gy = (torch.randn(shape, generator=gen, dtype=torch.float64)
                for shape in ((8, 1, 28, 28), (8, 1, 5, 5), (8, 8, 24, 24)))

    def wgrad(rows: slice, dtype: torch.dtype, device: str) -> torch.Tensor:
        ww = w.to(device, dtype).detach().requires_grad_()
        F.conv2d(x[rows].to(device, dtype), ww).backward(
            gy[rows].to(device, dtype))
        return ww.grad.double().cpu()

    exact = wgrad(slice(None), torch.float64, 'cpu')
    out = {}
    saved = torch.backends.cudnn.enabled
    try:
        for cudnn in (True, False):
            torch.backends.cudnn.enabled = cudnn
            for name, got in (
                    ('8_rows', wgrad(slice(None), torch.float32, DEVICE)),
                    ('4_plus_4', wgrad(slice(0, 4), torch.float32, DEVICE)
                     + wgrad(slice(4, 8), torch.float32, DEVICE))):
                out[f'cudnn_{"on" if cudnn else "off"}_{name}'] = float(
                    (got - exact).abs().max() / exact.abs().max())
    finally:
        torch.backends.cudnn.enabled = saved
    return out


def _run_ranks(root: str, name: str, world: int,
               argv: Callable[[int, int, str], list]) -> list:
    """Run `world` ranks of this script, rank r with argv(r, port, out)
    (a free local port; `out` under root, where the rank saves its
    results), one deadline of POD_TIMEOUT s; their results. Raises with a
    failed rank's output; kills every rank that outlives the deadline."""
    import socket

    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(root, f'{name}{r}.pt') for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv(r, port, outs[r])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=POD_TIMEOUT)[0].decode(
                errors='replace'))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f'{name} rank failed:\n{log[-3000:]}')
    return [torch.load(o, weights_only=False) for o in outs]


def dp_step_phase(root: str) -> dict:
    """The DP step of DP_STEP_CASES on the card (a world of 2 on gloo)
    against this process's step on the whole batch; raises past
    DP_STEP_TOL, or if the local-statistics control does not differ."""
    t0 = time.perf_counter()
    ranks = _run_ranks(root, 'dp_step', DP_STEP_WORLD, lambda r, port, out: [
        '--dp-step-worker', str(r), str(port), out, DEVICE,
        str(int(DP_STEP_CUDNN))])
    out: dict = dict(batch=DP_STEP_BATCH, world=DP_STEP_WORLD,
                     backend='gloo', tol=DP_STEP_TOL, cases={})
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = DP_STEP_CUDNN
    try:
        wants = {case: _dp_step(case, slice(None)) for case in DP_STEP_CASES}
    finally:
        torch.backends.cudnn.enabled = cudnn
    out.update(cudnn=DP_STEP_CUDNN, cudnn_wgrad=cudnn_wgrad_check())
    for case, want in wants.items():
        rec: dict = dict(max_abs_err=0.0, worst_excess=0.0, worst=None)
        for got in (r[case] for r in ranks):
            if set(got['leaves']) != set(want['leaves']):
                raise AssertionError(f'dp step {case}: leaves differ')
            pairs = [(k, got['leaves'][k], want['leaves'][k])
                     for k in want['leaves']]
            pairs.append(('loss', np.float64(got['loss']),
                          np.float64(want['loss'])))
            pairs += [(k, np.float64(got['metrics'][k]), np.float64(v))
                      for k, v in want['metrics'].items()]
            for k, g, w in pairs:
                err = np.abs(g - w)
                rec['max_abs_err'] = max(rec['max_abs_err'],
                                         float(err.max(initial=0.0)))
                excess = float((err - (DP_STEP_TOL['atol'] + DP_STEP_TOL[
                    'rtol'] * np.abs(w))).max(initial=0.0))
                if excess > rec['worst_excess']:
                    rec.update(worst_excess=excess, worst=k)
        local = ranks[0][case + '_local']['leaves']
        rec['local_stats_diff'] = max(
            float(np.abs(local[k] - want['leaves'][k]).max())
            for k in want['leaves'] if k.startswith('tree/batch_stats'))
        out['cases'][case] = rec
        if rec['worst_excess'] > 0:
            raise AssertionError(f'dp step {case} vs the single process '
                                 f'past {DP_STEP_TOL}: {rec}')
        if not rec['local_stats_diff'] > DP_LOCAL_MIN_DIFF:
            raise AssertionError(f'dp step {case}: the local-statistics '
                                 f'control does not differ: {rec}')
    out['s'] = time.perf_counter() - t0
    print(f'dp step ({DEVICE}): {out}', flush=True)
    return out


def pod_phase(root: str, seed: int) -> dict:
    """The MNIST recipe through PodComputePlatform (POD_RUNS), each world
    against the single-process run of its logical batches, the ranks'
    metrics equal; then the preempted pod. Seconds of each part. Pods
    and this process run cuDNN's deterministic algorithms
    (POD_DETERMINISTIC)."""
    from quant_tpu_torch.pod_worker import DETERMINISTIC_ENV

    t0 = time.perf_counter()
    data = os.path.join(root, 'mnist_pod')
    os.makedirs(data)
    write_mnist(data, POD_MNIST['train'], POD_MNIST['test'], seed + 1)
    exps = os.path.join(root, 'pod_experiments')
    cfg_path = recipe_copy(EXPERIMENT_MNIST['recipe'],
                           os.path.join(root, 'pod.yaml'), exps,
                           POD_MNIST['epochs'],
                           data={'dataset_path': data})
    out: dict = dict(images=POD_MNIST, worlds=[],
                     deterministic=POD_DETERMINISTIC)
    # Why the comparison runs deterministic: one process against itself
    # under cuDNN's default algorithms.
    config = _pod_config(cfg_path, 'pod_default_cudnn')
    runs = [pod_reference(config, 1)[:2] for _ in range(2)]
    out['default_cudnn_spread'] = {
        part: abs(runs[0][i]['Loss'] - runs[1][i]['Loss'])
        / abs(runs[1][i]['Loss']) for i, part in enumerate(('train',
                                                             'test'))}
    env = {DETERMINISTIC_ENV: '1'} if POD_DETERMINISTIC else {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = POD_DETERMINISTIC
    try:
        out['dp_step'] = dp_step_phase(root)
        _pod_worlds(cfg_path, env, out)
        out['preempt'] = _pod_preempt(cfg_path, exps, env)
    finally:
        torch.backends.cudnn.deterministic = saved
    steps = out['worlds'][-1]['single_process']['steps']
    out['preempt']['ms_per_step'] = out['preempt']['epoch3_s'] / steps * 1e3
    out['single_process_ms_per_step'] = (
        out['worlds'][-1]['single_process']['epoch_s'] / steps * 1e3)
    print(f'pod preempted: {out["preempt"]}; single process '
          f'{out["single_process_ms_per_step"]} ms a step; one process '
          f'against itself, default cuDNN, loss relative: '
          f'{out["default_cudnn_spread"]}', flush=True)
    out['s'] = time.perf_counter() - t0
    return out


def _pod_worlds(cfg_path: str, env: dict, out: dict) -> None:
    """Each world of POD_RUNS against this process's run of its logical
    batches, the ranks' metrics equal; records into out['worlds']."""
    from quant_tpu_torch.experiment import Experiment
    from quant_tpu_torch.parallel.multihost import BACKEND_ENV
    from quant_tpu_torch.platform import PodComputePlatform
    from quant_tpu_torch.train.task import classification_task

    for world, backend in POD_RUNS:
        config = _pod_config(cfg_path, f'pod_world{world}')
        platform = PodComputePlatform(
            world, env={**env, BACKEND_ENV: backend} if backend else env,
            timeout=POD_TIMEOUT)
        t1 = time.perf_counter()
        train_m, test_m = platform.run(Experiment(classification_task,
                                                  config))
        pod_s = time.perf_counter() - t1
        if any(m != platform.rank_metrics[0]
               for m in platform.rank_metrics):
            raise AssertionError(f'pod world {world}: ranks disagree '
                                 f'{platform.rank_metrics}')
        ref_train, ref_test, ref_time = pod_reference(config, world)
        diffs = {}
        for part, got, want, n in (
                ('train', train_m[0], ref_train, POD_MNIST['train']),
                ('test', test_m[0], ref_test, POD_MNIST['test'])):
            diffs[part] = dict(
                loss_rel_err=abs(got['Loss'] - want['Loss'])
                / abs(want['Loss']),
                **{f'{k} examples': round(abs(got[k] - want[k]) * n, 6)
                   for k in ('Top-1 Accuracy', 'Top-5 Accuracy')})
        record = dict(world=world, backend=backend or (
            'nccl' if DEVICE == 'cuda' else 'gloo'), pod_s=pod_s,
            single_process=ref_time, train=train_m[0], test=test_m[0],
            single_train=ref_train, single_test=ref_test, diffs=diffs)
        print(f'pod world {world}: {record}', flush=True)
        for part, d in diffs.items():
            loss_rtol, examples = POD_LIMITS[world][part]
            if not (d['loss_rel_err'] <= loss_rtol
                    and d['Top-1 Accuracy examples'] <= examples
                    and d['Top-5 Accuracy examples'] <= examples):
                raise AssertionError(f'pod world {world} {part} vs the '
                                     f'single process: {d}')
        out['worlds'].append(record)


def experiment_phase(seed: int, train_record: dict) -> dict:
    """The experiment phase, in a temporary directory removed after; the
    pod phase within it."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='qtt_experiment_') as root:
        out = dict(mnist=mnist_experiment(root, seed))
        print(f'experiment mnist: {out["mnist"]}', flush=True)
        out['pod'] = pod_phase(root, seed)
        out['imagenet'] = imagenet_experiment(root, seed, train_record)
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'experiment_phase': out}), flush=True)
    return out


def _sync() -> None:
    if DEVICE == 'cuda':
        torch.cuda.synchronize()


def _host_ms(fn: Callable[[], Any], iters: int) -> float:
    """ms a call of fn back to back, host included, after one warm-up,
    ended by a synchronize: gloo's collectives run on the host, so this
    is the time a caller gets. The ranks of a group call it alike."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    return (time.perf_counter() - t0) / iters * 1e3


def tp_serving_model(name: str, seed: int) -> torch.nn.Module:
    """TP_SERVING's model on the CPU: the main path's ResNet-18, or
    ('small') its small_config form (the CPU rehearsal's)."""
    if name == 'resnet18':
        return models.seeded_serving_resnet18('cpu', seed)

    def make(x_quant: str, w_quant: str, **kw: Any) -> torch.nn.Module:
        return models.build('xnor', models.small_config('xnor', x_quant,
                                                        w_quant), **kw)
    return models.seeded_model(make, 'ls-1', 'ls-1', 'cpu', seed)


class _SummingGather(torch.autograd.Function):
    """The all-gather of torch.distributed.nn.functional, whose backward
    reduce-scatters (sums) the group's gradients: here an all-reduce and
    this rank's slice (the library's gloo path scatters, which gloo takes
    on host tensors only)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, tp: Any) -> torch.Tensor:
        from quant_tpu_torch.parallel.sharding import all_gather_cat
        ctx.tp = tp
        return all_gather_cat(x, -1, tp)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> tuple:
        grad = grad.contiguous().clone()
        torch.distributed.all_reduce(grad, group=ctx.tp.group)
        return grad.chunk(ctx.tp.size, -1)[ctx.tp.index].contiguous(), None


def _tp_ring(mesh: Any, spec: dict) -> dict:
    """The packed ring GEMM of this rank's K/P words against the twin on
    the whole operands; its launches, and ms of the ring, the naive form
    and (on the card) one block's xnor_gemm."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.ops import binary_gemm as G
    from quant_tpu_torch.parallel import tp_packed_matmul_overlapped
    from quant_tpu_torch.parallel.sharding import tensor_parallel

    tp = tensor_parallel(mesh)
    m, k, n = spec['ring']
    words, wl, nb = k // 32, k // 32 // tp.size, n // tp.size
    gen = torch.Generator().manual_seed(spec['seed'])
    xp, wp = (torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                            dtype=torch.int32).to(DEVICE)
              for shape in ((m, words), (words, n)))
    mine = slice(tp.index * wl, (tp.index + 1) * wl)
    x_loc, w_loc = xp[:, mine].contiguous(), wp[mine].contiguous()
    ones_m, ones_n = (torch.ones(d, device=DEVICE) for d in (m, n))

    def ring(gather: bool = True) -> torch.Tensor:
        return tp_packed_matmul_overlapped(x_loc, w_loc, k, mesh,
                                           gather_output=gather)

    def naive() -> torch.Tensor:
        part = G.xnor_gemm(x_loc, w_loc, ones_m, ones_n, k // tp.size)
        torch.distributed.all_reduce(part, group=tp.group)
        return part

    want = G.xnor_gemm_plain(xp, wp, ones_m, ones_n, k)
    _sync()
    _build.reset_launch_counts()
    got = ring()
    _sync()
    launches = _build.launch_counts()
    out = dict(shape=[m, k, n], ranks=tp.size, launches=launches,
               max_abs_err=check_equal('tp ring', got, want))
    check_equal('tp ring scattered', ring(False),
                want[:, tp.index * nb:(tp.index + 1) * nb])
    check_equal('tp naive', naive(), want)
    out.update(ring_ms=_host_ms(ring, spec['iters']),
               naive_ms=_host_ms(naive, spec['iters']))
    if DEVICE == 'cuda':
        w_blk = w_loc[:, :nb].contiguous()
        out['block_ms'] = card_ms(lambda: G.xnor_gemm(
            x_loc, w_blk, ones_m, ones_n[:nb], k // tp.size), spec['iters'])
    return out


def _tp_round(model: torch.nn.Module, images: np.ndarray, leader: bool,
              dtype: Optional[torch.dtype], iters: int) -> dict:
    """One engine over the model in `dtype`: the leader queues every
    image before the scheduler starts (one batch, the batch predict
    runs), then predicts and times predict; a follower serves until the
    leader stops. The leader's logits, its queued-vs-predict difference,
    ms a predict and stats."""
    from quant_tpu_torch.serving.engine import InferenceEngine

    model.eval_dtype = dtype
    engine = InferenceEngine(model, images.shape[1:], max_batch=len(images),
                             max_wait_ms=5.0, device=DEVICE)
    if not leader:
        engine.start()
        engine.stop(timeout=POD_TIMEOUT)
        if engine.ping() or engine._thread.is_alive():
            raise AssertionError('tp follower did not stop')
        return {}
    futures = [engine.submit(img) for img in images]
    engine.start()
    try:
        queued = np.stack([f.result(timeout=POD_TIMEOUT) for f in futures])
        logits = engine.predict(images)
        ms = _host_ms(lambda: engine.predict(images), iters)
        stats = {k: engine.stats[k] for k in ('requests', 'batches')}
    finally:
        engine.stop()
    return dict(logits=logits, engine_ms=ms, stats=stats,
                queued_max_abs_err=float(np.abs(queued - logits).max()))


def _tp_serving(mesh: Any, spec: dict, leader: bool) -> dict:
    """The sharded serving model through the TP engine, bf16 then
    float32; launches and forwards of the bf16 round, the captured
    kernels against their twins, ms of a bare forward."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.nn.layers import QuantConv2d
    from quant_tpu_torch.ops.conv import max_pool2d
    from quant_tpu_torch.ops.pool import max_pool_3x3_s2_p1
    from quant_tpu_torch.parallel import shard_model

    serving = spec['serving']
    model = shard_model(tp_serving_model(serving['model'], spec['seed']).to(
        DEVICE), mesh)
    images = np.random.default_rng(spec['seed']).standard_normal(
        (serving['batch'],) + tuple(serving['input'])).astype(np.float32)
    # Forwards counted; the first one's conv inputs and pool input kept.
    seen: list = []
    stems: list = []
    forwards = [0]

    def count(mod: Any, args: tuple) -> None:
        forwards[0] += 1

    def first(keep: list, value: Any) -> None:
        if forwards[0] == 1:
            keep.append(value)

    convs = [m for m in model.modules() if isinstance(m, QuantConv2d)]
    hooks = [model.register_forward_pre_hook(count),
             model.bn1.register_forward_hook(
                 lambda mod, args, out: first(stems, torch.relu(out)))]
    hooks += [m.register_forward_pre_hook(
        lambda mod, args: first(seen, (mod, args[0], None))) for m in convs]
    _sync()
    _build.reset_launch_counts()
    out = dict(bf16=_tp_round(model, images, leader, torch.bfloat16,
                              spec['iters']))
    _sync()
    out.update(launches=_build.launch_counts(), forwards=forwards[0])
    for h in hooks:
        h.remove()
    if len(seen) != len(convs):
        raise AssertionError(f'tp: {len(seen)} conv inputs captured of '
                             f'{len(convs)}')
    with torch.inference_mode():
        out['captured'] = captured_phases(seen)
        stem = stems[0].contiguous()
        out['captured']['max_pool_3x3_s2_p1'] = check_equal(
            'tp pool captured', max_pool_3x3_s2_p1(stem),
            max_pool2d(stem, kernel_size=3, stride=2, padding=1))
    out['conv_out_channels'] = sorted({c.w_packed.shape[-1] for c in convs})
    x = torch.from_numpy(images).to(DEVICE)
    with torch.inference_mode():
        out['forward_ms'] = _host_ms(lambda: model(x), spec['iters'])
    out['f32'] = _tp_round(model, images, leader, None, spec['iters'])
    return out


def tp_worker(rank: int, port: int, out: str, spec_path: str) -> int:
    """One rank of the TP phase (chip_smoke.py --tp-worker): joins a gloo
    world of TP_WORLD, runs the ring, the TP serving rounds (rank 0
    leads) and the TP train steps with cuDNN off (and the summing
    control), and saves the results at `out`."""
    from quant_tpu_torch.nn import layers
    from quant_tpu_torch.parallel import make_mesh, multihost

    global DEVICE
    with open(spec_path) as f:
        spec = json.load(f)
    DEVICE = spec['device']
    if DEVICE == 'cuda' and not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    os.environ[multihost.BACKEND_ENV] = 'gloo'
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    multihost.initialize(f'127.0.0.1:{port}', spec['world'], rank,
                         device=DEVICE)
    mesh = make_mesh(model=spec['world'], device_type=DEVICE)
    results: dict = {}
    gather = layers.gather_channels
    try:
        results['ring'] = _tp_ring(mesh, spec)
        results['serving'] = _tp_serving(mesh, spec, rank == 0)
        torch.backends.cudnn.enabled = spec['cudnn']
        results['steps'] = {case: _dp_step(case, slice(None), mesh, True,
                                           case == TP_FLIP_CASE)
                            for case in (*TP_STEP_CASES, TP_FLIP_CASE)}
        layers.gather_channels = _SummingGather.apply
        results['steps']['lenet_summing'] = _dp_step('lenet', slice(None),
                                                     mesh, True)
    finally:
        layers.gather_channels = gather
        torch.distributed.destroy_process_group()
    torch.save(results, out)
    return 0


def _tp_launches(got: dict, calls: int, per_call: dict) -> dict:
    """A rank's launches over `calls` forwards (or ring calls): per call,
    raising unless they are per_call's, and nothing else."""
    want = {k: per_call.get(k, 0) * calls for k in got}
    if got != want:
        raise AssertionError(f'tp launches {got}, expected {want}')
    return {k: v // max(calls, 1) for k, v in got.items() if v}


def _max_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max())


def _tp_workers(root: str, seed: int) -> list[dict]:
    """Run TP_WORLD tp_worker ranks; their results."""
    spec = dict(seed=seed, device=DEVICE, world=TP_WORLD, ring=TP_RING_SHAPE,
                serving=TP_SERVING, iters=TP_ITERS, cudnn=DP_STEP_CUDNN)
    spec_path = os.path.join(root, 'tp_spec.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    return _run_ranks(root, 'tp', TP_WORLD, lambda r, port, out: [
        '--tp-worker', str(r), str(port), out, spec_path])


def _tp_serving_gates(ranks: list[dict], seed: int) -> dict:
    """The TP engine's logits against the unsharded engine's on the card,
    launches a forward, the captured kernels' errors; ms beside the
    unsharded engine's."""
    serving = TP_SERVING
    model = tp_serving_model(serving['model'], seed).to(DEVICE)
    images = np.random.default_rng(seed).standard_normal(
        (serving['batch'],) + tuple(serving['input'])).astype(np.float32)
    x = torch.from_numpy(images).to(DEVICE)
    ref = {}
    with tf32(False):
        for name, dt in (('bf16', torch.bfloat16), ('f32', None)):
            ref[name] = _tp_round(model, images, True, dt, TP_ITERS)
            with torch.inference_mode():
                ref[name]['forward_ms'] = _host_ms(lambda: model(x),
                                                   TP_ITERS)
    lead = ranks[0]['serving']
    f32 = lead['f32']['logits']
    np.testing.assert_allclose(f32, ref['f32']['logits'], **TP_F32_TOL,
                               err_msg='tp float32 chain vs unsharded')
    bf16, want16 = lead['bf16']['logits'], ref['bf16']['logits']
    spread = float(want16.max() - want16.min())
    bf16_err = _max_err(bf16, want16)
    if not (bf16.shape == (serving['batch'], serving['classes'])
            and np.isfinite(bf16).all()
            and bf16_err <= TP_BF16_REL_TOL * spread):
        raise AssertionError(f'tp bf16 chain vs unsharded: {bf16_err} of '
                             f'spread {spread}')
    for name in ('bf16', 'f32'):
        if lead[name]['queued_max_abs_err'] > 1e-6:
            raise AssertionError(f'tp {name} queued differs from predict')
    captured = {}
    for r in ranks:
        for kname, err in r['serving']['captured'].items():
            captured[kname] = max(captured.get(kname, 0.0), err)
    per_forward = [_tp_launches(r['serving']['launches'],
                                r['serving']['forwards'],
                                serving['per_forward']) for r in ranks]
    return dict(
        batch=serving['batch'], per_forward=per_forward,
        forwards=[r['serving']['forwards'] for r in ranks],
        conv_out_channels=lead['conv_out_channels'], captured=captured,
        f32_max_abs_err=_max_err(f32, ref['f32']['logits']),
        bf16_max_abs_err=bf16_err, bf16_spread=spread,
        bf16_rel_err=bf16_err / spread,
        engine_ms={'tp': lead['bf16']['engine_ms'],
                   'unsharded': ref['bf16']['engine_ms']},
        engine_f32_ms={'tp': lead['f32']['engine_ms'],
                       'unsharded': ref['f32']['engine_ms']},
        forward_ms={'tp': [r['serving']['forward_ms'] for r in ranks],
                    'unsharded': ref['bf16']['forward_ms'],
                    'unsharded_f32': ref['f32']['forward_ms']},
        stats=lead['bf16']['stats'])


def _tp_step_gates(ranks: list[dict]) -> dict:
    """Each rank's TP step against this process's step (cuDNN off), and
    the summing control beyond TP_SUMMING_MIN_DIFF."""
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = DP_STEP_CUDNN
    try:
        wants = {case: _dp_step(case, slice(None), trace=case == TP_FLIP_CASE)
                 for case in (*TP_STEP_CASES, TP_FLIP_CASE)}
    finally:
        torch.backends.cudnn.enabled = cudnn
    out: dict = dict(tol=DP_STEP_TOL, cudnn=DP_STEP_CUDNN, cases={})
    flip = wants.pop(TP_FLIP_CASE)
    got = ranks[0]['steps'][TP_FLIP_CASE]
    # Where the binary-activation step departs: the stem's output, then
    # the signs of each binary conv's input, in forward order.
    out['flip_case'] = dict(
        case=TP_FLIP_CASE, loss_rel_err=abs(got['loss'] - flip['loss'])
        / abs(flip['loss']), max_abs_err=max(
            float(np.abs(got['leaves'][k] - v).max())
            for k, v in flip['leaves'].items()),
        stem_max_abs_err=float((got['trace']['conv1']
                                - flip['trace']['conv1']).abs().max()),
        sign_flips={name: int((got['trace'][name].sign()
                               != v.sign()).sum())
                    for name, v in flip['trace'].items() if name != 'conv1'})
    for case, want in wants.items():
        rec = dict(max_abs_err=0.0, worst_excess=0.0, worst=None)
        for r in ranks:
            got = r['steps'][case]
            if set(got['leaves']) != set(want['leaves']):
                raise AssertionError(f'tp step {case}: leaves differ')
            pairs = [(k, got['leaves'][k], want['leaves'][k])
                     for k in want['leaves']]
            pairs.append(('loss', np.float64(got['loss']),
                          np.float64(want['loss'])))
            for k, g, w in pairs:
                err = np.abs(g - w)
                rec['max_abs_err'] = max(rec['max_abs_err'],
                                         float(err.max(initial=0.0)))
                excess = float((err - (DP_STEP_TOL['atol'] + DP_STEP_TOL[
                    'rtol'] * np.abs(w))).max(initial=0.0))
                if excess > rec['worst_excess']:
                    rec.update(worst_excess=excess, worst=k)
        out['cases'][case] = rec
        if rec['worst_excess'] > 0:
            raise AssertionError(f'tp step {case} vs the single process '
                                 f'past {DP_STEP_TOL}: {rec}')
    summing = ranks[0]['steps']['lenet_summing']['leaves']
    out['summing_diff'] = max(
        float(np.abs(summing[k] - v).max())
        for k, v in wants['lenet']['leaves'].items() if k.startswith('grad'))
    if not out['summing_diff'] > TP_SUMMING_MIN_DIFF:
        raise AssertionError(f'tp step: the summing control does not '
                             f'differ: {out["summing_diff"]}')
    return out


def tp_pod(root: str, seed: int) -> dict:
    """The MNIST recipe at tensor_parallel TP_WORLD through
    PodComputePlatform (gloo, cuDNN deterministic) against the same run
    at tp = 1 in this process; its last checkpoint restored at TP_WORLD
    (a pod) and at 1 (in process), each evaluated."""
    from quant_tpu_torch.experiment import Experiment
    from quant_tpu_torch.parallel.multihost import BACKEND_ENV
    from quant_tpu_torch.platform import PodComputePlatform
    from quant_tpu_torch.pod_worker import DETERMINISTIC_ENV
    from quant_tpu_torch.train.task import classification_task

    t0 = time.perf_counter()
    data = os.path.join(root, 'mnist_tp')
    os.makedirs(data)
    write_mnist(data, TP_POD_MNIST['train'], TP_POD_MNIST['test'], seed + 3)
    exps = os.path.join(root, 'tp_experiments')
    cfg_path = recipe_copy(EXPERIMENT_MNIST['recipe'],
                           os.path.join(root, 'tp.yaml'), exps,
                           TP_POD_MNIST['epochs'],
                           data={'dataset_path': data})
    tp_env = {'environment': {'tensor_parallel': TP_WORLD}}
    platform = PodComputePlatform(TP_WORLD, env={
        DETERMINISTIC_ENV: '1', BACKEND_ENV: 'gloo'}, timeout=POD_TIMEOUT)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        tp1 = classification_task(_pod_config(cfg_path, 'tp1'), exps)
        t1 = time.perf_counter()
        tp2 = platform.run(Experiment(classification_task, _pod_config(
            cfg_path, 'tp2', **tp_env)))
        pod_s = time.perf_counter() - t1
        if any(m != platform.rank_metrics[0]
               for m in platform.rank_metrics):
            raise AssertionError(f'tp pod: ranks disagree '
                                 f'{platform.rank_metrics}')
        restored = {}
        for tp, name in ((TP_WORLD, 'tp2_restored'), (1, 'tp2_at_tp1')):
            config = _pod_config(cfg_path, name, **(tp_env if tp > 1
                                                    else {}))
            config.update(restore_experiment=os.path.join(exps, 'tp2'),
                          skip_training=True)
            if tp > 1:
                restored[name] = platform.run(Experiment(
                    classification_task, config))[1][0]
            else:
                restored[name] = classification_task(
                    config, exps, restore_experiment=config[
                        'restore_experiment'])[1][0]
    finally:
        torch.backends.cudnn.deterministic = saved
    out = dict(images=TP_POD_MNIST, limits=TP_POD_LIMITS, pod_s=pod_s,
               tp1={'train': tp1[0][0], 'test': tp1[1][0]},
               tp2={'train': tp2[0][0], 'test': tp2[1][0]},
               restored=restored, loss_rel_err={})
    for part in ('train', 'test'):
        want = out['tp1'][part]['Loss']
        out['loss_rel_err'][part] = (abs(out['tp2'][part]['Loss'] - want)
                                     / abs(want))
    for name, m in restored.items():
        want = out['tp2']['test']['Loss']
        out['loss_rel_err'][name] = abs(m['Loss'] - want) / abs(want)
    if not all(err <= TP_POD_LIMITS[key if key in TP_POD_LIMITS
                                     else 'restored']
               for key, err in out['loss_rel_err'].items()):
        raise AssertionError(f'tp pod past {TP_POD_LIMITS}: '
                             f'{out["loss_rel_err"]}')
    out['s'] = time.perf_counter() - t0
    return out


def tp_phase(seed: int) -> dict:
    """The tensor-parallel phase (TP_WORLD's comment), in a temporary
    directory removed after; prints one {"tp_phase": ...} line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='qtt_tp_') as root:
        ranks = _tp_workers(root, seed)
        out = dict(world=TP_WORLD, backend='gloo', mesh=[1, TP_WORLD])
        ring = ranks[0]['ring']
        out['ring'] = dict(
            {k: ring[k] for k in ('shape', 'ranks', 'max_abs_err', 'ring_ms',
                                  'naive_ms') + (('block_ms',) if
                                                 'block_ms' in ring else ())},
            launches_per_rank=[_tp_launches(r['ring']['launches'], 1, {
                'xnor_gemm': TP_WORLD}) for r in ranks],
            ring_ms_ranks=[r['ring']['ring_ms'] for r in ranks],
            naive_ms_ranks=[r['ring']['naive_ms'] for r in ranks])
        print(f'tp ring: {out["ring"]}', flush=True)
        out['serving'] = _tp_serving_gates(ranks, seed)
        print(f'tp serving: {out["serving"]}', flush=True)
        out['step'] = _tp_step_gates(ranks)
        print(f'tp step: {out["step"]}', flush=True)
        out['pod'] = tp_pod(root, seed)
        print(f'tp pod: {out["pod"]}', flush=True)
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'tp_phase': out}), flush=True)
    return out


def band_rows(t: torch.Tensor, rank: int, world: int, kernel: int,
              stride: int, pad: int) -> tuple[torch.Tensor, int, int]:
    """Rank's band of a whole map t (H on dim -3) with the halo rows its
    exchange brings, and the band's (pad_top, pad_bottom): what a rank of
    an H-banded forward hands a kernel, cut here without a collective."""
    from quant_tpu_torch.parallel.spatial import _halo_geometry

    h = t.shape[-3] // world
    top, bot = _halo_geometry(h, kernel, stride, pad, world)
    top, bot = (top if rank > 0 else 0), (bot if rank < world - 1 else 0)
    ext = t.narrow(-3, rank * h - top, h + top + bot).contiguous()
    return ext, (pad if rank == 0 else 0), (pad if rank == world - 1 else 0)


def _out_rows(y: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    h = y.shape[-3] // world
    return y.narrow(-3, rank * h, h).contiguous()


def band_kernel_checks(seed: int) -> dict:
    """The banded kernels on each band of SPACE_WORLD at the spatial
    path's geometries against their twins on the band and the whole
    map's rows, and the raw-zero-edge control (SPACE_WORLD's comment):
    {kernel: max abs err, 'control_differ': elements the control
    changes}."""
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops import pool as P

    gen = torch.Generator().manual_seed(seed)
    n, bf16 = BAND_CHECK_BATCH, torch.bfloat16

    def words(*shape: int) -> torch.Tensor:
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=gen,
                             dtype=torch.int32).to(DEVICE)

    def scales(*shape: int, lo: float = 0.1) -> torch.Tensor:
        return (torch.rand(shape, generator=gen) + lo).to(DEVICE)

    errs = dict(xnor_conv2d=0.0, xnor_conv2d_planes=0.0,
                max_pool_3x3_s2_p1=0.0)

    def hold(name: str, kernel: Callable, plain: Callable, x: torch.Tensor,
             stride: int, nan_ok: bool = False) -> None:
        whole = plain(x, None, None)
        for r in range(SPACE_WORLD):
            ext, top, bottom = band_rows(x, r, SPACE_WORLD, 3, stride, 1)
            got = kernel(ext, top, bottom)
            errs[name] = max(
                errs[name],
                check_equal(f'{name} band {r} ({top}, {bottom})', got,
                            plain(ext, top, bottom), nan_ok),
                check_equal(f'{name} band {r} vs the whole map', got,
                            _out_rows(whole, r, SPACE_WORLD), nan_ok))

    for c, h, s in BAND_CONVS:
        wc, o = c // 32, c * s
        args = (words(3, 3, wc, o), scales(n), scales(o, lo=0.0) * 0.05,
                torch.randn(o, generator=gen).to(DEVICE, bf16))
        kw = dict(in_channels=c, stride=s, padding=1, out_dtype=bf16)
        hold('xnor_conv2d', lambda e, t, b: B.xnor_conv2d(
            e, *args, pad_top=t, pad_bottom=b, **kw),
            lambda e, t, b: B.xnor_conv2d_plain(
                e, *args, pad_top=t, pad_bottom=b, **kw),
            words(n, h, h, wc), s)
    c, h, s = BAND_PLANES
    wc, o = c // 32, c * s
    args = (words(1, 3, 3, wc, o), scales(2, n), scales(1, o, lo=0.0) * 0.05,
            None)
    kw = dict(in_channels=c, stride=s, padding=1, out_dtype=bf16)
    hold('xnor_conv2d_planes', lambda e, t, b: B.xnor_conv2d_planes(
        e, *args, pad_top=t, pad_bottom=b, **kw),
        lambda e, t, b: B.xnor_conv2d_planes_plain(
            e, *args, pad_top=t, pad_bottom=b, **kw),
        words(2, n, h, h, wc), s)
    for dt in (bf16, torch.float32):
        x = plant_specials(torch.randn(BAND_POOL_SHAPE, generator=gen).to(
            DEVICE, dt), seed)
        hold('max_pool_3x3_s2_p1',
             lambda e, t, b: P.max_pool_3x3_s2_p1(e, 1 if t is None else t),
             lambda e, t, b: P.max_pool_3x3_s2_p1_plain(
                 e, 1 if t is None else t), x, 2, nan_ok=True)
    # The control: rank 0's band of real activations with its received
    # bottom row, and JAX's fill for an fp conv (a 0.0 row at the image's
    # edge) in place of the kernel's own top padding. A 0.0 packs to a +1
    # bit, not to the zero the binary operand is padded with.
    c, h, _ = BAND_CONVS[0]
    act = torch.randn(n, h, h, c, generator=gen).to(DEVICE, bf16)
    args = (words(3, 3, c // 32, c), scales(n), scales(c, lo=0.0) * 0.05,
            None)
    kw = dict(in_channels=c, stride=1, padding=1, out_dtype=bf16)
    want = _out_rows(B.xnor_conv2d(B.pack_sign_planes(act, 1)[0], *args,
                                   **kw), 0, SPACE_WORLD)
    ext, top, bottom = band_rows(act, 0, SPACE_WORLD, 3, 1, 1)
    check_equal('band words route', B.xnor_conv2d(
        B.pack_sign_planes(ext, 1)[0], *args, pad_top=top,
        pad_bottom=bottom, **kw), want)
    filled = torch.cat([torch.zeros_like(ext[:, :1]), ext], dim=1)
    got = B.xnor_conv2d(B.pack_sign_planes(filled, 1)[0], *args, pad_top=0,
                        pad_bottom=bottom, **kw)
    errs['control_differ'] = int((got != want).sum())
    if not errs['control_differ']:
        raise AssertionError('control: zero-filled raw rows into the binary '
                             'conv agree with the whole map')
    _sync()
    return errs


def band_kernel_times(seed: int, iters: int) -> dict:
    """Card ms of xnor_conv2d at layer1's 3x3 conv and of the stem pool,
    TP_SERVING's batch in bf16, on each band of SPACE_WORLD beside the
    whole map's call: {kernel: {'whole': ms, 'bands': [ms a rank]}}."""
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops import pool as P

    gen = torch.Generator().manual_seed(seed)
    n, c, bf16 = TP_SERVING['batch'], BAND_CONVS[0][0], torch.bfloat16
    h, w = (d // 4 for d in TP_SERVING['input'][:2])
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, h, w, c // 32),
                          generator=gen, dtype=torch.int32).to(DEVICE)
    args = (torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 3, c // 32, c),
                          generator=gen, dtype=torch.int32).to(DEVICE),
            (torch.rand(n, generator=gen) + 0.1).to(DEVICE),
            (torch.rand(c, generator=gen) * 0.05).to(DEVICE), None)
    kw = dict(in_channels=c, stride=1, padding=1, out_dtype=bf16)
    stem = torch.randn((n, 2 * h, 2 * w, c), generator=gen).to(DEVICE, bf16)
    out: dict = {}
    for name, x, call in (
            ('xnor_conv2d', words, lambda e, t, b: B.xnor_conv2d(
                e, *args, pad_top=t, pad_bottom=b, **kw)),
            ('max_pool_3x3_s2_p1', stem,
             lambda e, t, b: P.max_pool_3x3_s2_p1(e, t))):
        stride = 1 if name == 'xnor_conv2d' else 2
        bands = [band_rows(x, r, SPACE_WORLD, 3, stride, 1)
                 for r in range(SPACE_WORLD)]
        out[name] = dict(
            shape=list(x.shape),
            whole=card_ms(lambda: call(x, 1, 1), iters),
            bands=[card_ms(lambda b=b: call(*b), iters) for b in bands],
            band_pad_top=[b[1] for b in bands])
    return out


@contextlib.contextmanager
def kernel_calls() -> Iterator[list]:
    """Record (name, args, kwargs) of every call of the banded path's
    kernel wrappers inside (the module attributes the forward calls)."""
    from quant_tpu_torch.nn import resnet
    from quant_tpu_torch.ops import binary_infer as B

    calls: list = []
    slots = [(B, 'xnor_conv2d'), (B, 'xnor_conv2d_planes'),
             (B, 'pack_sign_planes'), (resnet, 'max_pool_3x3_s2_p1')]
    saved = [getattr(m, a) for m, a in slots]

    def wrap(name: str, fn: Callable) -> Callable:
        def call(*args: Any, **kw: Any) -> Any:
            calls.append((name, args, kw))
            return fn(*args, **kw)
        return call

    for (m, a), fn in zip(slots, saved):
        setattr(m, a, wrap(a, fn))
    try:
        yield calls
    finally:
        for (m, a), fn in zip(slots, saved):
            setattr(m, a, fn)


def band_captured(calls: list) -> dict:
    """Each recorded kernel call again, against its twin on the same
    arguments (the band and its halo rows): {kernel: max abs err},
    and the calls by name and top padding."""
    from quant_tpu_torch.ops import binary_infer as B
    from quant_tpu_torch.ops import pool as P

    kernels = {'xnor_conv2d': (B.xnor_conv2d, B.xnor_conv2d_plain),
               'xnor_conv2d_planes': (B.xnor_conv2d_planes,
                                      B.xnor_conv2d_planes_plain),
               'pack_sign_planes': (B.pack_sign_planes,
                                    B.pack_sign_planes_plain),
               'max_pool_3x3_s2_p1': (P.max_pool_3x3_s2_p1,
                                      P.max_pool_3x3_s2_p1_plain)}
    errs: dict = {}
    calls_by: dict = {}
    for i, (name, args, kw) in enumerate(calls):
        kernel, plain = kernels[name]
        errs[name] = max(errs.get(name, 0.0), check_equal(
            f'{name} banded call {i}', kernel(*args, **kw),
            plain(*args, **kw), nan_ok=name == 'max_pool_3x3_s2_p1'))
        if name == 'pack_sign_planes':
            key = f'{name} k={args[1]}'
        else:
            top = kw.get('pad_top', args[1] if name == 'max_pool_3x3_s2_p1'
                         and len(args) > 1 else None)
            key = f'{name} pad_top={top}'
        calls_by[key] = calls_by.get(key, 0) + 1
    _sync()
    return dict(errs=errs, calls=calls_by)


# The spatial phase's halo_bytes and gathered_bytes: the bytes this rank
# contributed to the collectives of these kinds (SpatialParallel's).
_BYTE_KINDS = (('halo',), ('gather', 'solves'))


def _kind_bytes(space: Any, kinds: tuple) -> int:
    return sum(space.collectives.get(k, (0, 0))[1] for k in kinds)


def _space_serving(mesh: Any, spec: dict, leader: bool) -> dict:
    """The banded serving model through the banded engine, bf16 then
    float32: launches and forwards of the bf16 round; one more forward
    whose kernel calls are held to their twins, its halo and gathered
    bytes and which convs ran banded; ms of a bare forward."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.nn.layers import Conv, QuantConv2d
    from quant_tpu_torch.parallel import band_model, local_band

    serving = spec['serving']
    model = band_model(tp_serving_model(serving['model'], spec['seed']).to(
        DEVICE), mesh)
    space = model.space
    images = np.random.default_rng(spec['seed']).standard_normal(
        (serving['batch'],) + tuple(serving['input'])).astype(np.float32)
    forwards = [0]
    hook = model.register_forward_pre_hook(
        lambda mod, args: forwards.__setitem__(0, forwards[0] + 1))
    _sync()
    _build.reset_launch_counts()
    out = dict(bf16=_tp_round(model, images, leader, torch.bfloat16,
                              spec['iters']))
    _sync()
    out.update(launches=_build.launch_counts(), forwards=forwards[0])
    hook.remove()
    banded: list = []
    hooks = [m.register_forward_hook(
        lambda mod, args, y, name=name: banded.append(
            [name, mod.space.banded]))
        for name, m in model.named_modules()
        if isinstance(m, (Conv, QuantConv2d))]
    x = local_band(torch.from_numpy(images).to(DEVICE), mesh)
    sent, gathered = (_kind_bytes(space, k) for k in _BYTE_KINDS)
    with kernel_calls() as calls, torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    out.update(halo_bytes=_kind_bytes(space, _BYTE_KINDS[0]) - sent,
               gathered_bytes=_kind_bytes(space, _BYTE_KINDS[1]) - gathered,
               banded=banded)
    with torch.inference_mode():
        out['captured'] = band_captured(calls)
        out['forward_ms'] = _host_ms(lambda: model(x), spec['iters'])
    del calls
    out['f32'] = _tp_round(model, images, leader, None, spec['iters'])
    return out


def pipe_blocks(model: torch.nn.Module, stages: int) -> list:
    """The pipeline phase's stages: layer1's blocks of the served model
    (a model with fewer, such as the small rehearsal model's one, repeats
    them)."""
    blocks = [b for name, b in model.blocks() if name.startswith('layer1_')]
    return (blocks * stages)[:stages]


def _pipe_packed(mesh: Any, spec: dict) -> dict:
    """Layer1's packed blocks pipelined against the blocks in sequence,
    both with each block's tail in its binary convs, and against the
    blocks in sequence with every tail run by the eager ops
    (nn.resnet._Block.tail_engages held false): equal outputs, launches
    a call, ms a call against sequential."""
    from unittest import mock

    from quant_tpu_torch import _build
    from quant_tpu_torch.nn import resnet
    from quant_tpu_torch.parallel import pipeline_apply, stack_stage_params

    serving, stages, m = spec['serving'], spec['world'], spec['microbatches']
    model = tp_serving_model(serving['model'], spec['seed']).to(DEVICE)
    blocks = pipe_blocks(model, stages)
    dt, fold = torch.bfloat16, model.bn_fold
    h, w = serving['input'][0] // 4, serving['input'][1] // 4
    c = blocks[0].conv1.in_channels
    gen = torch.Generator().manual_seed(spec['seed'])
    x = torch.randn((serving['batch'], h, w, c), generator=gen).to(DEVICE, dt)
    mb = x.reshape((m, -1) + x.shape[1:])
    params = stack_stage_params([
        {k: v.detach() for k, v in (*b.named_parameters(),
                                     *b.named_buffers())} for b in blocks])

    def stage(p: dict, xb: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(blocks[0], p, (xb, dt, fold))

    def sequential() -> torch.Tensor:
        y = x
        for b in blocks:
            y = b(y, dt, fold)
        return y

    def pipelined() -> torch.Tensor:
        return pipeline_apply(stage, params, mb, mesh=mesh)

    with torch.no_grad():
        _sync()
        _build.reset_launch_counts()
        got = pipelined()
        _sync()
        launches = _build.launch_counts()
        with mock.patch.object(resnet._Block, 'tail_engages',
                               lambda self, *a, **kw: False):
            eager = sequential()
        out = dict(shape=list(mb.shape), launches=launches,
                   max_abs_err=check_equal('pipeline packed blocks',
                                           got.reshape(x.shape),
                                           sequential()),
                   eager_abs_err=check_equal(
                       'pipeline packed blocks against the eager tails',
                       got.reshape(x.shape), eager))
        out.update(pipeline_ms=_host_ms(pipelined, spec['iters']),
                   sequential_ms=_host_ms(sequential, spec['iters']))
    return out


def _pipe_step(mesh: Any, spec: dict) -> dict:
    """One step of JAX's quantized stage (PIPE_STEP): the stacked
    weights' gradients through the pipeline against the sequential
    composition's, and with the summing backward."""
    from quant_tpu_torch.ops.conv import conv2d
    from quant_tpu_torch.ops.quantize import quantizer_ls_1
    from quant_tpu_torch.parallel import pipeline, pipeline_apply

    cfg, stages = spec['step'], spec['world']
    c = cfg['channels']
    rng = np.random.default_rng(spec['seed'])
    w0 = rng.standard_normal((stages, 3, 3, c, c)) * 0.2
    mb = torch.tensor(rng.standard_normal(
        (cfg['microbatches'], cfg['rows'], cfg['hw'], cfg['hw'], c)),
        dtype=torch.float32, device=DEVICE)

    def stage(p: dict, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        xq = quantizer_ls_1(x.reshape(n, -1))[1].reshape(x.shape)
        wq = quantizer_ls_1(p['w'].reshape(c, -1))[1].reshape(p['w'].shape)
        return x + torch.tanh(conv2d(xq, wq, stride=1, padding=1))

    def grad(pipelined: bool) -> torch.Tensor:
        w = torch.tensor(w0, dtype=torch.float32, device=DEVICE,
                         requires_grad=True)
        if pipelined:
            y = pipeline_apply(stage, {'w': w}, mb, mesh=mesh)
        else:
            y = mb.reshape((-1,) + mb.shape[2:])
            for i in range(stages):
                y = stage({'w': w[i]}, y)
        (y ** 2).sum().backward()
        return w.grad

    def summing(g: torch.Tensor, pipe: Any) -> torch.Tensor:
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=pipe.group)
        return g

    want = grad(False)
    scale = float(want.abs().max())
    err = float((grad(True) - want).abs().max())
    out = dict(max_abs_err=err, rel_err=err / scale, grad_max=scale)
    saved = pipeline._replicated_grad
    pipeline._replicated_grad = summing
    try:
        out['summing_diff'] = float((grad(True) - want).abs().max()) / scale
    finally:
        pipeline._replicated_grad = saved
    return out


@contextlib.contextmanager
def _bands_only(space: Any, banded: bool) -> Iterator[None]:
    """spatial.recompute without global_stats.banded: the recomputation
    exchanges its halos (without them a halo conv's saved input changes
    shape and torch's checkpoint raises CheckpointError) and solves on the
    whole sample, but its statistics are its band's."""
    if space is None:
        yield
        return
    saved, space.banded = space.banded, banded
    try:
        yield
    finally:
        space.banded = saved


@contextlib.contextmanager
def space_control(name: str) -> Iterator[None]:
    """One of SPACE_CONTROLS in place of the port's rule inside: a
    summing backward at the average pool (the statistics' all-reduce; the
    head after the pool runs replicated, so it gives P times the
    gradient), no 'space' sum of the banded parameters' gradients,
    band-local train statistics, or a remat block recomputed in the
    backward on its bands but without the statistics' 'space' state
    (`_bands_only`: band-local statistics in the recomputation alone)."""
    from quant_tpu_torch.parallel import global_stats, spatial

    slots = {'summing_avg_pool': (spatial, 'replicated_sum', lambda x, sp: (
                 global_stats._AllReduceSum.apply(x, sp.group, None))),
             'no_space_sum': (spatial, 'sum_banded_grads',
                              lambda model: None),
             'local_statistics': (global_stats, 'banded',
                                  lambda space: contextlib.nullcontext()),
             'remat_unbanded': (spatial, 'recompute', _bands_only)}
    module, attr, value = slots[name]
    saved = getattr(module, attr)
    setattr(module, attr, value)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def _space_train_models(spec: dict, x_quant: str, w_quant: str,
                        options: Optional[dict] = None,
                        teacher_dtype: Optional[str] = None
                        ) -> tuple[torch.nn.Module, torch.nn.Module]:
    """(student, teacher) of the spatial train phase on the card, seeded
    as train_profile.build seeds them: SPACE_TRAIN's ResNet-18 pair, or
    ('small') small_config's (the CPU rehearsal's); the student built with
    `options` (a train_profile.CONFIGS entry's, e.g. remat), the teacher
    in `teacher_dtype`."""
    if spec['train']['model'] == 'resnet18':
        make, teacher_make = models.bench_resnet18, models.imagenet_teacher
    else:
        def make(xq: str, wq: str, **kw: Any) -> torch.nn.Module:
            return models.build('xnor', models.small_config('xnor', xq, wq),
                                **kw)

        def teacher_make(xq: str, wq: str, **kw: Any) -> torch.nn.Module:
            return models.build('regular', models.small_config(
                'regular', xq, wq), **kw)
    opts = dict(prepare=False, moving_average_mode='off',
                inference_mode='dense')
    student = models.seeded_model(make, x_quant, w_quant, 'cpu',
                                  spec['seed'], **opts, **(options or {}))
    dt = (dict(train_dtype=teacher_dtype, eval_dtype=teacher_dtype)
          if teacher_dtype else {})
    teacher = models.seeded_model(teacher_make, 'fp', 'fp', 'cpu',
                                  spec['seed'] + 1000, **opts, **dt)
    return student.to(DEVICE), teacher.to(DEVICE)


def _space_train_data(spec: dict, n: int, seed: int,
                      shape: Optional[list] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    cfg = spec['train']
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + tuple(shape or cfg['input']),
                            dtype=np.float32)
    return (torch.from_numpy(x), torch.from_numpy(rng.integers(
        0, cfg['classes'], n)))


def _sha256(tensors: Iterator[torch.Tensor]) -> str:
    """A hash of the tensors, bit for bit (bf16 read as its bytes)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def _digest(model: torch.nn.Module) -> str:
    """A hash of the model's parameters and buffers, bit for bit."""
    return _sha256(iter((*model.parameters(), *model.buffers())))


def _grad_digest(model: torch.nn.Module) -> str:
    """A hash of every parameter's gradient, bit for bit."""
    return _sha256(p.grad for p in model.parameters() if p.grad is not None)


def _space_run(spec: dict, x_quant: str, w_quant: str, mesh: Any,
               steps: int, timed: int = 0, signs: bool = False,
               shape: Optional[list] = None, options: Optional[dict] = None,
               teacher_dtype: Optional[str] = None) -> dict:
    """`steps` KD steps of the (x_quant, w_quant) student (built with
    `options`) and its teacher (in `teacher_dtype`) on the seeded batch
    (of images of `shape`, SPACE_TRAIN's by default), banded over `mesh`
    (this rank's band) or in one process (mesh None): the losses, the
    first step's gradients, digests of every gradient and of the student
    after each step, with `signs` each binary conv's input signs at the
    first step (this rank's rows), and over the last `timed` steps ms a
    step and its split, launches, collectives (those of remat's
    recomputation apart) and peak memory; banded, the stem pool calls of
    the last step held to their twins."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.nn.layers import QuantConv2d
    from quant_tpu_torch.parallel import band_model, local_band
    from quant_tpu_torch.train.metrics import init_metric_state

    student, teacher = _space_train_models(spec, x_quant, w_quant, options,
                                           teacher_dtype)
    if mesh is not None:
        band_model(student, mesh)
        band_model(teacher, mesh)
    x, y = _space_train_data(spec, spec['train']['batch'], spec['seed'],
                             shape)
    x, y = x.to(DEVICE), y.to(DEVICE)
    if mesh is not None:
        x = local_band(x, mesh)
    marks: list = []
    step = train_profile.make_step(teacher, lambda part: marks.append(
        (part, cuda_event())), mesh=mesh)
    state = train_profile.make_state(student)
    seen: dict = {}

    def keep(name: str) -> Callable:
        def hook(mod: Any, args: tuple, y: torch.Tensor) -> None:
            if name not in seen:
                seen[name] = (args[0] >= 0).cpu()
        return hook
    hooks = [m.register_forward_hook(keep(name))
             for name, m in student.named_modules()
             if signs and isinstance(m, QuantConv2d)]
    spaces = [m.space for m in (student, teacher) if m.space is not None]
    out: dict = dict(losses=[], digests=[], grad_digests=[])
    calls: list = []
    for i in range(steps):
        if i == steps - timed:
            _sync()
            marks.clear()
            before = [copy.deepcopy((sp.collectives, sp.recomputed))
                      for sp in spaces]
            if DEVICE == 'cuda':
                torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
        last = mesh is not None and timed and i == steps - 1
        with (kernel_calls() if last
              else contextlib.nullcontext(calls)) as c:
            state, _, loss = step(state, x, y, init_metric_state())
            _sync()
        if last:
            calls = c
        out['losses'].append(float(loss))
        out['digests'].append(_digest(student))
        out['grad_digests'].append(_grad_digest(student))
        if i == 0:
            for h in hooks:
                h.remove()
            out['grads'] = {n: p.grad.detach().clone()
                            for n, p in student.named_parameters()
                            if p.grad is not None}
    out['signs'] = seen
    if timed:
        out['launches'] = _build.launch_counts()
        out['quant_convs'] = sum(isinstance(m, QuantConv2d)
                                 for m in student.modules())
        out['max_memory_allocated'] = (torch.cuda.max_memory_allocated()
                                       if DEVICE == 'cuda' else 0)
        parts = ('forward', 'teacher', 'backward', 'optimizer')
        split = {p: 0.0 for p in parts}
        for (part, ev), (_, nxt) in zip(marks, marks[1:]):
            if part in split:
                split[part] += ev.elapsed_time(nxt) / timed
        starts = [ev for part, ev in marks if part == 'forward']
        ends = [ev for part, ev in marks if part == 'end']
        out.update(ms_per_step=sum(a.elapsed_time(b) for a, b in zip(
            starts, ends)) / timed, split_ms=split)
        for i, key in enumerate(('collectives', 'recomputed')):
            kinds: dict = {}
            for sp, was in zip(spaces, before):
                for kind, (n, nbytes) in getattr(sp, key).items():
                    n0, b0 = was[i].get(kind, (0, 0))
                    rec = kinds.setdefault(kind, [0, 0])
                    rec[0] += (n - n0) / timed
                    rec[1] += (nbytes - b0) / timed
            out[key] = {k: dict(count=v[0], bytes=v[1])
                        for k, v in kinds.items()}
    if calls:
        with torch.inference_mode():
            out['captured'] = band_captured(calls)
    out['model'] = student
    return out


def _space_errs(got: dict, want: dict) -> dict:
    """The first step's loss (relative) and gradients (the largest
    difference over the largest gradient element) against `want`'s."""
    largest = max(float(g.abs().max()) for g in want['grads'].values())
    worst, leaf = max((float((got['grads'][n] - g).abs().max()), n)
                      for n, g in want['grads'].items())
    return dict(loss_rel_err=abs(got['losses'][0] - want['losses'][0])
                / abs(want['losses'][0]), grad_rel_err=worst / largest,
                worst_leaf=leaf, grad_max=largest)


def _space_evaluate(spec: dict, model: torch.nn.Module, mesh: Any,
                    x_quant: str, w_quant: str) -> dict:
    """evaluate of `model` (banded over mesh) through the banded loaders
    and of a copy of its state unbanded, on SPACE_TRAIN['eval_images']
    seeded images: both metrics, the logits' largest difference and the
    banded evaluate's launches."""
    from quant_tpu_torch import _build
    from quant_tpu_torch import train as T
    from quant_tpu_torch.data.loaders import BatchIterable
    from quant_tpu_torch.parallel.multihost import shard_loader_for_host

    cfg = spec['train']
    x, y = _space_train_data(spec, cfg['eval_images'], spec['seed'] + 1)
    whole = BatchIterable(x.numpy(), y.numpy(), cfg['batch'], shuffle=False)
    plain, _ = _space_train_models(spec, x_quant, w_quant)
    plain.load_state_dict(model.state_dict())
    loss = T.get_loss_fn('cross_entropy')
    out: dict = {}
    for name, m, loader, mesh_ in (
            ('banded', model, shard_loader_for_host(whole, pad=True,
                                                    mesh=mesh), mesh),
            ('whole', plain, whole, None)):
        state = train_profile.make_state(m)
        step = T.make_eval_step(loss, mesh=mesh_)
        logits: list = []

        def keep(st: Any, data: Any, target: Any, ms: dict,
                 step: Callable = step, logits: list = logits) -> Any:
            ms, output = step(st, data, target, ms)
            logits.append(output.cpu())
            return ms, output
        _sync()
        _build.reset_launch_counts()
        metrics = T.evaluate(keep, state, loader)
        _sync()
        out[name] = dict(metrics=metrics, launches={
            k: v for k, v in _build.launch_counts().items() if v},
            logits=torch.cat(logits).numpy())
    out['max_abs_err'] = _max_err(out['banded'].pop('logits'),
                                  out['whole'].pop('logits'))
    return out


def _space_gate(spec: dict, x_quant: str, w_quant: str, mesh: Any,
                shape: Optional[list] = None,
                options: Optional[dict] = None) -> tuple[dict, dict]:
    """One banded step against one process's (_space_errs), the student
    built with `options` on both sides, with the float32 floor recorded
    beside it: one process's step with cuDNN off against the same with
    cuDNN on (`floor_grad_rel_err`, another summation order of the same
    step). Also returns the one-process run."""
    single = _space_run(spec, x_quant, w_quant, None, 1, shape=shape,
                        options=options)
    rec = _space_errs(_space_run(spec, x_quant, w_quant, mesh, 1,
                                 shape=shape, options=options), single)
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        floor = _space_errs(_space_run(spec, x_quant, w_quant, None, 1,
                                       shape=shape, options=options),
                            single)
    finally:
        torch.backends.cudnn.enabled = enabled
    rec.update(floor_grad_rel_err=floor['grad_rel_err'],
               floor_worst_leaf=floor['worst_leaf'],
               floor_loss_rel_err=floor['loss_rel_err'])
    return rec, single


def _space_gate_ok(rec: dict) -> bool:
    """SPACE_STEP_LOSS_RTOL on the loss; the gradients within
    SPACE_STEP_GRAD_TOL of the largest."""
    return (rec['loss_rel_err'] <= SPACE_STEP_LOSS_RTOL
            and rec['grad_rel_err'] <= SPACE_STEP_GRAD_TOL)


def _space_serve_trained(spec: dict, model: torch.nn.Module, mesh: Any,
                         x_quant: str, w_quant: str,
                         options: Optional[dict] = None) -> dict:
    """The state trained banded, packed (prepare_for_serving: export;
    per-batch scales rule out the threshold fold; strip) and served
    banded through the engine, against a copy of the same state (a
    student built with `options`) packed and served unsharded: one
    forward's launches and every kernel call of it held to its twin on
    its band, then the engine's float32 and bf16 logits (the leader's)
    beside the unsharded engine's."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.parallel import local_band

    plain, _ = _space_train_models(spec, x_quant, w_quant, options)
    plain.load_state_dict(model.state_dict())
    for m in (model, plain):
        m.eval()
        for mod in m.modules():
            if hasattr(mod, 'inference_mode'):
                mod.inference_mode = 'packed'
        models.prepare_for_serving(m)
    cfg, leader = spec['train'], mesh.get_local_rank() == 0
    x, _ = _space_train_data(spec, cfg['batch'], spec['seed'] + 2)
    images = x.numpy()
    xb = local_band(x.to(DEVICE), mesh)
    model.eval_dtype = torch.bfloat16
    _sync()
    _build.reset_launch_counts()
    with kernel_calls() as calls, torch.inference_mode():
        model(xb)
    _sync()
    out: dict = dict(launches=_build.launch_counts())
    with torch.inference_mode():
        out['captured'] = band_captured(calls)
    del calls
    for name, dt in (('f32', None), ('bf16', torch.bfloat16)):
        got = _tp_round(model, images, leader, dt, 1)
        if leader:
            want = _tp_round(plain, images, True, dt, 1)
            out[name] = dict(logits=got['logits'], want=want['logits'],
                             engine_ms=got['engine_ms'],
                             whole_engine_ms=want['engine_ms'])
    return out


def _space_train(mesh: Any, spec: dict) -> dict:
    """One rank of the spatial train phase (SPACE_TRAIN's comment)."""
    torch.backends.cudnn.deterministic = True
    cfg, out = spec['train'], dict(gates={}, controls={})
    cases = spec['step_cases']
    for case, (xq, wq) in cases.items():
        out['gates'][case] = _space_gate(spec, xq, wq, mesh)[0]
        out['gates'][f'{case} remat'] = _space_gate(
            spec, xq, wq, mesh, options={'remat': True})[0]
    control_case, shape = cases[next(iter(cases))], cfg['control_input']
    out['controls']['none'], single = _space_gate(spec, *control_case, mesh,
                                                  shape)
    for name in spec['controls']:
        with space_control(name):
            got = _space_run(spec, *control_case, mesh, 1, shape=shape,
                             options=SPACE_CONTROL_OPTIONS.get(name))
        out['controls'][name] = _space_errs(got, single)['grad_rel_err']
    del single, got
    _, xq, wq, _, _ = train_profile.CONFIGS[spec['kd_config']]
    steps = cfg['warmup'] + cfg['steps']
    for r in range(mesh.size()):  # one process's run, alone on the card
        if mesh.get_local_rank() == r:
            single = _space_run(spec, xq, wq, None, steps, cfg['steps'],
                                signs=True)
        torch.distributed.barrier(group=mesh.get_group())
    banded = _space_run(spec, xq, wq, mesh, steps, cfg['steps'], signs=True)
    flips = {}
    for name, got in banded['signs'].items():
        want = single['signs'][name]
        if got.shape != want.shape:  # this rank's band of the whole map
            h = got.shape[1]
            want = want[:, mesh.get_local_rank() * h:][:, :h]
        flips[name] = int((got != want).sum())
    out['kd'] = dict(
        config=spec['kd_config'], flips=flips,
        **{k: dict(losses=r['losses'], ms_per_step=r['ms_per_step'],
                   split_ms=r['split_ms'], launches=r['launches'],
                   max_memory_allocated=r['max_memory_allocated'])
           for k, r in (('banded', banded), ('single', single))},
        digests=banded['digests'], collectives=banded['collectives'],
        captured=banded['captured'])
    model = banded['model']
    del single, banded
    out['evaluate'] = _space_evaluate(spec, model, mesh, xq, wq)
    out['serve'] = _space_serve_trained(spec, model, mesh, xq, wq)
    del model
    out['remat'] = _space_remat(mesh, spec)
    return out


_REMAT_KEYS = ('losses', 'digests', 'grad_digests', 'ms_per_step',
               'split_ms', 'max_memory_allocated', 'launches',
               'collectives', 'recomputed', 'quant_convs')


def _space_remat(mesh: Any, spec: dict) -> dict:
    """Parts (d) and (e) of the spatial train phase on this rank
    (SPACE_REMAT_CONFIG's comment): the config banded in SPACE_REMAT_ROUNDS
    with remat on or off, each round after one process's run on rank 0;
    the first of each records the steps, the rounds their times; the
    state the last round trained served banded."""
    cfg = spec['train']
    _, xq, wq, options, teacher_dtype = train_profile.CONFIGS[
        spec['remat_config']]
    steps = cfg['warmup'] + cfg['steps']
    out: dict = dict(config=spec['remat_config'], single={}, rounds=[])
    for key in spec['remat_rounds']:
        opts = dict(options, remat=key == 'on', **spec['remat_options'])
        times = dict(remat=key)
        if mesh.get_local_rank() == 0:
            run = _space_run(spec, xq, wq, None, steps, cfg['steps'],
                             options=opts, teacher_dtype=teacher_dtype)
            out['single'].setdefault(key, {k: run[k] for k in _REMAT_KEYS})
            times.update(single_ms_per_step=run['ms_per_step'],
                         single_split_ms=run['split_ms'])
            del run
        torch.distributed.barrier(group=mesh.get_group())
        run = _space_run(spec, xq, wq, mesh, steps, cfg['steps'],
                         options=opts, teacher_dtype=teacher_dtype)
        times.update(ms_per_step=run['ms_per_step'], split_ms=run['split_ms'])
        out['rounds'].append(times)
        if key not in out:
            out[key] = {k: run[k] for k in _REMAT_KEYS}
            out[key]['captured'] = run['captured']
        model = run.pop('model')
        del run
        if len(out['rounds']) < len(spec['remat_rounds']):
            del model
    out['equal'] = {k: out['on'][k] == out['off'][k]
                    for k in ('losses', 'grad_digests', 'digests')}
    out['serve'] = _space_serve_trained(spec, model, mesh, xq, wq, opts)
    return out


def par_worker(rank: int, port: int, out: str, spec_path: str) -> int:
    """One rank of the spatial, spatial train or pipeline phase
    (chip_smoke.py --par-worker): joins a gloo world, runs spec['phase']
    over a mesh of its one axis ('space' or 'pipe') and saves the results
    at `out`."""
    from torch.distributed.device_mesh import DeviceMesh

    from quant_tpu_torch.parallel import multihost

    global DEVICE
    with open(spec_path) as f:
        spec = json.load(f)
    DEVICE = spec['device']
    if DEVICE == 'cuda' and not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    os.environ[multihost.BACKEND_ENV] = 'gloo'
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f'127.0.0.1:{port}', spec['world'], rank,
                         device=DEVICE)
    axis = 'pipe' if spec['phase'] == 'pipe' else 'space'
    mesh = DeviceMesh(DEVICE, torch.arange(spec['world']),
                      mesh_dim_names=(axis,))
    try:
        if spec['phase'] == 'space':
            results = dict(serving=_space_serving(mesh, spec, rank == 0))
        elif spec['phase'] == 'space_train':
            results = _space_train(mesh, spec)
        else:
            results = dict(packed=_pipe_packed(mesh, spec))
            torch.backends.cudnn.enabled = spec['cudnn']
            results['step'] = _pipe_step(mesh, spec)
    finally:
        torch.distributed.destroy_process_group()
    torch.save(results, out)
    return 0


def _par_workers(root: str, seed: int, phase: str, **extra: Any) -> list:
    """Run SPACE_WORLD par_worker ranks of `phase`; their results."""
    spec = dict(seed=seed, device=DEVICE, world=SPACE_WORLD, phase=phase,
                serving=TP_SERVING, iters=PAR_ITERS, **extra)
    spec_path = os.path.join(root, f'{phase}_spec.json')
    with open(spec_path, 'w') as f:
        json.dump(spec, f)
    return _run_ranks(root, phase, SPACE_WORLD, lambda r, port, out: [
        '--par-worker', str(r), str(port), out, spec_path])


def spatial_phase(seed: int) -> dict:
    """The spatial phase (SPACE_WORLD's comment), in a temporary
    directory removed after; prints one {"spatial_phase": ...} line."""
    import tempfile

    t0 = time.perf_counter()
    out: dict = dict(world=SPACE_WORLD, backend='gloo', mesh=['space'])
    out['band_checks'] = band_kernel_checks(seed)
    print(f'banded kernels vs plain twins: {out["band_checks"]}', flush=True)
    out['band_ms'] = band_kernel_times(seed, PAR_ITERS)
    with tempfile.TemporaryDirectory(prefix='qtt_space_') as root:
        ranks = [r['serving'] for r in _par_workers(root, seed, 'space')]
    serving = TP_SERVING
    model = tp_serving_model(serving['model'], seed).to(DEVICE)
    images = np.random.default_rng(seed).standard_normal(
        (serving['batch'],) + tuple(serving['input'])).astype(np.float32)
    x = torch.from_numpy(images).to(DEVICE)
    ref = {}
    with tf32(False):
        for name, dt in (('bf16', torch.bfloat16), ('f32', None)):
            ref[name] = _tp_round(model, images, True, dt, PAR_ITERS)
            with torch.inference_mode():
                ref[name]['forward_ms'] = _host_ms(lambda: model(x),
                                                   PAR_ITERS)
    lead = ranks[0]
    f32 = lead['f32']['logits']
    np.testing.assert_allclose(f32, ref['f32']['logits'], **TP_F32_TOL,
                               err_msg='banded float32 chain vs whole')
    bf16, want16 = lead['bf16']['logits'], ref['bf16']['logits']
    spread = float(want16.max() - want16.min())
    bf16_err = _max_err(bf16, want16)
    if not (bf16.shape == (serving['batch'], serving['classes'])
            and np.isfinite(bf16).all()
            and bf16_err <= TP_BF16_REL_TOL * spread):
        raise AssertionError(f'banded bf16 chain vs whole: {bf16_err} of '
                             f'spread {spread}')
    for name in ('bf16', 'f32'):
        if lead[name]['queued_max_abs_err'] > 1e-6:
            raise AssertionError(f'banded {name} queued differs from '
                                 'predict')
    if any(r['banded'] != lead['banded'] for r in ranks):
        raise AssertionError('the ranks banded different layers')
    captured: dict = {}
    for r in ranks:
        for kname, err in r['captured']['errs'].items():
            captured[kname] = max(captured.get(kname, 0.0), err)
    out.update(
        batch=serving['batch'],
        per_forward=[_tp_launches(r['launches'], r['forwards'],
                                  serving['per_forward']) for r in ranks],
        forwards=[r['forwards'] for r in ranks], captured=captured,
        calls=[r['captured']['calls'] for r in ranks],
        banded=[name for name, b in lead['banded'] if b],
        whole=[name for name, b in lead['banded'] if not b],
        halo_bytes=[r['halo_bytes'] for r in ranks],
        gathered_bytes=[r['gathered_bytes'] for r in ranks],
        f32_max_abs_err=_max_err(f32, ref['f32']['logits']),
        bf16_max_abs_err=bf16_err, bf16_spread=spread,
        bf16_rel_err=bf16_err / spread,
        engine_ms={'banded': lead['bf16']['engine_ms'],
                   'whole': ref['bf16']['engine_ms']},
        engine_f32_ms={'banded': lead['f32']['engine_ms'],
                       'whole': ref['f32']['engine_ms']},
        forward_ms={'banded': [r['forward_ms'] for r in ranks],
                    'whole': ref['bf16']['forward_ms'],
                    'whole_f32': ref['f32']['forward_ms']},
        stats=lead['bf16']['stats'])
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'spatial_phase': out}), flush=True)
    return out


def pipeline_phase(seed: int) -> dict:
    """The pipeline phase (PIPE_STAGES' comment), in a temporary
    directory removed after; prints one {"pipeline_phase": ...} line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='qtt_pipe_') as root:
        ranks = _par_workers(root, seed, 'pipe',
                             microbatches=PIPE_MICROBATCHES, step=PIPE_STEP,
                             cudnn=DP_STEP_CUDNN)
    packed = ranks[0]['packed']
    out = dict(
        world=SPACE_WORLD, backend='gloo', mesh=['pipe'],
        stages=PIPE_STAGES, shape=packed['shape'],
        max_abs_err=max(r['packed']['max_abs_err'] for r in ranks),
        eager_abs_err=max(r['packed']['eager_abs_err'] for r in ranks),
        per_microbatch=[_tp_launches(r['packed']['launches'],
                                     PIPE_MICROBATCHES,
                                     {'xnor_conv2d': 2,
                                      'pack_sign_planes': 2, TAIL: 2})
                        for r in ranks],
        pipeline_ms=[r['packed']['pipeline_ms'] for r in ranks],
        sequential_ms=[r['packed']['sequential_ms'] for r in ranks],
        step=dict(tol=PIPE_STEP_TOL, cudnn=DP_STEP_CUDNN, shape=PIPE_STEP,
                  max_abs_err=max(r['step']['max_abs_err'] for r in ranks),
                  rel_err=max(r['step']['rel_err'] for r in ranks),
                  grad_max=ranks[0]['step']['grad_max'],
                  summing_diff=min(r['step']['summing_diff']
                                   for r in ranks)))
    if not out['step']['rel_err'] <= PIPE_STEP_TOL:
        raise AssertionError(f'pipeline step vs sequential: {out["step"]}')
    if not out['step']['summing_diff'] > PIPE_SUMMING_MIN_DIFF:
        raise AssertionError(f'pipeline: the summing control does not '
                             f'differ: {out["step"]}')
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'pipeline_phase': out}), flush=True)
    return out


def spatial_train_phase(seed: int) -> dict:
    """The spatial train phase (SPACE_TRAIN's comment), in a temporary
    directory removed after; raises past its gates, prints one
    {"spatial_train_phase": ...} line."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='qtt_space_train_') as root:
        ranks = _par_workers(root, seed, 'space_train', train=SPACE_TRAIN,
                             step_cases=SPACE_STEP_CASES,
                             controls=SPACE_CONTROLS,
                             kd_config=SPACE_KD_CONFIG,
                             remat_config=SPACE_REMAT_CONFIG,
                             remat_options=SPACE_REMAT_OPTIONS,
                             remat_rounds=SPACE_REMAT_ROUNDS)
    cfg = SPACE_TRAIN
    out: dict = dict(world=SPACE_WORLD, backend='gloo', mesh=['space'],
                     train=cfg, cudnn='deterministic',
                     tol=dict(loss_rel=SPACE_STEP_LOSS_RTOL,
                              grad_rel=SPACE_STEP_GRAD_TOL,
                              control_min=SPACE_CONTROL_MIN_DIFF,
                              kd_loss_rel=SPACE_KD_LOSS_RTOL))
    out['gates'] = {case: [r['gates'][case] for r in ranks]
                    for case in ranks[0]['gates']}
    out['gates']['control_input'] = [r['controls'].pop('none')
                                     for r in ranks]
    for case, recs in out['gates'].items():
        for rec in recs:
            if not _space_gate_ok(rec):
                raise AssertionError(f'banded step {case} vs one process: '
                                     f'{rec}')
    out['controls'] = {name: min(r['controls'][name] for r in ranks)
                       for name in SPACE_CONTROLS}
    for name, diff in out['controls'].items():
        if not diff > SPACE_CONTROL_MIN_DIFF:
            raise AssertionError(f'banded step: the {name} control does '
                                 f'not differ: {diff}')
    kd = [r['kd'] for r in ranks]
    if any(k['digests'] != kd[0]['digests'] for k in kd):
        raise AssertionError('the ranks\' variables differ after a step')
    losses, want = kd[0]['banded']['losses'], kd[0]['single']['losses']
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    if not (np.isfinite(losses).all() and max(rel) <= SPACE_KD_LOSS_RTOL):
        raise AssertionError(f'banded {SPACE_KD_CONFIG} losses {losses} vs '
                             f'one process {want}')
    per_step = [_tp_launches(k['banded']['launches'], cfg['steps'],
                             {'max_pool_3x3_s2_p1': 1}) for k in kd]
    captured: dict = {}
    for k in kd:
        for kname, err in k['captured']['errs'].items():
            captured[kname] = max(captured.get(kname, 0.0), err)
    out['kd'] = dict(
        config=SPACE_KD_CONFIG, losses=losses, single_losses=want,
        loss_rel_err=rel, per_step=per_step, captured=captured,
        calls=[k['captured']['calls'] for k in kd],
        flips=[k['flips'] for k in kd],
        ms_per_step=[k['banded']['ms_per_step'] for k in kd],
        split_ms=[k['banded']['split_ms'] for k in kd],
        single_ms_per_step=kd[0]['single']['ms_per_step'],
        single_split_ms=kd[0]['single']['split_ms'],
        collectives=[k['collectives'] for k in kd],
        max_memory_allocated=[k['banded']['max_memory_allocated']
                              for k in kd],
        single_max_memory_allocated=kd[0]['single']['max_memory_allocated'])
    ev = [r['evaluate'] for r in ranks]
    for e in ev:
        if not e['max_abs_err'] <= TP_F32_TOL['atol']:
            raise AssertionError(f'banded evaluate vs whole: {e}')
    out['evaluate'] = dict(
        images=cfg['eval_images'], max_abs_err=max(e['max_abs_err']
                                                   for e in ev),
        metrics=ev[0]['banded']['metrics'],
        whole_metrics=ev[0]['whole']['metrics'],
        launches=[e['banded']['launches'] for e in ev])
    serve = [r['serve'] for r in ranks]
    out['serve'] = dict(
        batch=cfg['batch'], **_served_gates(serve, 'the state trained banded'),
        per_forward=[_tp_launches(r['launches'], 1,
                                  TP_SERVING['per_forward']) for r in serve])
    out['remat'] = _space_remat_gates([r['remat'] for r in ranks])
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'spatial_train_phase': out}), flush=True)
    return out


def _served_gates(serve: list, what: str) -> dict:
    """The served logits of the leader (serve[0]) against the unsharded
    engine's (float32 within TP_F32_TOL, bf16 within TP_BF16_REL_TOL of
    the spread) and every rank's kernel calls held to their twins."""
    lead = serve[0]
    np.testing.assert_allclose(lead['f32']['logits'], lead['f32']['want'],
                               **TP_F32_TOL, err_msg=f'{what}, served '
                               'banded vs whole (float32)')
    bf16, want16 = lead['bf16']['logits'], lead['bf16']['want']
    spread = float(want16.max() - want16.min())
    bf16_err = _max_err(bf16, want16)
    if not (np.isfinite(bf16).all() and bf16_err <= TP_BF16_REL_TOL * spread):
        raise AssertionError(f'{what}, served banded vs whole (bf16): '
                             f'{bf16_err} of {spread}')
    served: dict = {}
    for r in serve:
        for kname, err in r['captured']['errs'].items():
            served[kname] = max(served.get(kname, 0.0), err)
    return dict(
        captured=served, calls=[r['captured']['calls'] for r in serve],
        f32_max_abs_err=_max_err(lead['f32']['logits'], lead['f32']['want']),
        bf16_max_abs_err=bf16_err, bf16_spread=spread,
        engine_ms={'banded': lead['bf16']['engine_ms'],
                   'whole': lead['bf16']['whole_engine_ms']})


def _remat_per_step(remat: bool, convs: int) -> dict[str, int]:
    """A rank's launches a banded step of SPACE_REMAT_CONFIG, whose
    student has `convs` QuantConv2d: the teacher's stem pool, and the
    lloyd solves of the student's convs, each on the gathered samples."""
    _, xq, wq, options, _ = train_profile.CONFIGS[SPACE_REMAT_CONFIG]
    out = {'max_pool_3x3_s2_p1': 1}
    solves = lloyd_launches(convs, xq, wq, dict(options, remat=remat))
    if solves:
        out['lloyd_solve_rows'] = solves
    return out


def _space_remat_gates(rem: list) -> dict:
    """The gates of parts (d) and (e) over the ranks' records
    (SPACE_REMAT_CONFIG's comment); the phase's remat record."""
    steps = SPACE_TRAIN['steps']
    for rank, r in enumerate(rem):
        if not all(r['equal'].values()):
            raise AssertionError(f'remat on vs off, rank {rank}: '
                                 f'{r["equal"]}')
        if not np.isfinite(r['on']['losses']).all():
            raise AssertionError(f'remat losses {r["on"]["losses"]}')
    for key in ('on', 'off'):
        if any(r[key]['digests'] != rem[0][key]['digests'] for r in rem):
            raise AssertionError(f'remat {key}: the ranks\' variables '
                                 'differ after a step')
    counts = [{k: v['count'] for k, v in r['on']['recomputed'].items()}
              for r in rem]
    if any(c != counts[0] for c in counts) or not counts[0]:
        raise AssertionError(f'the recomputation\'s collectives differ '
                             f'between ranks: {counts}')
    captured: dict = {}
    for r in rem:
        for key in ('on', 'off'):
            for kname, err in r[key]['captured']['errs'].items():
                captured[kname] = max(captured.get(kname, 0.0), err)
    serve = [r['serve'] for r in rem]

    def mean_ms(rounds: list, key: str, part: str) -> float:
        return float(np.mean([t[part] for t in rounds if t['remat'] == key]))
    out = dict(
        config=SPACE_REMAT_CONFIG, options=SPACE_REMAT_OPTIONS,
        equal=[r['equal'] for r in rem], losses=rem[0]['on']['losses'],
        single_losses={k: v['losses'] for k, v in rem[0]['single'].items()},
        per_step={key: [_tp_launches(r[key]['launches'], steps,
                                     _remat_per_step(key == 'on',
                                                     r[key]['quant_convs']))
                        for r in rem] for key in ('on', 'off')},
        captured=captured,
        calls=[r['on']['captured']['calls'] for r in rem],
        ms_per_step={key: [mean_ms(r['rounds'], key, 'ms_per_step')
                           for r in rem] for key in ('on', 'off')},
        single_ms_per_step={key: mean_ms(rem[0]['rounds'], key,
                                         'single_ms_per_step')
                            for key in ('on', 'off')},
        rounds=[r['rounds'] for r in rem],
        **{part: {key: [r[key][part] for r in rem] for key in ('on', 'off')}
           for part in ('max_memory_allocated', 'collectives', 'recomputed')},
        single_max_memory_allocated={
            key: rem[0]['single'][key]['max_memory_allocated']
            for key in ('on', 'off')})
    served = _served_gates(serve, f'the state trained with remat '
                           f'({SPACE_REMAT_CONFIG})')
    served['per_forward'] = [_tp_launches(r['launches'], 1,
                                          SPACE_REMAT_SERVE) for r in serve]
    for rank, calls in enumerate(served['calls']):
        top = 1 if rank == 0 else 0
        if not (calls.get(f'xnor_conv2d_planes pad_top={top}')
                and calls.get('pack_sign_planes k=2')):
            raise AssertionError(f'rank {rank} served no multi-plane call '
                                 f'on its band at k = 2: {calls}')
    out['serve'] = served
    return out


_SERVING_IMPORT_PROBE = """
import json, socket, subprocess, sys
import torch.distributed as dist
opened = dict(processes=[], sockets=0)
real_popen, real_socket = subprocess.Popen, socket.socket
class Popen(real_popen):
    def __init__(self, args, *a, **k):
        opened['processes'].append(str(args))
        super().__init__(args, *a, **k)
class Socket(real_socket):
    def __init__(self, *a, **k):
        opened['sockets'] += 1
        super().__init__(*a, **k)
subprocess.Popen, socket.socket = Popen, Socket
import quant_tpu_torch.serving as serving
modules = sorted(m for m in sys.modules
                 if m.startswith('quant_tpu_torch.serving.'))
from quant_tpu_torch import _build
print(json.dumps(dict(
    libraries=sorted(_build._libs), **opened,
    process_group=dist.is_available() and dist.is_initialized(),
    modules=modules, engine=serving.InferenceEngine.__module__)))
"""


def serving_import_probe() -> dict:
    """`import quant_tpu_torch.serving` in a fresh interpreter, with
    subprocess.Popen and socket.socket counted: the kernel libraries it
    loaded, the processes it started, the sockets it opened, whether a
    process group is up and which serving modules it imported; then the
    module that serves `InferenceEngine`."""
    out = subprocess.run(
        [sys.executable, '-c', _SERVING_IMPORT_PROBE],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def xnor_resnet50(x_quant: str, w_quant: str, **kwargs: Any
                  ) -> torch.nn.Module:
    """The benchmark's ImageNet ResNet-50 (portbench's r50_xnor_ls2_ls1
    configuration): XNOR bottleneck blocks [3, 4, 6, 3], bench_resnet18's
    stem, clamp and PReLUs, no double shortcut, 1000 classes."""
    from quant_tpu_torch.nn.resnet import QResNet

    config = models.bench_resnet18_config(x_quant, w_quant)
    for layer in ('layer1', 'layer2', 'layer3', 'layer4'):
        config[layer].pop('double_shortcut')
    return QResNet(**dict(config, block='xnor_bottleneck',
                          num_blocks=[3, 4, 6, 3]), **kwargs)


@contextlib.contextmanager
def tail_calls() -> Iterator[list]:
    """Counts the binary conv calls (xnor_conv2d, xnor_conv2d_planes)
    handed a block's tail (ops.binary_infer.Tail), on the card and on the
    CPU alike (where the launch counter `TAIL` stays put): yields a
    one-item list that holds the count."""
    from unittest import mock

    from quant_tpu_torch.ops import binary_infer as B

    n = [0]

    def counted(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args: Any, tail: Any = None, **kw: Any) -> Any:
            n[0] += tail is not None
            return fn(*args, tail=tail, **kw)
        return call

    with mock.patch.object(B, 'xnor_conv2d', counted(B.xnor_conv2d)), \
            mock.patch.object(B, 'xnor_conv2d_planes',
                              counted(B.xnor_conv2d_planes)):
        yield n


# The tail phase (tail_phase): served, folded models whose blocks hand
# their tails to the binary convs (ops.binary_infer.Tail), against the
# same modules with every tail run by the eager ops
# (nn.resnet._Block.tail_engages held false), at the main path's batch of
# seeded images of TAIL_INPUT: logits equal bit for bit in the bf16 and
# the float32 chain; the convs handed a tail (tail_calls) and, on the
# card, the tail launches at the count a forward; none on the eager side.
# {name: (build, x_quant, w_quant, options, tails a forward)}: the main
# path's ResNet-18 and the benchmark's ResNet-50 (ls-2 x ls-1 on the int8
# route).
TAIL_MODELS = {
    'resnet18_xnor_ls1': (models.bench_resnet18, 'ls-1', 'ls-1', {}, 16),
    'resnet50_xnor_ls2_ls1': (xnor_resnet50, 'ls-2', 'ls-1',
                              {'sign_compute': 'int8'}, 48),
}
TAIL_INPUT = (224, 224, 3)


def tail_phase(seed: int, batch: int) -> dict:
    """The tail phase (TAIL_MODELS' comment) at `batch` images; one JSON
    line {"tail_phase": ...}."""
    from unittest import mock

    from quant_tpu_torch.nn import resnet
    from quant_tpu_torch.ops import binary_infer as B

    def forward(model: torch.nn.Module, x: torch.Tensor) -> tuple:
        before = B.tail_launches.count
        with tail_calls() as calls, torch.inference_mode():
            logits = model(x)
        _sync()
        return logits, calls[0], B.tail_launches.count - before

    t0 = time.perf_counter()
    out: dict = {}
    for i, (name, (make, xq, wq, options, tails)) in enumerate(
            TAIL_MODELS.items()):
        model = models.seeded_model(make, xq, wq, DEVICE, seed + i,
                                    moving_average_mode='eval_only',
                                    **options)
        x = torch.randn((batch,) + TAIL_INPUT,
                        generator=torch.Generator().manual_seed(seed + i))
        x = x.to(DEVICE)
        launched = tails if x.is_cuda else 0
        out[name] = {}
        for dt in (torch.bfloat16, None):
            model.eval_dtype = dt
            got, n, n_launched = forward(model, x)
            with mock.patch.object(resnet._Block, 'tail_engages',
                                   lambda self, *a, **kw: False):
                want, n_eager, _ = forward(model, x)
            rec = dict(tails=n, tail_launches=n_launched,
                       eager_tails=n_eager,
                       bit_equal=torch.equal(got.view(torch.int32),
                                             want.view(torch.int32)),
                       max_abs_err=(got - want).abs().max().item())
            out[name]['bfloat16' if dt else 'float32'] = rec
            if not (rec['bit_equal'] and n == tails
                    and n_launched == launched and n_eager == 0):
                raise AssertionError(f'tail phase {name} {dt}: {rec}, '
                                     f'{tails} tails expected')
        del model
    out.update(batch=batch, s=time.perf_counter() - t0)
    print(json.dumps({'tail_phase': out}), flush=True)
    return out


def _api_resnet18(seed: int) -> torch.nn.Module:
    """The main path's model (seeded_serving_resnet18) built through the
    package-level QResNet, on the card."""
    import quant_tpu_torch.nn as qnn

    def make(x_quant: str, w_quant: str, **kw: Any) -> torch.nn.Module:
        return qnn.QResNet(**models.bench_resnet18_config(x_quant, w_quant),
                           **kw)
    return models.seeded_model(make, 'ls-1', 'ls-1', DEVICE, seed,
                               moving_average_mode='eval_only')


def _grouped_block(x_quant: str, seed: int) -> torch.nn.Module:
    """API_GROUPED's QAT block on the CPU: a 3x3 conv of 2 groups, BN, a
    3x3 depthwise conv, BN, plus the input; ls-1 weights, x_quant
    activations, inference_mode 'packed' (the convs' default)."""
    import quant_tpu_torch.nn as qnn

    c = API_GROUPED['channels']
    gen = torch.Generator().manual_seed(seed)

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = qnn.QuantConv2d(c, c, 3, x_quant=x_quant,
                                         w_quant='ls-1', padding=1,
                                         groups=2, generator=gen)
            self.bn1 = qnn.BatchNorm(c)
            self.conv2 = qnn.QuantConv2d(c, c, 3, x_quant=x_quant,
                                         w_quant='ls-1', padding=1,
                                         groups=c, generator=gen)
            self.bn2 = qnn.BatchNorm(c)

        def forward(self, x: torch.Tensor) -> torch.Tensor:
            return x + self.bn2(self.conv2(self.bn1(self.conv1(x))))

    return Block().eval()


def _grouped_step(block: torch.nn.Module, x: torch.Tensor,
                  g: torch.Tensor) -> tuple[float, dict, dict]:
    """One SGD step (lr API_LR) of the loss sum(block(x) * g): (loss, the
    gradients, the new state), all on the CPU."""
    block.train()
    loss = (block(x) * g).sum()
    loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in block.named_parameters()}
    with torch.no_grad():
        for p in block.parameters():
            p -= API_LR * p.grad
    block.eval()
    state = {n: t.detach().cpu() for n, t in block.state_dict().items()}
    return loss.item(), grads, state


def _grouped_phase(x_quant: str, seed: int) -> dict:
    """(b) for one activation scheme: the step card against CPU, then the
    packed-mode eval forward, which must launch nothing."""
    from quant_tpu_torch import _build
    from quant_tpu_torch.device import full_precision

    cpu = _grouped_block(x_quant, seed)
    card = copy.deepcopy(cpu).to(DEVICE)
    rng = np.random.default_rng(seed)
    shape = (API_GROUPED['batch'], API_GROUPED['size'], API_GROUPED['size'],
             API_GROUPED['channels'])
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    with full_precision():
        got = _grouped_step(card, x.to(DEVICE), g.to(DEVICE))
    want = _grouped_step(cpu, x, g)
    largest = max(w.abs().max().item() for w in want[1].values())
    grad_err = max((got[1][n] - w).abs().max().item()
                   for n, w in want[1].items())
    # Each state tensor against its own largest value; a parameter also
    # within one step of the gradients' allowance. Recorded beside the
    # gate: the largest error relative to its own tensor, and which.
    state_excess, state_worst, state_rel = 0.0, None, (0.0, None)
    for n, w in want[2].items():
        if not w.is_floating_point():
            continue
        own = w.abs().max().item()
        err = (got[2][n] - w).abs().max().item()
        state_rel = max(state_rel, (err / own if own else err, n),
                        key=lambda e: e[0])
        excess = err - API_STEP_TOL * (own + (
            API_LR * largest if n in want[1] else 0.0))
        if excess > state_excess:
            state_excess, state_worst = excess, n
    convs = [m for m in card.modules() if hasattr(m, 'packable')]
    if any(m.packed for m in convs):
        raise AssertionError('a grouped conv claims the packed path')
    _sync()
    _build.reset_launch_counts()
    with torch.inference_mode(), full_precision():
        y = card(x.to(DEVICE)).cpu()
    _sync()
    launches = launch_counts()
    with torch.inference_mode():
        y_cpu = cpu(x)
    eval_err = ((y - y_cpu).abs().max() / y_cpu.abs().max()).item()
    rec = dict(x_quant=x_quant, loss_rel_err=abs(got[0] - want[0])
               / abs(want[0]), grad_rel_err=grad_err / largest,
               state_excess=state_excess, state_worst=state_worst,
               state_rel_err=state_rel[0], state_rel_worst=state_rel[1],
               eval_rel_err=eval_err,
               eval_launches={k: v for k, v in launches.items() if v},
               inference_mode=[m.inference_mode for m in convs],
               groups=[m.groups for m in convs])
    if not (rec['loss_rel_err'] <= API_STEP_TOL
            and rec['grad_rel_err'] <= API_STEP_TOL
            and state_excess == 0.0 and eval_err <= API_STEP_TOL):
        raise AssertionError(f'grouped block card vs CPU: {rec}')
    if rec['eval_launches']:
        raise AssertionError(f'the grouped block launched kernels: {rec}')
    return rec


def api_phase(main_model: torch.nn.Module, x: torch.Tensor,
              seed: int) -> dict:
    """The API phase (API_PER_FORWARD's comment): (a), (b), (c); one JSON
    line {"api_phase": ...}. main_model is the main path's bf16 model, x
    its input."""
    from quant_tpu_torch import _build

    t0 = time.perf_counter()
    model = _api_resnet18(seed)
    model.eval_dtype = torch.bfloat16
    _sync()
    _build.reset_launch_counts()
    with torch.inference_mode():
        logits = model(x)
    _sync()
    per_forward = {k: v for k, v in launch_counts().items() if v}
    if per_forward != API_PER_FORWARD:
        raise AssertionError(f'API model launches {per_forward}, expected '
                             f'{API_PER_FORWARD}')
    with torch.inference_mode():
        main_logits = main_model(x)
    err = (logits.float() - main_logits.float()).abs().max().item()
    if err != 0.0:
        raise AssertionError(f'API model logits {err} off the main path')
    out = dict(per_forward=per_forward, max_abs_err=err)
    out['serving'] = serve(model, seed)
    del model
    out['grouped'] = [_grouped_phase(xq, seed)
                      for xq in API_GROUPED['x_quants']]
    out['serving_import'] = serving_import_probe()
    imported = out['serving_import']
    if (imported['libraries'] or imported['processes']
            or imported['sockets'] or imported['process_group']
            or imported['modules']):
        raise AssertionError(f'importing quant_tpu_torch.serving did '
                             f'work: {imported}')
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'api_phase': out}), flush=True)
    return out


def path_launches(api: Optional[dict], tp: Optional[dict],
                  space: Optional[dict], pipe: Optional[dict],
                  space_train: Optional[dict]
                  ) -> dict[str, Optional[dict]]:
    """A rank's launches on each path after the main one, by the kernels
    line's field (None where the phase did not run): a forward of the
    package-level model (api); a TP ring call and a TP-served forward
    (tp); a banded forward (space); a pipeline call, per microbatch x
    PIPE_MICROBATCHES (pipe); a banded train step, the frozen teacher's
    pool (space_train); a served banded forward of the state trained
    with remat (space_remat)."""
    out: dict[str, Optional[dict]] = {f'{k}_launches': None for k in (
        'api', 'tp', 'space', 'pipe', 'space_train', 'space_remat')}
    if api:
        out['api_launches'] = api['per_forward']
    if tp:
        out['tp_launches'] = dict(tp['serving']['per_forward'][0],
                                  **tp['ring']['launches_per_rank'][0])
    if space:
        out['space_launches'] = space['per_forward'][0]
    if pipe:
        out['pipe_launches'] = {k: v * PIPE_MICROBATCHES
                                for k, v in pipe['per_microbatch'][0].items()}
    if space_train:
        out['space_train_launches'] = space_train['kd']['per_step'][0]
        out['space_remat_launches'] = space_train['remat']['serve'][
            'per_forward'][0]
    return out


def path_errs(tp: Optional[dict], space: Optional[dict],
              space_train: Optional[dict]) -> dict[str, float]:
    """The largest error of each kernel against its twin on the parallel
    phases' captured calls and band checks (of the phases that ran)."""
    found: list[dict] = []
    if tp:
        found.append(tp['serving']['captured'])
    if space:
        found += [space['captured'], {
            k: space['band_checks'][k] for k in (
                'xnor_conv2d', 'xnor_conv2d_planes', 'max_pool_3x3_s2_p1')}]
    if space_train:
        found += [space_train['kd']['captured'],
                  space_train['serve']['captured'],
                  space_train['remat']['captured'],
                  space_train['remat']['serve']['captured']]
    errs: dict[str, float] = {}
    for captured in found:
        for kname, err in captured.items():
            errs[kname] = max(errs.get(kname, 0.0), err)
    return errs


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--report', default=None,
                    help='also write the full results as JSON here')
    ap.add_argument('--dp-step-worker', nargs=5, default=None,
                    metavar=('RANK', 'PORT', 'OUT', 'DEVICE', 'CUDNN'),
                    help='run one rank of the DP step (dp_step_phase)')
    ap.add_argument('--tp-worker', nargs=4, default=None,
                    metavar=('RANK', 'PORT', 'OUT', 'SPEC'),
                    help='run one rank of the TP phase (tp_phase)')
    ap.add_argument('--par-worker', nargs=4, default=None,
                    metavar=('RANK', 'PORT', 'OUT', 'SPEC'),
                    help='run one rank of the spatial or pipeline phase')
    args = ap.parse_args(argv)
    if args.dp_step_worker:
        rank, port, out, device, cudnn = args.dp_step_worker
        return dp_step_worker(int(rank), int(port), out, device,
                              cudnn == '1')
    if args.tp_worker:
        rank, port, out, spec = args.tp_worker
        return tp_worker(int(rank), int(port), out, spec)
    if args.par_worker:
        rank, port, out, spec = args.par_worker
        return par_worker(int(rank), int(port), out, spec)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2

    from quant_tpu_torch import _build
    from quant_tpu_torch.probes.models import seeded_serving_resnet18

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f'build: {build_s:.3f} s ({", ".join(logs) or "cached"})')
    resources = {name: kernel_resources(log) for name, log in logs.items()}
    for name, funcs in resources.items():
        for func, res in funcs.items():
            print(f'  {name}: {func}: {res}')

    gen = torch.Generator().manual_seed(args.seed)
    errs = kernel_phases(args.batch, gen)
    for kname, err in planes_kernel_phases(
            torch.Generator().manual_seed(args.seed + 2)).items():
        errs[kname] = max(errs.get(kname, 0.0), err)
    errs.update(probe_kernel_phases(
        torch.Generator().manual_seed(args.seed + 1)))
    print(f'kernels vs plain twins: {errs}', flush=True)

    cpu_model = seeded_serving_resnet18('cpu', args.seed)
    model = copy.deepcopy(cpu_model).to(DEVICE)
    model.eval_dtype = torch.bfloat16
    x = torch.randn(args.batch, 224, 224, 3, generator=gen).to(DEVICE)
    seen, hooks = capture_conv_inputs(model)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with torch.inference_mode():
        logits = model(x)
    torch.cuda.synchronize()
    launches = launch_counts()
    for h in hooks:
        h.remove()
    want = {k: 0 for k in KERNELS}
    want.update({'xnor_conv2d': 16, 'pack_sign_planes': 16, TAIL: 16,
                 'max_pool_3x3_s2_p1': 1})
    if launches != want:
        raise AssertionError(f'launches {launches}, expected {want}')
    if logits.shape != (args.batch, 1000) or not logits.isfinite().all():
        raise AssertionError('bad bf16 logits')
    print(f'main path launches: {launches}', flush=True)
    with torch.inference_mode():
        captured = captured_phases(seen)
    for name, err in captured.items():
        errs[name] = max(errs[name], err)
    print(f'{len(seen)} captured convs vs plain twins: {captured}',
          flush=True)

    model.eval_dtype = None
    with torch.inference_mode():
        got32 = model(x[:4]).cpu()
        want32 = cpu_model(x[:4].cpu())
    spread = (want32.max() - want32.min()).item()
    fp32_err = (got32 - want32).abs().max().item()
    print(f'fp32 chain card vs CPU: max abs err {fp32_err} '
          f'(logit spread {spread})', flush=True)
    if not fp32_err <= FP32_REL_TOL * spread:
        raise AssertionError('fp32 chain disagrees with the CPU model')
    model.eval_dtype = torch.bfloat16

    served = serve(model, args.seed)
    print(f'serving: {served}', flush=True)
    api = api_phase(model, x, args.seed)
    print(f'api phase: {api["s"]:.1f} s', flush=True)
    tail = tail_phase(args.seed, args.batch)

    # Forwards back to back, host included: what a caller gets. The card's
    # share: the same forwards queued behind a head start.
    ms_fwd = card_ms(lambda: model(x), args.iters, head_start_ms=0)
    img_s = args.batch / ms_fwd * 1e3
    ms_fwd_card, card_calls = card_alone_ms(lambda: model(x), args.iters,
                                            ms_fwd)
    with torch.inference_mode():
        stem_ms = card_ms(lambda: torch.relu(model.bn1(
            model.conv1(x.to(torch.bfloat16), torch.bfloat16),
            torch.bfloat16)), args.iters)
    rows = time_kernels(model, x, seen, args.iters)
    next(r for r in rows if r['name'] == 'xnor_conv2d').update(
        occupancy(torch.bfloat16))
    print(f'main path bf16 batch {args.batch}: {ms_fwd} ms/forward, '
          f'{img_s} img/s (card alone {_ms_or_not(ms_fwd_card, card_calls)}'
          f'); stem conv+BN+ReLU {stem_ms} ms', flush=True)

    # The serving stack over the main-path model: in process, then two
    # worker processes, then a worker killed.
    t0 = time.perf_counter()
    stack = dict(frontend=frontend_phase(model, args.seed))
    print(f'serving frontend, 2 engines: {stack["frontend"]}', flush=True)
    stack['workers'] = worker_phase(args.seed)
    stack['s'] = time.perf_counter() - t0
    print(f'serving workers: {stack["workers"]} ({stack["s"]:.1f} s)',
          flush=True)

    # The model phases; the first, ls-T x ls-1, is this path's headline
    # and serves 16 requests. Each phase that launches the multi-plane
    # conv holds it (and the producer) against the twins on its captured
    # inputs and times it there: one kernel row a phase.
    t0 = time.perf_counter()
    phases, planes_launches = [], {}
    for i, (name, build, xq, wq, options, per_conv) in enumerate(
            MODEL_PHASES):
        record, phase_model, phase_seen = model_phase(
            name, build, xq, wq, options, per_conv, args.batch, args.iters,
            args.seed + i)
        if 'xnor_conv2d_planes' in per_conv:
            with torch.inference_mode():
                captured = planes_captured(phase_seen)
                conv_row, pack_row = time_planes_kernels(phase_seen,
                                                         args.iters)
            conv_row.update(phase=name, launches=record['launches'].get(
                'xnor_conv2d_planes', 0))
            rows.append(conv_row)
            for kname, err in captured.items():
                errs[kname] = max(errs[kname], err)
            print(f'{len(phase_seen)} captured {name} convs vs plain twins: '
                  f'{captured}; xnor_conv2d_planes {conv_row["ms"]} ms '
                  f'({conv_row["registers"]} registers, '
                  f'{conv_row["blocks_per_sm"]} blocks an SM)', flush=True)
        if i == 0:
            planes_launches = record['launches']
            # The producer's row is the main path's (k = 1); its k = 2
            # run in this phase goes beside it.
            next(r for r in rows if r['name'] == 'pack_sign_planes')[
                'model_phase'] = dict(phase=name, launches=record[
                    'launches'].get('pack_sign_planes', 0), **pack_row)
            record['serving'] = serve(phase_model, args.seed,
                                      tuple(record['input']),
                                      record['classes'])
            print(f'serving {name}: {record["serving"]}', flush=True)
        if name == OFF_PHASE:
            # The float32 chain's conv inputs, at batch 4.
            seen32, hooks = capture_conv_inputs(phase_model)
            phase_model.eval_dtype = None
            x4 = torch.randn((4,) + tuple(record['input']),
                             generator=torch.Generator().manual_seed(
                                 args.seed + i)).to(DEVICE)
            with torch.inference_mode():
                phase_model(x4)
            phase_model.eval_dtype = torch.bfloat16
            for h in hooks:
                h.remove()
            with torch.inference_mode():
                record['solves'] = solve_phase(phase_seen, seen32,
                                               args.iters)
            print(f'{name} solves {record["solves"]}', flush=True)
        phases.append(record)
        del phase_model, phase_seen
    phases_s = time.perf_counter() - t0
    launches['xnor_conv2d_planes'] = planes_launches.get(
        'xnor_conv2d_planes', 0)
    want['xnor_conv2d_planes'] = launches['xnor_conv2d_planes']
    print(f'model phases: {phases_s:.1f} s', flush=True)

    oracle, oracle_errs = oracle_phase()
    for kname, err in oracle_errs.items():
        errs[kname] = max(errs[kname], err)
    print(f'oracle phase: {oracle["s"]:.1f} s', flush=True)

    t0 = time.perf_counter()
    recipes = []
    for i, (build, xq, wq, recipe) in enumerate(RECIPE_PHASES):
        recipes.append(recipe_phase(build, xq, wq, recipe, args.seed + i))
        print(f'recipe {build} calibrated: {recipes[-1]}', flush=True)
    recipes_s = time.perf_counter() - t0

    train = train_phases(args.seed)
    print(f'train phase: {train["s"]:.1f} s', flush=True)

    def run(name: str, fn: Callable, *fn_args: Any) -> Optional[dict]:
        # A phase that returns None (a rehearsal's stand-in) did not run:
        # its path's fields in the kernels line read null.
        record = fn(*fn_args)
        if record is not None:
            print(f'{name} phase: {record["s"]:.1f} s', flush=True)
        return record

    experiment = run('experiment', experiment_phase, args.seed,
                     train['configs'][0])
    tp = run('tp', tp_phase, args.seed)
    space = run('spatial', spatial_phase, args.seed)
    pipe = run('pipeline', pipeline_phase, args.seed)
    space_train = run('spatial_train', spatial_train_phase, args.seed)
    paths = path_launches(api, tp, space, pipe, space_train)
    for kname, err in path_errs(tp, space, space_train).items():
        errs[kname] = max(errs[kname], err)
    # xnor_gemm runs on no earlier path than the TP ring.
    launches['xnor_gemm'] = (None if tp is None else
                             paths['tp_launches'].get('xnor_gemm', 0))

    t0 = time.perf_counter()
    records, probe_launches = probe_phase()
    probe_s = time.perf_counter() - t0
    print(f'probe path launches: {probe_launches} ({probe_s:.1f} s)',
          flush=True)
    rows += time_probe_kernels(args.iters)
    for kname in PROBE_KERNELS:
        launches[kname] = probe_launches[kname]

    sources = {**{k: 'quant_tpu_torch/csrc/xnor.cu'
                  for k in ('xnor_conv2d', 'xnor_conv2d_planes',
                            'pack_sign_planes', 'xnor_gemm')},
               'max_pool_3x3_s2_p1': 'quant_tpu_torch/csrc/pool.cu',
               **{k: 'quant_tpu_torch/csrc/probe.cu' for k in PROBE_KERNELS}}
    replaces = {'xnor_conv2d': 'quant_tpu/ops/binary_gemm.py:41',
                'xnor_gemm': 'quant_tpu/ops/binary_gemm.py:41',
                'xnor_conv2d_planes': 'quant_tpu/ops/binary_infer.py:280',
                'pack_sign_planes': 'quant_tpu/ops/binary_infer.py:149',
                'max_pool_3x3_s2_p1': 'quant_tpu/ops/pool.py:87',
                'add_f32': 'tools/probe_r2.py:408',
                'tiled_matmul_bf16': 'tools/probe_r2.py:429',
                'tiled_matmul_int8': 'tools/probe_r3.py:304'}
    # A multi-plane row carries its phase's launches.
    kernels = [dict(name=r['name'], route='cuda', source=sources[r['name']],
                    replaces=replaces[r['name']],
                    launches=r.get('launches', launches[r['name']]),
                    on_main_path=want[r['name']] > 0,
                    **{key: None if path is None else path.get(r['name'], 0)
                       for key, path in paths.items()},
                    max_abs_err=errs[r['name']], ms=r['ms'],
                    plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                    bound_by=r['bound_by'], library_ms=r['library_ms'],
                    **{k: r[k] for k in ('phase', 'registers',
                                         'blocks_per_sm', 'bandwidth',
                                         'empty_launch_ms', 'model_phase')
                       if k in r})
               for r in rows]
    if args.report:
        with open(args.report, 'w') as f:
            json.dump(dict(card=card_line(), build_s=build_s,
                           batch=args.batch, ms_per_forward=ms_fwd,
                           images_per_s=img_s, stem_ms=stem_ms,
                           ms_per_forward_card=ms_fwd_card,
                           card_alone_calls=card_calls,
                           fp32_max_abs_err=fp32_err, fp32_spread=spread,
                           serving=served, api=api, tail=tail,
                           kernels=rows,
                           serving_stack=stack,
                           model_phases=phases, model_phases_s=phases_s,
                           oracle=oracle,
                           recipes=recipes, recipes_s=recipes_s,
                           train=train, experiment=experiment, tp=tp,
                           spatial=space, pipeline=pipe,
                           spatial_train=space_train,
                           probes=records, probe_s=probe_s,
                           build_resources=resources,
                           torch=torch.__version__,
                           cuda=torch.version.cuda), f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'probes': records}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
