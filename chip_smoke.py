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
   xnor_conv2d, 16 producer, 1 pool per forward, no other kernel), then
   holds the fp32 chain on the card against the same model on the CPU,
   and holds xnor_conv2d (bf16 and f32 out) and the producer against
   their twins on every conv input the forward captured;
4. serves 16 requests through InferenceEngine on the card;
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
   and held to the CPU's). Each phase that launches the multi-plane conv
   (ls-T, ls-2 int8, and OFF_PHASE) holds it and the producer against
   their twins on its captured inputs and times them there: one kernels
   row a phase, with the registers and blocks an SM of the instance it
   takes;
8. calibrates the two recipe models (RECIPE_PHASES): EMA scales from
   four seeded batches on the card and on the CPU (held to
   CALIBRATION_REL_TOL), then folded, stripped and served;
9. trains (the train phase, TRAIN_CONFIGS): the QAT train step of the
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
10. runs the experiment phase, the port's entry point as users run it:
   the recipe drivers (quant_tpu_torch.examples) in process on the
   recipes' YAML files, cut as EXPERIMENT_MNIST and EXPERIMENT_IMAGENET
   say. (a) mnist_ls1.yaml on a seeded IDX-gz MNIST the phase writes:
   the experiment's files, --restore-experiment --skip-training equal to
   the last test.csv row, --auto-resume to checkpoint_4, serving.prepare
   --calibrate-dataset, the artifact served in process (its launches a
   forward), on the CPU and from an 'artifact' worker process; the
   loader's ms a step beside a fixed batch's and its idle share
   (torch.profiler). (b) The ImageNet KD pair at full width on the
   synthetic loader: the teacher imagenet_fp.yaml, then
   imagenet_ls1_kd.yaml from the teacher's config.yaml and checkpoint
   (the stem pool launched once an eval batch and once a step by the
   frozen teacher), the loaded teacher equal to its experiment's own
   model, serving.prepare --calibrate-synthetic, the artifact served as
   in (a) (16 xnor_conv2d, 16 pack_sign_planes, 1 pool a forward); one
   JSON line {"experiment_phase": ...};
11. runs the probe path (the kernel probes, the cuBLAS bf16 and int8
   rates, the stem against its s2d form and the served model's batch
   sweep at 128 and 512) and checks that it launched each probe kernel.

Prints the card line, a JSON line {"kernels": [...]}, a JSON line
{"probes": [...]} and, last, {"ok": true, "device": {...}}. Any failed
phase raises and exits non-zero; without CUDA it exits 2 before printing
any result.

Usage: python3 chip_smoke.py [--batch 128] [--iters 10] [--seed 0]
                             [--report PATH]
"""

import argparse
import copy
import functools
import json
import os
import re
import subprocess
import sys
import time
from typing import Any, Callable, Optional

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
     {'xnor_conv2d_planes': 1, 'pack_sign_planes': 1}),
    ('resnet18_xnor_ls2_ls1', 'resnet18', 'ls-2', 'ls-1', {}, {}),
    ('resnet18_xnor_ls2_ls1_int8', 'resnet18', 'ls-2', 'ls-1',
     {'sign_compute': 'int8'},
     {'xnor_conv2d_planes': 1, 'pack_sign_planes': 1}),
    ('resnet18_xnor_gf2_ls1', 'resnet18', 'gf-2', 'ls-1', {}, {}),
    ('resnet18_regular_ls1', 'resnet18_regular', 'ls-1', 'ls-1', {},
     {'xnor_conv2d': 1, 'pack_sign_planes': 1}),
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
    per_forward={'xnor_conv2d': 16, 'pack_sign_planes': 16,
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
# A worker process keeps PyTorch's defaults, (float32 matmuls in TF32,
# cuDNN convs in TF32) = (False, True); this script turns both off.
WORKER_TF32 = (False, True)


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
    """Forward pre-hooks that record each QuantConv2d's input."""
    from quant_tpu_torch.nn.layers import QuantConv2d
    seen: list = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((mod, args[0])))
        for m in model.modules() if isinstance(m, QuantConv2d)]
    return seen, hooks


def captured_phases(conv_inputs: list) -> dict[str, float]:
    """The producer and xnor_conv2d against their twins on every conv
    input the forward captured: the real block inputs, thresholds, words,
    scales and biases, the conv in bf16 and f32 out; returns {kernel: max
    abs error}."""
    from quant_tpu_torch.ops import binary_infer as B

    pack_err = conv_err = 0.0
    for i, (conv, xin) in enumerate(conv_inputs):
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
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d captured {i} {dt}',
                B.xnor_conv2d(*args, out_dtype=dt, **kw),
                B.xnor_conv2d_plain(*args, out_dtype=dt, **kw)))
    torch.cuda.synchronize()
    return {'pack_sign_planes': pack_err, 'xnor_conv2d': conv_err}


def time_kernels(model: torch.nn.Module, x: torch.Tensor,
                 conv_inputs: list, iters: int) -> list[dict]:
    """Per kernel, summed over the launches of one forward at the path's
    shapes: kernel, plain twin and library ms, and the bound."""
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
    for conv, xin in conv_inputs:
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

        kw = dict(in_channels=c, stride=s, padding=1, out_dtype=dt)
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
            + out.numel() * out.element_size()
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
    from quant_tpu_torch.serving.engine import InferenceEngine

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
    want = {k: 0 for k in SERVING_KERNELS + PROBE_KERNELS}
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
    for i, (conv, xin) in enumerate(seen):
        k = B.sign_planes(conv.x_quant)
        xp, args = _producer_args(conv, xin)
        for x in (xp, xp.float()):
            pack_err = max(pack_err, check_equal(
                f'pack_sign_planes captured {i} {x.dtype}',
                B.pack_sign_planes(x, k, *args),
                B.pack_sign_planes_plain(x, k, *args)))
        conv_args, kw = _planes_conv_args(conv, xin)
        for dt in (torch.bfloat16, torch.float32):
            conv_err = max(conv_err, check_equal(
                f'xnor_conv2d_planes captured {i} {dt}',
                B.xnor_conv2d_planes(*conv_args, out_dtype=dt, **kw),
                B.xnor_conv2d_planes_plain(*conv_args, out_dtype=dt, **kw)))
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
    for conv, xin in seen:
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
            + out.numel() * out.element_size()
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
    for conv, xin in seen:
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


def solve_phase(seen: list, seen32: list, iters: int) -> dict:
    """The per-sample activation solves of an 'off' model: card ms summed
    over the convs of its bf16 forward (the whole batch), and _solve_rows
    on the inputs of that forward (bf16 values) and of its float32 chain
    (seen32). Returns the record."""
    ms = 0.0
    for conv, xin in seen:
        xc = conv.clamp_fn()(xin)
        ms += card_ms(lambda: conv.x_quantizer.solve(xc), iters)
    return dict(solve_ms=ms, convs=len(seen), bf16_rows=_solve_rows(seen),
                f32_rows=_solve_rows(seen32))


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
    want = {k: 0 for k in SERVING_KERNELS + PROBE_KERNELS}
    want.update(xnor_conv2d=16 * batches, pack_sign_planes=16 * batches,
                max_pool_3x3_s2_p1=batches)
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
    xnor_conv2d, 16 pack_sign_planes and 1 pool."""
    got = {k: after['kernel_launches'][k] - before['kernel_launches'][k]
           for k in after['kernel_launches']}
    n = after['batches'] - before['batches']
    want = {k: 0 for k in got}
    per_batch = per_batch or dict(xnor_conv2d=16, pack_sign_planes=16,
                                  max_pool_3x3_s2_p1=1)
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


def cuda_event() -> Any:
    """A CUDA event recorded on the current stream (timing enabled)."""
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


def train_phase(name: str, seed: int) -> tuple[dict, Any]:
    """One train configuration at TRAIN_BATCH: TRAIN_WARMUP steps, then
    TRAIN_STEPS through make_train_step and train_epoch on one fixed
    seeded batch, timed with CUDA events at each part of the step. The
    loss must be finite at every step and fall from the first step to
    the last, and the timed steps launch the stem pool kernel once a
    step (the teacher's) and no other kernel. Returns (record, the train
    state)."""
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
    if launches != {'max_pool_3x3_s2_p1': TRAIN_STEPS}:
        raise AssertionError(f'{name}: launches {launches}')
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
    expect = dict(xnor_conv2d=n_convs, pack_sign_planes=n_convs,
                  max_pool_3x3_s2_p1=1)
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
    'artifact' worker process: the same requests, one at a time, equal
    to the in-process engine's answers under the worker's TF32 settings
    (WORKER_TF32), the worker's launches from its stats. Both engines
    pad every batch to one bucket of EXPERIMENT_REQUESTS, so each
    forward takes one cuDNN algorithm: the float32 stem's rounding flips
    binary activations near their thresholds (the ResNet-18 artifact's
    worker under cuDNN's TF32 against this process without: 3.3-3.4% of
    the logit spread, measured)."""
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
    with tf32(*WORKER_TF32):
        want_worker = engine.predict(images)
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
    err = float(np.abs(got - want_worker).max())
    if not np.array_equal(got, want_worker):
        raise AssertionError(f'{out}: worker vs in-process engine max abs '
                             f'err {err}, spread {spread}')
    return dict(requests=len(images), launches_per_forward=launches,
                cpu_max_abs_err=cpu_err, spread=spread,
                cpu_rel_err=cpu_err / spread, worker_startup_s=startup_s,
                worker_batches=after['batches'] - before['batches'],
                worker_launches=worker, worker_max_abs_err=err,
                worker_tf32_vs_off_max_abs_err=float(
                    np.abs(want_worker - want).max()),
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


def experiment_phase(seed: int, train_record: dict) -> dict:
    """The experiment phase, in a temporary directory removed after."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='qtt_experiment_') as root:
        out = dict(mnist=mnist_experiment(root, seed))
        print(f'experiment mnist: {out["mnist"]}', flush=True)
        out['imagenet'] = imagenet_experiment(root, seed, train_record)
    out['s'] = time.perf_counter() - t0
    print(json.dumps({'experiment_phase': out}), flush=True)
    return out


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--report', default=None,
                    help='also write the full results as JSON here')
    args = ap.parse_args(argv)
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
    want = {k: 0 for k in SERVING_KERNELS + PROBE_KERNELS}
    want.update(xnor_conv2d=16, pack_sign_planes=16, max_pool_3x3_s2_p1=1)
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

    t0 = time.perf_counter()
    recipes = []
    for i, (build, xq, wq, recipe) in enumerate(RECIPE_PHASES):
        recipes.append(recipe_phase(build, xq, wq, recipe, args.seed + i))
        print(f'recipe {build} calibrated: {recipes[-1]}', flush=True)
    recipes_s = time.perf_counter() - t0

    train = train_phases(args.seed)
    print(f'train phase: {train["s"]:.1f} s', flush=True)

    experiment = experiment_phase(args.seed, train['configs'][0])
    print(f'experiment phase: {experiment["s"]:.1f} s', flush=True)

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
                           serving=served, kernels=rows,
                           serving_stack=stack,
                           model_phases=phases, model_phases_s=phases_s,
                           recipes=recipes, recipes_s=recipes_s,
                           train=train, experiment=experiment,
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
