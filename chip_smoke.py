#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, fit, evaluation,
model-tool, data-tool, multi-device and spatially partitioned paths and
the repository's root entry points on one NVIDIA card (two ranks share it)
and check them.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its seconds; any failure raises and exits non-zero):

1. environment: torch/CUDA versions and the card's name and power limit;
2. build: the three CUDA kernel libraries (nvcc, sm_90a: the fused conv,
   the row shear and train-mode BatchNorm-ReLU) and the native TIFF
   library, from this checkout's sources, in parallel; ptxas must report no
   spills in any BatchNorm-ReLU kernel;
3. kernel parity: the fused conv against its plain PyTorch version on the
   card at the nine DoubleConv shapes of the full-width UNet (batch 2), an
   odd shape, channel tails, b > 0 cases and the edges of the bf16
   kernel's tiles, in f32 and bf16; ptxas must report no spills in the bf16
   kernel;
4. kernel timing: kernel, plain chain and one cuDNN conv of the
   materialized z, per level at batch 16 (CUDA events), beside the bound
   (its fraction and TFLOP/s); the kernel's batch-16 output is held to the
   plain chain's, and the kernel must beat the plain chain at every level;
4b. BatchNorm-ReLU parity and timing (``bn_relu_parity``,
   ``bn_relu_timing``): the train-mode kernels against
   their plain version at every distinct
   BatchNorm shape of the benchmark's two configurations (batch 10, 300^2
   early fusion and 512^2 late fusion) and at ragged tails, in bf16, f32 and
   f64 (statistics, sums, z and dx within their tolerances; the same bits
   from the plain version's statistics; two launches the same bits; a
   one-rank group's two stages); then one train step's 18 calls per
   configuration against the plain version and F.batch_norm + F.relu;
5. the slice (serving): synthetic PlanetScope scenes written with the
   port's TIFF writer, the full-width early-fusion UNet (base 64, 4 bands,
   3 classes, bf16, conv_impl=pallas_fused) with seeded flax-layout weights
   carried through the weights bridge, four ``infer`` requests on one warm
   model (two plain and one with TTA through the HBM scene cache, one plain
   through the host loader) and one overlapping ``sliding_window_predict``
   pass; masks, probabilities, kernel launches (9 per forward) and the
   agreement with the unfused cuDNN path are checked;
6. shear parity: the row-shear kernel against its plain version, bit for
   bit, at [8, 512, 512, 6] and [2, 300, 300, 6] over five residual angles
   and on the quantization's edges (integer shifts, .5 ties, clipped
   shifts) at odd shapes and C in {3, 5, 6}; both axes, order 0 and 1, f32
   and bf16;
7. shear timing: the kernel's device time (a trace, which must show one
   launch per wrapper call and nothing else), the wrapper's time per call,
   the shear along H, the plain version and one ``F.grid_sample`` at
   [8, 512, 512, 6] bf16, beside the bytes bound; the kernel must not be
   slower than ``grid_sample``;
8. training: augmentation (flips + rotation, rotate_impl=shear_pallas,
   bf16) and train steps (Adam, lr 1e-4) of the full-width model at batch 8
   on 512^2 crops through the loader, then steps on one fixed augmented
   batch (the loss must fall), eval steps before and after the updates and
   after one optimizer step alone (the pack cache must re-pack each time;
   the fused eval must agree with the unfused model), exact launch counts
   of both kernels, one f32 step fused + kernel shear against unfused +
   plain shear with an f64 unfused step as the witness, the model's 2x
   upsample at the decoder's four levels (its forward ``F.interpolate``
   bit for bit, its deterministic backward within UPSAMPLE_TOL of the
   exact one and timed against ``F.interpolate``'s), device times of the
   steps,
   the fused and unfused step with deterministic algorithms on (as the fit
   runs them) and off, and profiles of one train step and one augment
   step;
9. fit: the training phase's scenes and model through
   ``python -m floodplanet_code_tpu_torch.fit`` (its ``main``) with the
   reference's default transforms: every batch of one epoch from the HBM
   scene cache against the loader's (bit-identical with norm_mode null,
   1e-6 with local); a 3-epoch fit with async top-2 checkpoints (index.json
   held to the retention rules, finite losses, timing.json, exact conv
   launches: 9 per train step, validation batch and image panel); a resume
   to a 4th epoch whose restored tensors equal the file's bit for bit; a
   no-op re-run with no launch; a 2-epoch fit through the host loader;
   ``infer`` from the best checkpoint through the cache and the host
   loader on one warm model (probabilities within 1e-6, argmax equal);
   and the fit's reproduction (fit_reproduction): fits of REPRO_EPOCHS
   epochs run twice from scratch under pallas_fused and under xla, and 1
   epoch resumed to REPRO_EPOCHS under pallas_fused, every per-epoch
   metric and every tensor of the final checkpoint equal bit for bit;
10. evaluation: ``predict`` from a checkpoint directory of the full-width
   early-fusion model over the serving phase's scenes (geo-tagged, tiles
   overlapping by half): with every report and scene artifact (each file
   must parse, ``pred_class.tif`` must carry the scene's geo tags), with
   per-crop statistics, with TTA, and with ``conv_impl=xla`` (cuDNN), whose
   argmax must agree on >= 99.9% of pixels and move <= 0.1% of them to
   other confusion cells; ``predict`` of the full-width late-fusion model
   on Sen1Floods11 S1 chips, one flood event held out, through the scene
   cache and the host loader (probabilities within 1e-6, argmax equal);
   the HTTP daemon (``serve`` on 127.0.0.1, port 0, in a thread): health,
   two requests on one root whose masks must equal ``infer``'s bit for
   bit, the 400 and 404 replies; ``batch_infer`` over two roots, its masks
   equal to ``infer``'s (kept for phase 15); exact conv launches; the
   predict split (forward by CUDA events, loading + stitching, metrics,
   artifacts on the host clock) and the daemon's cold and warm request
   seconds;
11. model tools, on the full-width early-fusion model: ``run_crossval``'s
   ``main`` over two folds of synthetic PlanetScope regions at the
   reference recipe (300^2 crops, stride 150, Adam 1e-4, ignore_index -1)
   with ``--soup``, cut to TOOLS_EPOCHS epochs of at most
   TOOLS_LIMIT_TRAIN steps (each fold's best IoU held to its index, the
   greedy soup at least its base and outside the index), and a second call
   that skips both folds; ingredients re-scored on one model equal to fresh
   models bit for bit, the soup checkpoint re-scored to its metrics, a
   uniform soup; a second seed of fold A and the two-member ensemble
   (members equal to their own evaluation, folds not mixed, fused vs cuDNN
   <= 0.1% of pixels moved); ``export_model`` of fold A's best checkpoint
   at the serving tile and batch, plain and with TTA, the loaded programs
   against the live predict step (argmax equal, |dp| <= 1e-5) and timed
   with CUDA events; the daemon on the artifact, its masks against
   ``infer``'s; reference-schema checkpoints, early and late fusion,
   through ``import_torch_checkpoint`` and ``infer``, fused vs cuDNN as in
   the slice; exact conv launches;
12. data tools and options, with neither the conv nor the shear kernel on
   any path (0 launches of either; train-mode BatchNorm runs its kernels,
   counted): ``compute_norm_params`` over the serving scenes,
   the scene cache against the loader with ``norm_mode=global`` and fits
   through both; a fit at DATA_CROP non-square crops rotated by
   map_coordinates, one such augment step on the card against the CPU,
   and map_coordinates against the roll shear at 512^2; ``fused_bn=false``
   (under pallas_fused, the fused pair off) against ``fused_bn=true`` on the
   same weights, the bf16 eval forward and an f32 train step (the
   element-wise gradient bound with the true step's ReLU and pool
   decisions applied, BN_FORCED_SHARE); fits with
   ``tpu.debug_nans`` off, on and off again (the losses equal bit for
   bit: the fit is deterministic) and on a poisoned
   batch (``FloatingPointError`` at the step); ``visualize_transforms`` on
   the card, ``generate_dataset_visualizations``, ``compute_feature_stats``,
   ``delete_failed_experiments --dry_run`` over the phase's experiments, and
   the example transformer on the card against the CPU;
13. more than one device (``parallel/``), on the full-width early-fusion
   model (base 64, bf16 and f32, conv_impl=pallas_fused, 512^2): two ranks
   that share the one card over gloo (NCCL refuses two ranks on one
   device): the f32 data-parallel train step at global batch MD_BATCH (half
   per rank) held to the one-rank step on the same batch by phase 8's rule
   (loss 1e-4; each gradient, the running statistics and, after MD_STEPS
   steps, the parameters within GRAD_TOL of their norm and GRAD_MAX_TOL of
   their largest element), bf16 steps on one batch whose loss must fall, the
   eval step with padded rows, the augment step (shear kernel) over the
   globally drawn batch bit for bit, exact launches per rank; one rank over
   NCCL; a 2-rank ``fit_model`` (parallel/launch.py) through the replicated
   scene cache, resumed on both ranks through the pod-sharded cache as 2
   pods (its batches equal the replicated ones), rank 0 alone writing,
   per-epoch losses within 3% of the one-rank fit, the ranks' final
   parameters and statistics equal bit for bit; ``infer`` over two
   replicas against one device (>= 99.9% of pixels, |dp| <= DPROB_TOL). On
   a machine with two cards or more, the 2-rank fit over NCCL and ``infer``
   over two cards too; else one line says they were not run;
14. spatial partitioning (``tpu.spatial_shards=2``), in phase 13's two
   ranks: a 1 x 2 data x space mesh, each rank the whole global batch's
   MD_BATCH rows and its block of the image rows, at the even TILE^2
   (blocks of equal height at every level) and at the reference's default
   SP_TILE^2 crop (300: blocks 150/150, 75/75, 38/37, 19/18, 10/8, two
   pool windows split between the ranks, two padded levels; SyncBN
   weighting each rank by its pixels): at each, the same step checks
   against the one-rank steps on the same global batch (f32 gradients
   within SP_GRAD_TOL of their norm; at SP_TILE also an f64 step each
   through the fused pair's own graph, the spatial one within SP_F64_TOL of
   one rank's, and the f32 rule met there or by the f64 witness at
   SP_WITNESS_RATIO: see sp_step_checks), the augment step (shear
   kernel) on the full-height rows bit for bit, the fused conv on
   halo-extended rows (the neighbours' edge rows joined) against its plain
   version (TILE: the inc and bottleneck levels; SP_TILE: the uneven levels
   2-4), exact launches per rank, the bf16 step's time and peak memory per
   rank against one rank's and every collective of one step timed alone
   (the halo exchanges, the BatchNorm sums, the rest); at SP_TILE the eval
   pack cache across block heights (one pack serves a block and the whole
   image, equal to packing per call); a 2-rank spatial ``fit_model`` at
   SP_TILE^2 of MD_EPOCHS epochs through the replicated cache with a
   full-height image panel every SP_LOG_IMAGE_ITER steps, rank 0 alone
   writing, finite per-epoch losses, the ranks' final states bit for bit,
   reported beside a one-rank fit at the same crop (not held to it: the
   ranks sum in another order and a bf16 fit's epochs carry the rounding;
   the f32 step checks carry its correctness on the card, and
   tests/test_torch_fit_ranks.py holds a spatial fit with a split pool
   window to the JAX fit on the CPU). At SP_TILE the f32 steps are also
   held with matched ReLUs (sp_matched_step): the spatial step applies the
   one-rank step's ReLU decisions and pool choices, and its gradients must
   lie within SP_MATCHED_TOL of that step's. Its numbers are the
   ``spatial`` entry of the multi-device JSON (``crop``: the SP_TILE
   steps).

15. the root entry points: ``bench_torch.main`` (bench.py's workload on
   the port) under both conv_impl values, each JSON line logged: finite
   positive rates, equal FLOP counts, ``0 < mfu <= 1``, exact conv
   launches; ``Batch_infer_torch.sh`` on phase 10's checkpoint and roots,
   its masks equal to ``batch_infer``'s bit for bit.

The last eleven lines of standard output are the serving slice's numbers
as JSON, the training phase's numbers as JSON, the fit phase's numbers as
JSON, the evaluation phase's numbers as JSON, the model tools' numbers as
JSON, the data tools' numbers as JSON, the multi-device phase's numbers as
JSON, the entry points' numbers as JSON, the card's name and power limit,
the ``kernels`` JSON line and the ``{"ok": true, ...}`` line.
Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

# The fits run under deterministic algorithms (train/fit.py), which need
# this before the process's first cuBLAS call; spawned ranks inherit it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from floodplanet_code_tpu_torch import fit as fit_cli
from floodplanet_code_tpu_torch.config import Config, compose, load_experiment_config, save_config
from floodplanet_code_tpu_torch.data import (
    BatchLoader,
    build_dataset,
    device_prefetch,
    generate_image_slice_object,
)
from floodplanet_code_tpu_torch.data.augment import (
    AugmentDraws,
    TransformParams,
    apply_augmentation,
    draw_augmentation,
)
from floodplanet_code_tpu_torch.data.device_cache import (
    build_device_cache,
    make_batch_builder,
)
from floodplanet_code_tpu_torch.device import peaks
from floodplanet_code_tpu_torch.geo import tiff
from floodplanet_code_tpu_torch.inference import batch_infer as batch_infer_mod
from floodplanet_code_tpu_torch.inference import predict as predict_mod
from floodplanet_code_tpu_torch.inference import serve as serve_mod
from floodplanet_code_tpu_torch.inference.infer import (
    build_experiment_dataset,
    build_infer_dataset,
    infer,
    load_model_for_eval,
)
from floodplanet_code_tpu_torch.inference.sliding import (
    make_predict_step,
    sliding_window_predict,
)
from floodplanet_code_tpu_torch.models import build_model
from floodplanet_code_tpu_torch.ops import LAUNCHES
from floodplanet_code_tpu_torch.ops import batchnorm, conv_fused, rotate
from floodplanet_code_tpu_torch.models.example_transformer import ExampleTileTransformer
from floodplanet_code_tpu_torch.tools import (
    compute_feature_stats,
    compute_norm_params,
    delete_failed_experiments,
    eval_ensemble,
    export_model,
    generate_dataset_visualizations,
    import_torch_checkpoint,
    run_crossval,
    soup_checkpoints,
    test_image_transforms,
)
from floodplanet_code_tpu_torch.tools.import_jax_params import (
    save_weights,
    seeded_flax_variables,
    state_dict_from_flax,
)
from floodplanet_code_tpu_torch.train import (
    create_train_state,
    init_weights,
    make_augment_step,
    make_eval_step,
    make_train_step,
    resolve_ignore_index,
)
from floodplanet_code_tpu_torch.train import checkpoint as ckpt
from floodplanet_code_tpu_torch.train import fit as train_fit
from floodplanet_code_tpu_torch.train.logging import log_image_panel, open_writer

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")  # listed in .gitignore

# The nine DoubleConv middle boundaries of the base-64 UNet at 512^2 tiles:
# (name, H = W, C1, C2). The kernel's input is the mid activation.
LEVELS = [
    ("inc", 512, 64, 64),
    ("down1", 256, 128, 128),
    ("down2", 128, 256, 256),
    ("down3", 64, 512, 512),
    ("down4", 32, 512, 512),
    ("up1", 64, 512, 256),
    ("up2", 128, 256, 128),
    ("up3", 256, 128, 64),
    ("up4", 512, 64, 64),
]
# Dense bf16 tensor-core FLOP/s and HBM bytes/s (NVIDIA data sheets, SXM
# parts, at the full 700 W power limit).
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # of max|ref|
DPROB_TOL = 5e-3  # max |fused - unfused| stitched probability, bf16 model
SCENES = [(2100, 3300), (2100, 3300), (1500, 2700)]  # ragged edges at 512^2
TILE = 512
BATCH = 16
# f32 rate outside the tensor cores (NVIDIA data sheet, SXM, 700 W): the
# operations bound of the elementwise shear.
F32_PEAK = {"H100": 67e12, "H200": 67e12}

# Training phase: the reference's default recipe (config.yaml: flips and
# rotation at p=0.5 over 0-360 degrees, Adam at lr 1e-4, CE ignoring class 0,
# bf16) at bench.py's shape (512^2, batch 8), with the Pallas-kernel
# configuration of the rotation (rotate_impl=shear_pallas). Five scenes,
# so the 0.8 split leaves at least 15 batches of 8.
TRAIN_SCENES = SCENES + [(2100, 3300), (2100, 3300)]
TRAIN_BATCH = 8
TRAIN_STEPS = 12
FIXED_STEPS = 10  # steps on one fixed augmented batch: the loss must fall
BASE = 64  # UNet base width
F32_BATCH = 2  # the f32 fused-vs-plain step
# In that step, each gradient tensor's difference: its norm within GRAD_TOL
# of the tensor's norm, its largest element within GRAD_MAX_TOL of the
# tensor's largest (see f32_step_check). And the witness: against an f64
# unfused step, the fused f32 gradients' worst distance is at most
# WITNESS_RATIO times the unfused f32 gradients' worst distance.
GRAD_TOL = 1e-2
GRAD_MAX_TOL = 3e-2
WITNESS_RATIO = 3.0
# Phase 12's fused_bn=false step with the fused_bn=true step's ReLU and pool
# decisions: the share of its own decisions that they may override (f32
# rounding decides a few per million differently; a fault, a large share).
BN_FORCED_SHARE = 1e-4
# Shear parity: [B, H = W] at the augmentation shape and the reference's
# 300^2 crop; residual angles through rotate_flip_batch's a, b.
SHEAR_SHAPES = [(8, 512), (2, 300)]
SHEAR_ANGLES = [-44.9, -10.0, 0.0, 17.0, 44.9]
SHEAR_TOL = {torch.float32: 1e-5, torch.bfloat16: 3.9e-3}  # of max|ref|
# Shear parity at the quantization's edges: [B, H, W, C] with W*C not a
# multiple of the vector width, and C off the kernel's C = 6 path.
SHEAR_EDGE_SHAPES = [(1, 37, 53, 6), (2, 40, 40, 3), (2, 24, 40, 5)]

# Fit phase: the training phase's scenes, model and batch through the fit
# CLI with the reference's default transforms (the roll shear: no shear
# kernel), async checkpoints, top-2 retention and a resume point every
# second epoch.
FIT_EPOCHS = 3
FIT_LIMIT_TRAIN = 15
FIT_LIMIT_VAL = 2
FIT_LOG_IMAGE_ITER = 10
# The reproduction check (fit_reproduction): fits of REPRO_EPOCHS epochs of
# at most REPRO_LIMIT_TRAIN steps, compared bit for bit.
REPRO_EPOCHS = 2
REPRO_LIMIT_TRAIN = 4
LOCAL_TOL = 1e-6  # cache vs loader with norm_mode local, of max|ref|
PROB_TOL = 1e-6  # stitched probabilities, cache vs host path

# Evaluation phase: predict over the serving phase's scenes with tiles
# overlapping by half (the config's default crop_stride is 150 at 300^2
# crops), and Sen1Floods11 chips of one tile each, EVAL_CHIPS per flood
# event, the first event held out.
EVAL_REGIONS = ("Bolivia", "Ghana", "Mekong")
EVAL_CHIPS = 8

# Model-tools phase: run_crossval's recipe (300^2 crops at stride 150,
# Adam 1e-4, ignore_index -1, the default flips and rotation) over two
# synthetic PlanetScope regions of two scenes each, cut to TOOLS_EPOCHS
# epochs of at most TOOLS_LIMIT_TRAIN steps and TOOLS_LIMIT_VAL validation
# batches (the soups and the ensemble score the whole validation split);
# the export and the daemon at the serving phase's tile and batch.
TOOLS_REGIONS = ("RegionA", "RegionB")
TOOLS_SCENES = [(1200, 1500), (1250, 1530)]  # per region; the second ragged at 300^2
TOOLS_CROP = 300
TOOLS_BATCH = 8
TOOLS_EPOCHS = 2
TOOLS_LIMIT_TRAIN = 10
TOOLS_LIMIT_VAL = 4
EXPORT_DPROB_TOL = 1e-5  # exported program vs the live predict step
MASK_AGREE_MIN = 0.9999  # artifact daemon vs infer, should the masks not be equal
# Phase 15: bench_torch's timed steps per timing (bench.py's 20), and where
# phase 10 leaves its checkpoint, roots and batch_infer masks for it.
BENCH_STEPS = 20
KEEP = os.path.join(REPO, "build", "chip_smoke_entry")  # listed in .gitignore

# Data-tools phase: the serving phase's scenes through fits with the
# config's default conv_impl (xla), each cut to DATA_EPOCHS epochs of at
# most DATA_LIMIT_TRAIN steps and DATA_LIMIT_VAL validation batches, at the
# training phase's batch; non-square crops at DATA_CROP (H, W); the
# poisoned debug_nans fit gets its NaN at NAN_AT (epoch, train step); the
# example transformer at TRANSFORMER on TILE^2 tiles, batch TRAIN_BATCH.
DATA_EPOCHS = 2
DATA_LIMIT_TRAIN = 4
DATA_LIMIT_VAL = 2
DATA_CROP = (384, 512)
NAN_AT = (0, 2)
TRANSFORMER = {"d_model": 128, "n_layers": 2, "patch": 16}

# Multi-device phase: the data-parallel steps of the full-width model on
# MD_BATCH global rows of the training phase's scenes (MD_BATCH / 2 per
# rank), MD_STEPS f32 steps held to the one-rank step, MD_FIXED_STEPS bf16
# steps on one batch, an eval batch with MD_PAD padded rows; the 2-rank
# fits cut to MD_EPOCHS epochs of MD_LIMIT_TRAIN steps and MD_LIMIT_VAL
# validation batches at the training phase's batch.
MD_BATCH = 8
MD_STEPS = 3
MD_FIXED_STEPS = 4
MD_PAD = 3
MD_EPOCHS = 2
MD_LIMIT_TRAIN = 4
MD_LIMIT_VAL = 2
# Spatial partitioning (phase 14, in phase 13's ranks): the same global
# batch on a 1 x 2 data x space mesh (each rank MD_BATCH rows of TILE / 2
# image rows), the f32 gradients within SP_GRAD_TOL of their norm of the
# one-rank step's; its fit as phase 13's with an image panel every
# SP_LOG_IMAGE_ITER steps.
SP_GRAD_TOL = 2e-3
# The spatial f64 step's gradients against the one-rank f64 step's, of
# their largest element and of their norm: f64 rounding, and the f32 logits
# the loss reads (1e-7 on the CPU).
SP_F64_TOL = 1e-5
# The f64 witness at SP_TILE (sp_step_checks): the spatial f32 gradients'
# worst distance to the one-rank f64 step's, in the max and the norm form,
# at most SP_WITNESS_RATIO times one rank's own f32 gradients'. Both
# distances come from the few ReLUs whose input lies within rounding of
# zero, which each f32 step decides its own way (scripts/relu_flips.py), so
# the ratio moves with their count: on the card at 300^2 it reads 1.03 in
# both forms, in the CPU rehearsal at 50^2 (one such ReLU) 1.55 and 1.05
# (PERF.md).
SP_WITNESS_RATIO = 2.0
# The matched-ReLU check at SP_TILE (sp_matched_step): the spatial f32
# step applies the one-rank f32 step's ReLU decisions and 2x2 pool
# choices, so no decision taken at rounding distance (a ReLU input near
# zero, a near tie in a pool window) parts the two; the gradients must lie
# within SP_MATCHED_TOL of their norm and SP_MATCHED_MAX_TOL of their
# largest element of the one-rank step's, each tensor. What is left is f32
# rounding, largest in the BatchNorm scales' sums over 720K pixels per
# channel: 1.34e-4 and 1.92e-4 on the card (PERF.md), 1.9e-5 in
# the CPU rehearsal at 50^2; unmatched, 8.3e-3 and 4.5e-2.
SP_MATCHED_TOL = 5e-4
SP_MATCHED_MAX_TOL = 2e-3
SP_LOG_IMAGE_ITER = 4
# The uneven case: the reference's default crop (config.yaml: 300^2), whose
# levels 300, 150, 75, 37, 18 split over 2 ranks into 150/150, 75/75, 38/37,
# 19/18, 10/8 rows (parallel/rows.py): two pool windows across the ranks
# and two padded levels. Its steps, the fused conv on its uneven blocks
# (levels 2-4) and the spatial fit run at this crop.
SP_TILE = 300
SP_PARITY_LEVELS = {"even": (0, 4), "uneven": (2, 3, 4)}
AUG_TOL = 1e-5  # map_coordinates on the card vs the CPU, absolute, images in [0, 1]
# The model's upsample backward against the exact one (F.interpolate's in
# f64), of the largest element: f32 rounding; one bf16 rounding of the f32
# sum, at most 2^-8 of a value.
UPSAMPLE_TOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -8}
# Train-mode BatchNorm + ReLU kernels: the two benchmark configurations'
# UNets ((model, bands, tile) at batch BN_BATCH) and ragged tails (C off
# the 8-channel vector, rows under one slab); tolerances: z and dx of
# max|plain| (the dtype's rounding), the statistics and the backward's sums
# of their sum of magnitudes (summation order).
BN_CONFIGS = {"ef": ("ef_model", {"ms_image": 4}, 300), "lf": ("lf_model", {"ms_image": 2}, 512)}
BN_BATCH = 10
BN_TAILS = [("tail C 5", (2, 5, 3, 7)), ("tail C 12", (3, 12, 5, 4)),
            ("tail C 100", (2, 100, 9, 11)), ("tail 1 row", (1, 64, 1, 1)),
            ("tail C 3 1x1", (1, 3, 1, 1))]
BN_EPS = 1e-5
BN_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-5, torch.float64: 1e-12}
BN_STAT_TOL = {torch.bfloat16: 1e-5, torch.float32: 1e-5, torch.float64: 1e-12}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# -- 2. build ---------------------------------------------------------------


def build_all() -> None:
    results: dict = {}

    def run(name, fn):
        try:
            results[name] = fn()
        except BaseException as exc:  # re-raised below, in the main thread
            results[name] = exc

    # batchnorm.cu builds one library per type and load width.
    bn = {f"batchnorm {str(t).split('.')[1]} vec={v}": functools.partial(batchnorm.build, t, v)
          for t in (torch.bfloat16, torch.float32, torch.float64) for v in (1, 0)}
    threads = [
        threading.Thread(target=run, args=("conv_fused", conv_fused.build)),
        threading.Thread(target=run, args=("rotate", rotate.build)),
        *(threading.Thread(target=run, args=item) for item in bn.items()),
        threading.Thread(target=run, args=("tiffio", tiff.load_library)),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for value in results.values():
        if isinstance(value, BaseException):
            raise value
    for name in ("conv_fused", "rotate", *bn):
        path, report = results[name]
        log(f"built {os.path.relpath(path, REPO)}")
        if not report:
            log("  (already built: no ptxas report)")
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "C75", "Function properties")):
                log(f"  ptxas: {line.strip()}")
        check_no_spills(report)


def check_no_spills(report: str) -> None:
    """Raise if ptxas reports spills, or serialized wgmmas, in a bf16 conv
    kernel or any BatchNorm-ReLU kernel (``Function properties for <name>``
    is followed by its ``bytes spill stores`` line)."""
    kernel = None
    for line in report.splitlines():
        if "Function properties for" in line:
            kernel = line.split("for", 1)[1].strip()
        elif "spill stores" in line and kernel and ("conv_bf16" in kernel or "bnrelu" in kernel):
            stores, loads = (int(line.split(" bytes spill stores")[0].split(",")[-1]),
                             int(line.split(" bytes spill loads")[0].split(",")[-1]))
            if stores or loads:
                raise AssertionError(f"ptxas spills in {kernel}: {line.strip()}")
        if "C7512" in line or "C7515" in line or "C7508" in line:
            raise AssertionError(f"ptxas: {line.strip()}")


def check_bn_relu_launches(phase: str, counts: dict, on_card: bool, trains: bool) -> None:
    """The train-mode BatchNorm-ReLU kernels' launches on a phase's main
    paths (``counts``: path -> launches): some on the card where the phase
    trains, none on the CPU (the plain version) or where it only
    evaluates (eval mode bypasses them)."""
    if (sum(counts.values()) > 0) != (on_card and trains):
        raise AssertionError(f"{phase}: {batchnorm.KERNEL} launches {counts}")


# -- 3./4. the kernel -------------------------------------------------------


def kernel_inputs(gen, b, h, w, c1, c2, dtype, b_positive=False):
    dev = "cuda"
    y = torch.randn(b, c1, h, w, generator=gen, device=dev).to(dtype)
    y = y.contiguous(memory_format=torch.channels_last)
    a = torch.rand(c1, generator=gen, device=dev) + 0.5
    bias = torch.randn(c1, generator=gen, device=dev) * 0.5
    if b_positive:
        bias = bias.abs() + 0.5
    wt = torch.randn(c2, c1, 3, 3, generator=gen, device=dev) / math.sqrt(9 * c1)
    return y, a, bias, wt


def kernel_parity() -> dict:
    """Max errors of the kernel against the plain version, per dtype."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(name, 2, h, h, c1, c2, False) for name, h, c1, c2 in LEVELS]
    cases += [
        ("odd 37x75", 2, 37, 75, 256, 256, False),
        ("tails 13x11 5->7", 2, 13, 11, 5, 7, False),
        ("tails 9x21 40->72", 1, 9, 21, 40, 72, False),
        ("b>0 down4", 2, 32, 32, 512, 512, True),
        ("b>0 inc", 2, 64, 64, 64, 64, True),
        # Edges of the bf16 kernel's tiles (tile_config: 32x16, 16x16 or
        # 8x16 pixels by 64, 128 or 256 channels, K chunks of 64): H and W
        # off the tile, C2 off the N tile, C1 off the K chunk, an image
        # smaller than a tile, and C1 % 8 != 0 (the scalar halo load).
        ("hw tail 40x40 64->64", 2, 40, 40, 64, 64, True),
        ("c2 tail 16x24 128->96", 2, 16, 24, 128, 96, False),
        ("c2 tail 19x23 64->200", 1, 19, 23, 64, 200, True),
        ("c1 tail 16x20 96->128", 2, 16, 20, 96, 128, True),
        ("tiny 5x3 96->40", 1, 5, 3, 96, 40, True),
        ("scalar 10x9 12->300", 1, 10, 9, 12, 300, True),
    ]
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    for name, bsz, h, w, c1, c2, bpos in cases:
        for dtype in (torch.float32, torch.bfloat16):
            y, a, b, wt = kernel_inputs(gen, bsz, h, w, c1, c2, dtype, bpos)
            got = conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt)
            ref = conv_fused.relu_affine_conv3x3_plain(y, a, b, wt)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError(f"{name}: {got.shape} {got.dtype} vs {ref.shape}")
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            rel = err / max(scale, 1e-30)
            ok = math.isfinite(err) and rel <= TOL[dtype]
            log(f"  parity {name:18s} {str(dtype)[6:]:8s} max_abs_err={err:.3e} "
                f"max|ref|={scale:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with plain version: {name} {dtype}")
            worst[dtype] = max(worst[dtype], (rel, err))
    return worst


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_timing(card: str) -> list[dict]:
    """Per level at batch 16, bf16: kernel (on operands packed once, as the
    model does), plain chain, library conv; the kernel's output is held to
    the plain chain's on the same inputs."""
    peak_flops, peak_bytes = peaks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for name, h, c1, c2 in LEVELS:
        y, a, b, wt = kernel_inputs(gen, BATCH, h, h, c1, c2, torch.bfloat16)
        dt = y.dtype
        packed = conv_fused.pack(a, b, wt, dt)
        got = conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt, packed).float()
        ref = conv_fused.relu_affine_conv3x3_plain(y, a, b, wt).float()
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        del got, ref
        if not (math.isfinite(err) and rel <= TOL[dt]):
            raise AssertionError(f"kernel disagrees with plain version at batch "
                                 f"{BATCH}: {name} rel={rel:.3e}")
        z = F.relu(y * a.to(dt).view(1, -1, 1, 1) + b.to(dt).view(1, -1, 1, 1))
        wd = wt.to(dt)
        iters = 10
        ms = cuda_ms(lambda: conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt, packed), iters)
        plain_ms = cuda_ms(lambda: conv_fused.relu_affine_conv3x3_plain(y, a, b, wt), iters)
        library_ms = cuda_ms(lambda: F.conv2d(z, wd, padding=1), iters)
        flop = 2.0 * BATCH * h * h * 9 * c1 * c2
        nbytes = 2.0 * (BATCH * h * h * (c1 + c2) + 9 * c1 * c2 + 2 * c1)
        t_ops, t_bytes = flop / peak_flops * 1e3, nbytes / peak_bytes * 1e3
        row = dict(level=name, H=h, W=h, C1=c1, C2=c2, B=BATCH, gflop=flop / 1e9,
                   mbytes=nbytes / 1e6, max_abs_err=err, rel_err=rel, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   tile=list(conv_fused.tile_config(c2)))
        row["bound_frac"] = row["bound_ms"] / ms
        row["tflops"] = flop / ms / 1e9
        rows.append(row)
        log(f"  time {name:6s} {h}^2 {c1}->{c2} b{BATCH}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, cuDNN conv {library_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_frac']:.1%} of it), "
            f"{row['tflops']:.1f} TFLOP/s, tile {row['tile']}; vs plain "
            f"max_abs_err={err:.3e} rel={rel:.3e} [{card}]")
        del y, z, wd, packed
    slower = [r["level"] for r in rows if not r["ms"] < r["plain_ms"]]
    if slower:
        raise AssertionError(f"the kernel is not faster than the plain chain at {slower}")
    return rows


# -- 4b. train-mode BatchNorm + ReLU kernels ---------------------------------


def bn_relu_shapes(model: str, in_channels: dict, tile: int, batch: int,
                   base: int = 64) -> list[tuple]:
    """[N, C, H, W] of every train-mode BatchNormReLU input of the UNet, in
    call order, from one train forward on the meta device (which runs the
    plain version)."""
    from floodplanet_code_tpu_torch.models.unet import BatchNormReLU

    shapes = []
    net = build_model(model, in_channels, 3, dtype=torch.bfloat16, device="cpu",
                      base_feat_channels=base).to("meta").train()
    for m in net.modules():
        if isinstance(m, BatchNormReLU):
            m.register_forward_pre_hook(lambda mod, args: shapes.append(tuple(args[0].shape)))
    x = torch.empty(batch, sum(in_channels.values()), tile, tile, dtype=torch.bfloat16,
                    device="meta")
    net({"image": x, "ms_image": x})
    return shapes


def bn_relu_cases() -> list[tuple]:
    """(name, [N, C, H, W]) of the parity cases: each distinct BatchNorm
    shape of both benchmark configurations, then ragged tails."""
    cases = []
    for cfg, (model, channels, tile) in BN_CONFIGS.items():
        for shape in dict.fromkeys(bn_relu_shapes(model, channels, tile, BN_BATCH)):
            cases.append((f"{cfg} {shape[1]}x{shape[2]}^2", shape))
    return cases + BN_TAILS


def bn_inputs(gen, shape, dtype, device):
    """x with per-channel means in [-2, 2) and spreads in [0.5, 2), scale,
    bias (in the statistics' type) and dz, channels_last."""
    n, c, h, w = shape
    acc = torch.promote_types(dtype, torch.float32)

    def rand(*size):
        return torch.rand(*size, generator=gen, device=device, dtype=acc)

    def randn(*size):
        return torch.randn(*size, generator=gen, device=device, dtype=acc)

    mu, sd = rand(c) * 4 - 2, rand(c) * 1.5 + 0.5
    cl = torch.channels_last
    x = (randn(n, c, h, w) * sd.view(1, -1, 1, 1) + mu.view(1, -1, 1, 1)).to(dtype)
    dz = randn(n, c, h, w).to(dtype).contiguous(memory_format=cl)
    return x.contiguous(memory_format=cl), rand(c) + 0.5, randn(c) * 0.5, dz


def bn_plain(x, scale, bias, dz):
    """The plain version on x's device: (z, mean, var, m2, inv, a, b, dx,
    dscale, dbias, sum_dz, sum_dz_xhat); the same statistics and sums taken
    in f64 over the same terms (``exact_*``: the value any order of
    summation approximates); and the magnitudes that bound a reordered
    sum's error: mean|x|, E[x^2], sum|dzm|, sum|dzm*xhat|."""
    xr = x.detach().clone().requires_grad_(True)
    sr, br = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    z, mean, var = batchnorm._BNReLUTrain.apply(xr, sr, br, BN_EPS, None)
    dx, dscale, dbias = torch.autograd.grad(z, (xr, sr, br), dz)
    xf = batchnorm._acc(x)
    m2 = (xf * xf).mean(dim=batchnorm._AXES)
    inv = torch.rsqrt(var + BN_EPS)
    a, b = (t.view(-1) for t in batchnorm._affine(x, scale, bias, mean, inv))
    dzm = batchnorm._acc(torch.where(x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1) > 0, dz, 0))
    xhat = (xf - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
    axes = batchnorm._AXES
    exact_mean, exact_m2 = xf.double().mean(dim=axes), (xf * xf).double().mean(dim=axes)
    return dict(z=z.detach(), mean=mean, var=var, m2=m2, inv=inv, a=a, b=b, dx=dx,
                dscale=dscale, dbias=dbias, sum_dz=dzm.sum(dim=axes),
                sum_dz_xhat=(dzm * xhat).sum(dim=axes), exact_mean=exact_mean,
                exact_var=torch.clamp_min(exact_m2 - exact_mean * exact_mean, 0.0),
                mag_mean=xf.abs().mean(dim=axes), mag_var=m2,
                **bn_exact_sums(x, dz, a, b, mean, inv))


def bn_exact_sums(x, dz, a, b, mean, inv) -> dict:
    """The backward's two sums over the terms of the forward state (a, b,
    mean, inv) in f64, and their sums of magnitudes: the ReLU mask is that
    state's, so a kernel's sums are held to sums over the same mask."""
    channel = (lambda t: t.view(1, -1, 1, 1))
    dzm = batchnorm._acc(torch.where(x * channel(a) + channel(b) > 0, dz, 0))
    terms = dzm * (batchnorm._acc(x) - channel(mean)) * channel(inv)
    axes = batchnorm._AXES
    return dict(exact_sum_dz=dzm.double().sum(dim=axes),
                exact_sum_dz_xhat=terms.double().sum(dim=axes),
                mag_sum_dz=dzm.abs().sum(dim=axes), mag_sum_dz_xhat=terms.abs().sum(dim=axes))


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def bn_relu_parity(device="cuda") -> dict:
    """The kernels against the plain version at every case and dtype: the
    statistics and the backward's sums within ``BN_STAT_TOL`` of their sum
    of magnitudes from the f64 sums of the same terms (only the order of
    summation differs; the backward's terms under the kernel forward's own
    ReLU mask, since a last-bit change of f32 a, b moves the mask of an
    element within rounding of zero; the plain version's own reading is
    logged as ``plain``); z and dx within ``BN_TOL`` of max|plain| (dx
    from the plain backward of the kernel's own forward: one mask); z, var,
    inv, a, b and dx the same bits when the apply stages get the plain
    version's statistics and sums; two launches the same bits; and a
    one-rank group (no collective) through stage 1 and 2. On the CPU (the
    rehearsal) the plain version stands in for the kernels. Returns the
    worst readings per dtype."""
    on_card = device != "cpu"
    gen = torch.Generator(device=device).manual_seed(7)
    worst: dict = {}
    for name, shape in bn_relu_cases():
        for dtype in BN_TOL:
            x, scale, bias, dz = bn_inputs(gen, shape, dtype, device)
            p = bn_plain(x, scale, bias, dz)
            if on_card:
                z, mean, var, inv, a, b = batchnorm.forward_cuda(x, scale, bias, BN_EPS)
                dx, sum_dz, sum_dz_xhat = batchnorm.backward_cuda(x, dz, a, b, mean, inv, scale)
                again = batchnorm.forward_cuda(x, scale, bias, BN_EPS)
                dx2, _, _ = batchnorm.backward_cuda(x, dz, a, b, mean, inv, scale)
                zs, _, vs, ivs, as_, bs = batchnorm.forward_apply_cuda(
                    x, scale, bias, BN_EPS, p["mean"], p["m2"])
                dxs, _ = batchnorm.backward_apply_cuda(
                    x, dz, p["a"], p["b"], p["mean"], p["inv"], scale,
                    torch.stack([p["sum_dz"], p["sum_dz_xhat"]]))
                group = batchnorm.forward_cuda(x, scale, bias, BN_EPS, group="one rank")
                dxg, _, _ = batchnorm.backward_cuda(x, dz, a, b, mean, inv, scale, "one rank")
            else:
                z, mean, var = (p[k] for k in ("z", "mean", "var"))
                inv, a, b, dx = p["inv"], p["a"], p["b"], p["dx"]
                sum_dz, sum_dz_xhat = p["sum_dz"], p["sum_dz_xhat"]
                again, dx2 = (z, mean, var, inv, a, b), dx
                zs, vs, ivs, as_, bs, dxs = z, var, inv, a, b, dx
                group, dxg = again, dx
            if on_card:
                torch.cuda.synchronize()
            # dx of the plain backward from the kernel's forward: one mask.
            dx_same = bn_plain_backward(x, dz, scale, bias, mean, inv)
            stat_tol, tol = BN_STAT_TOL[dtype], BN_TOL[dtype]
            got = {"mean": mean, "var": var, "sum_dz": sum_dz, "sum_dz_xhat": sum_dz_xhat}
            ref = dict(p, **bn_exact_sums(x, dz, a, b, mean, inv))  # the kernel's own mask
            stats = {k: _rel_to(v, ref["exact_" + k], ref["mag_" + k]) for k, v in got.items()}
            stats["group_mean"] = _rel_to(group[1], p["exact_mean"], p["mag_mean"])
            stats["group_var"] = _rel_to(group[2], p["exact_var"], p["mag_var"])
            plain = max(_rel_to(p[k], p["exact_" + k], p["mag_" + k]) for k in got)
            ends = {"z": _rel_to(z, p["z"]), "dx": _rel_to(dx, dx_same),
                    "group_z": _rel_to(group[0], p["z"]), "group_dx": _rel_to(dxg, dx_same)}
            bits = {"z": _bits(zs, p["z"]), "var": _bits(vs, p["var"]),
                    "inv": _bits(ivs, p["inv"]), "a": _bits(as_, p["a"]), "b": _bits(bs, p["b"]),
                    "dx": _bits(dxs, p["dx"]),
                    "repeat_z": _bits(again[0], z), "repeat_dx": _bits(dx2, dx)}
            ok = (all(v <= stat_tol for v in stats.values()) and all(v <= tol for v in ends.values())
                  and all(bits.values()))
            log(f"  bn_relu {name:18s} {str(dtype)[6:]:8s} stats "
                f"{max(stats.values()):.2e} (plain {plain:.2e}) ends {max(ends.values()):.2e} "
                f"bits {'all' if all(bits.values()) else [k for k, v in bits.items() if not v]} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"bn_relu kernels disagree with the plain version: {name} "
                                     f"{dtype}: stats {stats}, ends {ends}, bits {bits}")
            w = worst.setdefault(str(dtype)[6:], {"stats": 0.0, "plain_stats": 0.0, "ends": 0.0})
            w["stats"] = max(w["stats"], *stats.values())
            w["plain_stats"] = max(w["plain_stats"], plain)
            w["ends"] = max(w["ends"], *ends.values())
            del x, dz, p
    return worst


def bn_plain_backward(x, dz, scale, bias, mean, inv):
    """The plain version's backward (``_BNReLUTrain.backward``'s lines, no
    group) from the given statistics: dx in x's dtype."""
    a, b = batchnorm._affine(x, scale, bias, mean, inv)
    dzm = batchnorm._acc(torch.where(x * a + b > 0, dz, 0))
    xhat = (batchnorm._acc(x) - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    sum_dz, sum_dz_xhat = dzm.sum(dim=batchnorm._AXES), (dzm * xhat).sum(dim=batchnorm._AXES)
    g = (scale * inv).view(1, -1, 1, 1)
    dx = g * (dzm - (sum_dz / n).view(1, -1, 1, 1) - xhat * (sum_dz_xhat / n).view(1, -1, 1, 1))
    return dx.to(x.dtype)


def _rel_to(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor | None = None) -> float:
    """max|got - want| over max|scale| (default: max|want|)."""
    err = (got.double() - want.double()).abs().max().item()
    ref = (want if scale is None else scale).double().abs().max().item()
    return err / max(ref, 1e-300) if math.isfinite(err) else math.inf


def bn_relu_timing(card: str) -> dict:
    """Per configuration, one train step's 18 BatchNorm-ReLU calls at
    batch 10 in bf16, forward and backward through autograd: the kernels,
    the plain version, and ``F.batch_norm(training=True)`` + ``F.relu`` (the
    library yardstick, which the port never calls). ``ms``, ``plain_ms``,
    ``library_ms``: device time of every kernel the step's calls launch
    (torch.profiler; the kernels' trace must hold all their launches);
    ``wrapper_ms``: the kernels' step on CUDA events, the host's pace
    included; beside the least time, 10 bytes an element (x in, z out; x
    and dz in, dx out) at the card's bandwidth; ``shapes``: the kernels'
    time per call at each distinct shape, on CUDA events. Run it in a
    process of its own (``bn_relu_timing_apart``)."""
    peak_bytes = peaks(torch.cuda.get_device_name(0))[1]
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for cfg, (model, channels, tile) in BN_CONFIGS.items():
        counts = collections.Counter(bn_relu_shapes(model, channels, tile, BN_BATCH))
        inputs = []
        for shape in counts:
            x, scale, bias, dz = bn_inputs(gen, shape, torch.bfloat16, "cuda")
            inputs.append((x.requires_grad_(True), scale.requires_grad_(True),
                           bias.requires_grad_(True), dz))

        def call(fn, x, scale, bias, dz):
            torch.autograd.grad(fn(x, scale, bias), (x, scale, bias), dz)

        variants = {
            "ms": lambda x, s, b: batchnorm._BNReLUTrainCUDA.apply(x, s, b, BN_EPS, None)[0],
            "plain_ms": lambda x, s, b: batchnorm._BNReLUTrain.apply(x, s, b, BN_EPS, None)[0],
            "library_ms": lambda x, s, b: F.relu(F.batch_norm(x, None, None, s, b, True, 0.1,
                                                              BN_EPS)),
        }
        row = {"shapes": {}}
        for key, fn in variants.items():
            def step(fn=fn):
                for args, count in zip(inputs, counts.values()):
                    for _ in range(count):
                        call(fn, *args)

            traced = trace_kernels(step)
            row[key] = sum(t for _, t, _ in traced)
            if key == "ms":
                launches = sum(n for k, _, n in traced if "bnrelu" in k)
                if launches != 6 * sum(counts.values()):
                    raise AssertionError(f"the trace holds {launches} of the step's "
                                         f"{6 * sum(counts.values())} kernel launches")
                row["wrapper_ms"] = cuda_ms(step, 5)
                for args, shape in zip(inputs, counts):
                    row["shapes"][str(shape)] = cuda_ms(lambda: call(fn, *args), 10)
        elements = sum(math.prod(shape) * n for shape, n in counts.items())
        row["bound_ms"] = 10.0 * elements / peak_bytes * 1e3
        row["bound_frac"] = row["bound_ms"] / row["ms"]
        row["elements"] = elements
        out[cfg] = row
        log(f"  bn_relu time {cfg} step (18 calls, fwd+bwd, bf16): kernels {row['ms']:.3f} ms "
            f"device ({row['wrapper_ms']:.3f} ms on events), plain {row['plain_ms']:.3f} ms, "
            f"F.batch_norm+relu {row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
            f"({row['bound_frac']:.1%}); per shape {row['shapes']} [{card}]")
        del inputs
    return out


def bn_relu_timing_apart(card: str) -> dict:
    """``bn_relu_timing`` in a process of its own, whose profiler sessions
    are then its first: a session late in a process drops kernel events
    (it read half the calls' time), and one early in this process makes
    ``shear_timing``'s later exact launch count fail. Its lines are
    logged here."""
    torch.cuda.empty_cache()
    code = ("import json, chip_smoke as c; "
            "print('BN_ROWS', json.dumps(c.bn_relu_timing(c.card_line())), flush=True)")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    rows = None
    for line in run.stdout.splitlines():
        if line.startswith("BN_ROWS "):
            rows = json.loads(line[len("BN_ROWS "):])
        else:
            log(line)
    if run.returncode != 0 or rows is None:
        raise AssertionError(f"bn_relu_timing exited {run.returncode}:\n{run.stderr[-4000:]}")
    return rows


# -- 5. the slice ------------------------------------------------------------


def write_scenes(root: str, scenes=None, seed: int = 0, geo_from: str | None = None,
                 region: str = "RegionA") -> None:
    """Synthetic CSDAP-layout PlanetScope scenes (uint16, 4 bands, stored
    HWC) with labels in ``region``, written by the port's TIFF writer (with
    the geo tags of ``geo_from`` when given)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "CSDAP_complete", region)
    os.makedirs(os.path.join(base, "labels"), exist_ok=True)
    os.makedirs(os.path.join(base, "PS"), exist_ok=True)
    for i, (h, w) in enumerate(SCENES if scenes is None else scenes):
        label = rng.choice([0, 1, 2], size=(h, w), p=[0.1, 0.6, 0.3]).astype(np.uint8)
        img = rng.integers(0, 8000, size=(h, w, 4), dtype=np.uint16)
        img[..., 0] = np.where(label == 2, 7200, 800)
        tiff.imwrite(os.path.join(base, "labels", f"scene_{i}.tif"), label)
        tiff.imwrite(os.path.join(base, "PS", f"scene_{i}.tif"), img, planar_as_chw=False,
                     geo_from=geo_from)


def slice_config(conv_impl: str) -> Config:
    return Config({
        "crop_height": TILE, "crop_width": TILE, "crop_stride": TILE,
        "batch_size": 8, "n_workers": 8, "norm_mode": None, "eval_region": None,
        "ignore_index": 0, "seed_num": 0, "train_split_pct": 0.8,
        "dataset": {"name": "floodplanet", "sensor": "PS", "channels": "ALL",
                    "dataset_kwargs": {}},
        "model": {"name": "ef_model", "model_kwargs": {"optimizer_name": "adam"}},
        "tpu": {"compute_dtype": "bfloat16", "conv_impl": conv_impl,
                "use_pallas": True, "inference_batch_size": BATCH},
    })


def check_masks(paths: list[str], scenes=None) -> None:
    scenes = SCENES if scenes is None else scenes
    if len(paths) != len(scenes):
        raise AssertionError(f"{len(paths)} masks for {len(scenes)} scenes")
    shapes = sorted(scenes)
    got = []
    for path in paths:
        mask = tiff.imread(path)
        if mask.dtype != np.uint8 or not set(np.unique(mask)) <= {0, 255}:
            raise AssertionError(f"{path}: not a {{0, 255}} uint8 mask")
        got.append(mask.shape)
    if sorted(got) != shapes:
        raise AssertionError(f"mask shapes {got} != scenes {shapes}")


def forward_ms(model) -> float:
    """CUDA-event time of one predict step on a random batch on the card."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(BATCH, TILE, TILE, 4, generator=gen, device="cuda")
    step = make_predict_step(model)
    return cuda_ms(lambda: step({"image": x.permute(0, 3, 1, 2)}), iters=5)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def small_input_reference(device="cuda") -> float:
    """Fused f32 model on the card vs the same model on the CPU (plain
    version) on a small input: max |logit difference|."""
    sd = state_dict_from_flax(seeded_flax_variables(4, 3, 64, seed=3))
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 4, 64, 96)).astype(np.float32))
    out = []
    for dev in (device, "cpu"):
        model = build_model("ef_model", {"ms_image": 4}, 3, dtype=torch.float32,
                            device=dev, conv_impl="pallas_fused")
        model.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            out.append(model({"image": x.to(dev)}).cpu())
    return (out[0] - out[1]).abs().max().item()


def run_slice(card: str, device="cuda") -> dict:
    """Phase 5. ``device`` is the card; ``"cpu"`` rehearses the control
    flow (tests/test_torch_chip_smoke.py, at a small size): no kernel
    launches and no device timing then."""
    data_root = os.path.join(WORK, "data")
    exp = os.path.join(WORK, "exp")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(os.path.join(exp, "weights"))
    with Phase("slice: write scenes"):
        write_scenes(data_root)

    err_small = small_input_reference(device)
    log(f"  small input, fused f32 card vs CPU: max |dlogit| = {err_small:.3e}")
    if not err_small <= 1e-3:
        raise AssertionError("card and CPU disagree on the small input")

    cfg = slice_config("pallas_fused")
    weights = os.path.join(exp, "weights", "model.pt")
    save_weights(state_dict_from_flax(seeded_flax_variables(4, 3, 64, seed=0)), weights)
    ds = build_infer_dataset(cfg, "floodplanet", "all", root_dir=data_root)
    ds_overlap = build_dataset(
        "floodplanet", "all", generate_image_slice_object(TILE, TILE, stride=TILE // 2),
        sensor="PS", channels="ALL", root_dir=data_root, output_metadata=True,
        ignore_index=0,
    )
    model = load_model_for_eval(cfg, weights, ds, device)  # warm, on the card
    batches = -(-len(ds) // BATCH)
    batches_overlap = -(-len(ds_overlap) // BATCH)
    forwards = 4 * batches + 8 * batches + batches_overlap
    log(f"  {len(ds)} tiles per request ({batches} batches of {BATCH}), "
        f"{len(ds_overlap)} tiles in the overlapping pass")
    # The requests read their scenes through the HBM scene cache (the
    # config's tpu.device_data_bytes); the "(host)" ones through the host
    # loader. Request 1 of each warms its path; the two request 2s are the
    # ones compared.
    cfg_host = slice_config("pallas_fused")
    cfg_host.tpu.device_data_bytes = 0

    sync(device)
    LAUNCHES.clear()  # the main path starts here
    times = {}
    for name, c, tta in (("request 1", cfg, False), ("request 1 (host)", cfg_host, False),
                         ("request 2", cfg, False), ("request 2 (host)", cfg_host, False),
                         ("request 3 (tta)", cfg, True)):
        with Phase(f"slice: {name}"):
            t0 = time.perf_counter()
            paths = infer(c, None, "floodplanet", "all",
                          os.path.join(exp, "masks", name.replace(" ", "_")),
                          tta=tta, warm=model, dataset=ds, device=device)
            sync(device)
            times[name] = time.perf_counter() - t0
            check_masks(paths)
    with Phase("slice: overlapping pass (fused)"):
        t0 = time.perf_counter()
        fused = {s["image_name"]: s["probabilities"]
                 for s in sliding_window_predict(model, ds_overlap, BATCH, n_workers=8,
                                                 device=device)}
        sync(device)
        times["overlap fused"] = time.perf_counter() - t0
    launches = LAUNCHES[conv_fused.KERNEL]  # the main path ends here
    bn_launches = LAUNCHES[batchnorm.KERNEL]
    log(f"  launches of {conv_fused.KERNEL}: {launches} for {forwards} forwards; of "
        f"{batchnorm.KERNEL}: {bn_launches}")
    # 9 per forward on the card; a CPU tensor runs the plain version.
    expected = 9 * forwards if torch.device(device).type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"expected {expected} kernel launches, got {launches}")
    check_bn_relu_launches("serving", {"requests": bn_launches},
                           torch.device(device).type == "cuda", False)

    for name, probs in fused.items():
        if not np.isfinite(probs).all():
            raise AssertionError(f"{name}: non-finite probabilities")
        dev = np.abs(probs.sum(-1) - 1).max()
        if dev > 1e-3:
            raise AssertionError(f"{name}: probabilities sum off by {dev}")

    model_xla = build_model("ef_model", ds.n_channels, ds.n_classes,
                            dtype=torch.bfloat16, device=device, conv_impl="xla")
    model_xla.load_state_dict(model.state_dict(), strict=True)
    with Phase("slice: overlapping pass (xla = unfused cuDNN)"):
        t0 = time.perf_counter()
        unfused = {s["image_name"]: s["probabilities"]
                   for s in sliding_window_predict(model_xla, ds_overlap, BATCH, n_workers=8,
                                                   device=device)}
        sync(device)
        times["overlap xla"] = time.perf_counter() - t0
    agree = np.mean(np.concatenate([
        (fused[k].argmax(-1) == unfused[k].argmax(-1)).ravel() for k in fused
    ]))
    dprob = max(np.abs(fused[k] - unfused[k]).max() for k in fused)
    shares = np.bincount(np.concatenate([fused[k].argmax(-1).ravel() for k in fused]),
                         minlength=3) / sum(p.shape[0] * p.shape[1] for p in fused.values())
    log(f"  fused vs unfused: argmax agreement {agree:.6f}, max |dp| {dprob:.3e}, "
        f"fused class shares {np.round(shares, 4).tolist()}")
    # The seeded weights predict one class almost everywhere, so the argmax
    # check alone would pass whatever the kernel computed: the probabilities
    # themselves are held to DPROB_TOL too. A probability moves by at most
    # a quarter of its logit's change, so 5e-3 allows logit differences of
    # 2e-2, several bf16 rounding steps at |logit| ~ 1, and no more.
    if agree < 0.999:
        raise AssertionError(f"fused and unfused paths agree on only {agree:.4%}")
    if not dprob <= DPROB_TOL:
        raise AssertionError(f"fused and unfused probabilities differ by {dprob:.3e}")

    forward = {}
    if torch.device(device).type == "cuda":
        # The bare forward (+softmax) of one batch, without loading or
        # stitching, and the share of request 2's wall time it accounts for.
        for name, m in (("fused", model), ("xla", model_xla)):
            fwd = forward[name] = forward_ms(m)
            log(f"  forward {name}: {fwd:.3f} ms per batch of {BATCH} "
                f"({BATCH / fwd * 1e3:.1f} tiles/s) [{card}]")
        for name in ("request 2", "request 2 (host)"):
            busy = batches * forward["fused"] / 1e3 / times[name]
            log(f"  {name} at the fused rate keeps the device busy {busy:.1%} of its "
                f"wall time [{card}]")

    rates = {
        "request 1": len(ds) / times["request 1"],
        "request 1 (host)": len(ds) / times["request 1 (host)"],
        "request 2": len(ds) / times["request 2"],
        "request 2 (host)": len(ds) / times["request 2 (host)"],
        "request 3 (tta)": len(ds) / times["request 3 (tta)"],
        "overlap fused": len(ds_overlap) / times["overlap fused"],
        "overlap xla": len(ds_overlap) / times["overlap xla"],
    }
    for name, rate in rates.items():
        log(f"  tiles/s {name}: {rate:.1f} (host clock, loading and stitching "
            f"included) [{card}]")
    shutil.rmtree(WORK, ignore_errors=True)
    return {"launches": launches, "bn_relu_launches": bn_launches,
            "agree": float(agree), "max_dprob": float(dprob),
            "class_shares": shares.tolist(), "tiles_per_s": rates,
            "forward_ms": forward, "tiles": {"request": len(ds),
                                             "overlap": len(ds_overlap)}}


# -- 6./7. the shear kernel --------------------------------------------------


def shear_input(gen, b, hw, dtype, device):
    """[image (4 bands) | label | validity], as augment_batch builds it."""
    img = torch.rand(b, hw, hw, 4, generator=gen, device=device)
    lbl = torch.randint(0, 3, (b, hw, hw, 1), generator=gen, device=device).float()
    return torch.cat([img, lbl, torch.ones_like(lbl)], dim=-1).to(dtype)


def shear_shifts(angle_deg: float, b: int, n: int, axis: int, device) -> torch.Tensor:
    """rotate_flip_batch's per-line shifts for one residual angle: a =
    -tan(theta/2) for the shears along W (axis 2), b = sin(theta) along H."""
    theta = torch.full((b,), angle_deg, dtype=torch.float32, device=device) * (math.pi / 180.0)
    coef = -torch.tan(theta / 2.0) if axis == 2 else torch.sin(theta)
    return rotate._row_shifts(coef, n)


def edge_shifts(b: int, n: int, device) -> dict:
    """Per-line shifts [b, n] at the quantization's edges, for n lines: exact
    integers; fractions whose fq = frac * 65536 lands on a .5 tie (src =
    shift + pad stays exact in f32 while |src| < 128); and shifts beyond
    +-(pad-1), where the clip binds."""
    pad = rotate._pad(n)
    line = torch.arange(n, dtype=torch.float32, device=device)
    row = torch.arange(b, dtype=torch.float32, device=device)[:, None]
    ints = torch.remainder(line + 3 * row, 11) - 5
    ties = ints + (2 * torch.remainder(line * 7 + row, 64) + 1) / 131072.0
    clip = torch.where(torch.remainder(line + row, 2) == 0, 1.0, -1.0) * (pad + 3.25 + line / n)
    return {"integers": ints.expand(b, n).contiguous(), "ties": ties.contiguous(),
            "clip": clip.contiguous()}


def shear_parity(device="cuda") -> dict:
    """The shear (the kernel on a card) against its plain version, bit for
    bit: at the augmentation shape and the 300^2 crop over five residual
    angles, and on the quantization edges (``edge_shifts``) at shapes whose
    W*C is not a multiple of the vector width and with C in {3, 5} (the
    kernel's any-C path); both axes, order 0 and 1, f32 and bf16,
    nearest_from = C - 2. Returns the worst (relative, absolute) error per
    dtype, which must be 0."""
    gen = torch.Generator(device=device).manual_seed(4)
    worst = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}
    cases = 0

    def check(x, shifts, axis, what):
        nonlocal cases
        nf = x.shape[-1] - 2
        for order in (0, 1):
            got = rotate.shear(x, shifts, order, 0.0, nf, axis)
            ref = rotate.shear_plain(x, shifts, order, 0.0, nf, axis)
            sync(device)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"shear kernel differs from its plain version: {what} {tuple(x.shape)} "
                    f"{x.dtype} axis {axis} order {order}: max_abs_err={err:.3e}")
            worst[x.dtype] = max(worst[x.dtype], (err / max(scale, 1e-30), err))
            cases += 1

    for b, hw in SHEAR_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = shear_input(gen, b, hw, dtype, device)
            for angle in SHEAR_ANGLES:
                for axis in (2, 1):
                    check(x, shear_shifts(angle, b, hw, axis, device), axis, f"angle {angle}")
    for b, h, w, c in SHEAR_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand(b, h, w, c, generator=gen, device=device).to(dtype)
            x[..., -2:] = torch.randint(0, 3, (b, h, w, 2), generator=gen, device=device).to(dtype)
            for axis in (2, 1):
                for name, shifts in edge_shifts(b, h if axis == 2 else w, device).items():
                    check(x, shifts, axis, name)
    for dtype, (rel, err) in worst.items():
        log(f"  shear parity {str(dtype)[6:]:8s}: worst max_abs_err={err:.3e} "
            f"rel={rel:.3e} over {cases} cases in both types, bit-identical")
    return worst


def shear_timing(card: str) -> dict:
    """One launch at [8, 512, 512, 6] bf16: the kernel's device time (from
    a trace), the wrapper's time per call with its quantization and host
    work, the plain version and F.grid_sample of the same shear as the
    library yardstick (bilinear on every channel, where the kernel rounds
    the label and validity channels' fraction; CUDA events), beside the
    bytes bound."""
    b, hw = SHEAR_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = shear_input(gen, b, hw, torch.bfloat16, "cuda")
    shifts = shear_shifts(17.0, b, hw, 2, "cuda")
    got = rotate.shear_cuda(x, shifts, 1, 0.0, 4, 2)
    ref = rotate.shear_plain(x, shifts, 1, 0.0, 4, 2)
    err = (got.float() - ref.float()).abs().max().item()
    # grid_sample's grid: (x + shift_y, y) in align_corners=True coordinates.
    ys, xs = torch.meshgrid(torch.arange(hw, device="cuda", dtype=torch.float32),
                            torch.arange(hw, device="cuda", dtype=torch.float32),
                            indexing="ij")
    gx = (xs[None] + shifts[:, :, None]) * (2.0 / (hw - 1)) - 1.0
    gy = (ys * (2.0 / (hw - 1)) - 1.0).expand(b, hw, hw)
    grid = torch.stack([gx, gy], dim=-1).to(x.dtype)
    x_nchw = x.permute(0, 3, 1, 2)
    iters = 50
    wrapper_ms = cuda_ms(lambda: rotate.shear_cuda(x, shifts, 1, 0.0, 4, 2), iters)
    # The kernel's device time from a trace of ``iters`` wrapper calls, which
    # must hold exactly one launch per call and nothing else: the wrapper
    # quantizes nothing itself.
    traced = trace_kernels(lambda: [rotate.shear_cuda(x, shifts, 1, 0.0, 4, 2)
                                    for _ in range(iters)])
    hits = [(t, n) for key, t, n in traced if "shear_kernel" in key]
    others = [key for key, _, _ in traced if "shear_kernel" not in key]
    launches = sum(n for _, n in hits)
    if others or launches != iters:
        raise AssertionError(f"{iters} shear calls launched {launches} shear kernels and "
                             f"{others}: want exactly one launch per call")
    ms = sum(t for t, _ in hits) / launches
    # The shear along H (the augmentation's middle shear): device time per
    # traced launch (a later trace session may drop a few kernel events, so
    # the count is not checked here).
    shifts_h = shear_shifts(17.0, b, hw, 1, "cuda")
    traced_h = [(t, n) for key, t, n in trace_kernels(
        lambda: [rotate.shear_cuda(x, shifts_h, 1, 0.0, 4, 1) for _ in range(iters)])
        if "shear" in key]
    axis1_ms = sum(t for t, _ in traced_h) / sum(n for _, n in traced_h)
    plain_ms = cuda_ms(lambda: rotate.shear_plain(x, shifts, 1, 0.0, 4, 2), iters)
    library_ms = cuda_ms(lambda: F.grid_sample(x_nchw, grid, mode="bilinear",
                                               padding_mode="zeros", align_corners=True),
                         iters)
    name = torch.cuda.get_device_name(0)
    nbytes = 2.0 * x.numel() * x.element_size() + 2 * shifts.numel() * 4
    ops = 6.0 * x.numel()  # two products, a difference and a sum, the tap tests
    t_bytes = nbytes / peaks(name)[1] * 1e3
    t_ops = ops / next(v for k, v in F32_PEAK.items() if k in name) * 1e3
    row = dict(shape=[b, hw, hw, 6], dtype="bfloat16", max_abs_err=err, ms=ms,
               wrapper_ms=wrapper_ms, axis1_ms=axis1_ms, launches_per_call=launches / iters,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               mbytes=nbytes / 1e6)
    log(f"  shear [{b},{hw},{hw},6] bf16 per launch: kernel {ms:.4f} ms (trace; "
        f"{nbytes / ms / 1e6:.0f} GB/s, {row['bound_ms'] / ms:.1%} of the bound), wrapper "
        f"{wrapper_ms:.4f} ms per call (events), plain {plain_ms:.4f} ms, grid_sample "
        f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{nbytes / 1e6:.1f} MB); one launch per call; along H {axis1_ms:.4f} ms per launch "
        f"(trace); vs plain max_abs_err={err:.3e} [{card}]")
    if not ms <= library_ms:
        raise AssertionError(f"the shear kernel ({ms:.4f} ms) is slower than grid_sample "
                             f"({library_ms:.4f} ms)")
    return row


@contextlib.contextmanager
def plain_shear():
    """Within the block, ``impl="pallas"`` runs ``shear_plain`` on a card
    too (the plain augmentation the kernel is held to and timed against)."""
    saved = rotate.shear
    rotate.shear = rotate.shear_plain
    try:
        yield
    finally:
        rotate.shear = saved


# -- 8. training -------------------------------------------------------------


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def grad_rels(ga: dict, gb: dict) -> dict:
    """Per tensor: (max |ga-gb| / max|gb|, ||ga-gb|| / ||gb||)."""
    return {n: ((ga[n] - gb[n]).abs().max().item() / max(gb[n].abs().max().item(), 1e-30),
                ((ga[n] - gb[n]).norm() / gb[n].norm().clamp_min(1e-30)).item())
            for n in gb}


def f32_step_check(card: str, eval_batch: dict, device) -> dict:
    """One f32 train step at batch F32_BATCH from the same weights and the
    same draws: the fused model with the kernel shear against the unfused
    (cuDNN) model with the plain shear. TF32 is off (main). An f64 step of
    the unfused model (f64 activations and BatchNorm; the loss on f32
    logits, as in every dtype) is the truth both f32 steps are held to:
    gaps of rounding put both at about one distance from it, a fault in the
    fused forward or backward puts the fused step farther away."""
    sd = state_dict_from_flax(seeded_flax_variables(4, 3, BASE, seed=1))
    tp = TransformParams(rotate_likelihood=1.0, rotate_impl="shear_pallas")
    batch = {k: v[:F32_BATCH] for k, v in eval_batch.items()}
    gen = torch.Generator(device=device).manual_seed(6)
    draws = draw_augmentation(gen, F32_BATCH, tp, device)
    img_k, tgt_k = apply_augmentation(batch["image"], batch["target"], draws, tp, 0)
    with plain_shear():
        img_p, tgt_p = apply_augmentation(batch["image"], batch["target"], draws, tp, 0)
    aug_err = (img_k - img_p).abs().max().item() / max(img_p.abs().max().item(), 1e-30)
    if not (aug_err <= SHEAR_TOL[torch.float32] and torch.equal(tgt_k, tgt_p)):
        raise AssertionError(f"f32 augmentation: kernel vs plain rel={aug_err:.3e}")
    out = {}
    for name, impl, dtype, img, tgt in (
            ("fused", "pallas_fused", torch.float32, img_k, tgt_k),
            ("xla", "xla", torch.float32, img_p, tgt_p),
            ("xla again", "xla", torch.float32, img_p, tgt_p),
            ("f64", "xla", torch.float64, img_p, tgt_p)):
        model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE,
                            dtype=dtype, device=device, conv_impl=impl)
        state = create_train_state(model, sd, 1e-4)
        step = make_train_step(model, 0, tp, fuse_augmentation=False)
        # Each DoubleConv's output ReLU mask, to count where the two paths'
        # f32 sums put a pre-activation on opposite sides of zero.
        masks = {}
        hooks = [m.register_forward_hook(
            lambda mod, inp, o, n=n: masks.__setitem__(n, (o > 0).detach()))
            for n, m in model.named_modules() if n.endswith("double_conv") or n.endswith("inc")]
        _, logs = step(state, {"image": img, "target": tgt})
        for h in hooks:
            h.remove()
        out[name] = (logs["loss"].item(),
                     {n: p.grad.detach().clone() for n, p in model.named_parameters()},
                     {n: b.detach().clone() for n, b in model.named_buffers()}, masks)
        del model, state, step
    (lf, gf, bf, mf), (lx, gx, bx, mx) = out["fused"], out["xla"]
    l64, g64, _, m64 = out["f64"]
    loss_rel = _rel(lf, lx)
    rels, noise = grad_rels(gf, gx), grad_rels(out["xla again"][1], gx)
    to64 = {"fused": grad_rels(gf, g64), "xla": grad_rels(gx, g64)}

    def short(n):
        return n.split(".")[-2] if n.endswith("double_conv") else "inc"

    flips = {n: int((mf[n] != mx[n]).sum()) for n in mx}
    flips64 = {k: {short(n): int((m[n] != m64[n]).sum()) for n in m64}
               for k, m in (("fused", mf), ("xla", mx))}
    for n in sorted(rels, key=lambda k: rels[k][0], reverse=True)[:4]:
        log(f"    grad {n}: fused vs xla max {rels[n][0]:.2e}·max|g|, norm "
            f"{rels[n][1]:.2e}·||g||; xla rerun max {noise[n][0]:.2e}; vs f64: fused "
            f"{to64['fused'][n][0]:.2e}/{to64['fused'][n][1]:.2e}, xla "
            f"{to64['xla'][n][0]:.2e}/{to64['xla'][n][1]:.2e} (max/norm)")
    log(f"    ReLU mask flips per DoubleConv output (fused vs xla): "
        f"{ {short(n): f for n, f in flips.items()} }; vs f64: fused {flips64['fused']}, "
        f"xla {flips64['xla']}")
    grad_max = max(r[0] for r in rels.values())
    grad_rel = max(r[1] for r in rels.values())
    # Worst distance to the f64 gradients over the tensors, (max, norm) forms.
    worst64 = {k: (max(r[0] for r in v.values()), max(r[1] for r in v.values()))
               for k, v in to64.items()}
    log(f"  f64 witness: worst gradient distance to the f64 step, fused f32 "
        f"{worst64['fused'][0]:.2e}·max|g| / {worst64['fused'][1]:.2e}·||g||, unfused f32 "
        f"{worst64['xla'][0]:.2e}·max|g| / {worst64['xla'][1]:.2e}·||g||; loss f64 "
        f"{l64:.8f}, fused rel {_rel(lf, l64):.2e}, xla rel {_rel(lx, l64):.2e}")
    stat_rel = max((bf[n] - bx[n]).abs().max().item() / max(bx[n].abs().max().item(), 1e-30)
                   for n in bx)
    log(f"  f32 step fused+kernel shear vs xla+plain shear (batch {F32_BATCH}): loss "
        f"{lf:.6f} vs {lx:.6f} (rel {loss_rel:.2e}), worst grad {grad_rel:.2e}·||g|| "
        f"(max-element form {grad_max:.2e}·max|g|), running stats {stat_rel:.2e}·max|ref|, "
        f"augmentation rel {aug_err:.2e}")
    # Gradients are held in norm to GRAD_TOL and element-wise to
    # GRAD_MAX_TOL: where two f32 paths' sums put a pre-activation on
    # opposite sides of zero (the flips above), that element's ReLU passes
    # its gradient in one path and not the other, and the deepest level's
    # BatchNorm averages over only 2048 samples per channel. The f64 step
    # tells rounding from a fault: the fused gradients must lie no farther
    # from it than WITNESS_RATIO times the unfused ones.
    witness_ok = all(worst64["fused"][i] <= WITNESS_RATIO * worst64["xla"][i] for i in (0, 1))
    if not (loss_rel <= 1e-4 and grad_rel <= GRAD_TOL and grad_max <= GRAD_MAX_TOL
            and stat_rel <= 1e-4 and witness_ok):
        raise AssertionError("f32 fused step disagrees with the plain step")
    return {"loss_rel": loss_rel, "grad_rel_norm": grad_rel, "grad_rel_max": grad_max,
            "relu_flips": sum(flips.values()), "stats_rel": stat_rel,
            "augment_rel": aug_err,
            "f64_witness": {k: {"grad_rel_max": v[0], "grad_rel_norm": v[1],
                                "relu_flips": sum(flips64[k].values())}
                            for k, v in worst64.items()}}


# Coarse classes of device kernels by name, for the train step's profile.
KERNEL_CLASSES = [
    ("fused conv kernel", ("conv_bf16_wgmma_kernel", "conv_f32_kernel")),
    ("shear kernel", ("shear_kernel", "shear_h_kernel")),
    ("cuDNN conv", ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad", "dgrad")),
    ("optimizer", ("adam",)),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "copy", "fill")),
]


def trace_kernels(fn) -> list[tuple[str, float, int]]:
    """(kernel name, device ms, launches) of one call of ``fn`` (after a
    warm-up call) under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # Kernel events only: the host-side operator rows carry the same
    # device time again.
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profile_step(card: str, fn, calls: int = 1) -> dict:
    """``calls`` calls of ``fn`` under torch.profiler: per call, the device
    time per class of kernel (KERNEL_CLASSES, by name), the launches and the
    largest kernels."""
    rows = [(key, t / calls, n / calls)
            for key, t, n in trace_kernels(lambda: [fn() for _ in range(calls)])]
    total = sum(r[1] for r in rows)
    classes: dict = {}
    for key, t, count in rows:
        low = key.lower()
        name = next((c for c, subs in KERNEL_CLASSES if any(x in low for x in subs)), "other")
        ms, n = classes.get(name, (0.0, 0))
        classes[name] = (ms + t, n + count)
    if total == 0:
        log(f"  profile: the profiler saw no device time [{card}]")
        return {}
    log(f"  profile, per call over {calls}: {total:.3f} ms of device time in "
        f"{sum(r[2] for r in rows):g} kernel launches [{card}]")
    for name, (ms, n) in sorted(classes.items(), key=lambda kv: -kv[1][0]):
        log(f"    {name:18s} {ms:8.3f} ms {ms / total:6.1%} ({n:g} launches)")
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"    {t:8.3f} ms x{count:<6g} {key[:110]}")
    return {"device_ms": total, "launches": sum(r[2] for r in rows),
            "classes_ms": {k: v[0] for k, v in classes.items()}}


def upsample_parity(card: str, device) -> dict:
    """The model's 2x upsample (models/unet.py::_upsample2x: its own
    backward, deterministic) at the four decoder levels of the training
    phase's bf16 step, and once in f32: the forward bit-identical to
    ``F.interpolate``, the backward within UPSAMPLE_TOL of the largest
    element of the exact one (``F.interpolate``'s in f64), beside
    ``F.interpolate``'s own distance to it (its CUDA backward adds with
    atomics in the input's dtype). On a card, each backward's time (CUDA
    events), and that of torch's own deterministic form of
    ``F.interpolate``'s (the mode on)."""
    from floodplanet_code_tpu_torch.models.unet import _interpolate2x, _upsample2x

    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(5)
    out = {"levels": []}
    shapes = [(TRAIN_BATCH, BASE * 8 >> k, TILE >> (4 - k)) for k in range(4)]
    for (b, c, h), dtype in [(s, torch.bfloat16) for s in shapes] + [(shapes[-1], torch.float32)]:
        x = torch.randn((b, c, h, h), generator=gen, device=device).to(dtype).contiguous(
            memory_format=torch.channels_last)
        g = torch.randn((b, c, 2 * h, 2 * h), generator=gen, device=device).to(dtype)
        ours, ref = x.clone().requires_grad_(), x.clone().requires_grad_()
        y, want = _upsample2x(ours), _interpolate_as_before(ref)
        if not torch.equal(y, want):
            raise AssertionError(f"the upsample's forward differs from F.interpolate at {h}")
        y.backward(g)
        want.backward(g)
        x64 = x.double().requires_grad_()
        exact = torch.autograd.grad(_interpolate2x(x64, False), x64, g.double())[0]
        scale = exact.abs().max()
        err = ((ours.grad.double() - exact).abs().max() / scale).item()
        row = {"shape": [b, c, h, h], "dtype": str(dtype).split(".")[-1], "rel_err": err,
               "interpolate_rel_err": ((ref.grad.double() - exact).abs().max() / scale).item()}
        del x64, exact
        if not err <= UPSAMPLE_TOL[dtype]:
            raise AssertionError(f"the upsample's backward at {row}: {err:.3e} of max")
        if on_card:
            # F.interpolate under the mode computes torch's decomposition,
            # forward and backward.
            for name, fn, mode in (("ms", _upsample2x, False),
                                   ("interpolate_ms", _interpolate_as_before, False),
                                   ("interpolate_deterministic_ms", _interpolate_as_before,
                                    True)):
                t = x.clone().requires_grad_()
                with train_fit.deterministic_algorithms() if mode else contextlib.nullcontext():
                    y = fn(t)
                    row[name] = cuda_ms(lambda: torch.autograd.grad(y, t, g, retain_graph=True),
                                        10)
        out["levels"].append(row)
    log(f"  upsample: forward = F.interpolate bit for bit; backward's distance to the exact "
        f"one (ours, F.interpolate's) and its time (ms, per backward: ours, F.interpolate's, "
        f"F.interpolate's under deterministic algorithms) {out['levels']} [{card}]")
    return out


def _interpolate_as_before(x, align_corners=False):
    """The model's upsample before it had its own backward: F.interpolate."""
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=align_corners)


def determinism_cost(card, train_step, state, step_xla, state_xla, batch) -> dict:
    """The fused and the unfused bf16 train step (CUDA events, batch
    TRAIN_BATCH) with deterministic algorithms on (as fit_model runs them,
    train/fit.py::deterministic_algorithms) and off, in turns (off, on, on,
    off), and the fused step under the mode with F.interpolate in place of
    the model's upsample (torch's own deterministic decomposition, forward
    and backward)."""
    from floodplanet_code_tpu_torch.models import unet

    runs = {"fused": lambda: train_step(state, batch), "xla": lambda: step_xla(state_xla, batch)}
    times: dict = {}
    for mode in ("off", "on", "on", "off"):
        with train_fit.deterministic_algorithms() if mode == "on" else contextlib.nullcontext():
            for name, fn in runs.items():
                times.setdefault(f"{name}_{mode}", []).append(cuda_ms(fn, 5))
    port = unet._upsample2x
    unet._upsample2x = _interpolate_as_before
    try:
        with train_fit.deterministic_algorithms():
            times["fused_on_interpolate"] = [cuda_ms(runs["fused"], 5)]
    finally:
        unet._upsample2x = port
    out = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"  train step ms per batch of {TRAIN_BATCH}, deterministic algorithms on/off: "
        f"fused {out['fused_on']:.3f}/{out['fused_off']:.3f}, unfused "
        f"{out['xla_on']:.3f}/{out['xla_off']:.3f}; fused, on, with F.interpolate (its "
        f"decomposition) {out['fused_on_interpolate']:.3f} [{card}]")
    return out


def _pack_keys(model) -> list:
    return [m._fused[0] for m in model.modules() if hasattr(m, "_fused")]


def run_training(card: str, device="cuda") -> dict:
    """Phase 8: augmentation + train steps of the full-width EF-UNet.
    ``device="cpu"`` rehearses the control flow at a small size
    (tests/test_torch_chip_smoke.py): no kernel launches and no device
    timing then."""
    on_card = torch.device(device).type == "cuda"
    data_root = os.path.join(WORK, "train_data")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("training: write scenes"):
        write_scenes(data_root, TRAIN_SCENES, seed=1)
    ds = build_dataset(
        "floodplanet", "train", generate_image_slice_object(TILE, TILE, stride=TILE),
        sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0, seed_num=0,
        train_split_pct=0.8,
    )
    loader = BatchLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, n_workers=8)
    if len(loader) < TRAIN_STEPS + 1:
        raise AssertionError(f"{len(loader)} train batches, want {TRAIN_STEPS + 1}")
    eval_batch = _to_device(next(iter(BatchLoader(ds, TRAIN_BATCH))), device)
    log(f"  {len(ds)} train tiles, {len(loader)} batches of {TRAIN_BATCH}")

    model = build_model("ef_model", ds.n_channels, ds.n_classes, dtype=torch.bfloat16,
                        device=device, conv_impl="pallas_fused", base_feat_channels=BASE)
    state = create_train_state(
        model, state_dict_from_flax(seeded_flax_variables(4, 3, BASE, seed=0)), 1e-4, "adam")
    tp = TransformParams(rotate_impl="shear_pallas", dtype="bfloat16")
    augment_step = make_augment_step(tp, 0)
    train_step = make_train_step(model, 0, tp, fuse_augmentation=False)
    eval_step = make_eval_step(model, 0)
    gen = torch.Generator(device=device).manual_seed(0)

    sync(device)
    LAUNCHES.clear()  # the training path starts here
    eval_before = eval_step(state, eval_batch)  # packs the pre-training weights
    keys_before = _pack_keys(model)
    losses = []
    with Phase("training: steps through the loader"):
        t0 = time.perf_counter()
        for n, batch in enumerate(device_prefetch(iter(loader), device)):
            if n == TRAIN_STEPS:
                break
            fixed = augment_step(gen, batch)
            state, logs = train_step(state, fixed)
            losses.append(logs["loss"])
        sync(device)
        loop_s = time.perf_counter() - t0
    fixed_losses = []
    with Phase(f"training: {FIXED_STEPS} steps on one augmented batch"):
        for _ in range(FIXED_STEPS):
            state, logs = train_step(state, fixed)
            fixed_losses.append(logs["loss"])
        sync(device)
    eval_after = eval_step(state, eval_batch)
    keys_after = _pack_keys(model)
    # An optimizer step alone, with no forward (the last step's gradients):
    # the parameters move in place and the next eval must re-pack.
    state.optimizer.step()
    eval_after = eval_step(state, eval_batch)
    sync(device)
    launches = {k: LAUNCHES[k] for k in (conv_fused.KERNEL, rotate.KERNEL,
                                         batchnorm.KERNEL)}  # ends here
    keys_opt = _pack_keys(model)

    losses = [v.item() for v in losses]
    fixed_losses = [v.item() for v in fixed_losses]
    log(f"  losses through the loader: {[round(v, 4) for v in losses]}")
    log(f"  losses on one batch: {[round(v, 4) for v in fixed_losses]}")
    if not all(math.isfinite(v) for v in losses + fixed_losses):
        raise AssertionError("non-finite training loss")
    if not fixed_losses[-1] < fixed_losses[0]:
        raise AssertionError(f"{FIXED_STEPS} steps on one batch did not lower the loss")
    forwards = TRAIN_STEPS + FIXED_STEPS + 3  # train forwards + fused eval forwards
    # The BatchNorm-ReLU kernels: 3 launches forward and 3 backward for
    # bn1 of each of the 9 DoubleConvs a train step (bn0 is the fused
    # pair's), none in eval mode.
    expected = {conv_fused.KERNEL: 9 * forwards, rotate.KERNEL: 3 * TRAIN_STEPS,
                batchnorm.KERNEL: 6 * 9 * (TRAIN_STEPS + FIXED_STEPS)}
    if not on_card:
        expected = {k: 0 for k in expected}  # a CPU tensor runs the plain versions
    log(f"  launches: {launches} for {forwards} forwards and {TRAIN_STEPS} augment steps")
    if launches != expected:
        raise AssertionError(f"expected launches {expected}, got {launches}")
    # Train steps move the parameters and the running statistics; the
    # optimizer step alone moves the parameters only.
    if on_card and any(a == b for a, b in zip(keys_before, keys_after)):
        raise AssertionError("the eval pack cache kept operands packed before the updates")
    if on_card and any(a == b for a, b in zip(keys_after, keys_opt)):
        raise AssertionError("the eval pack cache kept operands packed before an optimizer step")

    # The fused model after the updates against the unfused (cuDNN) model
    # on the same weights.
    model_xla = build_model("ef_model", ds.n_channels, ds.n_classes, dtype=torch.bfloat16,
                            device=device, conv_impl="xla", base_feat_channels=BASE)
    model_xla.load_state_dict(model.state_dict(), strict=True)
    eval_xla = make_eval_step(model_xla, 0)(state, eval_batch)
    cf, cx = eval_after["confusion"], eval_xla["confusion"]
    differ = ((cf - cx).abs().sum() / 2 / cx.sum()).item()
    loss_rel = _rel(eval_after["loss"].item(), eval_xla["loss"].item())
    log(f"  eval after the updates: fused loss {eval_after['loss'].item():.5f}, xla "
        f"{eval_xla['loss'].item():.5f} (rel {loss_rel:.2e}); confusion cells differ by "
        f"{differ:.2e} of the pixels; before the updates the fused loss was "
        f"{eval_before['loss'].item():.5f}")
    if not (loss_rel <= 1e-2 and differ <= 1e-3):
        raise AssertionError("fused and unfused eval disagree after the updates")

    result = {"launches": launches, "losses": losses, "fixed_losses": fixed_losses,
              "eval_loss_rel": loss_rel, "eval_confusion_differ": differ,
              "train_tiles_per_s": TRAIN_STEPS * TRAIN_BATCH / loop_s}
    log(f"  train tiles/s through the loader (host clock, loading, augmentation and "
        f"step included): {result['train_tiles_per_s']:.1f} [{card}]")
    result["f32_step"] = f32_step_check(card, eval_batch, device)
    result["upsample"] = upsample_parity(card, device)

    if on_card:
        # Device times (CUDA events) at batch TRAIN_BATCH: the train step
        # without augmentation, the augment step with the kernel and with
        # the plain shear, and the eval forward, for both models.
        state_xla = create_train_state(model_xla, None, 1e-4, "adam")
        step_xla = make_train_step(model_xla, 0, tp, fuse_augmentation=False)
        ms = {
            "train_step_fused": cuda_ms(lambda: train_step(state, fixed), 5),
            "train_step_xla": cuda_ms(lambda: step_xla(state_xla, fixed), 5),
            "augment_kernel": cuda_ms(lambda: augment_step(gen, eval_batch), 10),
        }
        with plain_shear():
            ms["augment_plain"] = cuda_ms(lambda: augment_step(gen, eval_batch), 10)
        image = fixed["image"].permute(0, 3, 1, 2)
        for name, m in (("eval_forward_fused", model), ("eval_forward_xla", model_xla)):
            m.eval()
            with torch.inference_mode():
                ms[name] = cuda_ms(lambda: m({"image": image}), 5)
        for name, value in ms.items():
            log(f"  {name}: {value:.3f} ms per batch of {TRAIN_BATCH} [{card}]")
        result["ms"] = ms
        result["determinism_ms"] = determinism_cost(card, train_step, state, step_xla,
                                                    state_xla, fixed)
        # Estimated: the loop's steps at these device times over its wall time.
        busy = TRAIN_STEPS * (ms["train_step_fused"] + ms["augment_kernel"]) / 1e3 / loop_s
        result["device_busy_share"] = busy
        log(f"  the loop through the loader kept the device busy ~{busy:.1%} of its "
            f"wall time [{card}]")
        # The augment step first: a short call, traced over ten calls.
        result["profile_augment_step"] = profile_step(
            card, lambda: augment_step(gen, eval_batch), calls=10)
        model.train()
        result["profile_train_step_fused"] = profile_step(card, lambda: train_step(state, fixed))
    shutil.rmtree(WORK, ignore_errors=True)
    return result


# -- 9. the fit loop -----------------------------------------------------------


def cache_parity(ds, device, norms=(None, "local")) -> dict:
    """Every batch of one shuffled epoch from the scene cache against the
    loader's at the same indices, for each of ``norms``: bit-identical with
    norm_mode null, within LOCAL_TOL·max|ref| with local or global. Returns
    the worst errors of the last normalized mode."""
    worst = {}
    order = np.random.default_rng((0, 0)).permutation(len(ds))
    loader = BatchLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, n_workers=8)
    for norm in norms:
        ds.norm_mode = norm
        cache = build_device_cache(ds, 6 << 30, device)
        build = make_batch_builder(cache)
        loader.set_epoch(0)
        for k, want in enumerate(loader):
            got = build(cache.index_rows(ds, order[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH]))
            for key in ("image", "target", "mean", "std"):
                g, w = got[key].cpu().numpy(), want[key]
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(f"cache {key} {g.shape} {g.dtype} vs loader {w.shape} {w.dtype}")
                err = float(np.abs(g.astype(np.float64) - w).max())
                rel = err / max(float(np.abs(w).max()), 1e-30)
                if (norm is None or key == "target") and not np.array_equal(g, w):
                    raise AssertionError(f"cache {key} differs from the loader's ({norm}): {err:.3e}")
                if rel > LOCAL_TOL:
                    raise AssertionError(f"cache {key} off by {rel:.3e}·max|ref| ({norm})")
                if norm is not None:
                    worst[key] = max(worst.get(key, 0.0), rel)
        log(f"  cache vs loader, norm {norm}: {len(loader)} batches of {TRAIN_BATCH}, "
            f"{'bit-identical' if norm is None else f'worst rel {worst}'}")
    ds.norm_mode = None
    return worst


def fit_overrides(data_root: str, exp: str, epochs: int, *extra: str) -> list[str]:
    return [
        "dataset.sensor=PS", f"dataset.dataset_kwargs.root_dir={data_root}",
        f"crop_height={TILE}", f"crop_width={TILE}", f"crop_stride={TILE}",
        f"batch_size={TRAIN_BATCH}", "n_workers=8", f"n_epochs={epochs}",
        f"limit_train_batches={FIT_LIMIT_TRAIN}", f"limit_val_batches={FIT_LIMIT_VAL}",
        "save_topk_models=2", "tpu.resume_every=2", "tpu.async_checkpoint=true",
        f"log_image_iter={FIT_LOG_IMAGE_ITER}", "tpu.conv_impl=pallas_fused",
        "tpu.compute_dtype=bfloat16", f"model.model_kwargs.base_feat_channels={BASE}",
        f"run.dir={exp}", *extra,
    ]


@contextlib.contextmanager
def watch_checkpoints():
    """Within the block, record every ``CheckpointManager.save`` (epoch,
    monitored metric, force, losses, written or not) and hold every
    ``restore`` to the file it read: model and optimizer tensors bit for
    bit, and the step."""
    saves, restores = [], []
    save, restore = ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore

    def saving(self, state, epoch, metrics, force=False):
        path = save(self, state, epoch, metrics, force)
        saves.append({"epoch": epoch, "metric": metrics[ckpt.MONITOR_KEY], "force": force,
                      "losses": [metrics["train_loss"], metrics["valid_loss"]],
                      "metrics": dict(metrics), "written": path is not None})
        return path

    def restoring(self, path, state):
        state = restore(self, path, state)
        want = ckpt.read_checkpoint(path)
        got_model = state.model.state_dict()
        got_opt = state.optimizer.state_dict()["state"]
        same = all(torch.equal(got_model[k].cpu(), v) for k, v in want["model"].items())
        same &= all(torch.equal(got_opt[i][k].cpu(), v) for i, s in want["optimizer"]["state"].items()
                    for k, v in s.items())
        if not (same and state.step == want["step"]):
            raise AssertionError(f"the restored state differs from {path}")
        restores.append(path)
        return state

    ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore = saving, restoring
    try:
        yield saves, restores
    finally:
        ckpt.CheckpointManager.save, ckpt.CheckpointManager.restore = save, restore


def expected_index(saves: list[dict], top_k: int, every: int) -> tuple[list, str]:
    """The retention rules, written out again: (kept (epoch, kind), latest
    epoch) after ``saves``; an epoch writes when it is forced or a resume
    point (full) or enters the top-k (slim)."""
    kept: list[tuple] = []  # (metric, epoch, kind)
    for s in saves:
        top = sorted((m for m, _, _ in kept), reverse=True)[:top_k]
        if s["force"] or s["epoch"] % every == 0:
            kind = "full"
        elif len(top) < top_k or s["metric"] > top[-1]:
            kind = "slim"
        else:
            continue
        kept = sorted(kept + [(s["metric"], s["epoch"], kind)], key=lambda e: -e[0])
        latest = max(e for _, e, k in kept if k == "full")
        kept = [e for i, e in enumerate(kept) if i < top_k or e[1] == latest]
    return sorted((e, k) for _, e, k in kept), latest


def check_fit_dir(exp: str, saves: list[dict]) -> dict:
    with open(os.path.join(exp, "checkpoints", "index.json")) as handle:
        index = json.load(handle)
    got = sorted((e["epoch"], e["kind"]) for e in index["entries"])
    want, latest = expected_index(saves, 2, 2)
    latest_epoch = next(e["epoch"] for e in index["entries"] if e["name"] == index["latest"])
    if got != want or latest_epoch != latest:
        raise AssertionError(f"index.json keeps {got} (latest {latest_epoch}); the retention "
                             f"rules keep {want} (latest {latest})")
    for s in saves:
        if not all(math.isfinite(v) for v in s["losses"]):
            raise AssertionError(f"non-finite loss in epoch {s['epoch']}: {s['losses']}")
    with open(os.path.join(exp, "timing.json")) as handle:
        return json.load(handle)


def fit_forwards(timing: dict, n_loader: int, n_valid_batches: int) -> int:
    """Forwards of a fit: train steps, validation batches, image panels."""
    epochs = timing["epochs"]
    steps = sum(e["n_train_batches"] for e in epochs)
    g0 = epochs[0]["epoch"] * n_loader
    panels = sum(1 for g in range(g0 + 1, g0 + steps + 1) if g % FIT_LOG_IMAGE_ITER == 0)
    return steps + len(epochs) * min(FIT_LIMIT_VAL, n_valid_batches) + panels


def latest_checkpoint(exp: str) -> str:
    with open(os.path.join(exp, "checkpoints", "index.json")) as handle:
        return os.path.join(exp, "checkpoints", json.load(handle)["latest"])


def differing(a, b, path: str = "") -> list[str]:
    """Where two checkpoint payloads (nested dicts and lists of tensors and
    numbers) differ: tensors by dtype, shape and value (torch.equal)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and torch.equal(a, b))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in differing(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for k, (x, y) in enumerate(zip(a, b)) for d in differing(x, y, f"{path}/{k}")]
    return [] if a == b else [path]


def fit_reproduction(data_root: str, cli: list, counted, forwards: dict, n_loader: int,
                     n_valid_batches: int) -> dict:
    """The fit's reproduction contract on the card (train/fit.py runs its
    steps under deterministic algorithms): for each conv_impl, one fit of
    REPRO_EPOCHS epochs of at most REPRO_LIMIT_TRAIN steps through the scene
    cache run twice from scratch, whose per-epoch metrics (losses, Jaccard,
    F1, accuracy) and every tensor of the final checkpoint.pt must be
    equal bit for bit; for pallas_fused also 1 epoch resumed to
    REPRO_EPOCHS, equal to the straight run in the same way (the JAX
    package's promise, ARCHITECTURE.md: an interrupted-then-resumed run
    produces the same checkpoints as an uninterrupted one). Records the
    conv launches of each run in ``forwards``' terms (none under xla)."""
    out = {}
    for conv_impl in ("pallas_fused", "xla"):
        runs = {}
        names = ("first", "again") + (("resumed",) if conv_impl == "pallas_fused" else ())
        for name in names:
            exp = os.path.join(WORK, f"repro_{conv_impl}_{name}")
            extra = (f"limit_train_batches={REPRO_LIMIT_TRAIN}", f"tpu.conv_impl={conv_impl}")
            calls = [1, REPRO_EPOCHS] if name == "resumed" else [REPRO_EPOCHS]
            with Phase(f"fit: reproduction, {conv_impl}, {name} ({' then '.join(map(str, calls))} "
                       "epochs)"), watch_checkpoints() as (saves, _):
                for epochs in calls:
                    key = f"repro {conv_impl} {name} {epochs}"
                    counted(key, lambda: fit_cli.main(cli + fit_overrides(data_root, exp,
                                                                          epochs, *extra)))
                    with open(os.path.join(exp, "timing.json")) as handle:
                        timing = json.load(handle)
                    forwards[key] = (fit_forwards(timing, n_loader, n_valid_batches)
                                     if conv_impl == "pallas_fused" else 0)
            runs[name] = {"metrics": [s["metrics"] for s in saves],
                          "payload": ckpt.read_checkpoint(latest_checkpoint(exp))}
        first = runs["first"]
        for name in names[1:]:
            if runs[name]["metrics"] != first["metrics"]:
                raise AssertionError(f"fit reproduction, {conv_impl}: the {name} run's metrics "
                                     f"{runs[name]['metrics']} differ from the first run's "
                                     f"{first['metrics']}")
            gap = differing(runs[name]["payload"], first["payload"])
            if gap:
                raise AssertionError(f"fit reproduction, {conv_impl}: the {name} run's final "
                                     f"checkpoint differs from the first run's in {gap[:5]}")
        n_tensors = sum(1 for _ in _tensors(first["payload"]))
        out[conv_impl] = {"runs": list(names), "epochs": len(first["metrics"]),
                          "checkpoint_tensors": n_tensors,
                          "train_loss": [m["train_loss"] for m in first["metrics"]],
                          "val_iou": [m[ckpt.MONITOR_KEY] for m in first["metrics"]]}
        log(f"  reproduction, {conv_impl}: runs {list(names)} equal bit for bit in "
            f"{len(first['metrics'])} epochs' metrics and {n_tensors} checkpoint tensors; "
            f"train losses {out[conv_impl]['train_loss']}")
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def run_fit(card: str, device="cuda") -> dict:
    """Phase 9: the fit loop through its CLI on the scene cache, a resume,
    a no-op re-run, the host loader, and serving from the best checkpoint.
    ``device="cpu"`` rehearses it at a small size
    (tests/test_torch_chip_smoke.py): no kernel launches and no device
    timing then."""
    on_card = torch.device(device).type == "cuda"
    data_root = os.path.join(WORK, "fit_data")
    exp, exp_host = os.path.join(WORK, "fit_exp"), os.path.join(WORK, "fit_exp_host")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("fit: write scenes"):
        write_scenes(data_root, TRAIN_SCENES, seed=1)
    split = dict(sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0,
                 seed_num=0, train_split_pct=0.8)
    slices = generate_image_slice_object(TILE, TILE, stride=TILE)
    ds = build_dataset("floodplanet", "train", slices, **split)
    n_valid = len(build_dataset("floodplanet", "valid", slices, **split))
    n_loader, n_valid_batches = len(ds) // TRAIN_BATCH, -(-n_valid // TRAIN_BATCH)
    with Phase("fit: cache parity"):
        local_worst = cache_parity(ds, device)
    cli = ["--device", str(device)]
    launches, bn_launches = {}, {}

    def counted(name, fn):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        launches[name] = LAUNCHES[conv_fused.KERNEL]  # and ends here
        bn_launches[name] = LAUNCHES[batchnorm.KERNEL]
        return out, time.perf_counter() - t0

    with Phase(f"fit: {FIT_EPOCHS} epochs through the CLI"), watch_checkpoints() as (saves, _):
        _, fit_s = counted("fit", lambda: fit_cli.main(cli + fit_overrides(data_root, exp, FIT_EPOCHS)))
    timing = check_fit_dir(exp, saves)
    forwards = {"fit": fit_forwards(timing, n_loader, n_valid_batches)}
    # The resumed epoch runs under the fit's torch.profiler trace
    # (profiler=advanced): its device-busy share, measured.
    with Phase("fit: resume to one more epoch"), watch_checkpoints() as (saves_more, restores):
        counted("resume", lambda: fit_cli.main(cli + fit_overrides(
            data_root, exp, FIT_EPOCHS + 1, "profiler=advanced")))
    traced = trace_busy(os.path.join(exp, "profile", f"epoch{FIT_EPOCHS}.json"))
    log(f"  trace of the resumed epoch: the device busy {traced['busy_share']:.1%} of "
        f"{traced['span_ms']:.0f} ms, {traced['kernels']} kernels; {traced['gaps_over_1ms']} "
        f"idle gaps of 1 ms or more, {traced['gaps_ms']:.0f} ms in all; host time in CUDA "
        f"runtime calls {traced['runtime_ms']} [{card}]")
    timing_resume = check_fit_dir(exp, saves + saves_more)
    forwards["resume"] = fit_forwards(timing_resume, n_loader, n_valid_batches)
    if len(restores) != 1 or [e["epoch"] for e in timing_resume["epochs"]] != [FIT_EPOCHS]:
        raise AssertionError(f"the resumed fit restored {restores} and ran "
                             f"{timing_resume['epochs']}, want epoch {FIT_EPOCHS} alone")
    with Phase("fit: a finished experiment"):
        best, _ = counted("noop", lambda: fit_cli.main(cli + fit_overrides(data_root, exp, FIT_EPOCHS + 1)))
    forwards["noop"] = 0
    with Phase("fit: host loader"), watch_checkpoints() as (saves_host, _):
        counted("host", lambda: fit_cli.main(cli + fit_overrides(data_root, exp_host, 2,
                                                                  "tpu.device_data_bytes=0")))
    timing_host = check_fit_dir(exp_host, saves_host)
    forwards["host"] = fit_forwards(timing_host, n_loader, n_valid_batches)
    if not os.path.isfile(os.path.join(best, ckpt.CHECKPOINT_FILE)):
        raise AssertionError(f"no best checkpoint at {best!r}")
    reproduction = fit_reproduction(data_root, cli, counted, forwards, n_loader, n_valid_batches)

    # Serving from the best checkpoint on one warm model, both input paths.
    cfg = load_experiment_config(exp)
    cfg_host = load_experiment_config(exp)
    cfg_host.tpu.device_data_bytes = 0
    serve_ds = build_infer_dataset(cfg, "floodplanet", "all")
    model = load_model_for_eval(cfg, best, serve_ds, device)
    # In turns (cache, host, host, cache), so that neither path's first
    # use decides the comparison.
    serve_s = {"cache": 0.0, "host": 0.0}
    batch = int(cfg.tpu.inference_batch_size)
    for k, (name, c) in enumerate((("cache", cfg), ("host", cfg_host),
                                   ("host", cfg_host), ("cache", cfg))):
        with Phase(f"fit: serve the best checkpoint ({name})"):
            paths, seconds = counted(f"serve {k} {name}", lambda: infer(
                c, None, "floodplanet", "all", os.path.join(WORK, "fit_masks", str(k)),
                warm=model, dataset=serve_ds, device=device))
            serve_s[name] += seconds / 2
            check_masks(paths, TRAIN_SCENES)
        forwards[f"serve {k} {name}"] = -(-len(serve_ds) // batch)
    probs = {}
    for name, budget in (("cache", 6 << 30), ("host", 0)):
        probs[name] = {s["image_name"]: s["probabilities"] for s in sliding_window_predict(
            model, serve_ds, batch, n_workers=8, device=device, device_data_bytes=budget)}
    agree = min(float(np.mean(probs["cache"][k].argmax(-1) == probs["host"][k].argmax(-1)))
                for k in probs["host"])
    dprob = max(float(np.abs(probs["cache"][k] - probs["host"][k]).max()) for k in probs["host"])
    log(f"  served from {os.path.basename(best)}: cache vs host argmax agreement {agree}, "
        f"max |dp| {dprob:.3e}")
    if agree != 1.0 or not dprob <= PROB_TOL:
        raise AssertionError("serving through the cache disagrees with the host path")

    expected = {k: (9 * v if on_card else 0) for k, v in forwards.items()}
    log(f"  conv launches {launches} for forwards {forwards}; {batchnorm.KERNEL} {bn_launches}")
    if launches != expected:
        raise AssertionError(f"expected conv launches {expected}, got {launches}")
    check_bn_relu_launches("fit", bn_launches, on_card, True)
    steady = {"cache": timing["steady_train_tiles_per_sec"],
              "host": timing_host["steady_train_tiles_per_sec"]}
    serve_rate = {k: len(serve_ds) / v for k, v in serve_s.items()}
    result = {
        "timing": {k: timing[k] for k in ("fit_wall", "setup_wall", "first_step_wall",
                                          "train_wall", "eval_wall", "ckpt_wall",
                                          "ckpt_bg_wall", "ckpt_drain_wall", "other_wall")},
        "timing_host": {k: timing_host[k] for k in ("fit_wall", "setup_wall", "train_wall",
                                                    "eval_wall", "ckpt_wall")},
        "steady_train_tiles_per_s": steady, "serve_tiles_per_s": serve_rate,
        "fit_cli_s": fit_s, "launches": launches, "bn_relu_launches": bn_launches,
        "local_norm_rel": local_worst,
        "resume_epoch_trace": traced, "reproduction": reproduction,
        "epochs": [s["epoch"] for s in saves + saves_more],
        "val_iou": [s["metric"] for s in saves + saves_more],
    }
    # The writer fit_model chose: open_writer's choice in this process.
    writer, result["writer"] = open_writer(os.path.join(WORK, "writer_probe"))
    writer.close()
    log(f"  steady train tiles/s: cache {steady['cache']}, host loader {steady['host']}; "
        f"serving tiles/s: cache {serve_rate['cache']:.1f}, host {serve_rate['host']:.1f} "
        f"(host clock) [{card}]")
    if on_card:
        result["busy_share"] = fit_busy_shares(card, cfg, ds, timing, timing_host, model,
                                               serve_s, len(serve_ds), batch)
    shutil.rmtree(WORK, ignore_errors=True)
    return result


def host_enqueue_ms(fn, calls: int = 5) -> float:
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return 1e3 * sorted(times)[calls // 2]


def trace_busy(path: str) -> dict:
    """The device-busy share of a torch.profiler chrome trace: the union of
    its kernels' intervals over the span from the trace's first event to
    its last kernel's end (the profiler's own host cost lowers it); the
    device's idle gaps of 1 ms or more; and the CUDA runtime calls that
    took the most host time."""
    with open(path) as handle:
        events = [e for e in json.load(handle)["traceEvents"] if e.get("ph") == "X"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    busy, end, gaps = 0.0, -math.inf, []
    for start, stop in kernels:
        if end > -math.inf and start - end >= 1e3:
            gaps.append(start - end)
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    span = (end - min(e["ts"] for e in events)) if kernels else 0.0
    runtime: dict = {}
    for e in events:
        if e.get("cat") == "cuda_runtime":
            runtime[e["name"]] = runtime.get(e["name"], 0.0) + e["dur"] / 1e3
    return {"busy_share": busy / span if span > 0 else 0.0, "span_ms": span / 1e3,
            "busy_ms": busy / 1e3, "kernels": len(kernels),
            "gaps_over_1ms": len(gaps), "gaps_ms": sum(gaps) / 1e3,
            "runtime_ms": dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:6])}


def fit_busy_shares(card, cfg, ds, timing, timing_host, model, serve_s, n_serve, batch) -> dict:
    """Estimated device-busy shares: the device times (CUDA events) of one
    augment step, train step and cache gather at the fit's shapes, times
    the steady epochs' steps, over their train wall; and of one serving
    forward times a request's batches over its wall."""
    train_model = build_model("ef_model", ds.n_channels, ds.n_classes, dtype=torch.bfloat16,
                              conv_impl="pallas_fused", base_feat_channels=BASE)
    state = create_train_state(init_weights(train_model, 0), None, 1e-4)
    tp = dataclasses.replace(TransformParams.from_config(cfg.transforms), dtype="bfloat16")
    augment_step = make_augment_step(tp, 0)
    train_step = make_train_step(train_model, 0, tp, fuse_augmentation=False)
    cache = build_device_cache(ds, 6 << 30, "cuda")
    build = make_batch_builder(cache)
    rows = cache.index_rows(ds, np.arange(TRAIN_BATCH))
    batch0 = build(rows)
    gen = torch.Generator(device="cuda").manual_seed(0)
    fixed = augment_step(gen, batch0)
    ms = {"gather": cuda_ms(lambda: build(rows), 10),
          "augment": cuda_ms(lambda: augment_step(gen, batch0), 10),
          "train_step": cuda_ms(lambda: train_step(state, fixed), 5),
          "forward": forward_ms(model)}
    # Host clock to enqueue one call on an idle card (median of 5): near or
    # above the device time, the loop waits on the host.
    out = {"ms": ms, "host_enqueue_ms": {
        "augment": host_enqueue_ms(lambda: augment_step(gen, batch0)),
        "train_step": host_enqueue_ms(lambda: train_step(state, fixed))}}
    # The fit's per-step work alone (gather, augment, train step; no
    # logging, validation or checkpoint), host clock over 10 steps.
    order = np.random.default_rng((0, 0)).permutation(len(ds))
    sync("cuda")
    t0 = time.perf_counter()
    for k in range(10):
        rows_k = cache.index_rows(ds, order[k * TRAIN_BATCH:(k + 1) * TRAIN_BATCH])
        train_step(state, augment_step(gen, build(rows_k)))
    sync("cuda")
    out["bare_loop_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / 10
    # One image panel of the fit (train/logging.py) on a batch-8 train
    # batch, through the writer the fit uses, host clock.
    writer, _ = open_writer(os.path.join(WORK, "panel_probe"))
    t0 = time.perf_counter()
    for k in range(3):
        log_image_panel(writer, "probe", fixed["image"][0].float().cpu().numpy(),
                        fixed["mean"][0].cpu().numpy(), fixed["std"][0].cpu().numpy(),
                        np.zeros((TILE, TILE, 3), np.float32),
                        fixed["target"][0].cpu().numpy(), ds.to_RGB, k)
    out["panel_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    writer.close()
    for name, t, extra in (("fit_cache", timing, ms["gather"]), ("fit_host", timing_host, 0.0)):
        steady = t["epochs"][1:]
        steps = sum(e["n_train_batches"] for e in steady)
        wall = sum(e["train_wall"] for e in steady)
        out[name] = steps * (ms["augment"] + ms["train_step"] + extra) / 1e3 / wall
    for name, wall in serve_s.items():
        out[f"serve_{name}"] = -(-n_serve // batch) * ms["forward"] / 1e3 / wall
    log(f"  device times {ms} ms, host enqueue {out['host_enqueue_ms']} ms, the bare "
        f"step loop {out['bare_loop_ms_per_step']:.1f} ms per step, one image panel "
        f"{out['panel_ms']:.1f} ms (host clock); estimated busy shares "
        f"{ {k: round(v, 3) for k, v in out.items() if 'ms' not in k} } [{card}]")
    return out


# -- 10. evaluation: predict, serve, batch_infer --------------------------------


def write_geo_source(path: str) -> str:
    """A small GeoTIFF with pixel scale, tie point and geo keys (UTM 31N),
    the source whose tags the synthetic scenes carry."""
    from PIL import Image
    from PIL.TiffImagePlugin import ImageFileDirectory_v2

    ifd = ImageFileDirectory_v2()
    for tag, typ, value in ((33550, 12, (3.0, 3.0, 0.0)),
                            (33922, 12, (0.0, 0.0, 0.0, 500000.0, 4100000.0, 0.0)),
                            (34735, 3, (1, 1, 0, 2, 1024, 0, 1, 1, 3072, 0, 1, 32631))):
        ifd[tag] = value
        ifd.tagtype[tag] = typ
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path, tiffinfo=ifd)
    return path


def write_chips(root: str, seed: int = 0) -> None:
    """Synthetic Sen1Floods11 hand-labeled chips (TILE^2, S1 VV/VH in dB as
    f32, labels {-1, 0, 1} as int16), EVAL_CHIPS per region, written by
    the port's TIFF writer."""
    rng = np.random.default_rng(seed)
    for sub in ("S1Hand", "LabelHand"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for region in EVAL_REGIONS:
        for i in range(EVAL_CHIPS):
            stem = f"{region}_{100 + i}"
            label = rng.choice([-1, 0, 1], size=(TILE, TILE), p=[0.1, 0.6, 0.3]).astype(np.int16)
            s1 = rng.uniform(-30.0, 5.0, size=(2, TILE, TILE)).astype(np.float32)
            s1[0] = np.where(label == 1, 4.0, -25.0)
            tiff.imwrite(os.path.join(root, "LabelHand", f"{stem}_LabelHand.tif"), label)
            tiff.imwrite(os.path.join(root, "S1Hand", f"{stem}_S1Hand.tif"), s1)


def eval_overrides(data_root: str, *extra: str) -> list[str]:
    return [f"dataset.dataset_kwargs.root_dir={data_root}", f"crop_height={TILE}",
            f"crop_width={TILE}", f"crop_stride={TILE // 2}", "n_workers=8",
            f"tpu.inference_batch_size={BATCH}", "tpu.conv_impl=pallas_fused",
            "tpu.compute_dtype=bfloat16", f"model.model_kwargs.base_feat_channels={BASE}",
            *extra]


def seeded_checkpoint(cfg: Config, exp: str, in_channels, seed: int, device) -> str:
    """An experiment directory with ``cfg`` and one CheckpointManager entry
    holding seeded flax-layout weights (through the weights bridge)."""
    save_config(cfg, exp)
    model = build_model(cfg.model.name, in_channels, 3, device=device,
                        **(cfg.model.get("model_kwargs") or {}))
    bridge_in = in_channels if cfg.model.name == "lf_model" else sum(in_channels.values())
    model.load_state_dict(state_dict_from_flax(seeded_flax_variables(bridge_in, 3, BASE, seed)),
                          strict=True)
    manager = ckpt.CheckpointManager(exp, save_top_k=1)
    entry = manager.save(create_train_state(model, None, 1e-4), 0, {ckpt.MONITOR_KEY: 0.5})
    manager.wait_until_finished()
    return entry


def check_predict_dir(pred_dir: str, scenes: list[dict], geo_from: str | None) -> None:
    """Every file of predict's layout exists and parses; pred_class.tif
    carries its scene's geo tags."""
    from PIL import Image

    with open(os.path.join(pred_dir, "metrics.json")) as handle:
        metrics = json.load(handle)
    for key in ("test_MulticlassJaccardIndex", "test_MulticlassF1Score", "test_water_IoU"):
        if not math.isfinite(metrics[key]):
            raise AssertionError(f"metrics.json {key} = {metrics[key]}")
    for name in ("images_F1-score", "images_mIoU", "regions_F1-Score", "regions_iou"):
        with open(os.path.join(pred_dir, f"ranked_{name}.txt")) as handle:
            rows = handle.read().splitlines()[2:]
        if not rows or not all(math.isfinite(float(r.rsplit(": ", 1)[1].rstrip("% ")))
                               for r in rows):
            raise AssertionError(f"ranked_{name}.txt does not parse: {rows}")
    for scene in scenes:
        d = os.path.join(pred_dir, "image_predictions", scene["region"], scene["image_name"])
        shape = scene["probabilities"].shape[:2]
        for png in ("rgb.png", "pred_softmax.png", "gt.png", "cm.png"):
            with Image.open(os.path.join(d, png)) as img:
                if img.size[::-1] != shape:
                    raise AssertionError(f"{d}/{png}: {img.size} for a {shape} scene")
        with Image.open(os.path.join(d, "rgb_cm.gif")) as gif:
            if gif.n_frames != 2:
                raise AssertionError(f"{d}/rgb_cm.gif has {gif.n_frames} frames")
        mask = tiff.imread(os.path.join(d, "pred_class.tif"))
        if mask.shape != shape or not set(np.unique(mask)) <= {0, 1}:
            raise AssertionError(f"{d}/pred_class.tif: {mask.shape} {np.unique(mask)}")
        with tiff.TiffFile(os.path.join(d, "pred_class.tif")) as got, \
                tiff.TiffFile(scene["image_path"]) as src:
            if geo_from is not None and not got.geo_tags():
                raise AssertionError(f"{d}/pred_class.tif lost its geo tags")
            if got.geo_tags() != src.geo_tags():
                raise AssertionError(f"{d}/pred_class.tif: geo tags differ from the scene's")


def http(url: str, body=None) -> tuple[int, dict]:
    """(status, JSON reply) of a GET (no body) or POST to the local daemon."""
    import urllib.error
    import urllib.request

    data = None if body is None else (body if isinstance(body, bytes) else
                                      json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def read_masks(paths: list[str]) -> dict:
    return {os.path.basename(p): tiff.imread(p) for p in paths}


def same_masks(got: dict, want: dict, what: str) -> None:
    if got.keys() != want.keys() or not got:
        raise AssertionError(f"{what}: masks {sorted(got)} != {sorted(want)}")
    for key, mask in want.items():
        if not np.array_equal(got[key], mask):
            raise AssertionError(f"{what}: {key} differs from infer's "
                                 f"({np.mean(got[key] != mask):.3e} of its pixels)")


def run_evaluation(card: str, device="cuda", keep_dir: str | None = None) -> dict:
    """Phase 10: ``predict`` of the early-fusion model on the serving
    phase's scenes (artifacts, per-crop stats, TTA, and against the unfused
    cuDNN path) and of the late-fusion model on Sen1Floods11 chips (the
    cache path against the host loader), then the HTTP daemon and
    ``batch_infer`` against ``infer``. ``device="cpu"`` rehearses it at a
    small size (tests/test_torch_chip_smoke.py): no kernel launches and no
    device timing then. ``keep_dir``: a directory into which the experiment,
    the two roots and ``batch_infer``'s masks move for phase 15; their
    paths are the result's ``kept``."""
    on_card = torch.device(device).type == "cuda"
    data_root, root2 = os.path.join(WORK, "eval_data"), os.path.join(WORK, "eval_data_2")
    s1_root = os.path.join(WORK, "eval_s1f11")
    exp, exp_lf = os.path.join(WORK, "eval_exp"), os.path.join(WORK, "eval_exp_lf")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    with Phase("evaluation: write scenes"):
        geo = write_geo_source(os.path.join(WORK, "geo.tif"))
        write_scenes(data_root, geo_from=geo)
        write_scenes(root2, SCENES[-1:], seed=5, geo_from=geo)
        write_chips(s1_root)
    cfg = compose(overrides=eval_overrides(data_root, "dataset.sensor=PS", "eval_region=RegionA",
                                           "ignore_index=0"))
    entry = seeded_checkpoint(cfg, exp, {"ms_image": 4}, 0, device)
    launches, bn_launches, forwards, out = {}, {}, {}, {}

    def counted(name, fn, n_forwards):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        launches[name] = LAUNCHES[conv_fused.KERNEL]  # and ends here
        bn_launches[name] = LAUNCHES[batchnorm.KERNEL]
        forwards[name] = n_forwards
        return result, time.perf_counter() - t0

    # Early fusion on FloodPlanet: artifacts on, scene-level ranking, timed.
    scenes, timing = {}, {}

    def keep(store):
        def hook(scene, pred_class, confusion):
            store[scene["image_name"]] = (scene, pred_class, confusion)
        return hook

    def run_predict(name, c, exp_dir, tta=False, **kw):
        store = {}
        with Phase(f"evaluation: predict, {name}"):
            metrics, seconds = counted(name, lambda: predict_mod.predict(
                c, exp_dir, entry, c.dataset.name, tta=tta, device=device,
                on_scene=keep(store), **kw), 0)
        return metrics, seconds, store

    metrics, seconds, scenes["fused"] = run_predict("ef fused", cfg, exp, timing=timing)
    batches = timing["batches"]
    forwards["ef fused"] = batches
    check_predict_dir(timing["pred_dir"], [v[0] for v in scenes["fused"].values()], geo)
    # The wall's parts: setup, the scene loop (forward by CUDA events; the
    # rest of it loading and stitching), metrics and what the artifacts add
    # (preparing them and waiting for the writer threads); beside them, the
    # writer threads' own host seconds.
    split = {"forward_s": (timing["forward_ms"] or 0.0) / 1e3,
             "load_stitch_s": timing["loop_s"] - (timing["forward_ms"] or 0.0) / 1e3,
             "metrics_s": timing["metrics_s"], "artifacts_wait_s": timing["artifacts_wait_s"],
             "setup_s": timing["setup_s"]}
    out["predict"] = {"tiles": timing["tiles"], "scenes": timing["scenes"], "batches": batches,
                      "seconds": seconds, "tiles_per_s": timing["tiles"] / seconds,
                      "split_s": split,
                      "per_scene_s": {k: v / timing["scenes"] for k, v in split.items()},
                      "artifact_writers_s": timing["artifacts_s"], "metrics": metrics}
    log(f"  predict (fused, artifacts): {timing['tiles']} tiles in {timing['scenes']} scenes, "
        f"{seconds:.2f} s = {timing['tiles'] / seconds:.1f} tiles/s; split {split}, writer "
        f"threads {timing['artifacts_s']:.2f} s (forward: CUDA events; the rest host clock) "
        f"[{card}]")
    _, _, _ = run_predict("ef per-crop", cfg, os.path.join(WORK, "eval_exp_crop"),
                          per_crop_stats=True, predict_images=False)
    forwards["ef per-crop"] = batches
    _, tta_s, _ = run_predict("ef tta", cfg, os.path.join(WORK, "eval_exp_tta"), tta=True,
                              predict_images=False)
    forwards["ef tta"] = 8 * batches
    cfg_xla = compose(overrides=eval_overrides(data_root, "dataset.sensor=PS",
                                               "eval_region=RegionA", "ignore_index=0",
                                               "tpu.conv_impl=xla"))
    _, xla_s, scenes["xla"] = run_predict("ef xla", cfg_xla, os.path.join(WORK, "eval_exp_xla"),
                                          predict_images=False)
    forwards["ef xla"] = 0  # cuDNN: no fused-conv launch
    fused, unfused = scenes["fused"], scenes["xla"]
    agree = float(np.mean(np.concatenate([
        (fused[k][1] == unfused[k][1]).ravel() for k in fused])))
    cm_f = sum(v[2] for v in fused.values())
    cm_x = sum(v[2] for v in unfused.values())
    moved = float(np.abs(cm_f - cm_x).sum() / 2 / cm_f.sum())
    # As in the slice: the seeded weights predict one class almost
    # everywhere, so the probabilities are held to DPROB_TOL as well.
    dprob = max(float(np.abs(fused[k][0]["probabilities"] - unfused[k][0]["probabilities"])
                      .max()) for k in fused)
    log(f"  predict fused vs xla (cuDNN): argmax agreement {agree:.6f}, share of pixels in "
        f"other confusion cells {moved:.3e}, max |dp| {dprob:.3e}")
    if agree < 0.999 or moved > 1e-3 or not dprob <= DPROB_TOL:
        raise AssertionError("fused and unfused predict disagree")
    out["fused_vs_xla"] = {"argmax_agree": agree, "confusion_moved": moved, "max_dprob": dprob}
    out["predict_s"] = {"fused": seconds, "tta": tta_s, "xla": xla_s}

    # Late fusion on Sen1Floods11, leave-one-region-out: the cache path
    # against the host loader.
    cfg_lf = compose(overrides=eval_overrides(
        s1_root, "dataset=sen1floods11", "dataset.sensor=S1", "model=lf_model",
        f"eval_region={EVAL_REGIONS[0]}", "ignore_index=-1"))
    entry_lf = seeded_checkpoint(cfg_lf, exp_lf, {"ms_image": 2}, 1, device)
    cfg_lf_host = load_experiment_config(exp_lf)
    cfg_lf_host.tpu.device_data_bytes = 0
    lf = {}
    for name, c in (("lf cache", cfg_lf), ("lf host", cfg_lf_host)):
        store, t = {}, {}
        with Phase(f"evaluation: predict, {name}"):
            lf[name], _ = counted(name, lambda: (predict_mod.predict(
                c, exp_lf, entry_lf, "sen1floods11", device=device, on_scene=keep(store),
                timing=t, predict_images=name == "lf cache"), store), 0)
        forwards[name] = t["batches"]
    (m_cache, lf_cache), (m_host, lf_host) = lf["lf cache"], lf["lf host"]
    if sorted(lf_cache) != sorted(lf_host) or len(lf_cache) != EVAL_CHIPS:
        raise AssertionError(f"late fusion: scenes {sorted(lf_cache)} vs {sorted(lf_host)}")
    dprob = max(float(np.abs(lf_cache[k][0]["probabilities"] - lf_host[k][0]["probabilities"])
                      .max()) for k in lf_cache)
    lf_agree = all(np.array_equal(lf_cache[k][1], lf_host[k][1]) for k in lf_cache)
    log(f"  late fusion on Sen1Floods11 ({EVAL_REGIONS[0]} held out, {len(lf_cache)} chips): "
        f"cache vs host loader max |dp| {dprob:.3e}, argmax equal {lf_agree}; "
        f"test_MulticlassJaccardIndex {m_cache['test_MulticlassJaccardIndex']:.4f}")
    if not (dprob <= PROB_TOL and lf_agree and m_cache == m_host):
        raise AssertionError("late fusion: the cache path disagrees with the host loader")
    check_predict_dir(os.path.join(exp_lf, "predictions", "sen1floods11", EVAL_REGIONS[0],
                                   os.path.basename(entry_lf)),
                      [v[0] for v in lf_cache.values()], None)
    out["late_fusion"] = {"max_dprob": dprob, "metrics": m_cache}

    # The daemon: two requests on one root (the second warm), then errors.
    cfg_serve = load_experiment_config(exp)
    cfg_serve.eval_region = None
    ds_serve = build_infer_dataset(cfg_serve, "floodplanet", "all", root_dir=data_root)
    n_req = -(-len(ds_serve) // BATCH)
    want, _ = counted("infer reference", lambda: read_masks(infer(
        cfg_serve, entry, "floodplanet", "all", os.path.join(WORK, "eval_infer"),
        dataset=ds_serve, device=device)), n_req)
    server = serve_mod.serve(entry, "127.0.0.1", 0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    serve_s = []
    try:
        with Phase("evaluation: serve"):
            status, health = http(url + "/healthz")
            if status != 200 or health["device"] != str(torch.device(device)) or \
                    health["model_loaded"]:
                raise AssertionError(f"/healthz: {status} {health}")
            for k in range(2):
                (status, reply), secs = counted(f"serve {k}", lambda: http(
                    url + "/infer", {"root": data_root,
                                     "save_dir": os.path.join(WORK, f"eval_serve_{k}")}), n_req)
                if status != 200:
                    raise AssertionError(f"/infer: {status} {reply}")
                same_masks(read_masks(reply["written"]), want, f"serve request {k}")
                serve_s.append(secs)
            codes = [http(url + "/infer", b"{not json")[0],
                     http(url + "/infer", {"split": "all"})[0],
                     http(url + "/nope")[0],
                     http(url + "/infer", {"root": os.path.join(WORK, "absent")})[0]]
            if codes != [400, 400, 404, 404]:
                raise AssertionError(f"error replies {codes}, want [400, 400, 404, 404]")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    log(f"  serve: {len(ds_serve)} tiles per request, cold {serve_s[0]:.2f} s, warm "
        f"{serve_s[1]:.2f} s ({len(ds_serve) / serve_s[1]:.1f} tiles/s, host clock) [{card}]")
    out["serve_s"] = {"cold": serve_s[0], "warm": serve_s[1], "tiles": len(ds_serve)}

    # batch_infer over two roots, against infer per root.
    cfg_b = load_experiment_config(exp)
    ds2 = build_infer_dataset(cfg_b, "floodplanet", "all", root_dir=root2)
    n2 = -(-len(ds2) // BATCH)
    with Phase("evaluation: batch_infer"):
        results, batch_s = counted("batch_infer", lambda: batch_infer_mod.batch_infer(
            entry, "floodplanet", [data_root, root2], save_dir=os.path.join(WORK, "eval_batch"),
            device=device), n_req + n2)
    ds1 = build_infer_dataset(cfg_b, "floodplanet", "all", root_dir=data_root)
    for root, ds in ((data_root, ds1), (root2, ds2)):
        ref, _ = counted(f"infer {os.path.basename(root)}", lambda: read_masks(infer(
            cfg_b, entry, "floodplanet", "all", os.path.join(WORK, "eval_ref", os.path.basename(
                root)), dataset=ds, device=device)), -(-len(ds) // BATCH))
        same_masks(read_masks(results[root]), ref, f"batch_infer {root}")
    out["batch_infer_s"] = batch_s

    expected = {k: (9 * v if on_card else 0) for k, v in forwards.items()}
    log(f"  conv launches {launches} for forwards {forwards}")
    if launches != expected:
        raise AssertionError(f"expected conv launches {expected}, got {launches}")
    check_bn_relu_launches("evaluation", bn_launches, on_card, False)
    out["launches"], out["bn_relu_launches"] = launches, bn_launches
    if keep_dir is not None:
        shutil.rmtree(keep_dir, ignore_errors=True)
        os.makedirs(keep_dir)
        moved = lambda path: os.path.join(keep_dir, os.path.relpath(path, WORK))  # noqa: E731
        for path in (exp, data_root, root2, os.path.join(WORK, "eval_batch")):
            shutil.move(path, moved(path))
        out["kept"] = {"entry": moved(entry), "roots": [moved(data_root), moved(root2)],
                       "masks": {moved(r): [moved(p) for p in results[r]]
                                 for r in (data_root, root2)},
                       "batch_masks": moved(os.path.join(WORK, "eval_batch"))}
    shutil.rmtree(WORK, ignore_errors=True)
    return out


# -- 11. model tools: cross-validation, soups, ensembles, export, import --------


# -- 15. the root entry points ---------------------------------------------------


def run_entry_points(card: str, kept: dict, device="cuda") -> dict:
    """Phase 15: the repository's root entry points on the port.
    ``bench_torch.main`` at the training phase's size (bench.py's workload:
    TILE^2, batch TRAIN_BATCH, base BASE) with both conv_impl values, each
    JSON line logged: every rate finite and positive, ``flops`` the same
    for both, on a card ``0 < mfu <= 1`` (and the forward's), exact conv
    launches (9 per forward: the FLOP count's, and the warm-up and timed
    steps of the three timings under pallas_fused; none under xla).
    ``Batch_infer_torch.sh`` on phase 10's checkpoint and its two roots
    (``kept``, run_evaluation's): its masks equal ``batch_infer``'s bit for
    bit. ``device="cpu"`` rehearses it (tests/test_torch_chip_smoke.py): the
    script then gets ``--device cpu`` after the roots."""
    import bench_torch

    on_card = torch.device(device).type == "cuda"
    out = {"bench": {}, "launches": {}, "bn_relu_launches": {}}
    for conv_impl in ("xla", "pallas_fused"):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        t0 = time.perf_counter()
        res = bench_torch.main(conv_impl=conv_impl, device=device, tile=TILE,
                               batch=TRAIN_BATCH, base_feat_channels=BASE, steps=BENCH_STEPS)
        sync(device)
        out["launches"][conv_impl] = LAUNCHES[conv_fused.KERNEL]  # and ends here
        out["bn_relu_launches"][conv_impl] = LAUNCHES[batchnorm.KERNEL]
        out["bench"][conv_impl] = dict(res, seconds=time.perf_counter() - t0)
        log(f"  bench_torch --conv_impl {conv_impl}: {json.dumps(res)} [{card}]")
        rates = [res[k] for k in ("value", "augmented_recipe_value", "inference_value")]
        if not all(math.isfinite(v) and v > 0 for v in rates):
            raise AssertionError(f"bench_torch ({conv_impl}): rates {rates}")
        if on_card and not all(0 < res[k] <= 1 for k in ("mfu", "inference_mfu")):
            raise AssertionError(f"bench_torch ({conv_impl}): mfu {res['mfu']}, inference "
                                 f"{res['inference_mfu']}")
    bench = out["bench"]
    if (bench["xla"]["flops"], bench["xla"]["inference_flops"]) != (
            bench["pallas_fused"]["flops"], bench["pallas_fused"]["inference_flops"]):
        raise AssertionError("bench_torch counts other FLOPs for the two conv_impl values")
    forwards = 1 + 3 * (bench_torch.WARMUP + BENCH_STEPS)
    expected = {"xla": 0, "pallas_fused": 9 * forwards if on_card else 0}
    if out["launches"] != expected:
        raise AssertionError(f"bench_torch conv launches {out['launches']}, expected {expected}")
    check_bn_relu_launches("entry points", out["bn_relu_launches"], on_card, True)

    # Batch_infer_torch.sh, with ``python`` this interpreter (a wrapper,
    # not a link: a link elsewhere would lose a virtual environment).
    bindir = tempfile.mkdtemp(prefix="bin_", dir=os.path.dirname(kept["batch_masks"]))
    with open(os.path.join(bindir, "python"), "w") as handle:
        handle.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), 0o755)
    env = dict(os.environ, PATH=bindir + os.pathsep + os.environ.get("PATH", ""),
               PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    argv = ["bash", os.path.join(REPO, "Batch_infer_torch.sh"), kept["entry"], *kept["roots"]]
    t0 = time.perf_counter()
    run = subprocess.run(argv + ([] if on_card else ["--device", "cpu"]), cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    out["batch_infer_script_s"] = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"Batch_infer_torch.sh exited {run.returncode}: {run.stderr[-3000:]}")
    # The script writes where batch_infer does by default:
    # <exp>/batch_inference/<root>/<region>/<scene>.tif.
    out_dir = os.path.join(os.path.dirname(os.path.dirname(kept["entry"])), "batch_inference")
    script_path = lambda p: os.path.join(out_dir, os.path.relpath(p, kept["batch_masks"]))  # noqa: E731
    written = sorted(os.path.join(d, f) for d, _, files in os.walk(out_dir) for f in files)
    want = sorted(script_path(p) for paths in kept["masks"].values() for p in paths)
    if written != want:
        raise AssertionError(f"Batch_infer_torch.sh wrote {written}, batch_infer {want}")
    for root, paths in kept["masks"].items():
        same_masks(read_masks([script_path(p) for p in paths]), read_masks(paths),
                   f"Batch_infer_torch.sh {os.path.basename(root)}")
    out["batch_infer_script_masks"] = len(want)
    log(f"  Batch_infer_torch.sh over {len(kept['roots'])} roots: {len(want)} masks equal to "
        f"batch_infer's, {out['batch_infer_script_s']:.2f} s (a new process, host clock) "
        f"[{card}]")
    shutil.rmtree(os.path.dirname(kept["batch_masks"]), ignore_errors=True)
    return out


def tools_overrides(data_root: str, *extra: str) -> list[str]:
    """The phase's config on top of run_crossval's recipe: the data, the
    crop (the recipe's own 300 on the card), the cuts and the model."""
    return [f"dataset.dataset_kwargs.root_dir={data_root}", f"crop_height={TOOLS_CROP}",
            f"crop_width={TOOLS_CROP}", f"crop_stride={TOOLS_CROP // 2}", "n_workers=8",
            f"limit_train_batches={TOOLS_LIMIT_TRAIN}", f"limit_val_batches={TOOLS_LIMIT_VAL}",
            "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=bfloat16",
            f"model.model_kwargs.base_feat_channels={BASE}", *extra]


def fold_forwards(fold: dict, cfg: Config, n_valid_batches: int) -> int:
    """Forwards of one run_fold: its train steps, validation batches and
    image panels, and its greedy soup's evaluations (one per ingredient,
    each over the whole validation split)."""
    timing = fold["timing"]
    steps = timing["train_tiles"] // TOOLS_BATCH
    every = cfg.select("log_image_iter") or 0
    n = steps + timing["n_epochs_run"] * min(TOOLS_LIMIT_VAL, n_valid_batches)
    n += steps // every if every else 0
    if "soup_checkpoint" in fold:
        with open(os.path.join(fold["soup_checkpoint"], "soup.json")) as handle:
            n += json.load(handle)["n_ingredients_available"] * n_valid_batches
    return n


def reference_state_dict(in_channels: dict, n_classes: int, seed: int,
                         late_fusion: bool) -> dict:
    """A state dict in the reference's own schema (its torch UNet under
    the Lightning wrapper's ``model.``, or its late-fusion model's
    ``encoders.<modality>``/``concat_convs``/``decoder``) at base width
    BASE, from a seed: 3x3 convs with biases, BatchNorms with running
    statistics and ``num_batches_tracked``, the 1x1 head."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.asarray(value, np.float32))

    def double_conv(prefix, c_in, c_mid, c_out):
        for conv, bn, (ci, co) in (("0", "1", (c_in, c_mid)), ("3", "4", (c_mid, c_out))):
            put(f"{prefix}.{conv}.weight", rng.standard_normal((co, ci, 3, 3)) / np.sqrt(9 * ci))
            put(f"{prefix}.{conv}.bias", 0.1 * rng.standard_normal(co))
            put(f"{prefix}.{bn}.weight", rng.uniform(0.8, 1.2, co))
            put(f"{prefix}.{bn}.bias", 0.1 * rng.standard_normal(co))
            put(f"{prefix}.{bn}.running_mean", 0.1 * rng.standard_normal(co))
            put(f"{prefix}.{bn}.running_var", rng.uniform(0.5, 1.5, co))
            sd[f"{prefix}.{bn}.num_batches_tracked"] = torch.tensor(7)

    def encoder(prefix, c_in):
        double_conv(f"{prefix}inc.double_conv", c_in, BASE, BASE)
        for i, (ci, co) in enumerate(((1, 2), (2, 4), (4, 8), (8, 8))):
            double_conv(f"{prefix}down{i + 1}.maxpool_conv.1.double_conv", ci * BASE, co * BASE,
                        co * BASE)

    def decoder(prefix):
        for i, (ci, co) in enumerate(((16, 4), (8, 2), (4, 1), (2, 1))):
            double_conv(f"{prefix}up{i + 1}.conv.double_conv", ci * BASE, ci * BASE // 2,
                        co * BASE)
        put(f"{prefix}outc.conv.weight", rng.standard_normal((n_classes, BASE, 1, 1))
            / np.sqrt(BASE))
        put(f"{prefix}outc.conv.bias", 0.1 * rng.standard_normal(n_classes))

    if not late_fusion:
        encoder("model.", sum(in_channels.values()))
        decoder("model.")
        return sd
    for modality, c in in_channels.items():
        encoder(f"encoders.{modality}.", c)
    for i, w in enumerate((1, 2, 4, 8, 8)):
        c = w * BASE
        put(f"concat_convs.{i}.weight", rng.standard_normal((c, c * len(in_channels), 1, 1))
            / np.sqrt(c * len(in_channels)))
        put(f"concat_convs.{i}.bias", 0.1 * rng.standard_normal(c))
    decoder("decoder.")
    return sd


def archive_parts(path: str) -> dict:
    """Uncompressed bytes of a ``.pt2`` archive by part (the directory
    under the archive's root: weights and constants under ``data``, the
    serialized program under ``models``)."""
    import zipfile

    parts: dict = {}
    with zipfile.ZipFile(path) as archive:
        for info in archive.infolist():
            names = info.filename.split("/")
            key = "/".join(names[1:3]) if len(names) > 3 else "/".join(names[1:])
            parts[key] = parts.get(key, 0) + info.file_size
    return dict(sorted(parts.items(), key=lambda kv: -kv[1])[:6])


@contextlib.contextmanager
def ensemble_confusions(n_members: int):
    """Within the block, keep the ensemble's confusion of every batch that
    tools/eval_ensemble.py computes: per batch it calls
    confusion_from_logits once per member, then once on the averaged
    probabilities."""
    kept, calls = [], [0]
    original = eval_ensemble.confusion_from_logits

    def confusion(*args, **kwargs):
        cm = original(*args, **kwargs)
        if calls[0] % (n_members + 1) == n_members:
            kept.append(cm)
        calls[0] += 1
        return cm

    eval_ensemble.confusion_from_logits = confusion
    try:
        yield kept
    finally:
        eval_ensemble.confusion_from_logits = original


def run_tools(card: str, device="cuda") -> dict:
    """Phase 11: the trained-model tools on the full-width early-fusion
    UNet. ``device="cpu"`` rehearses it at a small size
    (tests/test_torch_chip_smoke.py): no kernel launches and no device
    timing then."""
    on_card = torch.device(device).type == "cuda"
    data_root, serve_root = os.path.join(WORK, "tools_data"), os.path.join(WORK, "tools_serve")
    cv_dir, cv_seed1 = os.path.join(WORK, "cv"), os.path.join(WORK, "cv_seed1")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("tools: write scenes"):
        for k, region in enumerate(TOOLS_REGIONS):
            write_scenes(data_root, TOOLS_SCENES, seed=10 + k, region=region)
        write_scenes(serve_root, seed=12)
    slices = generate_image_slice_object(TOOLS_CROP, TOOLS_CROP, TOOLS_CROP // 2)
    n_valid = {r: len(build_dataset("floodplanet", "valid", slices, sensor="PS", channels="ALL",
                                    root_dir=data_root, eval_region=r, ignore_index=-1,
                                    seed_num=0)) for r in TOOLS_REGIONS}
    nvb = {r: -(-n // TOOLS_BATCH) for r, n in n_valid.items()}
    launches, bn_launches, forwards, seconds, out = {}, {}, {}, {}, {}

    def counted(name, fn, n_forwards):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        launches[name] = LAUNCHES[conv_fused.KERNEL]  # and ends here
        bn_launches[name] = LAUNCHES[batchnorm.KERNEL]
        seconds[name] = time.perf_counter() - t0
        forwards[name] = n_forwards
        return result

    # Cross-validation: both folds with --soup, then a second call that
    # finds both recorded.
    argv = ["--sensor", "PS", "--regions", *TOOLS_REGIONS, "--batch_size", str(TOOLS_BATCH),
            "--n_epochs", str(TOOLS_EPOCHS), "--out_dir", cv_dir, "--soup",
            "--device", str(device)]
    argv += [a for o in tools_overrides(data_root) for a in ("--override", o)]
    with Phase("tools: cross-validation, two folds with --soup"):
        summary = counted("cv", lambda: run_crossval.main(argv), None)
    folds = {f["region"]: f for f in summary["folds"]}
    if tuple(folds) != TOOLS_REGIONS:
        raise AssertionError(f"folds {list(folds)}, want {TOOLS_REGIONS}")
    exps = {r: os.path.join(cv_dir, f"PS_{r}") for r in TOOLS_REGIONS}
    forwards["cv"] = 0
    for region, fold in folds.items():
        with open(os.path.join(exps[region], "checkpoints", "index.json")) as handle:
            entries = json.load(handle)["entries"]
        best = max(entries, key=lambda e: e["metric"])
        if (fold["best_val_iou"] != best["metric"] or fold["best_checkpoint"]
                != os.path.join(exps[region], "checkpoints", best["name"])):
            raise AssertionError(f"{region}: fold record {fold} vs the index's best {best}")
        if not fold["soup_val_iou"] >= fold["soup_base_val_iou"]:
            raise AssertionError(f"{region}: soup {fold['soup_val_iou']} below its base "
                                 f"{fold['soup_base_val_iou']}")
        if any(e["name"].startswith("soup-") for e in entries) or not os.path.isfile(
                os.path.join(fold["soup_checkpoint"], ckpt.CHECKPOINT_FILE)):
            raise AssertionError(f"{region}: the soup is in the index or missing")
        forwards["cv"] += fold_forwards(fold, load_experiment_config(exps[region]),
                                        nvb[region])
    with Phase("tools: cross-validation again"):
        if counted("cv again", lambda: run_crossval.main(argv), 0) != summary:
            raise AssertionError("the second run_crossval call changed the results")
    log(f"  cv: {[(r, f['best_val_iou'], f['soup_val_iou'], f['soup_n_ingredients']) for r, f in folds.items()]} "
        f"(region, best val IoU, greedy soup, ingredients kept); fold walls "
        f"{[f['wall_seconds'] for f in folds.values()]} s [{card}]")
    out["cv"] = {r: {"wall_s": f["wall_seconds"], "best_val_iou": f["best_val_iou"],
                     "best_epoch": f["best_epoch"], "soup_val_iou": f["soup_val_iou"],
                     "soup_base_val_iou": f["soup_base_val_iou"],
                     "soup_n_ingredients": f["soup_n_ingredients"],
                     "steady_train_tiles_per_s": f["timing"]["steady_train_tiles_per_sec"],
                     "fit_timing": {k: f["timing"][k] for k in (
                         "fit_wall", "setup_wall", "train_wall", "eval_wall", "ckpt_wall")}}
                 for r, f in folds.items()}
    out["cv_s"] = seconds["cv"]

    # The soup's weights: ingredients re-scored on one model equal fresh
    # models' bit for bit (the eval pack cache re-packs on each load); the
    # soup checkpoint reloads to its own metrics.
    cfg_a = load_experiment_config(exps["RegionA"])
    ds_a = build_experiment_dataset(cfg_a, "valid")
    ignore = resolve_ignore_index(cfg_a.ignore_index, ds_a.n_classes)

    def evaluator(path):
        model = load_model_for_eval(cfg_a, path, ds_a, device)
        return soup_checkpoints.make_val_evaluator(cfg_a, ds_a, model, ignore, device)

    def weights_of(path):
        return ckpt.eval_state_dict(ckpt.read_checkpoint(path))

    with open(os.path.join(exps["RegionA"], "checkpoints", "index.json")) as handle:
        entries = sorted(json.load(handle)["entries"], key=lambda e: -e["metric"])
    ingredients = [os.path.join(exps["RegionA"], "checkpoints", e["name"]) for e in entries[:2]]
    if len(ingredients) != 2:
        raise AssertionError(f"fold A kept {len(entries)} checkpoints, want 2 ingredients")
    soup_path = folds["RegionA"]["soup_checkpoint"]

    def soup_weights():
        shared = evaluator(ingredients[0])
        for k in (0, 1, 0):
            got, want = shared(weights_of(ingredients[k])), evaluator(ingredients[k])(
                weights_of(ingredients[k]))
            if got != want:
                raise AssertionError(f"ingredient {k} re-scored on a shared model: {got}; on a "
                                     f"fresh model: {want}")
        with open(os.path.join(soup_path, "soup.json")) as handle:
            recorded = json.load(handle)["soup_val_metrics"]
        again = evaluator(soup_path)(weights_of(soup_path))
        return max(abs(again[k] - v) for k, v in recorded.items())

    with Phase("tools: the soup's weights"):
        soup_err = counted("soup weights", soup_weights, 7 * nvb["RegionA"])
    if not soup_err <= 1e-6:
        raise AssertionError(f"the soup checkpoint re-scores {soup_err:.3e} off its metrics")
    with Phase("tools: uniform soup of fold A"):
        uniform = counted("soup uniform", lambda: soup_checkpoints.soup_experiment(
            exps["RegionA"], mode="uniform", device=device), nvb["RegionA"])
    out["soup"] = {"reload_max_err": soup_err, "uniform_val_iou": uniform["soup_val_iou"],
                   "uniform_s": seconds["soup uniform"]}

    # The ensemble: fold A again with seed 1, then both runs of fold A.
    with Phase("tools: fold A with seed 1"):
        seed1 = counted("fit seed 1", lambda: run_crossval.run_fold(
            "PS", "RegionA", TOOLS_BATCH, cv_seed1, TOOLS_EPOCHS,
            tools_overrides(data_root, "seed_num=1"), device=device), None)
    forwards["fit seed 1"] = fold_forwards(seed1, cfg_a, nvb["RegionA"])
    members = [exps["RegionA"], os.path.join(cv_seed1, "PS_RegionA")]
    with Phase("tools: ensemble"), ensemble_confusions(2) as cms:
        ens = counted("ensemble", lambda: eval_ensemble.evaluate_ensemble(members, device=device),
                      2 * nvb["RegionA"])
    alone = counted("ensemble members alone", lambda: [
        evaluator(m["checkpoint"])(weights_of(m["checkpoint"]))[ckpt.MONITOR_KEY]
        for m in ens["members"]], 2 * nvb["RegionA"])
    if [m["iou"] for m in ens["members"]] != alone:
        raise AssertionError(f"ensemble members {ens['members']} vs alone {alone}")
    try:
        eval_ensemble.evaluate_ensemble([exps["RegionA"], exps["RegionB"]], device=device)
    except ValueError as exc:
        if "different fold" not in str(exc):
            raise
    else:
        raise AssertionError("an ensemble across folds was not refused")
    xla_members = []
    for exp in members:
        cfg = load_experiment_config(exp)
        cfg.tpu.conv_impl = "xla"
        save_config(cfg, exp + "_xla")
        os.symlink(os.path.join(exp, "checkpoints"), os.path.join(exp + "_xla", "checkpoints"))
        xla_members.append(exp + "_xla")
    with Phase("tools: ensemble, xla = unfused cuDNN"), ensemble_confusions(2) as cms_xla:
        ens_xla = counted("ensemble xla", lambda: eval_ensemble.evaluate_ensemble(
            xla_members, device=device), 0)
    cm_f, cm_x = torch.stack(cms).sum(0).cpu(), torch.stack(cms_xla).sum(0).cpu()
    moved = float((cm_f - cm_x).abs().sum() / 2 / cm_f.sum())
    log(f"  ensemble of fold A's seeds 0 and 1: IoU {ens['ensemble_iou']:.4f}, members "
        f"{alone}; fused vs xla: {moved:.3e} of the pixels in other confusion cells, xla "
        f"IoU {ens_xla['ensemble_iou']:.4f} [{card}]")
    if moved > 1e-3:
        raise AssertionError(f"fused and unfused ensembles disagree on {moved:.3e} of pixels")
    out["ensemble"] = {"ensemble_iou": ens["ensemble_iou"], "member_iou": alone,
                       "xla_ensemble_iou": ens_xla["ensemble_iou"], "confusion_moved": moved,
                       "seconds": seconds["ensemble"], "xla_seconds": seconds["ensemble xla"]}

    # Export of fold A's best checkpoint at the serving tile and batch; the
    # loaded program against the live predict step.
    best_a = folds["RegionA"]["best_checkpoint"]
    manifests = {}
    for tta in (False, True):
        with Phase(f"tools: export (tta={tta})"):
            manifests[tta] = counted(f"export tta={tta}", lambda: export_model.export_checkpoint(
                best_a, os.path.join(WORK, "tools_export", f"model_tta{int(tta)}"),
                batch_size=BATCH, height=TILE, width=TILE, tta=tta, device=device), 0)
    live_model = load_model_for_eval(cfg_a, best_a, ds_a, device)
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.rand(BATCH, TILE, TILE, 4, generator=gen, device=device)
    out["export"] = {}
    for tta in (False, True):
        with Phase(f"tools: exported program (tta={tta})"):
            call = export_model.load_exported(manifests[tta]["artifact"])
            live = make_predict_step(live_model, tta)
            n = 8 if tta else 1
            got = counted(f"exported forward tta={tta}", lambda: call({"image": x}), n)
            want = counted(f"live forward tta={tta}", lambda: live({"image": x.permute(0, 3, 1, 2)}),
                           n)
        dprob = float((got - want).abs().max())
        argmax_equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
        row = {"max_dprob": dprob, "argmax_equal": argmax_equal,
               "export_s": seconds[f"export tta={tta}"], "bytes": manifests[tta]["bytes"],
               "archive_bytes": archive_parts(manifests[tta]["artifact"])}
        if on_card:
            row["exported_ms"] = cuda_ms(lambda: call({"image": x}), 5)
            row["live_ms"] = cuda_ms(lambda: live({"image": x.permute(0, 3, 1, 2)}), 5)
        log(f"  exported vs live predict step (tta={tta}): max |dp| {dprob:.3e}, argmax equal "
            f"{argmax_equal}; {row} [{card}]")
        if not (argmax_equal and dprob <= EXPORT_DPROB_TOL):
            raise AssertionError(f"the exported program disagrees with the live step (tta={tta})")
        out["export"][f"tta={tta}"] = row

    # The daemon on the plain artifact against infer from the checkpoint at
    # the same tile and batch.
    cfg_ref = load_experiment_config(exps["RegionA"])
    cfg_ref.eval_region = None
    cfg_ref.crop_height = cfg_ref.crop_width = TILE
    cfg_ref.tpu.inference_batch_size = BATCH
    ds_serve = build_infer_dataset(cfg_ref, "floodplanet", "all", root_dir=serve_root)
    n_req = -(-len(ds_serve) // BATCH)
    want = counted("infer reference", lambda: read_masks(infer(
        cfg_ref, best_a, "floodplanet", "all", os.path.join(WORK, "tools_infer"),
        dataset=ds_serve, device=device)), n_req)
    server = serve_mod.serve(artifact_path=manifests[False]["artifact"], host="127.0.0.1",
                             port=0, device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with Phase("tools: serve the artifact"):
            status, health = http(url + "/healthz")
            if status != 200 or health["artifact"] != manifests[False]["artifact"] or \
                    health["checkpoint"] is not None:
                raise AssertionError(f"/healthz: {status} {health}")
            status, reply = counted("serve artifact", lambda: http(url + "/infer", {
                "root": serve_root, "save_dir": os.path.join(WORK, "tools_serve_out")}), n_req)
            if status != 200:
                raise AssertionError(f"/infer: {status} {reply}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    got = read_masks(reply["written"])
    if got.keys() != want.keys() or not got:
        raise AssertionError(f"artifact daemon: masks {sorted(got)} != {sorted(want)}")
    equal = all(np.array_equal(got[k], m) for k, m in want.items())
    agree = float(np.mean(np.concatenate([(got[k] == m).ravel() for k, m in want.items()])))
    log(f"  artifact daemon: {len(ds_serve)} tiles, {seconds['serve artifact']:.2f} s, masks "
        f"equal to infer's: {equal} (pixel agreement {agree}) [{card}]")
    if not equal and agree < MASK_AGREE_MIN:
        raise AssertionError(f"artifact daemon masks agree with infer's on {agree:.6f}")
    out["serve_artifact"] = {"seconds": seconds["serve artifact"], "tiles": len(ds_serve),
                             "masks_equal": equal, "pixel_agreement": agree}

    # Reference-schema checkpoints, early and late fusion, imported and
    # served; the fused model against the unfused one on the serving root.
    out["import"] = {}
    for kind, late in (("ef", False), ("lf", True)):
        src = os.path.join(WORK, f"reference_{kind}",
                           "model-epoch=07-val_MulticlassJaccardIndex=0.5000.ckpt")
        os.makedirs(os.path.dirname(src))
        torch.save({"state_dict": reference_state_dict({"ms_image": 4}, 3, 20 + late, late)},
                   src)
        exp_i = os.path.join(WORK, f"imported_{kind}")
        with Phase(f"tools: import a reference checkpoint ({kind})"):
            entry = counted(f"import {kind}", lambda: import_torch_checkpoint.import_checkpoint(
                src, exp_i, sensor="PS", device=device, overrides=[
                    f"dataset.dataset_kwargs.root_dir={serve_root}", f"crop_height={TILE}",
                    f"crop_width={TILE}", f"tpu.inference_batch_size={BATCH}", "n_workers=8",
                    "tpu.conv_impl=pallas_fused", "tpu.compute_dtype=bfloat16",
                    f"model.model_kwargs.base_feat_channels={BASE}"]), 0)
            cfg_i = load_experiment_config(exp_i)
            ds_i = build_infer_dataset(cfg_i, "floodplanet", "all")
            n_i = -(-len(ds_i) // BATCH)
            paths = counted(f"infer imported {kind}", lambda: infer(
                cfg_i, entry, "floodplanet", "all", os.path.join(WORK, f"imported_{kind}_masks"),
                dataset=ds_i, device=device), n_i)
            check_masks(paths)
        cfg_x = load_experiment_config(exp_i)
        cfg_x.tpu.conv_impl = "xla"
        probs = {}
        for name, c in (("fused", cfg_i), ("xla", cfg_x)):
            model = load_model_for_eval(c, entry, ds_i, device)
            probs[name] = counted(f"imported {kind} {name}", lambda: {
                s["image_name"]: s["probabilities"] for s in sliding_window_predict(
                    model, ds_i, BATCH, n_workers=8, device=device)},
                n_i if name == "fused" else 0)
        fused, unfused = probs["fused"], probs["xla"]
        same = np.concatenate([(fused[k].argmax(-1) == unfused[k].argmax(-1)).ravel()
                               for k in fused])
        # Unlike the serving seeds, which predict one class, the seeded
        # late-fusion model splits its pixels among the classes, and some
        # of them sit within bf16 rounding of a tie. The argmax is held to
        # 99.9% on the pixels whose unfused top two are more than
        # 2*DPROB_TOL apart (decided), the probabilities everywhere.
        top2 = np.concatenate([np.sort(unfused[k], -1)[..., -2:].reshape(-1, 2)
                               for k in unfused])
        decided = top2[:, 1] - top2[:, 0] > 2 * DPROB_TOL
        agree, agree_decided = float(same.mean()), float(same[decided].mean())
        dprob = max(float(np.abs(fused[k] - unfused[k]).max()) for k in fused)
        log(f"  imported {kind}: fused vs xla argmax agreement {agree:.6f} ({agree_decided:.6f} "
            f"on the {decided.mean():.4%} of pixels decided by more than {2 * DPROB_TOL}), "
            f"max |dp| {dprob:.3e}")
        if not (decided.any() and agree_decided >= 0.999 and dprob <= DPROB_TOL):
            raise AssertionError(f"imported {kind}: fused and unfused disagree")
        out["import"][kind] = {"argmax_agree": agree, "argmax_agree_decided": agree_decided,
                               "decided_share": float(decided.mean()), "max_dprob": dprob,
                               "model": cfg_i.model.name}

    expected = {k: (9 * v if on_card else 0) for k, v in forwards.items()}
    log(f"  conv launches {launches} for forwards {forwards}")
    if launches != expected:
        raise AssertionError(f"expected conv launches {expected}, got {launches}")
    check_bn_relu_launches("model tools", bn_launches, on_card, True)
    out["launches"], out["bn_relu_launches"] = launches, bn_launches
    out["seconds"] = seconds
    shutil.rmtree(WORK, ignore_errors=True)
    return out


# -- 12. data tools and options ---------------------------------------------


def data_overrides(data_root: str, exp: str, *extra: str) -> list[str]:
    return [
        "dataset.sensor=PS", f"dataset.dataset_kwargs.root_dir={data_root}",
        f"crop_height={TILE}", f"crop_width={TILE}", f"crop_stride={TILE}",
        f"batch_size={TRAIN_BATCH}", "n_workers=8", f"n_epochs={DATA_EPOCHS}",
        f"limit_train_batches={DATA_LIMIT_TRAIN}", f"limit_val_batches={DATA_LIMIT_VAL}",
        "save_topk_models=1", "tpu.compute_dtype=bfloat16",
        f"model.model_kwargs.base_feat_channels={BASE}", f"run.dir={exp}", *extra,
    ]


@contextlib.contextmanager
def poisoned_train_steps(at: tuple[int, int]):
    """Within the block, the fit's train step number ``at[1]`` of epoch
    ``at[0]`` (each epoch DATA_LIMIT_TRAIN steps) gets a NaN pixel in its
    (augmented) image."""
    make = train_fit.make_train_step
    target_call = at[0] * DATA_LIMIT_TRAIN + at[1]

    def making(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = [0]

        def poisoned(state, batch, generator=None):
            if calls[0] == target_call:
                batch = dict(batch)
                batch["image"] = batch["image"].clone()
                batch["image"][0, 7, 11, 0] = float("nan")
            calls[0] += 1
            return step(state, batch, generator)

        return poisoned

    train_fit.make_train_step = making
    try:
        yield
    finally:
        train_fit.make_train_step = make


def loss_gap(a: list, b: list) -> float:
    """Largest relative difference between two fits' per-epoch losses."""
    return max(_rel(x, y) for p, q in zip(a, b) for x, y in zip(p["losses"], q["losses"]))


def step_grads(model, sd, batch: dict):
    """One Adam step of ``model`` from ``sd`` on ``batch`` (no
    augmentation): (the loss, the gradients, a call that takes one more
    step, for timing)."""
    state = create_train_state(model, sd, 1e-4)
    step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                           fuse_augmentation=False)
    _, logs = step(state, batch)
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return logs["loss"].item(), grads, (lambda: step(state, batch))


@contextlib.contextmanager
def _bn_decisions(decisions: dict):
    """The fused_bn comparison's ReLU and 2x2 pool decisions. With
    ``decisions`` empty, records the fused_bn=true step's own as it runs,
    unchanged: each BatchNormReLU's mask (``z > 0`` of
    ``unet.bn_relu_train``, the kernels on the card) and each
    ``F.max_pool2d``'s indices. Else the fused_bn=false step applies them
    call by call: FlaxBatchNormReLU's ReLU becomes ``torch.where(mask, y,
    0)`` (the ReLU's gradient for that mask) and a pool gathers the
    recorded elements; ``decisions["forced"]`` counts the elements where
    its own decision differs, ``decisions["elements"]`` those decided."""
    from floodplanet_code_tpu_torch.models import unet

    record = not decisions
    calls = {"relu": 0, "pool": 0}
    forced = decisions.setdefault("forced", {"relu": 0, "pool": 0})
    elements = decisions.setdefault("elements", {"relu": 0, "pool": 0})
    saved = unet.bn_relu_train, F.relu, F.max_pool2d
    bn_relu_train, relu, max_pool2d = saved

    def recorded(kind, shape):
        k, calls[kind] = calls[kind], calls[kind] + 1
        if k >= len(decisions[kind]) or decisions[kind][k].shape != shape:
            raise AssertionError(f"{kind} call {k} of shape {tuple(shape)} has no recorded "
                                 f"decision")
        elements[kind] += decisions[kind][k].numel()
        return decisions[kind][k]

    def recording_bn_relu(x, scale, bias, eps=1e-5, group=None):
        z, mean, var = bn_relu_train(x, scale, bias, eps, group)
        decisions.setdefault("relu", []).append(z.detach() > 0)
        return z, mean, var

    def matched_relu(y, inplace=False):
        mask = recorded("relu", y.shape)
        forced["relu"] += int(((y > 0) != mask).sum())
        return torch.where(mask, y, y.new_zeros(()))

    def pool(x, kernel_size, *args, **kwargs):
        out, idx = max_pool2d(x, kernel_size, *args, return_indices=True, **kwargs)
        if record:
            decisions.setdefault("pool", []).append(idx)
            return out
        want = recorded("pool", idx.shape)
        forced["pool"] += int((idx != want).sum())
        picked = x.flatten(2).gather(2, want.flatten(2)).view(want.shape)
        return picked.contiguous(memory_format=torch.channels_last
                                 if x.is_contiguous(memory_format=torch.channels_last)
                                 else torch.contiguous_format)

    if record:
        unet.bn_relu_train = recording_bn_relu
    else:
        F.relu = matched_relu
    F.max_pool2d = pool
    try:
        yield
    finally:
        unet.bn_relu_train, F.relu, F.max_pool2d = saved
    if not record and calls != {k: len(decisions[k]) for k in calls}:
        raise AssertionError(f"{calls} decisions applied of "
                             f"{ {k: len(decisions[k]) for k in calls} } recorded")


def gif_sizes(paths: list[str]) -> list[tuple]:
    from PIL import Image

    sizes = []
    for path in paths:
        with Image.open(path) as gif:
            sizes.append((gif.size, gif.n_frames))
    return sizes


def run_data_tools(card: str, device="cuda") -> dict:
    """Phase 12: the offline data tools and the single-device options on the
    full-width early-fusion UNet, with no hand-written kernel on any of its
    paths (each must count 0 launches). ``device="cpu"`` rehearses it at a
    small size (tests/test_torch_chip_smoke.py): no device timing then."""
    on_card = torch.device(device).type == "cuda"
    data_root = os.path.join(WORK, "data_tools_data")
    outputs = os.path.join(WORK, "data_tools_outputs")
    runs = os.path.join(outputs, "phase12")  # <outputs>/<group>/<experiment>
    norm_path = os.path.join(WORK, "data_tools_norm.json")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("data tools: write scenes"):
        write_scenes(data_root, seed=13)
    cli = ["--device", str(device)]
    launches, bn_launches, seconds, out = {}, {}, {}, {}

    def counted(name, fn):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        launches[name] = {k: LAUNCHES[k] for k in (conv_fused.KERNEL, rotate.KERNEL)}  # ends
        bn_launches[name] = LAUNCHES[batchnorm.KERNEL]
        seconds[name] = time.perf_counter() - t0
        return result

    # 1. Global normalization: the parameters, the cache against the loader,
    # and fits through both.
    with Phase("data tools: compute_norm_params"):
        params = counted("compute_norm_params", lambda: compute_norm_params.main(
            ["--sensor", "PS", "--root_dir", data_root, "--pct_sample", "1.0",
             "--out", norm_path]))
    if not (params["n_scenes"] == len(SCENES) and all(s > 0 for s in params["std"])):
        raise AssertionError(f"norm params {params}")
    slices = generate_image_slice_object(TILE, TILE, stride=TILE)
    ds = build_dataset("floodplanet", "train", slices, sensor="PS", channels="ALL",
                       root_dir=data_root, ignore_index=0, seed_num=0, train_split_pct=0.8,
                       norm_mode="global", norm_param_path=norm_path)
    with Phase("data tools: cache parity, norm_mode global"):
        global_worst = counted("cache parity global", lambda: cache_parity(ds, device, ("global",)))
    global_norm = ["norm_mode=global", f"dataset.dataset_kwargs.norm_param_path={norm_path}"]
    fits = {}
    for name, extra in (("global cache", []), ("global host", ["tpu.device_data_bytes=0"])):
        exp = os.path.join(runs, name.replace(" ", "_"))
        with Phase(f"data tools: fit, {name}"), watch_checkpoints() as (saves, _):
            counted(f"fit {name}", lambda: fit_cli.main(
                cli + data_overrides(data_root, exp, *global_norm, *extra)))
        fits[name] = saves
    out["global_norm"] = {"mean": params["mean"], "std": params["std"],
                          "n_pixels": params["n_pixels"], "cache_parity_rel": global_worst,
                          "losses": {k: [s["losses"] for s in v] for k, v in fits.items()}}

    # 2. Non-square crops: a fit through the cache, rotating by
    # map_coordinates; one augment step on the card against the CPU on the
    # same batch and draws; map_coordinates against the roll shear.
    ch, cw = DATA_CROP
    exp = os.path.join(runs, "non_square")
    with Phase(f"data tools: fit at {ch}x{cw} crops"), watch_checkpoints() as (saves, _), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        counted("fit non-square", lambda: fit_cli.main(cli + data_overrides(
            data_root, exp, f"crop_height={ch}", f"crop_width={cw}", f"crop_stride={ch}")))
    said = [str(w.message) for w in caught if f"non-square crops {ch}x{cw}" in str(w.message)]
    if not said or len(saves) != DATA_EPOCHS:
        raise AssertionError(f"the {ch}x{cw} fit: {len(saves)} epochs, warnings {said[:1]}")
    for s in saves:
        if not all(math.isfinite(v) for v in s["losses"]):
            raise AssertionError(f"non-finite loss in the {ch}x{cw} fit: {s}")
    ds_ns = build_dataset("floodplanet", "train", generate_image_slice_object(ch, cw, stride=ch),
                          sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0,
                          seed_num=0, train_split_pct=0.8)
    cache = build_device_cache(ds_ns, 6 << 30, device)
    batch = make_batch_builder(cache)(cache.index_rows(ds_ns, range(TRAIN_BATCH)))
    tp = TransformParams(dtype="bfloat16")  # the fit's: p = 0.5, bf16 ignored here
    gen = torch.Generator(device=device).manual_seed(5)
    draws = draw_augmentation(gen, TRAIN_BATCH, tp, device)
    img, tgt = counted("augment non-square", lambda: apply_augmentation(
        batch["image"], batch["target"], draws, tp, 0))
    cpu_draws = AugmentDraws(**{f.name: getattr(draws, f.name).cpu()
                                for f in dataclasses.fields(draws)})
    img_cpu, tgt_cpu = apply_augmentation(batch["image"].cpu(), batch["target"].cpu(),
                                          cpu_draws, tp, 0)
    aug_err = float((img.cpu() - img_cpu).abs().max())
    label_differ = float((tgt.cpu() != tgt_cpu).float().mean())
    log(f"  map_coordinates at {ch}x{cw}, batch {TRAIN_BATCH} ({int(draws.do_r.sum())} "
        f"rotated): card vs CPU max |d image| {aug_err:.3e}, labels differ on "
        f"{label_differ:.3e} of pixels [{card}]")
    if not (img.dtype == torch.float32 and aug_err <= AUG_TOL and label_differ <= 1e-3):
        raise AssertionError("map_coordinates rotation: the card disagrees with the CPU")
    out["non_square"] = {"crop": [ch, cw], "losses": [s["losses"] for s in saves],
                         "augment_max_abs_err": aug_err, "label_differ": label_differ,
                         "rotated": int(draws.do_r.sum())}
    if on_card:
        x = torch.rand(TRAIN_BATCH, TILE, TILE, 4, generator=gen, device=device)
        t = torch.randint(0, 3, (TRAIN_BATCH, TILE, TILE), generator=gen, device=device,
                          dtype=torch.int32)
        every = TransformParams(rotate_likelihood=1.0, dtype="bfloat16")
        d = draw_augmentation(gen, TRAIN_BATCH, every, device)
        ms = {}
        for name, p in (("roll_shear", every), ("map_coordinates",
                                                dataclasses.replace(every, rotate_impl="map_coordinates")),
                        ("roll_shear again", every)):
            ms[name] = cuda_ms(lambda: apply_augmentation(x, t, d, p, 0), 10)
        log(f"  augment step at {TILE}^2, batch {TRAIN_BATCH}, every sample rotated: "
            f"{ {k: round(v, 4) for k, v in ms.items()} } ms (CUDA events) [{card}]")
        out["non_square"]["augment_ms"] = ms
    del cache, batch

    # 3. fused_bn=false against fused_bn=true (unfused, cuDNN) on the same
    # weights: the bf16 eval forward at BATCH, an f32 train step at
    # TRAIN_BATCH; the flax-rounding build runs under pallas_fused, where
    # the fused pair must stay off.
    sd = state_dict_from_flax(seeded_flax_variables(4, 3, BASE, seed=7))

    def ef(dtype, fused_bn):
        model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=BASE, dtype=dtype,
                            device=device, fused_bn=fused_bn,
                            conv_impl="pallas_fused" if not fused_bn else "xla")
        model.load_state_dict(sd, strict=True)
        return model

    x = torch.rand(BATCH, 4, TILE, TILE, generator=gen, device=device)
    probs, fwd_ms = {}, {}
    for fused_bn in (False, True):
        step = make_predict_step(ef(torch.bfloat16, fused_bn))
        probs[fused_bn] = counted(f"forward fused_bn={fused_bn}", lambda: step({"image": x}))
        if on_card:
            fwd_ms[fused_bn] = cuda_ms(lambda: step({"image": x}), 5)
    same = probs[False].argmax(-1) == probs[True].argmax(-1)
    agree = float(same.float().mean())
    dprob = float((probs[False] - probs[True]).abs().max())
    # For the record, as in the imports of phase 11: the pixels whose
    # fused_bn=true top two are more than 2*DPROB_TOL apart.
    top2 = probs[True].topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * DPROB_TOL
    agree_decided = float(same[decided].float().mean()) if decided.any() else None
    xb = {"image": torch.rand(TRAIN_BATCH, TILE, TILE, 4, generator=gen, device=device),
          "target": torch.randint(0, 3, (TRAIN_BATCH, TILE, TILE), generator=gen, device=device,
                                  dtype=torch.int32)}
    # The fused_bn=true step records its ReLU and pool decisions; a second
    # fused_bn=false step applies them (_bn_decisions).
    steps, step_ms, decisions = {}, {}, {}
    for name, dtype, fused_bn in (("false", torch.float32, False), ("true", torch.float32, True),
                                  ("false matched", torch.float32, False),
                                  ("f64", torch.float64, False)):
        with (_bn_decisions(decisions) if name in ("true", "false matched")
              else contextlib.nullcontext()):
            loss, grads, again = counted(f"step fused_bn={name}",
                                         lambda: step_grads(ef(dtype, fused_bn), sd, xb))
        steps[name] = (loss, grads)
        if on_card and name in ("false", "true"):
            step_ms[name] = cuda_ms(again, 3, warmup=1)
        del again
    (lf, gf), (lt, gt), (_, g64) = steps["false"], steps["true"], steps["f64"]
    lm, gm = steps["false matched"]
    loss_rel = _rel(lf, lt)
    rels = grad_rels(gf, gt)
    grad_max = max(r[0] for r in rels.values())
    grad_norm = max(r[1] for r in rels.values())
    worst_tensor = max(rels, key=lambda n: rels[n][1])
    matched = grad_rels(gm, gt)
    matched_max = max(r[0] for r in matched.values())
    matched_norm = max(r[1] for r in matched.values())
    forced = {k: decisions["forced"][k] / max(decisions["elements"][k], 1)
              for k in ("relu", "pool")}
    # The f64 step (flax rounding, f64 activations, the loss on f32 logits)
    # as the witness, as in f32_step_check: each f32 step's worst distance
    # to it, (max, norm) forms.
    to64 = {k: grad_rels(g, g64) for k, g in (("false", gf), ("true", gt))}
    worst64 = {k: (max(r[0] for r in v.values()), max(r[1] for r in v.values()))
               for k, v in to64.items()}
    witness_ok = all(worst64["false"][i] <= WITNESS_RATIO * worst64["true"][i] for i in (0, 1))
    log(f"  fused_bn=false vs true: bf16 forward of {BATCH} argmax agreement {agree} "
        f"({agree_decided} on the {float(decided.float().mean()):.4%} of pixels decided by more "
        f"than {2 * DPROB_TOL}), max |dp| {dprob:.3e}; f32 step of {TRAIN_BATCH}: loss rel "
        f"{loss_rel:.2e}, worst grad {grad_norm:.2e}·||g|| ({worst_tensor}) / "
        f"{grad_max:.2e}·max|g|; with the true step's decisions: loss rel {_rel(lm, lt):.2e}, "
        f"worst grad {matched_norm:.2e}·||g|| / {matched_max:.2e}·max|g|, forced ReLU "
        f"{decisions['forced']['relu']} of {decisions['elements']['relu']}, pool "
        f"{decisions['forced']['pool']} of {decisions['elements']['pool']}; vs the f64 step: "
        f"false {worst64['false'][0]:.2e}/{worst64['false'][1]:.2e}, true "
        f"{worst64['true'][0]:.2e}/{worst64['true'][1]:.2e} (max/norm); forward ms {fwd_ms}, "
        f"step ms {step_ms} [{card}]")
    # The largest element of the unmatched gap is set by the ReLUs and pools
    # that the two steps' f32 roundings decide differently: it reads about
    # the f32 steps' own distance to the f64 step, so it is printed, and the
    # element-wise bound holds the gap with the decisions matched. Both forms
    # are held there, the norm form unmatched too, and the decisions that
    # matching overrides must be few (BN_FORCED_SHARE): a fault in either
    # build's values moves the matched gap, a fault in its decisions the
    # forced share.
    if not (agree >= 0.999 and dprob <= DPROB_TOL and loss_rel <= 1e-4
            and grad_norm <= GRAD_TOL and witness_ok and _rel(lm, lt) <= 1e-4
            and matched_norm <= GRAD_TOL and matched_max <= GRAD_MAX_TOL
            and all(v <= BN_FORCED_SHARE for v in forced.values())):
        raise AssertionError("fused_bn=false disagrees with fused_bn=true")
    out["fused_bn_false"] = {"argmax_agree": agree, "argmax_agree_decided": agree_decided,
                             "decided_share": float(decided.float().mean()),
                             "max_dprob": dprob, "loss_rel": loss_rel,
                             "grad_rel_norm": grad_norm, "grad_rel_max": grad_max,
                             "worst_tensor": worst_tensor,
                             "matched": {"loss_rel": _rel(lm, lt), "grad_rel_norm": matched_norm,
                                         "grad_rel_max": matched_max, "forced_share": forced},
                             "f64_witness": {k: {"grad_rel_max": v[0], "grad_rel_norm": v[1]}
                                             for k, v in worst64.items()},
                             "forward_ms": {str(k).lower(): v for k, v in fwd_ms.items()},
                             "step_ms": step_ms}
    del probs, steps, gf, gt, gm, g64, top2, decisions

    # 4. tpu.debug_nans: clean fits off, on and off again, and a poisoned
    # fit. The fit runs under deterministic algorithms (train/fit.py), so a
    # clean fit reproduces bit for bit: off against off again and on
    # against off must both read exactly 0 (and on within 4x of off, the
    # rule from before the fit was deterministic, still holds).
    clean, timing = {}, {}
    for name, flag in (("off", "false"), ("on", "true"), ("off again", "false")):
        exp = os.path.join(runs, "nans_" + name.replace(" ", "_"))
        with Phase(f"data tools: fit, debug_nans {name}"), watch_checkpoints() as (saves, _):
            counted(f"fit debug_nans {name}", lambda: fit_cli.main(
                cli + data_overrides(data_root, exp, f"tpu.debug_nans={flag}")))
        clean[name] = saves
        with open(os.path.join(exp, "timing.json")) as handle:
            timing[name] = json.load(handle)
    gap_on, gap_off = loss_gap(clean["on"], clean["off"]), loss_gap(clean["off again"], clean["off"])
    log(f"  debug_nans: per-epoch losses on vs off differ by {gap_on:.3e} (rel), off vs off "
        f"again by {gap_off:.3e}")
    if not gap_on <= 4 * gap_off:
        raise AssertionError("the clean fit's losses move with tpu.debug_nans")
    if gap_off != 0.0 or gap_on != 0.0:
        raise AssertionError(f"clean fits do not reproduce: on vs off {gap_on}, off vs off "
                             f"again {gap_off}; both must be 0")
    per_step = {k: v["train_wall"] / sum(e["n_train_batches"] for e in v["epochs"])
                for k, v in timing.items()}
    exp = os.path.join(runs, "nans_poisoned")
    raised = None
    with Phase("data tools: fit, debug_nans on a poisoned batch"), poisoned_train_steps(NAN_AT):
        try:
            counted("fit debug_nans poisoned", lambda: fit_cli.main(
                cli + data_overrides(data_root, exp, "tpu.debug_nans=true")))
        except FloatingPointError as exc:
            raised = str(exc)
    want = f"after train step {NAN_AT[1]} of epoch {NAN_AT[0]}"
    log(f"  poisoned fit: {raised!r}")
    if raised is None or want not in raised:
        raise AssertionError(f"the poisoned fit raised {raised!r}, want '{want}'")
    # The check alone, on a trained model's tensors: the host's time per
    # call, synchronized on both sides.
    model = ef(torch.bfloat16, True)
    model.train()
    state = create_train_state(model, None, 1e-4)
    _, logs = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                              fuse_augmentation=False)(state, xb)
    named = train_fit._train_step_tensors(model, logs["loss"])
    times = []
    for _ in range(10):
        sync(device)
        t0 = time.perf_counter()
        train_fit.raise_on_nan("in the timing", named)
        times.append(time.perf_counter() - t0)
    out["debug_nans"] = {
        "loss_gap_on_off": gap_on, "loss_gap_off_off": gap_off,
        "train_wall_per_step_s": per_step, "check_ms": 1e3 * sorted(times)[5],
        "checked_tensors": len(named), "raised": raised,
        "losses": {k: [s["losses"] for s in v] for k, v in clean.items()},
    }
    log(f"  debug_nans check alone: {out['debug_nans']['check_ms']:.3f} ms per train step "
        f"({len(named)} tensors, host clock, synchronized); train wall per step {per_step} s "
        f"[{card}]")
    del model, state, logs, named, xb

    # 5. The tools on the phase's own data and experiments.
    with Phase("data tools: visualize_transforms"):
        gifs = counted("visualize_transforms", lambda: test_image_transforms.visualize_transforms(
            "floodplanet", "PS", os.path.join(WORK, "data_tools_aug"), root_dir=data_root,
            n_examples=8, crop=TILE, device=device))
    with Phase("data tools: generate_dataset_visualizations"):
        scene_gifs = counted("dataset visualizations",
                             lambda: generate_dataset_visualizations.generate_dataset_visualizations(
                                 "floodplanet", "PS", os.path.join(WORK, "data_tools_viz"),
                                 root_dir=data_root))
    with Phase("data tools: compute_feature_stats"):
        stats = counted("feature stats", lambda: compute_feature_stats.compute_feature_stats(
            "floodplanet", "PS", root_dir=data_root))["image"]
    if len(gifs) != 8 or len(scene_gifs) != len(SCENES) or not (
            stats["min"] <= stats["pct_5"] <= stats["pct_95"] <= stats["max"]):
        raise AssertionError(f"tools: {len(gifs)} transform GIFs, {len(scene_gifs)} scene GIFs, "
                             f"stats {stats}")
    # The poisoned fit died in its first epoch, before any checkpoint: its
    # config, its logs and an empty checkpoints/.
    listed = counted("delete_failed_experiments --dry_run", lambda: delete_failed_experiments.main(
        ["--outputs_dir", outputs, "--max_entries", "3", "--dry_run"]))
    if listed != [os.path.join(runs, "nans_poisoned")] or not os.path.isdir(listed[0]):
        raise AssertionError(f"delete_failed_experiments --dry_run listed {listed}, want the "
                             f"poisoned fit alone, deleting none")

    # The example transformer: the card against the CPU on the same weights.
    torch.manual_seed(0)
    cpu_model = ExampleTileTransformer(4, **TRANSFORMER)
    card_model = ExampleTileTransformer(4, **TRANSFORMER).to(device)
    card_model.load_state_dict(cpu_model.state_dict())
    tiles = torch.rand(TRAIN_BATCH, TILE, TILE, 4, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        want_t = cpu_model(tiles)
        got_t = counted("example transformer", lambda: card_model(tiles.to(device))).cpu()
        t_ms = cuda_ms(lambda: card_model(tiles.to(device)), 5) if on_card else None
    t_err = float((got_t - want_t).abs().max())
    t_rel = t_err / max(float(want_t.abs().max()), 1e-30)
    n_tokens = (TILE // TRANSFORMER["patch"]) ** 2
    log(f"  example transformer d_model {TRANSFORMER['d_model']}, {TRANSFORMER['n_layers']} "
        f"layers, {n_tokens} tokens, batch {TRAIN_BATCH}: card vs CPU max |d| {t_err:.3e} "
        f"({t_rel:.2e}·max|ref|), {t_ms} ms [{card}]")
    if not (got_t.shape == (TRAIN_BATCH, TRANSFORMER["d_model"]) and t_rel <= TOL[torch.float32]):
        raise AssertionError("the example transformer on the card disagrees with the CPU")
    out["tools"] = {"transform_gifs": len(gifs), "scene_gifs": gif_sizes(scene_gifs),
                    "feature_stats": stats, "gc_listed": [os.path.relpath(p, outputs)
                                                          for p in listed],
                    "transformer": {"tokens": n_tokens, "max_abs_err": t_err, "rel": t_rel,
                                    "ms": t_ms}}

    if any(any(v.values()) for v in launches.values()):
        raise AssertionError(f"a hand-written kernel ran on this phase's paths: {launches}")
    check_bn_relu_launches("data tools", bn_launches, on_card, True)
    out["launches"] = {k: sum(v[k] for v in launches.values())
                       for k in (conv_fused.KERNEL, rotate.KERNEL)}
    out["bn_relu_launches"] = bn_launches
    out["seconds"] = seconds
    shutil.rmtree(WORK, ignore_errors=True)
    return out


# -- 13. more than one device -------------------------------------------------------


def _md_tf32_off() -> None:
    # A rank is a fresh interpreter: main() did not run there. The f32
    # references run in full f32 (cuDNN would use TF32 by default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _md_model(spec: dict, dtype, device, group=None, space=None, conv_impl="pallas_fused"):
    model = build_model("ef_model", {"ms_image": 4}, 3, base_feat_channels=spec["base"],
                        dtype=dtype, device=device, conv_impl=conv_impl, bn_group=group,
                        space_group=space)
    sd = state_dict_from_flax(seeded_flax_variables(4, 3, spec["base"], seed=1))
    return model, create_train_state(model, sd, 1e-4)


def _md_tensors(batch: dict, rows, device) -> dict:
    return {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}


@contextlib.contextmanager
def _plain_fused_op():
    """The model's fused op runs its plain version (autograd through the
    unfused chain, any dtype) while the context is open."""
    from floodplanet_code_tpu_torch.models import unet

    def plain(y, a, b, w, packed=None):
        out = conv_fused.relu_affine_conv3x3_plain(y, a, b, w)
        return out.contiguous(memory_format=torch.channels_last)

    kernel, unet.relu_affine_conv3x3 = unet.relu_affine_conv3x3, plain
    try:
        yield
    finally:
        unet.relu_affine_conv3x3 = kernel


@contextlib.contextmanager
def _matched_decisions(decisions: dict, layout=None, group=None):
    """Within the block the model's two kinds of decision, each train-mode
    BatchNorm + ReLU (the BatchNormReLUs' ``bn_relu_train`` and the fused
    pair's BN_0 in its op's plain version, which runs for the kernel) and
    each 2x2 max pool, are explicit: a ReLU is ``torch.where(mask, x, 0)``
    (the ReLU's gradient for that mask), a pool gathers each window's
    chosen element. ``layout`` None: they are this run's own (``x > 0``, the
    pool's argmax), appended to ``decisions["relu"]`` and
    ``decisions["pool"]`` on the host, call by call. With the ``layout`` of
    a space ``group``: call k applies the k-th recorded decisions, a whole
    image's, at this rank's rows (its block, or its block with the
    neighbours' rows joined for a 3x3 op; the level from the width), and
    ``decisions["forced"]`` counts the elements where this run's own
    decision differs. Statistics through ``ops/batchnorm.py::batch_stats``,
    so autograd carries SyncBN as the fused pair's BN_0 does."""
    from floodplanet_code_tpu_torch.models import unet
    from floodplanet_code_tpu_torch.ops.batchnorm import batch_stats
    from floodplanet_code_tpu_torch.parallel import halo

    record = layout is None
    calls = {"relu": 0, "pool": 0}
    forced = decisions.setdefault("forced", {"relu": 0, "pool": 0})
    max_pool2d = F.max_pool2d

    def recorded(kind, x, rows_of_x):
        k, calls[kind] = calls[kind], calls[kind] + 1
        s, n = halo.position(group)
        lo, hi = layout.blocks[layout.heights.index(x.shape[3])][s]
        if rows_of_x != hi - lo:
            lo, hi = lo - int(s > 0), hi + int(s < n - 1)
        want = decisions[kind][k][:, :, lo:hi].to(x.device)
        if want.shape[2] != rows_of_x:
            raise AssertionError(f"{kind} {k}: {want.shape[2]} recorded rows for {rows_of_x}")
        return want

    def relu(x):
        if record:
            mask = x > 0
            decisions.setdefault("relu", []).append(mask.cpu())
        else:
            mask = recorded("relu", x, x.shape[2])
            forced["relu"] += int(((x > 0) != mask).sum())
        return torch.where(mask, x, x.new_zeros(()))

    def pool(x, kernel_size):
        h, w = x.shape[2] // 2, x.shape[3] // 2
        windows = torch.stack([x[:, :, dy:2 * h:2, dx:2 * w:2] for dy in (0, 1) for dx in (0, 1)],
                              dim=-1)
        own = windows.argmax(-1)  # the first largest, as max_pool2d picks
        if record:
            choice = own
            decisions.setdefault("pool", []).append(choice.to(torch.uint8).cpu())
        else:
            choice = recorded("pool", windows[..., 0], h).long()
            forced["pool"] += int((own != choice).sum())
        out = windows.gather(-1, choice.unsqueeze(-1)).squeeze(-1)
        if record and not torch.equal(out, max_pool2d(x, kernel_size)):
            raise AssertionError("the recorded pool differs from max_pool2d")
        return out

    def bn_relu_train(x, scale, bias, eps=1e-5, group=None):
        mean, m2 = batch_stats(x, group)
        var = torch.clamp_min(m2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        a, b = (inv * scale).to(x.dtype), (bias - mean * inv * scale).to(x.dtype)
        return relu(x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)), mean.detach(), var.detach()

    def fused(y, a, b, w, packed=None):
        dt = y.dtype
        z = relu(y * a.to(dt).view(1, -1, 1, 1) + b.to(dt).view(1, -1, 1, 1))
        return F.conv2d(z, w.to(dt), padding=1).contiguous(memory_format=torch.channels_last)

    saved = unet.bn_relu_train, unet.relu_affine_conv3x3
    unet.bn_relu_train, unet.relu_affine_conv3x3, F.max_pool2d = bn_relu_train, fused, pool
    try:
        yield
    finally:
        (unet.bn_relu_train, unet.relu_affine_conv3x3), F.max_pool2d = saved, max_pool2d


def sp_matched_step(spec: dict, device, block: dict, group, space, mesh) -> dict:
    """One f32 train step from the seeded weights with matched decisions
    (``_matched_decisions``): without a ``mesh`` the one-rank step, which
    saves its ReLU masks and pool choices to ``spec["matched"]``; with one
    the spatial step, which applies them. Its gradients, and how many of
    the spatial step's own decisions the recorded ones overrode."""
    from floodplanet_code_tpu_torch.parallel.mesh import n_space_shards
    from floodplanet_code_tpu_torch.parallel.rows import row_layout

    model, state = _md_model(spec, torch.float32, device, group, space)
    step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                           fuse_augmentation=False, group=group)
    if mesh is None:
        decisions: dict = {}
        with _matched_decisions(decisions):
            step(state, block)
        torch.save({k: decisions[k] for k in ("relu", "pool")}, spec["matched"])
    else:
        decisions = torch.load(spec["matched"])
        with _matched_decisions(decisions, row_layout(spec["tile"], n_space_shards(mesh)),
                                space):
            step(state, block)
    return {"grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            "forced": decisions["forced"]}


def md_steps(spec: dict, device, mesh=None) -> dict:
    """Phase 13's and 14's step checks on this process's share of
    ``spec``'s global batch: with ``mesh`` (a rank) the steps over its
    ranks, data parallel or data x space (the rank's rows, cut to its block
    of image rows after the augment step), without it the one-rank steps on
    the whole batch. The f32 eval step with padded rows and MD_STEPS f32
    train steps from the seeded weights, MD_FIXED_STEPS bf16 steps on the
    same batch, the augment step (shear kernel, bf16) on the full-height
    rows, and each path's launches; on a card the bf16 step's time and peak
    memory, and with a mesh every collective's host time in one bf16 step
    (``timed_collectives``)."""
    from floodplanet_code_tpu_torch.parallel.mesh import (
        all_group,
        local_height,
        local_rows,
        space_group,
    )

    _md_tf32_off()
    group = space = None
    rows = slice(None)
    if mesh is not None:
        group, space = all_group(mesh), space_group(mesh)
        rows = local_rows(mesh, spec["batch"]["image"].shape[0])
    batch = _md_tensors(spec["batch"], rows, device)
    block = batch
    if space is not None:
        hs = local_height(mesh, batch["image"].shape[1])
        block = {k: v[:, hs] for k, v in batch.items()}
    n = spec["batch"]["image"].shape[0]
    valid = torch.arange(n, device=device)[rows] < spec["n_valid"]
    on_card = torch.device(device).type == "cuda"
    out, launches, bn_launches = {}, {}, {}

    def counted(name, fn, kernel=conv_fused.KERNEL):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        value = fn()
        sync(device)
        launches[name] = LAUNCHES[kernel]  # and ends here
        bn_launches[name] = LAUNCHES[batchnorm.KERNEL]
        return value

    model, state = _md_model(spec, torch.float32, device, group, space)
    eval_step = make_eval_step(model, 0, group)
    logs = counted("eval", lambda: eval_step(state, dict(block, valid=valid)))
    out["eval"] = {"loss": logs["loss"].item(), "confusion": logs["confusion"].cpu().numpy()}
    step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                           fuse_augmentation=False, group=group)
    losses = []

    def f32_steps():
        nonlocal state
        for k in range(spec["steps"]):
            state, logs = step(state, block)
            losses.append(logs["loss"].item())
            if k == 0:
                out["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
                out["stats1"] = {n: b.detach().cpu().clone() for n, b in model.named_buffers()}
                out["f32_confusion"] = logs["confusion"].cpu().numpy()

    counted("f32_steps", f32_steps)
    out["f32_losses"] = losses
    out["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    out["stats"] = {n: b.detach().cpu() for n, b in model.named_buffers()}
    del model, state, step, eval_step
    if spec.get("f64"):
        # One f64 step from the same weights through the f32 steps' own
        # graph (f64 activations and BatchNorm, the loss on f32 logits):
        # the pallas_fused DoubleConvs, their fused pair's operands folded
        # from the synced statistics and applied to the joined halo rows of
        # y, with the op's plain version in place of the kernel, which runs
        # f32 and bf16 alone (for this step only). Where two f32 steps
        # decide a few ReLUs differently, the truth that both are held to,
        # and the partitioning's own check, the fused pair's included.
        model, state = _md_model(spec, torch.float64, device, group, space)
        with _plain_fused_op():
            make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                            fuse_augmentation=False, group=group)(state, block)
        out["f64_grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        del model, state
    if spec.get("matched"):
        out["matched"] = sp_matched_step(spec, device, block, group, space, mesh)
    model, state = _md_model(spec, torch.bfloat16, device, group, space)
    step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                           fuse_augmentation=False, group=group)
    bf16 = []

    def bf16_steps():
        nonlocal state
        for _ in range(spec["fixed_steps"]):
            state, logs = step(state, block)
            bf16.append(logs["loss"])

    counted("bf16_steps", bf16_steps)
    out["bf16_losses"] = [v.item() for v in bf16]
    if on_card:
        out["bf16_step_ms"] = cuda_ms(lambda: step(state, block), 3, warmup=1)
        # The step's peak: the largest allocation the step reached, and
        # what it added to what was allocated before it (model, Adam,
        # batch).
        sync(device)
        before = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        step(state, block)
        sync(device)
        peak = torch.cuda.max_memory_allocated(device)
        out["bf16_step_memory_mib"] = {"peak": peak / 2**20, "added": (peak - before) / 2**20}
    if group is not None:
        with timed_collectives(device) as calls:
            step(state, block)
        out["collectives"] = {kind: {"count": sum(1 for k, _ in calls if k == kind),
                                     "ms": sum(ms for k, ms in calls if k == kind)}
                              for kind in sorted({k for k, _ in calls})}
    if on_card and group is not None:
        # The step's collectives alone (host clock, synchronized): the
        # gradients' one all-reduce, and one of the size a BatchNorm
        # sums (2 x 512 channels + 1).
        from floodplanet_code_tpu_torch.parallel.collectives import all_reduce

        for name, n in (("grad_all_reduce_ms", sum(p.numel() for p in model.parameters())),
                        ("bn_all_reduce_ms", 1025)):
            flat = torch.zeros(n, device=device)
            all_reduce(flat, group)
            sync(device)
            t0 = time.perf_counter()
            for _ in range(5):
                all_reduce(flat, group)
            sync(device)
            out[name] = (time.perf_counter() - t0) / 5 * 1e3
    del model, state, step
    tp = TransformParams(rotate_impl="shear_pallas", dtype="bfloat16")
    augment = make_augment_step(tp, 0, mesh)
    gen = torch.Generator(device=device).manual_seed(spec["seed"])
    aug = counted("augment", lambda: augment(gen, batch), rotate.KERNEL)
    out["augment"] = {k: aug[k].cpu() for k in ("image", "target")}
    out["launches"], out["bn_relu_launches"] = launches, bn_launches
    return out


@contextlib.contextmanager
def timed_collectives(device):
    """Within the block, every all-reduce of the train step is timed alone
    (host clock, the device synchronized before and after) and recorded as
    (kind, ms): ``halo`` (a row exchange, parallel/halo.py: its [sp, 2, B,
    k, W, C] buffer), ``batchnorm`` (ops/batchnorm.py), ``confusion``
    (ops/metrics.py), ``loss_and_gradients`` (the global loss's sums and the
    gradients' one all-reduce)."""
    from floodplanet_code_tpu_torch.ops import batchnorm, metrics
    from floodplanet_code_tpu_torch.parallel import collectives

    calls = []
    originals = {m: m.all_reduce for m in (collectives, batchnorm, metrics)}

    def timed(module):
        def all_reduce(t, group=None):
            kind = {batchnorm: "batchnorm", metrics: "confusion"}.get(
                module, "halo" if t.dim() == 6 else "loss_and_gradients")
            sync(device)
            t0 = time.perf_counter()
            originals[collectives](t, group)
            sync(device)
            calls.append((kind, (time.perf_counter() - t0) * 1e3))
            return t
        return all_reduce

    for module in originals:
        module.all_reduce = timed(module)
    try:
        yield calls
    finally:
        for module, fn in originals.items():
            module.all_reduce = fn


# A Down level's DoubleConv: its fused conv maps LEVEL_WIDTHS[l] * base
# channels to as many (the inc at level 0, the bottleneck at level 4).
LEVEL_WIDTHS = (1, 2, 4, 8, 8)
LEVEL_NAMES = {0: "inc", 4: "bottleneck"}


def sp_halo_parity(spec: dict, mesh, device, levels) -> dict:
    """Phase 14's kernel check: the fused conv on a halo-extended y, as
    ``DoubleConv`` runs it under spatial partitioning (this rank's block of
    rows of a seeded y at each of ``levels`` of ``spec``'s tile, the
    neighbours' edge rows joined by the exchange), against its plain
    version on the same y_ext, and the block's own output rows against the
    plain version on the whole y; f32 and bf16. Returns the worst error of
    each over max|ref| (phase 3's TOL) and each level's block heights."""
    from floodplanet_code_tpu_torch.parallel import halo
    from floodplanet_code_tpu_torch.parallel.mesh import space_group
    from floodplanet_code_tpu_torch.parallel.rows import row_layout

    space = space_group(mesh)
    tile, base, s = spec["tile"], spec["base"], mesh.coords["space"]
    layout = row_layout(tile, mesh.shape["space"])
    out = {"blocks": {}}
    for level in levels:
        name = LEVEL_NAMES.get(level, f"level{level}")
        h, width, c1 = layout.heights[level], tile >> level, LEVEL_WIDTHS[level] * base
        c2 = c1
        rows = layout.block(level, s)
        out["blocks"][name] = [b - a for a, b in layout.blocks[level]]
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=device).manual_seed(5)  # one y on every rank
            y = torch.randn(2, c1, h, width, generator=gen, device=device).to(dtype)
            y = y.contiguous(memory_format=torch.channels_last)
            a = torch.rand(c1, generator=gen, device=device) + 0.5
            b = torch.randn(c1, generator=gen, device=device) * 0.5
            w = torch.randn(c2, c1, 3, 3, generator=gen, device=device) / math.sqrt(9 * c1)
            y_ext = halo.join_rows(y[:, :, rows], space)
            got = conv_fused.relu_affine_conv3x3(y_ext, a, b, w)
            ref = conv_fused.relu_affine_conv3x3_plain(y_ext, a, b, w)
            whole = conv_fused.relu_affine_conv3x3_plain(y, a, b, w)[:, :, rows]
            joined_top = int(s > 0)
            own = got[:, :, joined_top:joined_top + rows.stop - rows.start]
            scale = ref.abs().max().item()
            err = max((got - ref).abs().max().item(), (own - whole).abs().max().item()) / scale
            if not err <= TOL[dtype]:
                raise AssertionError(f"fused conv on halo-extended y, {name} {dtype}: error "
                                     f"{err:.2e} of max|ref|, tolerance {TOL[dtype]}")
            out[f"{name}_{str(dtype).split('.')[-1]}"] = err
    return out


def sp_pack_reuse(spec: dict, mesh, device) -> dict:
    """The eval pack cache (``DoubleConv._pack_key``) across block heights:
    one seeded DoubleConv of level 2 of ``spec``'s tile (bf16,
    pallas_fused), in eval mode under inference mode, runs this rank's
    block with the space group set and then the whole image with it unset,
    as the fit's eval step and the coordinator's image panel do. The key
    holds no height (``pack`` reads the parameters alone): on a card one
    pack serves both, and each output equals the same forward packed per
    call (inference mode off) bit for bit; the block's rows match the whole
    image's within TOL. On the CPU nothing is packed."""
    from floodplanet_code_tpu_torch.models.unet import DoubleConv, set_space_group
    from floodplanet_code_tpu_torch.parallel.mesh import space_group
    from floodplanet_code_tpu_torch.parallel.rows import row_layout

    level, tile, base = 2, spec["tile"], spec["base"]
    layout = row_layout(tile, mesh.shape["space"])
    rows = layout.block(level, mesh.coords["space"])
    c = LEVEL_WIDTHS[level] * base
    torch.manual_seed(7)  # one module on every rank
    module = DoubleConv(c // 2, c, conv_impl="pallas_fused")
    with torch.no_grad():
        for bn in (module.bn0, module.bn1):
            bn.mean.uniform_(-0.5, 0.5)
            bn.var.uniform_(0.5, 1.5)
            bn.scale.uniform_(0.5, 1.5)
            bn.bias.uniform_(-0.5, 0.5)
    module = module.to(device, memory_format=torch.channels_last).eval()
    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.randn(2, c // 2, layout.heights[level], tile >> level, generator=gen,
                    device=device).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    space = space_group(mesh)

    def both():
        set_space_group(module, space)
        block = module(x[:, :, rows].contiguous(memory_format=torch.channels_last))
        key = module._fused[0]
        set_space_group(module, None)
        return block, module(x), key

    with torch.inference_mode():
        block, whole, key = both()
        same_pack = key is not None and module._fused[0] == key
    with torch.no_grad():
        block_ref, whole_ref, _ = both()
    on_card = torch.device(device).type == "cuda"
    if on_card and not same_pack:
        raise AssertionError("the eval pack cache re-packed between block and full height")
    if not (torch.equal(block, block_ref) and torch.equal(whole, whole_ref)):
        raise AssertionError("a pack cached at one block height differs from packing per call")
    err = ((block.float() - whole[:, :, rows].float()).abs().max()
           / whole.float().abs().max()).item()
    if not err <= TOL[torch.bfloat16]:
        raise AssertionError(f"pack reuse: block rows vs the whole image's {err:.2e} of max|ref|")
    return {"one_pack": same_pack, "block_vs_whole": err,
            "block_rows": rows.stop - rows.start}


def md_rank(spec: dict, spec_sp: dict, fits: dict, device) -> dict:
    """All of phases 13 and 14's work on one of the two ranks that share
    the device, in one process start: the step checks on the 1-D data mesh
    (md_steps), the fit through the replicated cache with both ranks on one
    node; then phase 14 on a 1 x 2 data x space mesh: the step checks and
    the fused conv on halo-extended rows (sp_halo_parity) at ``spec``'s
    even tile and at ``spec_sp``'s uneven crop, the pack cache across block
    heights (sp_pack_reuse), and a spatial fit at that crop;
    then phase 13's resume through the pod-sharded cache with each rank a
    node of its own (LOCAL_WORLD_SIZE, which mesh.detect_n_pods reads, as
    ``launch.spawn(pods=2)`` sets it). Each part's seconds on this rank."""
    from floodplanet_code_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d

    out, seconds = {}, {}
    t0 = time.perf_counter()
    out["steps"] = md_steps(spec, device, make_mesh())
    seconds["steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["replicated"] = md_fit_rank(fits["replicated"], fits["exp"], None, device)
    seconds["fit_replicated"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh_2d(1, 2)
    out["spatial_steps"] = md_steps(spec, device, mesh)
    out["spatial_steps"]["halo_parity"] = sp_halo_parity(spec, mesh, device,
                                                         SP_PARITY_LEVELS["even"])
    seconds["spatial_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["spatial_crop_steps"] = md_steps(spec_sp, device, mesh)
    out["spatial_crop_steps"]["halo_parity"] = sp_halo_parity(spec_sp, mesh, device,
                                                              SP_PARITY_LEVELS["uneven"])
    out["spatial_crop_steps"]["pack_reuse"] = sp_pack_reuse(spec_sp, mesh, device)
    seconds["spatial_crop_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["spatial"] = md_fit_rank(fits["spatial"], fits["exp_spatial"], None, device)
    seconds["fit_spatial"] = time.perf_counter() - t0
    os.environ.update(LOCAL_WORLD_SIZE="1", LOCAL_RANK="0", GROUP_RANK=os.environ["RANK"])
    t0 = time.perf_counter()
    out["pod"] = md_fit_rank(fits["pod"], fits["exp"], fits["pod_spec"], device)
    seconds["fit_pod"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def md_nccl_one_rank(spec: dict, device) -> dict:
    """One data-parallel f32 step in this process as a group of one rank,
    through the backend the launcher picks for one device (NCCL for a
    card): its backend and loss. Run in the smoke's own process, which has
    the card and the kernels up already."""
    import torch.distributed as dist

    from floodplanet_code_tpu_torch.parallel import launch
    from floodplanet_code_tpu_torch.parallel.mesh import batch_group, make_mesh

    backend = launch.backend_for([device])
    store = tempfile.mkdtemp(prefix="md_store_", dir=WORK)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store, 'store')}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=300),
        device_id=torch.device(device) if backend == "nccl" else None)
    try:
        mesh = make_mesh()
        model, state = _md_model(spec, torch.float32, device, batch_group(mesh))
        step = make_train_step(model, 0, TransformParams(False, 0, False, 0, False, 0),
                               fuse_augmentation=False, group=batch_group(mesh))
        _, logs = step(state, _md_tensors(spec["batch"], slice(None), device))
        return {"backend": dist.get_backend(), "loss": logs["loss"].item()}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def md_fit_rank(cfg: Config, exp: str, pod_parity: dict | None, device) -> dict:
    """fit_model on this rank, recording per epoch what every rank saw
    (CheckpointManager.save runs on all of them), which ranks wrote
    checkpoints, and the conv launches; with ``pod_parity`` first every
    batch of one shuffled epoch from the pod-sharded cache against the
    replicated cache's."""
    from floodplanet_code_tpu_torch.parallel import multihost

    saves, writes, digests = [], [], []
    save, write = ckpt.CheckpointManager.save, ckpt.CheckpointManager._write

    def saving(self, state, epoch, metrics, force=False):
        saves.append({"epoch": epoch, "losses": [metrics["train_loss"], metrics["valid_loss"]],
                      "metric": metrics[ckpt.MONITOR_KEY]})
        digests.append(state_digest(state.model))
        return save(self, state, epoch, metrics, force)

    def writing(self, *args, **kwargs):
        writes.append(1)
        return write(self, *args, **kwargs)

    out = {"rank": multihost.process_index()}
    if pod_parity is not None:
        out["pod_batches"] = md_pod_parity(pod_parity, device)
    ckpt.CheckpointManager.save, ckpt.CheckpointManager._write = saving, writing
    try:
        sync(device)
        LAUNCHES.clear()  # the rank's fit starts here
        out["best"] = train_fit.fit_model(cfg, exp, device=device)
        sync(device)
        out["launches"] = LAUNCHES[conv_fused.KERNEL]  # and ends here
        out["bn_relu_launches"] = LAUNCHES[batchnorm.KERNEL]
    finally:
        ckpt.CheckpointManager.save, ckpt.CheckpointManager._write = save, write
    # What this rank holds at the fit's end: its parameters and running
    # statistics, hashed (every rank's must be the same bits).
    out["saves"], out["writes"], out["final_digest"] = saves, len(writes), digests[-1]
    if out["rank"] == 0:  # the writer of this fit's timing.json
        with open(os.path.join(exp, "timing.json")) as handle:
            out["timing"] = json.load(handle)
    return out


def state_digest(model) -> dict:
    """SHA-256 of the bytes of the model's parameters and of its buffers
    (running statistics), each in ``named_*`` order."""
    import hashlib

    out = {}
    for kind, tensors in (("params", model.named_parameters()),
                          ("buffers", model.named_buffers())):
        h = hashlib.sha256()
        for name, t in tensors:
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().flatten().view(torch.uint8).numpy().tobytes())
        out[kind] = h.hexdigest()
    return out


def md_pod_parity(spec: dict, device) -> int:
    """Batches of one shuffled epoch, pod-sharded cache against the
    replicated one, for this rank's rows: equal (torch.equal); returns
    their count."""
    from floodplanet_code_tpu_torch.data.device_cache import (
        build_device_cache_sharded,
        cache_batches,
        make_batch_builder_podsharded,
    )
    from floodplanet_code_tpu_torch.parallel.mesh import detect_n_pods, local_rows, make_hybrid_mesh

    mesh = make_hybrid_mesh(detect_n_pods(), 1)
    tile, batch = spec["tile"], spec["batch"]
    ds = build_dataset("floodplanet", "train", generate_image_slice_object(tile, tile, stride=tile),
                       sensor="PS", channels="ALL", root_dir=spec["root"], ignore_index=0,
                       seed_num=0, train_split_pct=0.8)
    full = build_device_cache(ds, 6 << 30, device)
    pod = build_device_cache_sharded(ds, mesh, 6 << 30, device)
    if not pod.images.shape[0] < full.images.shape[0]:
        raise AssertionError("the pod-sharded cache holds every scene")
    order = np.random.default_rng((0, 0)).permutation(len(ds))
    want = cache_batches(full, ds, batch, order, True,
                         make_batch_builder(full, local_rows(mesh, batch)))
    got = cache_batches(pod, ds, batch, order, True,
                        make_batch_builder_podsharded(pod, mesh, batch))
    n = 0
    for (w, _, _), (g, _, _) in zip(want, got):
        for key in ("image", "target", "mean", "std"):
            if not (g[key].dtype == w[key].dtype and torch.equal(g[key], w[key])):
                raise AssertionError(f"pod-sharded batch {n}: {key} differs from the replicated")
        n += 1
    return n


def _md_rel_checks(name: str, got: dict, want: dict) -> dict:
    """Phase 8's f32 rule per tensor: the difference's norm within GRAD_TOL
    of the tensor's norm and its largest element within GRAD_MAX_TOL of
    the tensor's largest; returns the worst of each."""
    rels = grad_rels({k: v.float() for k, v in got.items()}, {k: v.float() for k, v in want.items()})
    worst = {"rel_max": max(r[0] for r in rels.values()),
             "rel_norm": max(r[1] for r in rels.values())}
    if not (worst["rel_norm"] <= GRAD_TOL and worst["rel_max"] <= GRAD_MAX_TOL):
        bad = sorted(rels, key=lambda k: -rels[k][1])[:3]
        raise AssertionError(f"2 ranks vs 1 rank, {name}: {worst}; worst {bad}")
    return worst


def md_fit_forwards(timing: dict, n_loader: int, n_valid: int, coordinator: bool,
                    panel_every: int = FIT_LOG_IMAGE_ITER) -> int:
    """One rank's forwards in a fit: train steps, validation batches, and
    on the coordinator the image panels (one every ``panel_every`` steps)."""
    epochs = timing["epochs"]
    steps = sum(e["n_train_batches"] for e in epochs)
    g0 = epochs[0]["epoch"] * n_loader
    panels = sum(1 for g in range(g0 + 1, g0 + steps + 1) if g % panel_every == 0)
    return steps + len(epochs) * min(MD_LIMIT_VAL, n_valid) + (panels if coordinator else 0)


def sp_step_checks(ranks: list, one: dict, expected: dict, card: str, on_card: bool,
                   tile: int) -> dict:
    """Phase 14's step checks against the one-rank steps on the same global
    batch of ``tile``^2 crops: the f32 loss (1e-4), the first step's
    gradients, its running statistics and confusion, the parameters after
    MD_STEPS steps (phase 8's rule), the eval step with padded rows, the
    bf16 losses falling, the augment step bit for bit (each rank augments
    the whole global batch: one data row), the fused conv on halo-extended
    rows, the exact launches per rank; on a card the bf16 step's time, peak
    memory and collectives against one rank's.

    The gradients: within SP_GRAD_TOL of their norm (GRAD_MAX_TOL of their
    largest element) of one rank's. Where the steps carry an f64 step (the
    uneven crop; the fused pair's graph with the op's plain version), the
    spatial f64 step's gradients must also lie within SP_F64_TOL of the
    one-rank f64 step's: the partitioning, the fused pair's halo rows of y,
    count-weighted fold and da, db included, apart from f32 rounding. The
    f32 rule may then be met instead by the witness: the spatial f32 step
    no farther from the f64 gradients than SP_WITNESS_RATIO times one
    rank's f32 step. On the 300^2 batch one rank's own f32 gradients lie
    7.5e-3 of their norm from its f64 gradients (PERF.md): each f32 step
    decides a few ReLUs at rounding distance from zero its own way, so two
    of them cannot meet SP_GRAD_TOL there; where no ReLU flips the
    witness's distances are rounding noise and SP_GRAD_TOL decides."""
    out, failed = {}, []
    witness = "f64_grads" in one
    witness_ok = False
    if witness:
        g64 = {k: v.double() for k, v in one["f64_grads"].items()}

        def worst(grads, ref):
            rels = grad_rels({k: v.double() for k, v in grads.items()}, ref)
            return tuple(max(v[i] for v in rels.values()) for i in (0, 1))

        out["f64_witness"] = {"one_rank": worst(one["grads"], g64),
                              "spatial": [worst(r["grads"], g64) for r in ranks]}
        out["f64_spatial"] = [worst(r["f64_grads"], g64) for r in ranks]
        witness_ok = all(w[i] <= SP_WITNESS_RATIO * out["f64_witness"]["one_rank"][i]
                         for w in out["f64_witness"]["spatial"] for i in (0, 1))
        if not all(v <= SP_F64_TOL for w in out["f64_spatial"] for v in w):
            failed.append(f"spatial f64 gradients vs 1 rank's: {out['f64_spatial']}")
    if "matched" in one:
        # The spatial step with the one-rank step's ReLU and pool decisions:
        # no decision at rounding distance parts them, only f32 rounding.
        gaps = [grad_rels(r["matched"]["grads"], one["matched"]["grads"]) for r in ranks]
        out["matched_relu"] = {"rel_max": max(v[0] for g in gaps for v in g.values()),
                               "rel_norm": max(v[1] for g in gaps for v in g.values()),
                               "forced_per_rank": [r["matched"]["forced"] for r in ranks]}
        if not (out["matched_relu"]["rel_norm"] <= SP_MATCHED_TOL
                and out["matched_relu"]["rel_max"] <= SP_MATCHED_MAX_TOL):
            worst_t = sorted(gaps[0], key=lambda k: -gaps[0][k][1])[:3]
            failed.append(f"spatial f32 gradients with matched ReLUs at {tile}^2: "
                          f"{out['matched_relu']}; worst {worst_t}")
    for r in ranks:
        if not _rel(r["f32_losses"][0], one["f32_losses"][0]) <= 1e-4:
            failed.append(f"spatial f32 loss {r['f32_losses']} vs 1 rank {one['f32_losses']}")
        rels = grad_rels({k: v.float() for k, v in r["grads"].items()},
                         {k: v.float() for k, v in one["grads"].items()})
        gap = {"rel_max": max(v[0] for v in rels.values()),
               "rel_norm": max(v[1] for v in rels.values())}
        out["f32_grads"] = gap
        if not (gap["rel_norm"] <= SP_GRAD_TOL and gap["rel_max"] <= GRAD_MAX_TOL
                or witness_ok):
            failed.append(f"spatial f32 gradients vs 1 rank at {tile}^2: {gap}; distance "
                          f"to the f64 step {out.get('f64_witness')}")
        for name in ("stats1", "params", "stats"):
            try:
                out[f"f32_{name}"] = _md_rel_checks(f"spatial {name}", r[name], one[name])
            except AssertionError as exc:
                failed.append(str(exc))
        if any(not torch.equal(r[k][n], ranks[0][k][n]) for k in ("params", "stats")
               for n in r[k]):
            failed.append("the space ranks' states differ after the spatial steps")
        for name, got, want in (("train", r["f32_confusion"], one["f32_confusion"]),
                                ("eval", r["eval"]["confusion"], one["eval"]["confusion"])):
            out[f"{name}_confusion_moved"] = float(np.abs(got - want).sum() / 2)
            if not out[f"{name}_confusion_moved"] <= 1e-3 * want.sum():
                failed.append(f"spatial {name} confusion: {out[f'{name}_confusion_moved']} "
                              "pixels moved")
        out["eval_loss_rel"] = _rel(r["eval"]["loss"], one["eval"]["loss"])
        if not out["eval_loss_rel"] <= 1e-4:
            failed.append(f"spatial eval loss rel {out['eval_loss_rel']:.2e}")
        if not r["bf16_losses"][-1] < r["bf16_losses"][0]:
            failed.append(f"spatial bf16 losses did not fall: {r['bf16_losses']}")
        for key in ("image", "target"):
            if not torch.equal(r["augment"][key], one["augment"][key]):
                failed.append(f"spatial augment step: {key} differs from one rank's")
        if r["launches"] != expected:
            failed.append(f"spatial launches {r['launches']}, expected {expected}")
    out["f32_loss_rel"] = [max(_rel(r["f32_losses"][k], one["f32_losses"][k]) for r in ranks)
                           for k in range(MD_STEPS)]
    out["halo_parity"] = {k: max(r["halo_parity"][k] for r in ranks)
                          for k in ranks[0]["halo_parity"] if k != "blocks"}
    out["halo_parity_blocks"] = ranks[0]["halo_parity"]["blocks"]
    if "pack_reuse" in ranks[0]:
        out["pack_reuse"] = [r["pack_reuse"] for r in ranks]
    out["bf16_losses"] = ranks[0]["bf16_losses"]
    out["collectives_per_rank"] = [r["collectives"] for r in ranks]
    out["launches_per_rank"] = ranks[0]["launches"]
    out["bn_relu_launches_per_rank"] = ranks[0]["bn_relu_launches"]
    out["launches"] = {"bn_relu": sum(sum(r["bn_relu_launches"].values()) for r in ranks),
                       "conv": sum(r["launches"][k] for r in ranks for k in
                                   ("eval", "f32_steps", "bf16_steps")),
                       "shear": sum(r["launches"]["augment"] for r in ranks)}
    halo = [r["collectives"].get("halo", {"count": 0, "ms": 0.0}) for r in ranks]
    if on_card:
        out["bf16_step_ms"] = {"one_rank": one["bf16_step_ms"],
                               "two_ranks": [r["bf16_step_ms"] for r in ranks]}
        out["bf16_step_memory_mib"] = {"one_rank": one["bf16_step_memory_mib"],
                                       "two_ranks": [r["bf16_step_memory_mib"] for r in ranks]}
        log(f"  spatial bf16 step at {tile}^2 (1 x 2 data x space, {MD_BATCH} rows of "
            f"{tile // 2} image rows per rank): {[round(r['bf16_step_ms'], 2) for r in ranks]} "
            f"ms per rank against "
            f"{one['bf16_step_ms']:.2f} ms on one rank; peak memory "
            f"{[round(r['bf16_step_memory_mib']['peak'], 1) for r in ranks]} MiB per rank "
            f"against {one['bf16_step_memory_mib']['peak']:.1f} MiB (added by the step "
            f"{[round(r['bf16_step_memory_mib']['added'], 1) for r in ranks]} against "
            f"{one['bf16_step_memory_mib']['added']:.1f}) [{card}]")
    log(f"  spatial vs 1 rank at {tile}^2 (f32): loss rel per step "
        f"{[f'{v:.2e}' for v in out['f32_loss_rel']]}, "
        f"grads {out['f32_grads']}, params after {MD_STEPS} steps {out['f32_params']}, eval loss "
        f"rel {out['eval_loss_rel']:.2e}; halo exchanges per step {[h['count'] for h in halo]} "
        f"taking {[round(h['ms'], 2) for h in halo]} ms (timed alone, host clock); fused conv on "
        f"halo-extended rows {out['halo_parity']} (blocks {out['halo_parity_blocks']}); "
        f"pack reuse {out.get('pack_reuse')}; launches per rank {out['launches_per_rank']} "
        f"[{card}]")
    if "matched_relu" in out:
        log(f"  at {tile}^2 with matched ReLUs and pools the spatial f32 gradients' worst "
            f"distance to the one-rank step's, and the decisions overridden per rank: "
            f"{out['matched_relu']} [{card}]")
    if witness:
        log(f"  at {tile}^2 the gradients' worst (max, norm) distance to the one-rank f64 "
            f"step: one rank's f32 {out['f64_witness']['one_rank']}, spatial f32 "
            f"{out['f64_witness']['spatial']}, spatial f64 {out['f64_spatial']} [{card}]")
    if failed:
        raise AssertionError(f"spatial steps at {tile}^2: " + "; ".join(failed))
    return out


def sp_ext_overhead(card: str) -> dict:
    """What joining the halo row costs the fused conv, per level of the
    bf16 spatial step on a 1 x 2 mesh (MD_BATCH rows of H / 2 image rows,
    one neighbour row; CUDA events, this process alone on the card): the
    kernel on the block alone, the copy that joins the row (cat into a
    channels_last y_ext) and the kernel on y_ext; the overhead is the last
    two less the first, what an output-row offset argument of the kernel
    would save at most."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, total = [], {"block_ms": 0.0, "join_ms": 0.0, "ext_ms": 0.0}
    for name, h, c1, c2 in LEVELS:
        y, a, b, wt = kernel_inputs(gen, MD_BATCH, h // 2, h, c1, c2, torch.bfloat16)
        halo_row = y[:, :, :1].clone()
        packed = conv_fused.pack(a, b, wt, y.dtype)

        def join():
            return torch.cat([halo_row, y], dim=2).contiguous(memory_format=torch.channels_last)

        y_ext = join()
        row = {"level": name, "block_ms": cuda_ms(
            lambda: conv_fused.relu_affine_conv3x3_cuda(y, a, b, wt, packed), 10),
            "join_ms": cuda_ms(join, 10), "ext_ms": cuda_ms(
            lambda: conv_fused.relu_affine_conv3x3_cuda(y_ext, a, b, wt, packed), 10)}
        for k in total:
            total[k] += row[k]
        rows.append(row)
        del y, y_ext, halo_row, packed
    total["overhead_ms"] = total["join_ms"] + total["ext_ms"] - total["block_ms"]
    total["overhead_frac"] = total["overhead_ms"] / total["block_ms"]
    log(f"  fused conv on y_ext vs the block alone, nine levels of one forward per rank "
        f"(bf16, {MD_BATCH} x H/2 rows): block {total['block_ms']:.3f} ms, join "
        f"{total['join_ms']:.3f} ms, y_ext {total['ext_ms']:.3f} ms: overhead "
        f"{total['overhead_ms']:.3f} ms ({total['overhead_frac']:.1%}) [{card}]")
    return dict(total, levels=rows)


def sp_fit_checks(run: list, one_losses: list, n_loader: int, n_valid_batches: int,
                  card: str, on_card: bool) -> dict:
    """Phase 14's 2-rank spatial fit at SP_TILE^2 crops: rank 0 alone
    writes, both ranks saw the same epochs, finite per-epoch losses, exact
    conv launches (the coordinator's image panels at full height included),
    its steady tiles/s, and (run_multi_device) the ranks' final states
    equal bit for bit. Its losses' largest relative gap to the one-rank
    fit's at the same crop is reported, not held to a bound: the ranks sum
    in another order than one rank, and a bf16 fit's epochs carry that
    (up to 2.91e-2, PERF.md); the step checks carry its correctness."""
    if run[1]["writes"] != 0 or run[0]["writes"] == 0:
        raise AssertionError(f"spatial fit: checkpoint writes per rank {[r['writes'] for r in run]}")
    if run[0]["saves"] != run[1]["saves"] or run[0]["best"] != run[1]["best"]:
        raise AssertionError("spatial fit: the ranks saw different epochs or bests")
    losses = [s["losses"] for s in run[0]["saves"]]
    if [s["epoch"] for s in run[0]["saves"]] != list(range(MD_EPOCHS)):
        raise AssertionError(f"spatial fit ran epochs {[s['epoch'] for s in run[0]['saves']]}")
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"non-finite spatial fit losses {losses}")
    rel = max(_rel(a, b) for pa, pb in zip(losses, one_losses) for a, b in zip(pa, pb))
    timing = run[0]["timing"]
    want = [9 * md_fit_forwards(timing, n_loader, n_valid_batches, r["rank"] == 0,
                                SP_LOG_IMAGE_ITER) if on_card else 0 for r in run]
    got = [r["launches"] for r in run]
    if got != want:
        raise AssertionError(f"spatial fit: conv launches per rank {got}, expected {want}")
    out = {"crop": SP_TILE, "losses": losses, "one_rank_losses": one_losses, "loss_rel": rel,
           "launches_per_rank": got,
           "steady_train_tiles_per_s": timing["steady_train_tiles_per_sec"],
           "val_iou": [s["metric"] for s in run[0]["saves"]]}
    log(f"  spatial fit at {SP_TILE}^2: losses {[[round(v, 4) for v in p] for p in losses]}, "
        f"worst rel {rel:.2e} to one rank's at the same crop (reported, not held); conv "
        f"launches per rank {got}; steady train tiles/s "
        f"{out['steady_train_tiles_per_s']} (2 ranks sharing the card) [{card}]")
    return out


def run_multi_device(card: str, device="cuda") -> dict:
    """Phase 13: data parallelism on two ranks that share the one card
    (gloo, which carries CUDA tensors; NCCL refuses two ranks on one
    device), NCCL with one rank, a 2-rank fit with the replicated and the
    pod-sharded scene cache and a resume, and ``infer`` over two replicas.
    ``device="cpu"`` rehearses it at a small size
    (tests/test_torch_chip_smoke.py): the ranks are CPU ranks, no kernel
    launches and no device timing then."""
    from floodplanet_code_tpu_torch.inference.sliding import make_replicated_predict_step
    from floodplanet_code_tpu_torch.parallel import launch

    on_card = torch.device(device).type == "cuda"
    dev = str(torch.device(device, 0) if on_card else torch.device("cpu"))
    data_root = os.path.join(WORK, "md_data")
    shutil.rmtree(WORK, ignore_errors=True)
    with Phase("multi-device: write scenes"):
        write_scenes(data_root, TRAIN_SCENES, seed=1)
    ds = build_dataset("floodplanet", "train", generate_image_slice_object(TILE, TILE, stride=TILE),
                       sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0,
                       seed_num=0, train_split_pct=0.8)
    batch = next(iter(BatchLoader(ds, MD_BATCH, shuffle=True, n_workers=8)))
    spec = {"base": BASE, "tile": TILE, "steps": MD_STEPS, "fixed_steps": MD_FIXED_STEPS,
            "seed": 3, "n_valid": MD_BATCH - MD_PAD,
            "batch": {k: batch[k] for k in ("image", "target")}}
    # Phase 14's uneven crop: the same scenes cut at SP_TILE.
    ds_sp = build_dataset("floodplanet", "train",
                          generate_image_slice_object(SP_TILE, SP_TILE, stride=SP_TILE),
                          sensor="PS", channels="ALL", root_dir=data_root, ignore_index=0,
                          seed_num=0, train_split_pct=0.8)
    batch = next(iter(BatchLoader(ds_sp, MD_BATCH, shuffle=True, n_workers=8)))
    spec_sp = dict(spec, tile=SP_TILE, batch={k: batch[k] for k in ("image", "target")},
                   f64=True, matched=os.path.join(WORK, "sp_relu_masks.pt"))
    result = {}
    with Phase("multi-device: one rank"):
        one = md_steps(spec, device)
        one_sp = md_steps(spec_sp, device)
        sync(device)
        if on_card:
            torch.cuda.empty_cache()
    with Phase("multi-device: NCCL, one rank"):
        nccl = md_nccl_one_rank(spec, dev)
    want = "nccl" if on_card else "gloo"
    if nccl["backend"] != want or not math.isfinite(nccl["loss"]):
        raise AssertionError(f"one-rank step: backend {nccl['backend']}, loss {nccl['loss']}")
    result["nccl_one_rank"] = nccl

    # The 2-rank fit on the one device: replicated cache, then a resume to
    # two more epochs through the pod-sharded cache as 2 pods; and the
    # same 2 epochs on one rank.
    exp, exp_one = os.path.join(WORK, "md_exp"), os.path.join(WORK, "md_exp_one")
    exp_sp = os.path.join(WORK, "sp_exp")
    n_valid = len(build_dataset("floodplanet", "valid",
                                generate_image_slice_object(TILE, TILE, stride=TILE),
                                sensor="PS", channels="ALL", root_dir=data_root,
                                ignore_index=0, seed_num=0, train_split_pct=0.8))
    n_loader, n_valid_batches = len(ds) // TRAIN_BATCH, -(-n_valid // TRAIN_BATCH)
    n_valid_sp = len(build_dataset("floodplanet", "valid",
                                   generate_image_slice_object(SP_TILE, SP_TILE, stride=SP_TILE),
                                   sensor="PS", channels="ALL", root_dir=data_root,
                                   ignore_index=0, seed_num=0, train_split_pct=0.8))
    n_loader_sp, n_valid_batches_sp = len(ds_sp) // TRAIN_BATCH, -(-n_valid_sp // TRAIN_BATCH)
    sp_crop = [f"crop_height={SP_TILE}", f"crop_width={SP_TILE}", f"crop_stride={SP_TILE}"]

    def md_cfg(path, epochs, *extra):
        return compose(overrides=fit_overrides(data_root, path, epochs, *extra) + [
            f"limit_train_batches={MD_LIMIT_TRAIN}", f"limit_val_batches={MD_LIMIT_VAL}",
            "tpu.resume_every=1"])

    fit_args = {"exp": exp, "replicated": md_cfg(exp, MD_EPOCHS),
                "pod": md_cfg(exp, 2 * MD_EPOCHS, "tpu.device_cache_shard=pod"),
                "pod_spec": {"tile": TILE, "batch": TRAIN_BATCH, "root": data_root},
                "exp_spatial": exp_sp,
                "spatial": md_cfg(exp_sp, MD_EPOCHS, "tpu.spatial_shards=2",
                                  f"log_image_iter={SP_LOG_IMAGE_ITER}", *sp_crop)}
    with Phase(f"multi-device: two ranks on one device: the steps, a {MD_EPOCHS}-epoch fit "
               f"(replicated cache); spatial partitioning (phase 14): the steps on a 1 x 2 "
               f"data x space mesh at {TILE}^2 and {SP_TILE}^2 and a {MD_EPOCHS}-epoch "
               f"spatial fit at {SP_TILE}^2; the data-parallel fit resumed to {2 * MD_EPOCHS} "
               f"(pod-sharded cache, 2 pods)"):
        t0 = time.perf_counter()
        out = launch.spawn(md_rank, (spec, spec_sp, fit_args), devices=[dev, dev],
                           timeout_s=300, join_timeout_s=900)
        result["spawn_s"] = time.perf_counter() - t0
    result["rank_s"] = out[0]["seconds"]
    log(f"  rank 0: {({k: round(v, 2) for k, v in out[0]['seconds'].items()})} s of "
        f"{result['spawn_s']:.2f} s from spawn to join [{card}]")
    ranks = [r["steps"] for r in out]
    sp_ranks = [r["spatial_steps"] for r in out]
    sp_crop_ranks = [r["spatial_crop_steps"] for r in out]
    fits = {k: [r[k] for r in out] for k in ("replicated", "pod")}
    sp_fit = [r["spatial"] for r in out]
    # The data-parallel step against the one-rank step on the same batch.
    for r in ranks:
        loss_rel = _rel(r["f32_losses"][0], one["f32_losses"][0])
        if not loss_rel <= 1e-4:
            raise AssertionError(f"2-rank f32 loss {r['f32_losses']} vs 1 rank {one['f32_losses']}")
        for name in ("grads", "stats1", "params", "stats"):
            result[f"f32_{name}"] = _md_rel_checks(name, r[name], one[name])
        if any(not torch.equal(r[k][n], ranks[0][k][n]) for k in ("params", "stats")
               for n in r[k]):
            raise AssertionError("the ranks' states differ after the data-parallel steps")
        eval_rel = _rel(r["eval"]["loss"], one["eval"]["loss"])
        cells = np.abs(r["eval"]["confusion"] - one["eval"]["confusion"]).sum() / 2
        if not (eval_rel <= 1e-4 and cells <= 1e-3 * one["eval"]["confusion"].sum()):
            raise AssertionError(f"2-rank eval step: loss rel {eval_rel:.2e}, {cells} pixels moved")
        if not r["bf16_losses"][-1] < r["bf16_losses"][0]:
            raise AssertionError(f"bf16 losses on one batch did not fall: {r['bf16_losses']}")
    result["f32_loss_rel"] = [max(_rel(r["f32_losses"][k], one["f32_losses"][k]) for r in ranks)
                              for k in range(MD_STEPS)]
    result["eval_loss_rel"] = eval_rel
    result["bf16_losses"] = ranks[0]["bf16_losses"]
    result["collectives_per_rank"] = [r["collectives"] for r in ranks]
    # The augment step: the ranks' rows of the globally drawn batch, bit for bit.
    for key in ("image", "target"):
        if not torch.equal(torch.cat([r["augment"][key] for r in ranks]), one["augment"][key]):
            raise AssertionError(f"2-rank augment step: {key} differs from the one-rank step")
    per = MD_BATCH // 2
    expected = {"eval": 9, "f32_steps": 9 * MD_STEPS, "bf16_steps": 9 * MD_FIXED_STEPS,
                "augment": 3}
    if not on_card:
        expected = {k: 0 for k in expected}
    for r in ranks + [one]:
        if r["launches"] != expected:
            raise AssertionError(f"launches {r['launches']}, expected {expected}")
    result["launches_per_rank"] = ranks[0]["launches"]
    result["bn_relu_launches_per_rank"] = ranks[0]["bn_relu_launches"]
    launches = {"bn_relu": sum(sum(r["bn_relu_launches"].values()) for r in ranks),
                "conv": sum(r["launches"][k] for r in ranks for k in
                            ("eval", "f32_steps", "bf16_steps")),
                "shear": sum(r["launches"]["augment"] for r in ranks)}
    if on_card:
        result["bf16_step_ms"] = {"one_rank": one["bf16_step_ms"],
                                  "two_ranks": [r["bf16_step_ms"] for r in ranks]}
        result["all_reduce_ms"] = {k: [r[k] for r in ranks]
                                   for k in ("grad_all_reduce_ms", "bn_all_reduce_ms")}
        log(f"  bf16 step: one rank {one['bf16_step_ms']:.2f} ms per batch of {MD_BATCH}, two "
            f"ranks {[round(r['bf16_step_ms'], 2) for r in ranks]} ms per {per} rows each; "
            f"all-reduce alone (gloo, host clock): gradients "
            f"{[round(r['grad_all_reduce_ms'], 2) for r in ranks]} ms, a BatchNorm's "
            f"{[round(r['bn_all_reduce_ms'], 3) for r in ranks]} ms [{card}]")
    log(f"  2 ranks vs 1 (f32, batch {MD_BATCH} = 2 x {per}): loss rel per step "
        f"{[f'{v:.2e}' for v in result['f32_loss_rel']]}, grads {result['f32_grads']}, params after "
        f"{MD_STEPS} steps {result['f32_params']}, eval loss rel {eval_rel:.2e}; bf16 losses "
        f"{[round(v, 4) for v in result['bf16_losses']]}; augment bit-identical; launches "
        f"per rank {ranks[0]['launches']} [{card}]")
    spatial = sp_step_checks(sp_ranks, one, expected, card, on_card, TILE)
    spatial["crop"] = sp_step_checks(sp_crop_ranks, one_sp, expected, card, on_card, SP_TILE)
    crop_launches = spatial["crop"].pop("launches")
    for kernel in ("bn_relu", "conv", "shear"):
        spatial["launches"][kernel] += crop_launches[kernel]
    if on_card:
        spatial["y_ext_overhead"] = sp_ext_overhead(card)
    del ranks, one, sp_ranks, one_sp, sp_crop_ranks

    timing, timing_pod = fits["replicated"][0]["timing"], fits["pod"][0]["timing"]
    with Phase(f"multi-device: the same {MD_EPOCHS} epochs on one rank, at {TILE}^2 and "
               f"{SP_TILE}^2"):
        with watch_checkpoints() as (saves_one, _):
            train_fit.fit_model(md_cfg(exp_one, MD_EPOCHS), exp_one, device=device)
        exp_one_sp = os.path.join(WORK, "md_exp_one_sp")
        with watch_checkpoints() as (saves_one_sp, _):
            train_fit.fit_model(md_cfg(exp_one_sp, MD_EPOCHS, *sp_crop), exp_one_sp,
                                device=device)
    # Side effects: rank 0's alone; every rank saw every epoch.
    if sorted(os.listdir(exp)) != ["checkpoints", "hydra", "tensorboard_logs", "timing.json"]:
        raise AssertionError(f"the 2-rank experiment holds {sorted(os.listdir(exp))}")
    for name, run in fits.items():
        if run[1]["writes"] != 0 or run[0]["writes"] == 0:
            raise AssertionError(f"{name} fit: checkpoint writes per rank "
                                 f"{[r['writes'] for r in run]}; rank 0 alone must write")
        if run[0]["saves"] != run[1]["saves"] or run[0]["best"] != run[1]["best"]:
            raise AssertionError(f"{name} fit: the ranks saw different epochs or bests")
    # Every rank takes the same update from the same all-reduced gradients:
    # the ranks' final parameters and statistics, bit for bit.
    for name, run in list(fits.items()) + [("spatial", sp_fit)]:
        if run[0]["final_digest"] != run[1]["final_digest"]:
            raise AssertionError(f"{name} fit: the ranks' final states differ "
                                 f"({[r['final_digest'] for r in run]})")
    epochs = [s["epoch"] for r in (fits["replicated"][0], fits["pod"][0]) for s in r["saves"]]
    if epochs != list(range(2 * MD_EPOCHS)):
        raise AssertionError(f"the 2-rank fits ran epochs {epochs}")
    losses = [s["losses"] for r in (fits["replicated"][0], fits["pod"][0]) for s in r["saves"]]
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError(f"non-finite 2-rank fit losses {losses}")
    one_losses = [s["losses"] for s in saves_one]
    # The same global batches and draws: bf16 rounding and the sums' order
    # apart (two ranks sum the gradients and the statistics in another
    # order than one rank), the same epochs.
    fit_rel = max(_rel(a, b) for pa, pb in zip(losses, one_losses) for a, b in zip(pa, pb))
    if not fit_rel <= 3e-2:
        raise AssertionError(f"2-rank fit losses {losses[:MD_EPOCHS]} vs 1 rank {one_losses}")
    pod_batches = [r["pod_batches"] for r in fits["pod"]]
    fit_launches = {}
    for name, run, tm in (("replicated", fits["replicated"], timing), ("pod", fits["pod"], timing_pod)):
        want_l = [9 * md_fit_forwards(tm, n_loader, n_valid_batches, r["rank"] == 0) if on_card
                  else 0 for r in run]
        got_l = [r["launches"] for r in run]
        if got_l != want_l:
            raise AssertionError(f"{name} fit: conv launches per rank {got_l}, expected {want_l}")
        fit_launches[name] = got_l
    launches["conv"] += sum(sum(v) for v in fit_launches.values())
    launches["bn_relu"] += sum(r["bn_relu_launches"] for run in fits.values() for r in run)
    spatial["fit"] = sp_fit_checks(sp_fit, [s["losses"] for s in saves_one_sp], n_loader_sp,
                                   n_valid_batches_sp, card, on_card)
    spatial["launches"]["conv"] += sum(spatial["fit"]["launches_per_rank"])
    spatial["launches"]["bn_relu"] += sum(r["bn_relu_launches"] for r in sp_fit)
    spatial["seconds_per_rank"] = {k: out[0]["seconds"][k]
                                   for k in ("spatial_steps", "spatial_crop_steps",
                                             "fit_spatial")}
    result["spatial"] = spatial
    result["fit"] = {"losses": losses, "one_rank_losses": one_losses, "loss_rel": fit_rel,
                     "final_digests": {k: fits[k][0]["final_digest"] for k in fits},
                     "pod_batches_equal": pod_batches, "launches_per_rank": fit_launches,
                     "steady_train_tiles_per_s": timing["steady_train_tiles_per_sec"],
                     "val_iou": [s["metric"] for r in (fits["replicated"][0], fits["pod"][0])
                                 for s in r["saves"]]}
    log(f"  2-rank fit: epochs {epochs}, losses {[[round(v, 4) for v in p] for p in losses]} "
        f"vs one rank {[[round(v, 4) for v in p] for p in one_losses]} (worst rel "
        f"{fit_rel:.2e}); pod-sharded batches equal the replicated ({pod_batches} per rank); "
        f"conv launches per rank {fit_launches}; steady train tiles/s "
        f"{timing['steady_train_tiles_per_sec']} (2 ranks sharing the card) [{card}]")

    # infer over two replicas on the one device against one device.
    best = fits["pod"][0]["best"]
    cfg = load_experiment_config(exp)
    serve_ds = build_infer_dataset(cfg, "floodplanet", "all")
    model = load_model_for_eval(cfg, best, serve_ds, device)
    batch_size = int(cfg.tpu.inference_batch_size)
    probs, seconds = {}, {}
    for name, step in (("one", None), ("two", make_replicated_predict_step(model, [dev, dev]))):
        sync(device)
        t0 = time.perf_counter()
        probs[name] = {s["image_name"]: s["probabilities"] for s in sliding_window_predict(
            model, serve_ds, batch_size, n_workers=8, device=device, predict_step=step)}
        seconds[name] = time.perf_counter() - t0
    agree = min(float(np.mean(probs["one"][k].argmax(-1) == probs["two"][k].argmax(-1)))
                for k in probs["one"])
    dprob = max(float(np.abs(probs["one"][k] - probs["two"][k]).max()) for k in probs["one"])
    identical = all(np.array_equal(probs["one"][k], probs["two"][k]) for k in probs["one"])
    if not (agree >= 0.999 and dprob <= DPROB_TOL):
        raise AssertionError(f"infer over two replicas: argmax agreement {agree}, |dp| {dprob}")
    with Phase("multi-device: infer over two replicas"):
        sync(device)
        LAUNCHES.clear()  # a main path starts here
        paths = infer(cfg, best, "floodplanet", "all", os.path.join(WORK, "md_masks"),
                      dataset=serve_ds, device=device, devices=[dev, dev])
        sync(device)
        infer_launches = LAUNCHES[conv_fused.KERNEL]  # and ends here
        check_bn_relu_launches("infer over two replicas", {"infer": LAUNCHES[batchnorm.KERNEL]},
                               on_card, False)
        check_masks(paths, TRAIN_SCENES)
    want_infer = 9 * 2 * -(-len(serve_ds) // batch_size) if on_card else 0
    if infer_launches != want_infer:
        raise AssertionError(f"infer over two replicas: {infer_launches} conv launches, "
                             f"expected {want_infer}")
    launches["conv"] += infer_launches
    result["infer"] = {"argmax_agree": agree, "max_dprob": dprob, "bit_identical": identical,
                       "tiles_per_s": {k: len(serve_ds) / v for k, v in seconds.items()},
                       "launches": infer_launches}
    log(f"  infer over two replicas on one device vs one device: argmax agreement {agree}, "
        f"max |dp| {dprob:.2e}, bit-identical {identical}; tiles/s (host clock) one "
        f"{result['infer']['tiles_per_s']['one']:.1f}, two replicas "
        f"{result['infer']['tiles_per_s']['two']:.1f} [{card}]")

    if on_card and torch.cuda.device_count() >= 2:
        cards = ["cuda:0", "cuda:1"]
        with Phase("multi-device: 2-rank fit over NCCL on two cards"):
            exp2 = os.path.join(WORK, "md_exp_nccl")
            run = launch.spawn(md_fit_rank, (md_cfg(exp2, MD_EPOCHS), exp2, None),
                               devices=cards, timeout_s=300, join_timeout_s=900)
        with open(os.path.join(exp2, "timing.json")) as handle:
            result["two_cards"] = {"steady_train_tiles_per_s": json.load(handle)[
                "steady_train_tiles_per_sec"], "losses": [s["losses"] for s in run[0]["saves"]]}
        t0 = time.perf_counter()
        infer(cfg, best, "floodplanet", "all", os.path.join(WORK, "md_masks2"),
              dataset=serve_ds, device=device, devices=cards)
        result["two_cards"]["infer_tiles_per_s"] = len(serve_ds) / (time.perf_counter() - t0)
        log(f"  two cards: {result['two_cards']} [{card}]")
    else:
        log("multi-device: 2-card runs not run "
            f"({torch.cuda.device_count() if on_card else 0} card)")
        result["two_cards"] = None
    check_bn_relu_launches("multi-device", {"data parallel": launches["bn_relu"],
                                            "spatial": spatial["launches"]["bn_relu"]},
                           on_card, True)
    result["launches"] = launches
    shutil.rmtree(WORK, ignore_errors=True)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # References in f32 run in full f32: cuDNN would use TF32 by default.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with Phase("environment"):
        card = card_line()
        log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s)")
        log(f"card: {card}")
    with Phase("build"):
        build_all()
    with Phase("kernel parity"):
        worst = kernel_parity()
    with Phase("kernel timing"):
        rows = kernel_timing(card)
    with Phase("bn_relu parity"):
        bn_worst = bn_relu_parity()
    with Phase("bn_relu timing"):
        bn_rows = bn_relu_timing_apart(card)
    with Phase("slice"):
        result = run_slice(card)
    with Phase("shear parity"):
        shear_worst = shear_parity()
    with Phase("shear timing"):
        shear_row = shear_timing(card)
    with Phase("training"):
        train = run_training(card)
    with Phase("fit"):
        fit = run_fit(card)
    with Phase("evaluation"):
        evaluation = run_evaluation(card, keep_dir=KEEP)
    kept = evaluation.pop("kept")
    with Phase("model tools"):
        tools = run_tools(card)
    with Phase("data tools and options"):
        data_tools = run_data_tools(card)
    with Phase("multi-device"):
        multi = run_multi_device(card)
    with Phase("entry points"):
        entry_points = run_entry_points(card, kept)

    # One forward launches the kernel once per level, so its least time is
    # the sum of the per-level bounds; it is bound by whichever resource
    # bounds the levels that make up most of that sum.
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    t_ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    bn_by_path = {"serving": result["bn_relu_launches"],
                  "training": train["launches"][batchnorm.KERNEL],
                  "fit": sum(fit["bn_relu_launches"].values()),
                  "evaluation": sum(evaluation["bn_relu_launches"].values()),
                  "tools": sum(tools["bn_relu_launches"].values()),
                  "data_tools": sum(data_tools["bn_relu_launches"].values()),
                  "multi_device": multi["launches"]["bn_relu"],
                  "spatial": multi["spatial"]["launches"]["bn_relu"],
                  "entry_points": sum(entry_points["bn_relu_launches"].values())}
    kernels = {"kernels": [{
        "name": conv_fused.KERNEL,
        "route": "cuda",
        "source": "floodplanet_code_tpu_torch/ops/csrc/conv_fused.cu",
        "replaces": "floodplanet_code_tpu/ops/conv_fused.py:95",
        # The main paths: serving (9 per forward), training (9 per
        # train-step forward and per fused eval forward), the fit loop (9
        # per train step, validation batch and image panel, and per serving
        # forward from its best checkpoint), evaluation (9 per forward of
        # predict, the daemon and batch_infer; none on the cuDNN run) and
        # the model tools (9 per forward of the CV fits and validation, the
        # soups, the ensemble, the exported programs, the artifact daemon
        # and the imported models; none on the cuDNN runs), every rank of
        # the multi-device phase, and spatial partitioning (9 per forward
        # of each rank's block, on its rows and its neighbours' edge rows,
        # and per full-height image panel), and bench_torch.py under
        # pallas_fused (9 per forward of its three timings).
        "launches": (result["launches"] + train["launches"][conv_fused.KERNEL]
                     + sum(fit["launches"].values()) + sum(evaluation["launches"].values())
                     + sum(tools["launches"].values())
                     + data_tools["launches"][conv_fused.KERNEL]
                     + multi["launches"]["conv"] + multi["spatial"]["launches"]["conv"]
                     + sum(entry_points["launches"].values())),
        "launches_by_path": {"serving": result["launches"],
                             "training": train["launches"][conv_fused.KERNEL],
                             "fit": sum(fit["launches"].values()),
                             "evaluation": sum(evaluation["launches"].values()),
                             "tools": sum(tools["launches"].values()),
                             # fused_bn=false and the rest: no kernel on the path
                             "data_tools": data_tools["launches"][conv_fused.KERNEL],
                             "multi_device": multi["launches"]["conv"],
                             "spatial": multi["spatial"]["launches"]["conv"],
                             "entry_points": sum(entry_points["launches"].values())},
        # bf16: the parity cases at batch 2 and the nine levels at batch 16.
        "max_abs_err": max(worst[torch.bfloat16][1], *(r["max_abs_err"] for r in rows)),
        "max_rel_err_f32": worst[torch.float32][0],
        "max_rel_err_bf16": worst[torch.bfloat16][0],
        # Times are per forward of one batch of 16 tiles: the sum over the
        # nine levels (per-level rows under "levels").
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "operations" if t_ops >= total["bound_ms"] / 2 else "bytes",
        "library_ms": total["library_ms"],
        "levels": rows,
    }, {
        "name": rotate.KERNEL,
        "route": "cuda",
        "source": "floodplanet_code_tpu_torch/ops/csrc/rotate.cu",
        "replaces": "floodplanet_code_tpu/ops/rotate.py:193",
        # 3 per augment step of the training phase and of each rank's
        # augment step in the multi-device and spatial phases; the
        # data-tools phase's rotations are the roll shear and
        # map_coordinates.
        "launches": (train["launches"][rotate.KERNEL] + data_tools["launches"][rotate.KERNEL]
                     + multi["launches"]["shear"] + multi["spatial"]["launches"]["shear"]),
        "launches_by_path": {"training": train["launches"][rotate.KERNEL],
                             "data_tools": data_tools["launches"][rotate.KERNEL],
                             "multi_device": multi["launches"]["shear"],
                             "spatial": multi["spatial"]["launches"]["shear"]},
        # Parity over both shapes, axes, orders and types, and the timed launch.
        "max_abs_err": max(shear_worst[torch.bfloat16][1], shear_worst[torch.float32][1],
                           shear_row["max_abs_err"]),
        "max_rel_err_f32": shear_worst[torch.float32][0],
        "max_rel_err_bf16": shear_worst[torch.bfloat16][0],
        # Times are per launch at [8, 512, 512, 6] bf16: ms is the kernel's
        # device time from a trace, wrapper_ms the wrapper's time per call
        # (CUDA events); library_ms is one F.grid_sample of the same shear
        # (bilinear on every channel).
        "ms": shear_row["ms"],
        "wrapper_ms": shear_row["wrapper_ms"],
        "launches_per_call": shear_row["launches_per_call"],
        "axis1_ms": shear_row["axis1_ms"],  # the shear along H, trace
        "plain_ms": shear_row["plain_ms"],
        "bound_ms": shear_row["bound_ms"],
        "bound_by": shear_row["bound_by"],
        "library_ms": shear_row["library_ms"],
    }, {
        "name": batchnorm.KERNEL,
        "route": "cuda",
        "source": "floodplanet_code_tpu_torch/ops/csrc/batchnorm.cu",
        "replaces": None,  # bn_relu_train is plain jnp in the JAX package
        # Every train-mode BatchNormReLU forward and backward on the card:
        # 3 launches each (2 + 2 with a group); none in eval mode (serving,
        # evaluation), 54 a train step of the training phase (bn1 of each
        # DoubleConv under pallas_fused), read on each main path.
        "launches": sum(bn_by_path.values()),
        "launches_by_path": bn_by_path,
        # Worst readings per dtype: statistics and sums against their f64
        # sums (of their magnitudes), z and dx against the plain version.
        "parity": bn_worst,
        # Per configuration, one train step's 18 calls forward and backward
        # in bf16: device ms of the kernels, the plain version and
        # F.batch_norm + F.relu; the least time at 10 bytes an element.
        "ms": {k: r["ms"] for k, r in bn_rows.items()},
        "wrapper_ms": {k: r["wrapper_ms"] for k, r in bn_rows.items()},
        "plain_ms": {k: r["plain_ms"] for k, r in bn_rows.items()},
        "bound_ms": {k: r["bound_ms"] for k, r in bn_rows.items()},
        "bound_by": "bytes",
        "library_ms": {k: r["library_ms"] for k, r in bn_rows.items()},
        "steps": bn_rows,
    }]}
    log(json.dumps({"slice": {k: v for k, v in result.items() if k != "launches"}}))
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "launches"}}))
    log(json.dumps({"fit": fit}))
    log(json.dumps({"evaluation": evaluation}))
    log(json.dumps({"tools": tools}))
    log(json.dumps({"data_tools": data_tools}))
    log(json.dumps({"multi_device": {k: v for k, v in multi.items() if k != "launches"}}))
    log(json.dumps({"entry_points": entry_points}))
    log(card)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
