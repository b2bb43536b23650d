#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (unetseg_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with the card and the CUDA
toolkit: `python3 chip_smoke.py`. The phases run in order, each prints
its own line, and any failure raises (non-zero exit):

1. environment: torch, CUDA, nvcc, the card's name and power limit, and
   whether Pillow and matplotlib import;
2. build the kernels of the twenty-three wrappers from the fourteen CUDA sources
   of unetseg_tpu_torch/csrc (one nvcc per source, in parallel) and print
   ptxas's register and spill lines and any wgmma serialization warning;
3. serving-kernel parity at the serving path's full-width shapes (700^2
   tiles, base 64, batch 16): kernel on bf16 inputs against its plain
   version in fp32 (TF32 off) on the same values, plus both times; also
   the serving variants' kernels: enc0_fused, dec_tail, conv3x3_dense
   (tier-2 enc1 conv0, enc1 conv1 + pool, dec2 conv1), dec_conv0_dense
   (dec2 conv0 at offset 40) and conv3x3_cblock (the eleven middle convs
   with output channels a multiple of 128), and the default forward's
   middle stages those leave out (enc1..enc3 conv1 with the pool, up0..up2,
   dec0..dec2 conv0; printed, not in the kernels' JSON). Each case that
   runs the wgmma forward (csrc/conv_fwd_wgmma.cu: every
   conv3x3_bias_relu, conv3x3_dense, conv3x3_cblock, dec_conv0 and
   dec_conv0_dense case with more than one input channel) also prints its
   kernel's and cuDNN's events and torch.profiler device times, kernel /
   cuDNN, its share of the bound and the launch plan's form (im2col or
   windowed) and tile fill. The head conv
   (the wgmma forward's head variant) and the tconv (a streaming wgmma
   GEMM) print one line each: events and device time, the library's (the
   head: cuDNN conv + bias, ReLU and the 1x1 conv, three calls; the tconv:
   F.conv_transpose2d with its bias), the share of the bound and, for the
   head, the tile fill; the stem (the row kernel, CI = 1) prints the same
   line: its events and device time, cuDNN's conv + bias on the same
   tensors and the share of its bytes bound; the fused decoder tail
   (dec_tail_kernel of the wgmma forward's source) prints the same line
   with the wgmma chain dec_conv0 -> conv3x3_head in place of the library,
   its walk and conv0's recompute factor; the fused enc0
   (enc0_fused_kernel of the same source) the same line with the counted
   chain stem -> wgmma conv1 + pool in place of the library, its walk,
   conv1's fill and the stem's recompute factor; two launches at enc4
   conv1, at the dec3 entry, of the head and of the tconv must give the
   same bits; the fused enc0 must equal the stem kernel and the wgmma conv
   chained, and dec_tail the wgmma chain, each bit for bit (any miss
   fails);
4. serving path: Predictor.masks_tiled on 16 seeded synthetic 512^2 cell
   frames at full width, with seeded He-scaled weights, random BatchNorm
   statistics and a planted intensity path (see plant_intensity_path);
   checks the uint8 masks, that its four kernels launched exactly as
   DEFAULT_LAUNCHES says (13, 4, 4, 1 per forward chunk), finite logits,
   and >= 0.999 pixel agreement with the plain fp32 forward on the card,
   and times it with CUDA events beside the plain bf16 forward;
4b. serving variants: Predictor.masks_tiled on the same frames with (a)
   tier2, (b) fused_enc0 with dec_fuse="tail", (c) cblock=("all",), (d)
   all three; checks each one's uint8 masks, finite
   logits, its exact launch counts and >= 0.999 pixel agreement with phase
   4's plain fp32 masks, and times it with CUDA events beside the default
   configuration, alternating which goes first;
5. train-kernel parity at the train step's full-width shapes (batch 4,
   512^2 input): dgrad, wgrad, the decoder-entry wgrad, the elastic
   sampler, and the forward kernels with relu=False; the tier-2 option's
   dense dgrad (enc1 conv0 and conv1, dec2 conv0 into its 256-channel
   concat, dec2 conv1), dense wgrad (enc1 conv0 and conv1, dec2 conv1),
   dense decoder-entry wgrad (skip1 at (41, 41)) and its forward kernels
   with relu=False (conv3x3_dense, dec_conv0_dense); same bound. Each
   multi-channel weight gradient also prints its fraction of the bound
   and cuDNN's time; the stem's (CI = 1, the TMA kernel) the device time
   of its kernel and reduce beside cuDNN's, its share of the bytes bound,
   and the same bits on two launches (a miss fails); two launches at enc0
   conv1 must give the same bits; the
   relu=False forwards print phase 3's wgmma lines, the tconv at the
   train step's up3 (4, 164, 164, 128) phase 3's tconv line and the train
   stem (relu=False) phase 3's stem line; each of the seven dgrads (tier
   1's three, tier 2's four; the wgmma forward's kernels on g read at
   (-2, -2)) prints the same line with conv2d_input beside it, its plan's
   form, and must give the same bits on two launches;
6. train path: make_train_step with the best recipe's options (Adam 3e-4,
   cosine, EMA 0.999, standardize, elastic 2000/20, gamma / illumination /
   noise) on 4 seeded synthetic 512^2 frames with instance labels and
   reference weight maps, full width, at tier 1 and with tier2=True; checks
   each step's exact launch counts (TRAIN_LAUNCHES, TIER2_LAUNCHES), finite
   loss and grad_norm, moved params and EMA; holds one step's gradients
   through either kernel path against the plain path in fp32 beside the
   plain path in bf16; times tier-1, tier-2 and plain bf16 steps the same
   number of times, rotating which goes first, and prints a torch.profiler
   table (top 10 operations) of three steps of each kernel path, with the
   summed device time and the wgmma forward's and the dgrad's parts of it;
6b. the train step's update (update_path): fused_update and fused_ema at
   the full parameter tree with the recipe's Adam and EMA from epoch 40,
   bit for bit against the plain `_foreach` update on the card, grad_norm
   within 1e-6, no host sync; the passes' device times beside the plain
   update's and the bytes bound, the host's time to issue an update, and
   the launches and strided gradients of a recipe step;
6c. the train step's BatchNorm+ReLU (bn_path; alone with `python3
   chip_smoke.py --bn`): bn_relu_fwd and bn_relu_bwd at the recipe step's
   18 shapes (batch 4 at 512^2) against the plain version in bf16 on the
   card (max error over the reference's max), the same bits on a second
   run; the device time of each stage (statistics, finalise, the
   elementwise pass) of the forward and of the backward, summed over the
   18, beside the plain version's, the bytes bound (8 passes) and its
   share; the host's time to issue one step's 18 forwards and backwards;
7. kernel parity of the weighted CE (forward and backward at batch 4,
   324^2 logits, C = 2 and 3, targets and weights read at the 512 -> 324
   crop) and the min-plus product ((32, 512, 512) with either operand
   shared), against their plain versions;
8. preprocess path: weight_map (the preprocess command's dispatcher, paper
   mode on the card) on 8 seeded synthetic 512^2 label frames: 2 min-plus
   launches per frame, within 1e-3 of scipy's weight_map_np, ms per frame
   beside scipy's host time; then a 512^2 frame of 300 instances, more
   than one EDT batch: 4 launches, within 1e-3 of scipy;
9. training loop: train() on 17 synthetic 512^2 frames in memory (16 train
   in 4 steps, 1 val) with the best recipe at full width for 2 epochs,
   then resumed for a third: launches (the weighted CE once per step, every
   train kernel), finite history, both checkpoint streams, the restored
   full state bit for bit, the resume at epoch 2, and Predictor.masks_tiled
   on the restored light checkpoint; ms per step of the epoch feed, ms per
   validation pass and seconds per checkpoint write;
10. sequence path: two light checkpoint directories written by the port's
   checkpoint code (planted full-width params and an EMA shadow from other
   seeds), served as a 4-member ensemble (Predictor.from_checkpoints,
   ema="both") with configs/best_recipe.json's inference settings
   (standardize, flips TTA by vote, members by vote, temporal markers and
   the backward sweep, min_cell_size 1500; 700^2 tiles, tile_batch 16) by
   the in-memory sequence core (Predictor.predict_frames, tiled) on 16
   seeded 512^2 frames whose cells drift 1-3 px a frame, some in touching
   pairs: exact launches (chunks x 4 transforms x 4 members x the four
   serving kernels), uint8 binary masks, uint16 instances none under
   min_cell_size before the grow, >= 0.999 pixel agreement with the same
   ensemble through the plain fp32 forward (TF32 off), the same instances
   on every frame whose mask equals the plain path's bit for bit;
   ms per frame of the device part and of the host post-processing. Then
   device CC: a one-member Predictor.labels_device on the 16 frames at
   image_size 512 equals scipy's labels after compact_labels, bit for bit,
   and a 512^2 spiral converges under the 4096 cap (its iterations
   printed), with ms beside scipy's; from_torch_checkpoint on a
   reference-layout .pth of the planted variables gives their
   probabilities bit for bit; and, where Pillow is installed (phase 1
   says), `python -m unetseg_tpu_torch predict` on TIFFs of the frames
   writes the core's masks;
11. scoring path: (a) a seeded synthetic CTC sequence (ctc_sequence: 20
   512^2 frames of drifting cells, one planted division, one cell that
   leaves the frame; GT labels and man_track.txt rows); (b) the known
   answer: the tracker over the GT labels, relabelled by track id, scores
   SEG = TRA = DET = 1.0 with the native and the python measures (equal
   counts, TRA and every object's SEG within 1e-12) and finds the
   division; (c) the planted net (one member, 700^2 tiles, through the
   kernels: exact launches) segments the frames through the sequence
   core, and its tracked instances are scored by both backends, held to
   each other, printed as the synthetic sequence's numbers with planted
   weights, with the tracker's and each measure's host ms; (d) where
   Pillow imports, the sequence written as a CTC data root and
   `python -m unetseg_tpu_torch pipeline` run in this process with
   configs/best_recipe.json cut to 1 epoch at full width: exit code 0,
   the launches exactly the train steps x TRAIN_LAUNCHES plus the forward
   chunks x 4 TTA transforms x the serving kernels, summary.json's SEG /
   TRA / DET in [0, 1] and equal to the evaluate-ctc command's on the same
   01_CTC directory, 01_CTC/res_track.txt equal to the track command's run
   alone, and the seconds of each stage;
12. data parallelism: two ranks on the one card over gloo (nccl refuses
   two ranks on one card), each a worker process of this script
   (`--dp-worker RANK DIR`): (a) at full width with the best recipe, three
   tier-1 steps, one with valid [T, T, T, F] and one tier-2 step through
   the kernels, and one step through the plain forward in fp32, each from
   the seeded state with its own draws on a global batch of 4 512^2
   frames (2 a rank), held to the single-process batch-4 step on the card
   with the same draws: the fp32 step within 2e-3 relative on loss and
   grad_norm, relative L2 error 1e-2 on every gradient but the pre-BN
   conv biases and 1e-3 of their largest value on the running
   statistics; the bf16 kernel steps no further from the plain fp32 step
   on each of these than max(2 x the single-process kernel step, those
   tolerances) (see DP_NOISE_FACTOR); both ranks' parameters bit for bit
   equal; exact launches (TRAIN_LAUNCHES, TIER2_LAUNCHES or the plain
   step's three a step on each rank) and both steps' wall ms printed
   (information only); (b) Predictor.masks_tiled over the two ranks on
   phase 4's frames: exact launches of each rank's share, uint8 masks
   equal to phase 4's single-rank masks bit for bit (the kernels sum each
   output in one order whatever the batch); (c) where Pillow imports,
   `python -m unetseg_tpu_torch train` twice, joined by --coordinator /
   --num-processes / --process-id, 1 epoch of the best recipe on 8
   synthetic frames: exit codes 0, the same parameter digest on both
   ranks and in rank 0's full checkpoint, no file written by rank 1, and
   the checkpoint served by the Predictor.
13. export and visualize-augmentation: the default serving forward
   exported with a symbolic batch (infer/export.py: torch.export through
   the custom operators of ops/kernels/library.py) at full width with
   phase 4's planted weights and 512^2 frames; loaded in a fresh process
   (which must import neither infer.engine nor train) and in this one,
   and run at batches 1, 2 and 16 of phase 4's frames: exact launches
   (DEFAULT_LAUNCHES a call), the five unetseg operators in the graph,
   probabilities equal to Predictor.probs bit for bit (else the largest
   difference is printed and the masks are held to the 0.999 agreement
   bar), and the artifact's ms beside Predictor.probs's at batch 16,
   alternating (information only); then visualize-augmentation's
   deformation (cli.augmentation_arrays) of one 512^2 frame and its
   labels on the card: one sample_displaced launch, the image within
   SAMPLER_ATOL of the plain sampler on the same uniforms and the labels
   equal, the panel written where matplotlib imports;
14. the benchmark: `python -m unetseg_tpu_torch bench` (the default
   forward and the best-recipe train step) and `python -m
   unetseg_tpu_torch.bench --tier2 --fused-enc0 --dec-fuse tail --cblock
   all` with BENCH_TRAIN=0 (variant (d)), each a subprocess under
   BENCH_TIMEOUT: exit code 0, the last stdout line one JSON object with
   bench.py's keys, value > 0, train_step_ms > 0 (default), SEG null,
   `device` nvidia-smi's line, and the launches the bench printed on
   stderr exactly its forward's kernels a chunk and the nine train
   kernels a step; both lines printed;
15. the flagship reproduction, `bash tools/reproduce_flagship_torch.sh`
   in a subprocess (where Pillow imports) on a synthetic two-sequence CTC
   root (ctc_sequence for 01 and 02, seq 01's weight maps through the
   preprocess command here), with the best recipe cut to CTC_EPOCHS and
   DATA, RUN, EVAL and LATEST in a temporary directory: exit code 0, three
   members' checkpoints (their saved config's seed, finite params), each
   process's launches (UNETSEG_LAUNCH_LOG) exactly its train steps' or
   its ensemble's forward chunks', per sequence the flagship summary equal
   to the evaluate-ctc command on its result directories, the LATEST
   record's SEG equal to the summary's and its provenance naming the
   card, and bench.seg_record reading those numbers back; prints each
   step's wall seconds (the SEG/TRA/DET of this synthetic root check that
   the parts agree, they are not quality).

Every parity case prints the kernel's ms, its plain version's, the one
PyTorch call that computes the same work where there is one (library;
none for the fused enc0 and decoder tail), and the bound: the larger of the case's operations over the card's peak
for their type and its bytes (each input read once, each output written
once) over the memory rate (H100 SXM data sheet: 989 TFLOP/s bf16
dense, 67 TFLOP/s f32, 3.35 TB/s). The min-plus product does no FMA: its
add and its min are one instruction each, at the f32 issue rate of half
the FLOP rate (33.5e12/s). The last two lines are the kernels'
JSON record and {"ok": true, "device": {...}}; the line before them is
nvidia-smi's name and power limit.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from unetseg_tpu_torch import bench
from unetseg_tpu_torch.cli import main as cli
from unetseg_tpu_torch.core import distributed
from unetseg_tpu_torch.core.config import (
    Config, DataConfig, InferConfig, MeshConfig, ModelConfig, TrainConfig,
)
from unetseg_tpu_torch.core.mesh import make_mesh
from unetseg_tpu_torch.data.dataset import HeLaArrays, epoch_index_matrix, train_val_split
from unetseg_tpu_torch.infer.engine import Predictor
from unetseg_tpu_torch.infer.folding import FoldedUNet
from unetseg_tpu_torch.infer.kernel_net import folded_forward_kernels
from unetseg_tpu_torch.infer.tiling import (
    TTA_TRANSFORMS,
    extract_tiles,
    make_tiled_mask_batch_fn,
    min_tile_input,
    mirror_pad,
    plan_tiles,
)
from unetseg_tpu_torch.metrics import ctc
from unetseg_tpu_torch.models.fast_init import fast_random_variables
from unetseg_tpu_torch.models.shapes import unet_shapes
from unetseg_tpu_torch.models.train_forward import train_forward
from unetseg_tpu_torch.models.unet import to_nchw, to_nhwc, unet_train_forward
from unetseg_tpu_torch.ops.elastic import displaced_coords, draw_elastic
from unetseg_tpu_torch.ops.kernels import conv3x3 as K
from unetseg_tpu_torch.ops.kernels import conv3x3_train as KT
from unetseg_tpu_torch.ops.kernels import elastic as KE
from unetseg_tpu_torch.ops.kernels import minplus as KM
from unetseg_tpu_torch.ops.kernels import wce as KW
from unetseg_tpu_torch.ops.kernels.build import build, nvcc_path
from unetseg_tpu_torch.ops.losses import binary_probs_from_logits
from unetseg_tpu_torch.ops.weight_maps import weight_map, weight_map_np
from unetseg_tpu_torch.post.cc import get_instance_masks
from unetseg_tpu_torch.post.cc_device import (
    compact_labels,
    label_components_device,
    propagate_labels,
)
from unetseg_tpu_torch.post.watershed import watershed
from unetseg_tpu_torch.track.ctc_io import read_track_file, relabel_by_track
from unetseg_tpu_torch.track.tracker import CellTrack, Tracker
from unetseg_tpu_torch.train import checkpoint as ckpt
from unetseg_tpu_torch.train.loop import train
from unetseg_tpu_torch.train.state import create_train_state
from unetseg_tpu_torch.train.steps import (
    AugmentDraws,
    draw_augment,
    loss_and_grads,
    make_augmenter,
    make_epoch_eval_step,
    make_epoch_train_step,
    make_train_step,
)
from unetseg_tpu_torch.utils.torch_import import to_reference_state_dict

FRAMES, SIZE = 16, 512
BATCH = 16  # tiles per forward chunk: one 700^2 tile per 512^2 frame
SEED = 0
# Tolerance of a kernel against its fp32 plain version: |k - ref| <=
# ATOL_REL * std(ref) + RTOL * |ref| (+ head slack). The kernels round their
# output to bf16 (relative error <= 2^-9 ~ 2e-3) and sum in another order in
# f32. The head kernel also rounds its 64-channel activation to bf16 before
# the f32 head product, as the bf16 network stores it; the fp32 plain
# version does not, so its logits may differ by up to 2^-9 * sum_c |a_c k_c|
# per pixel: the head's bound adds twice that (HEAD_SLACK * sum |a||k|).
# On an H100 the worst err/bound was 0.34 without the head, and 1.01 for the
# head before the slack term.
RTOL, ATOL_REL = 1e-2, 1e-2
HEAD_SLACK = 2.0**-8
# The fused kernels round their intermediate (the stem activation, conv0's
# output) to bf16 where the chained kernels store it: they are held to the
# fp32 chain with that rounding (fused_reference) within the tolerance
# above, and to the chained kernels bit for bit.
AGREEMENT_BAR = 0.999  # BASELINE.md's bf16 pixel-agreement bar

SOURCES = {
    "conv3x3_bias_relu": ("unetseg_tpu_torch/csrc/conv3x3_bias_relu.cu",
                          "unetseg_tpu/ops/pallas/conv3x3.py:377"),
    "tconv2x2_bias": ("unetseg_tpu_torch/csrc/tconv2x2_bias.cu",
                      "unetseg_tpu/ops/pallas/conv3x3.py:783"),
    "dec_conv0": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                  "unetseg_tpu/ops/pallas/conv3x3.py:893"),
    "conv3x3_head": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                     "unetseg_tpu/ops/pallas/conv3x3.py:540"),
    "conv3x3_dgrad": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                      "unetseg_tpu/ops/pallas/conv3x3_train.py:74"),
    "conv3x3_wgrad": ("unetseg_tpu_torch/csrc/conv3x3_wgrad.cu",
                      "unetseg_tpu/ops/pallas/conv3x3_train.py:197"),
    "conv3x3_dec0_wgrad": ("unetseg_tpu_torch/csrc/conv3x3_wgrad.cu",
                           "unetseg_tpu/ops/pallas/conv3x3_train.py:616"),
    "sample_displaced": ("unetseg_tpu_torch/csrc/sample_displaced.cu",
                         "unetseg_tpu/ops/pallas/elastic.py:103"),
    "weighted_ce_fwd": ("unetseg_tpu_torch/csrc/weighted_ce.cu",
                        "unetseg_tpu/ops/pallas/wce.py:59"),
    "weighted_ce_bwd": ("unetseg_tpu_torch/csrc/weighted_ce.cu",
                        "unetseg_tpu/ops/pallas/wce.py:76"),
    "minplus": ("unetseg_tpu_torch/csrc/minplus.cu", "unetseg_tpu/ops/pallas/minplus.py:47"),
    "conv3x3_dense": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                      "unetseg_tpu/ops/pallas/conv3x3.py:190"),
    "dec_conv0_dense": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                        "unetseg_tpu/ops/pallas/conv3x3.py:1170"),
    "conv3x3_cblock": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                       "unetseg_tpu/ops/pallas/conv_cblock.py:118"),
    "enc0_fused": ("unetseg_tpu_torch/csrc/enc0_fused.cu", "unetseg_tpu/ops/pallas/conv3x3.py:663"),
    "dec_tail": ("unetseg_tpu_torch/csrc/dec_tail.cu", "unetseg_tpu/ops/pallas/conv3x3.py:1026"),
    "conv3x3_dense_dgrad": ("unetseg_tpu_torch/csrc/conv_fwd_wgmma.cu",
                            "unetseg_tpu/ops/pallas/conv3x3_train.py:266"),
    "conv3x3_dense_wgrad": ("unetseg_tpu_torch/csrc/conv3x3_wgrad.cu",
                            "unetseg_tpu/ops/pallas/conv3x3_train.py:370"),
    "conv3x3_dec0_dense_wgrad": ("unetseg_tpu_torch/csrc/conv3x3_wgrad.cu",
                                 "unetseg_tpu/ops/pallas/conv3x3_train.py:852"),
    # the train step's update: no TPU kernel (optax under jit)
    "fused_update": ("unetseg_tpu_torch/csrc/fused_update.cu",
                     "none: optax under jit, unetseg_tpu/train/state.py"),
    "fused_ema": ("unetseg_tpu_torch/csrc/fused_update.cu",
                  "none: optax under jit, unetseg_tpu/train/state.py"),
    # the train step's BatchNorm+ReLU: no TPU kernel (a custom VJP in XLA)
    "bn_relu_fwd": ("unetseg_tpu_torch/csrc/bn_relu.cu",
                    "none: a custom VJP in XLA, unetseg_tpu/ops/fused_bn.py:make_bn_relu_nhwc"),
    "bn_relu_bwd": ("unetseg_tpu_torch/csrc/bn_relu.cu",
                    "none: a custom VJP in XLA, unetseg_tpu/ops/fused_bn.py:make_bn_relu_nhwc"),
}
# launches per forward chunk of the default serving path and of each
# variant (phase 4b): the stem, enc0 conv1 + pool and the 11 middle convs
# (enc1..enc4 and dec0..dec2 conv1, the pools of enc1..enc3 in their
# epilogues) through conv3x3_bias_relu, the four up-convs, the four decoder
# entries, the head; 11 middle convs have CO % 128 == 0, 8 of them from
# enc2 on
DEFAULT_LAUNCHES = {"conv3x3_bias_relu": 13, "tconv2x2_bias": 4, "dec_conv0": 4,
                    "conv3x3_head": 1}
VARIANTS = {
    "a tier2": (dict(tier2=True),
                {"conv3x3_bias_relu": 10, "tconv2x2_bias": 4, "dec_conv0": 3, "conv3x3_head": 1,
                 "conv3x3_dense": 3, "dec_conv0_dense": 1}),
    "b fused_enc0 + tail": (dict(fused_enc0=True, dec_fuse="tail"),
                            {"enc0_fused": 1, "conv3x3_bias_relu": 11, "tconv2x2_bias": 4,
                             "dec_conv0": 3, "dec_tail": 1}),
    "c cblock all": (dict(cblock=("all",)),
                     {"conv3x3_bias_relu": 2, "tconv2x2_bias": 4, "dec_conv0": 4,
                      "conv3x3_head": 1, "conv3x3_cblock": 11}),
    "d all three": (dict(tier2=True, fused_enc0=True, dec_fuse="tail", cblock=("all",)),
                   {"enc0_fused": 1, "conv3x3_dense": 3, "conv3x3_cblock": 8,
                    "dec_conv0_dense": 1, "tconv2x2_bias": 4, "dec_conv0": 2, "dec_tail": 1}),
}
VARIANT_ROUNDS = 2  # timed runs of each variant and the default, alternating
# launches per train step at tier 1 (the stem's dgrad is skipped: the input
# needs no gradient), and with tier2=True: enc1 conv0 / conv1 and dec2
# conv1 through the dense conv, dec2 conv0 through the dense entry, four
# dense dgrads (dec2 conv0's into its concat), three dense wgrads and the
# dense two-source wgrad; the tier-1 wrappers keep their counts. Each of
# the 18 BatchNorms runs bn_relu_fwd and bn_relu_bwd once. Every step of
# the recipe (EMA on) ends in the update: one fused_update, and one
# fused_ema for the parameters' shadow and one for the statistics'
UPDATE_LAUNCHES = {"fused_update": 1, "fused_ema": 2}
TRAIN_LAUNCHES = {"conv3x3_bias_relu": 3, "tconv2x2_bias": 1, "dec_conv0": 1, "conv3x3_dgrad": 3,
                  "conv3x3_wgrad": 3, "conv3x3_dec0_wgrad": 1, "sample_displaced": 1,
                  "weighted_ce_fwd": 1, "weighted_ce_bwd": 1, "bn_relu_fwd": 18,
                  "bn_relu_bwd": 18, **UPDATE_LAUNCHES}
TIER2_LAUNCHES = {**TRAIN_LAUNCHES, "conv3x3_dense": 3, "dec_conv0_dense": 1,
                  "conv3x3_dense_dgrad": 4, "conv3x3_dense_wgrad": 3,
                  "conv3x3_dec0_dense_wgrad": 1}
# the plain forward's step: the elastic sampler, the weighted CE, the update
PLAIN_LAUNCHES = {"sample_displaced": 1, "weighted_ce_fwd": 1, "weighted_ce_bwd": 1,
                  **UPDATE_LAUNCHES}
TRAINING = tuple(TRAIN_LAUNCHES)
PREPROCESS = ("minplus",)
# H100 SXM peaks (data sheet; dense, at the 700 W limit)
PEAK_BF16, PEAK_F32, HBM_BPS = 989e12, 67e12, 3.35e12
# f32 instructions per second: the FLOP rate counts an FMA as two
# (132 SMs x 128 lanes x 1.98 GHz = 33.5e12); FADD and FMNMX issue at
# no more than this
F32_ISSUE = PEAK_F32 / 2

# The train step: batch 4 at 512^2 (TrainConfig.batch_size,
# DataConfig.image_size) with configs/best_recipe.json's options.
TRAIN_BATCH, TRAIN_SIZE, TRAIN_MODEL = 4, 512, ModelConfig()
DEVICE = "cuda"
RECIPE = dict(augment=True, elastic_alpha=2000.0, elastic_sigma=20.0, standardize=True,
              aug_gamma=0.35, aug_illum=0.15, aug_noise=0.05)
RECIPE_TRAIN = TrainConfig(optimizer="adam", learning_rate=3e-4, cosine_decay=True,
                           num_epochs=80, ema_decay=0.999)
STEPS_PER_EPOCH = 38  # 152 training frames / batch 4
SAMPLER_ATOL = 1e-5
# kernel path's gradient error against the fp32 plain path, per tensor:
# at most max(GRAD_FACTOR x the plain bf16 path's error, GRAD_FLOOR)
GRAD_FACTOR, GRAD_FLOOR, LOSS_RTOL = 2.0, 1e-2, 1e-2
TIMING_ROUNDS = 4  # timed runs of each train path, alternating which goes first
# the cases of phases 3 and 5 that run csrc/conv_fwd_wgmma.cu: these wrappers
# with more than one input channel
FWD_KERNELS = ("conv3x3_bias_relu", "conv3x3_dense", "conv3x3_cblock", "dec_conv0",
               "dec_conv0_dense")
# the kernels with a line of their own (the head conv and the tconv on
# wgmma, the dgrad on the wgmma forward's kernels, the stem's row kernel,
# the fused decoder tail and the fused enc0 on the wgmma forward's
# machinery): per kind, the profiler's name of its kernel and what the
# library line times
KERNEL_LINES = {"conv3x3_head": ("conv_fwd_kernel",
                                 "cuDNN conv + bias, ReLU, 1x1 conv: three calls"),
                "tconv2x2_bias": ("tconv2x2_wgmma_kernel", "F.conv_transpose2d with bias"),
                "dgrad": ("conv_dgrad", "conv2d_input"),
                "stem": ("stem_rows_kernel", "cuDNN conv + bias"),
                "dec_tail": ("dec_tail_kernel",
                             "the wgmma chain dec_conv0 -> conv3x3_head: two kernels"),
                "enc0_fused": ("enc0_fused_kernel",
                               "the counted chain stem_rows_kernel -> wgmma conv1 + pool: two "
                               "kernels")}
DGRAD_KERNELS = ("conv3x3_dgrad", "conv3x3_dense_dgrad")
GPU = ""  # nvidia-smi's name and power limit, set by main()
# the weighted CE against its plain version, max |k - ref| / max |ref|:
# both are f32 with the same formula, apart in exp/log implementations and
# operation order (~1e-7 relative); a confident pixel's gradient is a
# difference whose rounding is an ulp of w*g, not of the difference
WCE_RTOL = 1e-5
MINPLUS_K = 32  # instances of one frame: the smallest label bucket
PRE_FRAMES, PRE_SIZE = 8, 512
WMAP_ATOL = 1e-3  # device weight maps against scipy's (tests/test_weight_maps.py)
CROWD_INSTANCES = 300  # more than one EDT batch (ops/weight_maps.py EDT_CHUNK)
LOOP_FRAMES, LOOP_EPOCHS = 17, 2  # train_val_split: 16 train (4 steps of 4), 1 val
# phase 10: the best recipe's inference settings on a sequence cut to one
# forward chunk of frames (a CTC sequence has 84+)
RECIPE_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           "best_recipe.json")
SEQ_FRAMES, SEQ_MODEL = 16, ModelConfig()
# phase 11: a synthetic CTC sequence cut from 84+ frames to 20, GT SEG on
# every 4th frame (the CTC annotates SEG sparsely), and the pipeline
# command with the best recipe cut from 80 epochs to 1
CTC_FRAMES, CTC_SEG_EVERY, CTC_EPOCHS = 20, 4, 1


# phase 12: data parallelism, two ranks on the one card over gloo
# (core/distributed.py: nccl refuses two ranks on one card). Two checks of
# each data-parallel step:
# - exact: both ranks hold the same two items and draws, so every global
#   sum is twice a rank's (exact in floating point) and the step must
#   equal the single-process step on those two items bit for bit (but the
#   running variances, whose unbiasing n / (n - 1) counts four items, and
#   grad_norm, within 1e-6); any
#   fault of the collectives (a sum left out or taken twice, a local
#   normaliser, an average) breaks it;
# - against the single-process batch-4 step on four distinct items with
#   the same draws, by loss and grad_norm (relative), each gradient's
#   relative L2 error (the pre-BN conv biases, true gradient 0, left out
#   as in phase 6), the whole gradient's, and each running statistic's max
#   error over its max. Only the order of float sums differs there, and
#   this random full-width net amplifies it: in fp32 (the plain forward,
#   without cuDNN) the batch split moved enc4.conv0's and enc3.bn0.bias's
#   gradients by 1.9% while grad_norm moved 6.8e-5 (an H100, this script), so
#   the fp32 step gates each quantity but the single tensors at the
#   tolerances; in bf16 (the kernels) the split changes roundings by as
#   much as bf16 itself errs (enc3.conv0: 0.27 from the single step, whose
#   plain bf16 version is 0.48 from fp32), so there each quantity's error
#   against the plain fp32 step may be at most max(DP_NOISE_FACTOR x the
#   single-process kernel step's, the tolerance), as phase 6 holds the
#   kernel path's gradients.
DP_RANKS, DP_STEPS = 2, 3
DP_LOSS_RTOL, DP_GRAD_L2, DP_STATS_RTOL = 2e-3, 1e-2, 1e-3
DP_NOISE_FACTOR = 2.0
DP_CLI_FRAMES = 8  # the train command: 8 frames, no validation split: 2 steps of 4
DP_TIMEOUT = 300
# phase 13: the exported serving function at one whole 512^2 frame per item
EXPORT_SIZE = 512
EXPORT_BATCHES = (1, 2, 16)
EXPORT_ROUNDS = 3  # timed rounds of the artifact and Predictor.probs, alternating
EXPORT_TIMEOUT = 300
AUG_ALPHA, AUG_SIGMA = 2000.0, 20.0  # visualize-augmentation's defaults
# phase 14: the benchmark's two runs (the command, and variant (d) without
# the train step), and the keys of bench.py's line that each must print
BENCH_TIMEOUT = 600
BENCH_RUNS = {
    "default": (["-m", "unetseg_tpu_torch", "bench"], {}, {}),
    "variant d": (["-m", "unetseg_tpu_torch.bench", "--tier2", "--fused-enc0", "--dec-fuse",
                   "tail", "--cblock", "all"], {"BENCH_TRAIN": "0"}, VARIANTS["d all three"][0]),
}
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "seg_seq01", "seg_seq02", "seg_source",
              "device")
BENCH_TRAIN_KEYS = ("train_steps_per_sec", "train_step_ms", "train_step_config")
# phase 15: the flagship script on two synthetic sequences of CTC_FRAMES
# frames, its members trained CTC_EPOCHS epochs
FLAGSHIP_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                               "reproduce_flagship_torch.sh")
FLAGSHIP_MEMBERS = 3
FLAGSHIP_TIMEOUT = 900
# The fresh process of phase 13: loads the artifact with nothing of the
# package but infer/export.py and the custom operators, runs each batch,
# and reports its launches and whether the engine or training was imported
EXPORT_LOADER = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from unetseg_tpu_torch.infer.export import load_exported
from unetseg_tpu_torch.ops.kernels.launches import launch_counts, reset_launch_counts
work, batches = sys.argv[2], json.loads(sys.argv[3])
fn = load_exported(work + "/serving.pt2", device="cuda")
frames = np.load(work + "/frames.npy")
out = {"platforms": list(fn.platforms), "launches": {}}
for b in batches:
    reset_launch_counts()
    p = fn(frames[:b])
    torch.cuda.synchronize()
    out["launches"][str(b)] = {k: v for k, v in launch_counts().items() if v}
    np.save(f"{work}/fresh{b}.npy", p.cpu().numpy())
out["imported"] = sorted(m for m in ("unetseg_tpu_torch.infer.engine", "unetseg_tpu_torch.train")
                         if m in sys.modules)
print(json.dumps(out))
"""


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() in ms, with CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_times(fn, iters=20, warmup=2, tries=3):
    """{kernel name: device ms per call} of the kernels fn() launches, from
    torch.profiler. For kernels of a few microseconds: CUDA events around
    back-to-back launches time the host's launch rate instead. After many
    sessions in one process the profiler can record no device activity: a
    session without any is repeated, up to `tries` times, then fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {e.key: e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
        if sum(times.values()) > 0:
            return times
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} sessions")


def device_ms(fn, iters=20, warmup=2):
    """Summed device time of the kernels fn() launches, per call."""
    return sum(device_times(fn, iters, warmup).values())


def compare(name, got, ref, slack=0.0):
    """Max abs error of a kernel output against its fp32 reference; raises
    when any element is outside the tolerance (plus `slack`)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bound = ATOL_REL * ref.std() + RTOL * ref.abs() + slack
    worst = (err / bound).max().item()
    max_err = err.max().item()
    finite = bool(torch.isfinite(got).all())
    print(f"parity {name}: shape {tuple(got.shape)} max_abs_err {max_err:.3e} "
          f"ref_std {ref.std().item():.3e} worst err/bound {worst:.3f}", flush=True)
    if not finite or worst > 1.0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(finite={finite}, worst err/bound {worst:.3f})")
    return max_err


def he(g, *shape, fan_out):
    """He-scaled f32 weights holding bf16 values, so the kernel (which reads
    weights in bf16) and the fp32 plain version see the same numbers."""
    w = torch.randn(*shape, generator=g, device="cuda") * (2.0 / fan_out) ** 0.5
    return w.to(torch.bfloat16).float()


def head_slack(x, w, b, k_head, b_head):
    """HEAD_SLACK * sum_c |a_c| |k_c| per pixel, a = the fp32 activation."""
    return HEAD_SLACK * abs_conv(K.conv3x3_bias_relu_plain(x, w, b), k_head)


def abs_conv(x, w):
    """sum |w| |x| over each output's window: (NHWC x, OIHW w) -> NHWC."""
    return to_nhwc(F.conv2d(to_nchw(x).abs(), w.abs()))


def fused_reference(kname, args):
    """A fused kernel's fp32 plain chain on the fp32 values of its args,
    with the intermediate rounded to bf16 where the kernel rounds it, and
    the slack of each output."""
    if kname == "enc0_fused":
        x, w0, b0, w1, b1 = args
        h = bf(K.conv3x3_bias_relu_plain(x, w0, b0)).float()
        return K.conv3x3_bias_relu_plain(h, w1, b1, fuse_pool=True), (0.0, 0.0)
    skip, up, w0, b0, w1, b1, k_head, b_head, row_off, col_off = args
    y = bf(K.dec_conv0_plain(skip, up, w0, b0, row_off, col_off)).float()
    return (K.conv3x3_head_plain(y, w1, b1, k_head, b_head),
            (head_slack(y, w1, b1, k_head, b_head),))


def conv_ops(b, ho, wo, ci, co, taps=9):
    """Multiply-adds x 2 of a convolution with (b, ho, wo, co) outputs."""
    return 2 * b * ho * wo * ci * co * taps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def crop_read(skip, up, off, *rest):
    """The tensors a two-source kernel reads: skip only at its crop."""
    hu, wu = up.shape[1], up.shape[2]
    return (skip[:, off:off + hu, off:off + wu], up, *rest)


def new_stats():
    return {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                "bound_ms": 0.0, "bound_by": None, "_ops_ms": 0.0, "_bytes_ms": 0.0}
            for k in SOURCES}


def add_bound(st, ops, peak, n_bytes):
    """Accumulate one case's bound (ms) into a kernel's stats; bound_by
    names whichever limit takes more of the summed bound."""
    t_ops, t_bytes = ops / peak * 1e3, n_bytes / HBM_BPS * 1e3
    st["bound_ms"] += max(t_ops, t_bytes)
    st["_ops_ms" if t_ops >= t_bytes else "_bytes_ms"] += max(t_ops, t_bytes)
    st["bound_by"] = "operations" if st["_ops_ms"] >= st["_bytes_ms"] else "bytes"
    return max(t_ops, t_bytes)


def add_times(st, ms, plain_ms, library_ms):
    st["ms"] += ms
    st["plain_ms"] += plain_ms
    if library_ms is not None:
        st["library_ms"] = (st["library_ms"] or 0.0) + library_ms


def bf(t):
    return t.to(torch.bfloat16)


@torch.inference_mode()
def kernel_parity(sh, c=64):
    """Each kernel at the main path's shapes against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def rand(*shape):
        return bf(torch.rand(*shape, generator=g, device="cuda"))

    def bias(n):
        return 0.1 * torch.randn(n, generator=g, device="cuda")

    s, b = sh.input_size, BATCH
    e0, u = sh.encoder[0], sh.crops[-1]
    off = (e0 - u) // 2
    stem = (rand(b, s, s, 1), he(g, c, 1, 3, 3, fan_out=9 * c), bias(c))
    enc0 = (rand(b, s - 2, s - 2, c), he(g, c, c, 3, 3, fan_out=9 * c), bias(c))
    up3 = (rand(b, u // 2, u // 2, 2 * c), he(g, 2 * c, c, 2, 2, fan_out=4 * c), bias(c))
    dec0 = (rand(b, e0, e0, c), rand(b, u, u, c), he(g, c, 2 * c, 3, 3, fan_out=9 * c), bias(c),
            off, off)
    dec0_cat = torch.cat([dec0[0][:, off:off + u, off:off + u], dec0[1]], -1)
    head = (rand(b, u - 2, u - 2, c), he(g, c, c, 3, 3, fan_out=9 * c), bias(c),
            he(g, 2, c, 1, 1, fan_out=2), bias(2))

    def conv_lib(x, w, bb):
        return lambda: F.conv2d(to_nchw(x), bf(w), bf(bb))

    cases = {
        "stem": ("conv3x3_bias_relu", K.conv3x3_bias_relu, K.conv3x3_bias_relu_plain, stem, {},
                 conv_lib(*stem), conv_ops(b, s - 2, s - 2, 1, c)),
        "enc0_conv1_pool": ("conv3x3_bias_relu", K.conv3x3_bias_relu, K.conv3x3_bias_relu_plain,
                            enc0, {"fuse_pool": True}, conv_lib(*enc0),
                            conv_ops(b, s - 4, s - 4, c, c)),
        "up3": ("tconv2x2_bias", K.tconv2x2_bias, K.tconv2x2_bias_plain, up3, {},
                lambda: F.conv_transpose2d(to_nchw(up3[0]), bf(up3[1]), bf(up3[2]), stride=2),
                conv_ops(b, u // 2, u // 2, 2 * c, c, taps=4)),
        "dec3_conv0": ("dec_conv0", K.dec_conv0, K.dec_conv0_plain, dec0, {},
                       conv_lib(dec0_cat, dec0[2], dec0[3]),
                       (conv_ops(b, u - 2, u - 2, 2 * c, c),
                        nbytes(*crop_read(dec0[0], dec0[1], off, *dec0[2:4])))),
        "dec3_conv1_head": ("conv3x3_head", K.conv3x3_head, K.conv3x3_head_plain, head, {},
                            None, conv_ops(b, u - 4, u - 4, c, c) + conv_ops(b, u - 4, u - 4,
                                                                             c, 2, taps=1)),
    }
    stats = new_stats()
    run_cases(cases, stats, BATCH)

    # ---- the serving variants' kernels at their full-width shapes
    f1 = 2 * c
    p0 = e0 // 2  # pooled enc0 (348 at 700^2)
    e1, d2 = sh.encoder[1], sh.crops[-2]  # skip1 and up2: 344, 264
    off2 = (e1 - d2) // 2  # 40
    enc1 = (rand(b, p0, p0, c), he(g, f1, c, 3, 3, fan_out=9 * f1), bias(f1))
    enc1b = (rand(b, p0 - 2, p0 - 2, f1), he(g, f1, f1, 3, 3, fan_out=9 * f1), bias(f1))
    dec2 = (rand(b, e1, e1, f1), rand(b, d2, d2, f1), he(g, f1, 2 * f1, 3, 3, fan_out=9 * f1),
            bias(f1), off2, off2)
    dec2_cat = torch.cat([dec2[0][:, off2:off2 + d2, off2:off2 + d2], dec2[1]], -1)
    dec2b = (rand(b, d2 - 2, d2 - 2, f1), he(g, f1, f1, 3, 3, fan_out=9 * f1), bias(f1))
    fused0 = (*stem, *enc0[1:])
    tail = (*dec0[:4], *head[1:], off, off)
    dense = ("conv3x3_dense", K.conv3x3_dense, K.conv3x3_bias_relu_plain)
    cases = {
        "enc0_fused": ("enc0_fused", K.enc0_fused, K.enc0_fused_plain, fused0, {}, None,
                       conv_ops(b, s - 2, s - 2, 1, c) + conv_ops(b, s - 4, s - 4, c, c)),
        "dec3_tail": ("dec_tail", K.dec_tail, K.dec_tail_plain, tail, {}, None,
                      (conv_ops(b, u - 2, u - 2, 2 * c, c) + conv_ops(b, u - 4, u - 4, c, c)
                       + conv_ops(b, u - 4, u - 4, c, 2, taps=1),
                       nbytes(*crop_read(dec0[0], dec0[1], off, *tail[2:8])))),
        "enc1_conv0_dense": (*dense, enc1, {}, conv_lib(*enc1), conv_ops(b, p0 - 2, p0 - 2, c, f1)),
        "enc1_conv1_pool_dense": (*dense, enc1b, {"fuse_pool": True}, conv_lib(*enc1b),
                                  conv_ops(b, p0 - 4, p0 - 4, f1, f1)),
        "dec2_conv1_dense": (*dense, dec2b, {}, conv_lib(*dec2b), conv_ops(b, d2 - 4, d2 - 4, f1, f1)),
        "dec2_conv0_dense": ("dec_conv0_dense", K.dec_conv0_dense, K.dec_conv0_plain, dec2, {},
                             conv_lib(dec2_cat, dec2[2], dec2[3]),
                             (conv_ops(b, d2 - 2, d2 - 2, 2 * f1, f1),
                              nbytes(*crop_read(dec2[0], dec2[1], off2, *dec2[2:4])))),
    }
    # cblock: the middle's convs with CO % 128 == 0 (tier 1); enc1 and dec2
    # conv1 reuse the tier-2 cases' inputs, which have their shapes
    cb = ("conv3x3_cblock", K.conv3x3_cblock, K.conv3x3_bias_relu_plain)
    mids = {"enc1c0": enc1, "enc1c1": enc1b, "dec2c1": dec2b}
    for lvl in range(2, len(sh.encoder)):
        n_in, ci, co = sh.encoder[lvl - 1] // 2, c << (lvl - 1), c << lvl
        mids[f"enc{lvl}c0"] = (rand(b, n_in, n_in, ci), he(g, co, ci, 3, 3, fan_out=9 * co), bias(co))
        mids[f"enc{lvl}c1"] = (rand(b, n_in - 2, n_in - 2, co), he(g, co, co, 3, 3, fan_out=9 * co),
                               bias(co))
    for i in range(2):
        n_in, co = sh.crops[i] - 2, c << (3 - i)
        mids[f"dec{i}c1"] = (rand(b, n_in, n_in, co), he(g, co, co, 3, 3, fan_out=9 * co), bias(co))
    for name, args in mids.items():
        x, w = args[0], args[1]
        cases[f"cblock_{name}"] = (*cb, args, {}, conv_lib(*args),
                                   conv_ops(b, x.shape[1] - 2, x.shape[2] - 2, w.shape[1], w.shape[0]))
    run_cases(cases, stats, BATCH)
    # the default forward's middle stages that the cblock cases do not run:
    # enc1..enc3 conv1 with the pool in the epilogue, up0..up2 and the
    # decoder entries dec0..dec2 (the skip at its crop offset); printed,
    # not summed into the kernels' JSON
    cases = {}
    for lvl in range(1, len(sh.encoder) - 1):
        args = mids[f"enc{lvl}c1"]
        x, w = args[0], args[1]
        cases[f"middle_enc{lvl}c1_pool"] = (
            "conv3x3_bias_relu", K.conv3x3_bias_relu, K.conv3x3_bias_relu_plain, args,
            {"fuse_pool": True}, conv_lib(*args),
            conv_ops(b, x.shape[1] - 2, x.shape[2] - 2, w.shape[1], w.shape[0]))
    for i in range(len(sh.crops) - 1):
        u, ci = sh.crops[i], c << (len(sh.encoder) - 1 - i)
        co, es = ci // 2, sh.encoder[-2 - i]
        o = (es - u) // 2
        t = (rand(b, u // 2, u // 2, ci), he(g, ci, co, 2, 2, fan_out=4 * co), bias(co))
        cases[f"middle_up{i}"] = (
            "tconv2x2_bias", K.tconv2x2_bias, K.tconv2x2_bias_plain, t, {},
            lambda t=t: F.conv_transpose2d(to_nchw(t[0]), bf(t[1]), bf(t[2]), stride=2),
            conv_ops(b, u // 2, u // 2, ci, co, taps=4))
        d = (rand(b, es, es, co), rand(b, u, u, co), he(g, co, 2 * co, 3, 3, fan_out=9 * co),
             bias(co), o, o)
        cat = torch.cat([d[0][:, o:o + u, o:o + u], d[1]], -1)
        cases[f"middle_dec{i}_conv0"] = (
            "dec_conv0", K.dec_conv0, K.dec_conv0_plain, d, {}, conv_lib(cat, d[2], d[3]),
            (conv_ops(b, u - 2, u - 2, 2 * co, co), nbytes(*crop_read(d[0], d[1], o, *d[2:4]))))
    run_cases(cases, new_stats(), BATCH)
    del cases
    same_bits("wgmma forward at enc4 conv1 (cblock)", lambda: K.conv3x3_cblock(*mids["enc4c1"]))
    same_bits("wgmma forward at the dec3 entry", lambda: K.dec_conv0(*dec0))
    same_bits("wgmma head conv at dec3 conv1", lambda: K.conv3x3_head(*head))
    same_bits("wgmma tconv at up3", lambda: K.tconv2x2_bias(*up3))
    # enc0_fused sums and rounds in the order of the counted chain, the stem
    # kernel then the wgmma conv with the pool; dec_tail in the order of the
    # wgmma chain dec_conv0 -> conv3x3_head
    chained = K.conv3x3_bias_relu(K.conv3x3_bias_relu(*stem), *enc0[1:], fuse_pool=True)
    wgmma_chain = K.conv3x3_head(K.dec_conv0(*dec0), *head[1:])
    same = {"enc0_fused == stem kernel + wgmma conv chain":
            all(map(torch.equal, K.enc0_fused(*fused0), chained)),
            "dec_tail == wgmma chain": torch.equal(K.dec_tail(*tail), wgmma_chain)}
    print(f"parity fused kernels equal to their chains bit for bit: {same}", flush=True)
    if not all(same.values()):
        raise AssertionError(f"fused kernels differ from their chains: {same}")
    return stats


def f32(*ts):
    """bf16 activations -> f32; weights, biases, offsets as they are."""
    return [t.float() if isinstance(t, torch.Tensor) else t for t in ts]


def run_cases(cases, stats, batch):
    """Each case's kernel against its plain version in fp32 on the same
    values (compare's bound), then the kernel, the plain version and the
    library call (the one cuDNN call of the plain version, on a prepared
    input where the plain version crops or concatenates) timed on the bf16
    tensors, and the case's bound from its operations (bf16 tensor-core
    peak) and bytes (the inputs as given, or `(ops, input bytes)` where a
    kernel reads only part of one); errors, times and bounds accumulate
    per kernel into `stats`."""
    for case, (kname, kernel, plain, args, kw, lib, ops) in cases.items():
        ops, in_bytes = ops if isinstance(ops, tuple) else (ops, nbytes(*args))
        got = kernel(*args, **kw)
        if kname in ("enc0_fused", "dec_tail"):
            ref, slacks = fused_reference(kname, f32(*args))
        else:
            ref = plain(*f32(*args), **kw)
            slacks = (head_slack(*f32(*args)) if kname == "conv3x3_head" else 0.0,) * 2
        torch.cuda.synchronize()
        pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
        err = max(compare(f"{case}[{i}]", a, b, sl)
                  for i, ((a, b), sl) in enumerate(zip(pairs, slacks)))
        out_bytes = nbytes(*(got if isinstance(got, tuple) else (got,)))
        del got, ref, pairs, slacks
        ms = cuda_ms(lambda: kernel(*args, **kw))
        plain_ms = cuda_ms(lambda: plain(*args, **kw))  # same bf16 tensors (cuDNN)
        lib_ms = cuda_ms(lib) if lib is not None else None
        st = stats[kname]
        n_bytes = in_bytes + out_bytes
        bound = add_bound(st, ops, PEAK_BF16, n_bytes)
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.3f}"
        print(f"time {case}: kernel {ms:.3f} ms, plain bf16 {plain_ms:.3f} ms, library {lib_txt} "
              f"ms, bound {bound:.3f} ms ({ops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB; "
              f"batch {batch})", flush=True)
        if case == "wgrad_stem":
            stem_wgrad_line(case, kernel, args, lib, ms, lib_ms, bound)
        elif "wgrad" in kname:
            # events over back-to-back calls time the host where its launch
            # path outlasts the kernels; the profiler's device time does not
            dev, lib_dev = device_ms(lambda: kernel(*args, **kw)), device_ms(lib)
            print(f"wgrad {case}: kernel {ms:.4f} ms, cuDNN {lib_ms:.4f} ms (kernel / cuDNN "
                  f"{ms / lib_ms:.2f}); device time kernel {dev:.4f} ms, cuDNN {lib_dev:.4f} ms "
                  f"(kernel / cuDNN {dev / lib_dev:.2f}); bound {bound:.4f} ms ({bound / ms:.1%} "
                  f"of the bound, {bound / dev:.1%} in device time, {ops / dev / 1e9:.0f} "
                  f"TFLOP/s)", flush=True)
        if kname in FWD_KERNELS and args[0].shape[3] > 1:
            fwd_line(case, kname, kernel, args, kw, lib, ms, lib_ms, bound, ops)
        kind = line_kind(kname, args)
        if kind is not None:
            kernel_line(case, kind, kernel, args, kw, ms, ops, n_bytes)
        st["max_abs_err"] = max(st["max_abs_err"], err)
        add_times(st, ms, plain_ms, lib_ms)


def stem_wgrad_line(case, kernel, args, lib, ms, lib_ms, bound):
    """The stem's weight gradient (CI = 1): device times of the TMA kernel
    and its split-K reduce and of cuDNN's conv2d_weight, each in a profiler
    session of its own; the share of the bound; the same bits on two
    launches (a miss fails). At 0.05-0.16 ms events over back-to-back calls
    can time the host. Both must read g, so a session whose device time
    falls under the bytes bound lost activity (cuDNN once read 0.039 ms
    against its 0.163 by events): it is measured again, up to three
    sessions, and flagged if it stays under."""
    def parts(fn, keep):
        for _ in range(3):
            got = {}
            for k, v in device_times(fn).items():
                if keep(k):
                    name = re.search(r"wgrad_\w+", k).group(0) if "wgrad_" in k else "cuDNN"
                    got[name] = got.get(name, 0.0) + v
            if sum(got.values()) >= bound:
                return got, ""
        return got, " (under the bound in three sessions: the profiler lost activity)"

    ours, ours_note = parts(lambda: kernel(*args), lambda k: "wgrad_" in k)
    lib, lib_note = parts(lib, lambda k: "copy" not in k)
    dev, lib_dev = sum(ours.values()), sum(lib.values())
    if not any("wgrad_stem_tma_kernel" in k for k in ours) or min(dev, lib_dev) <= 0:
        raise AssertionError(f"{case}: a kernel is missing from the profile: {ours}, {lib}")
    first, again = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    print(f"wgrad {case} (TMA kernel, CI = 1): kernel {ms:.4f} ms, cuDNN {lib_ms:.4f} ms by "
          f"events; device time kernel {dev:.4f} ms ("
          f"{', '.join(f'{k} {v:.4f}' for k, v in ours.items())}){ours_note}, cuDNN "
          f"{lib_dev:.4f}{lib_note} (kernel / cuDNN {dev / lib_dev:.2f}); bound {bound:.4f} ms "
          f"by bytes ({bound / dev:.1%} in device "
          f"time, {bound / ms:.1%} by events); two launches equal bit for bit: {same}; on {GPU}",
          flush=True)
    if not same:
        raise AssertionError(f"{case}: two launches on the same inputs differ")


def fwd_line(case, kname, kernel, args, kw, lib, ms, lib_ms, bound, ops):
    """A wgmma-forward case's line: events and device times of the kernel
    and of cuDNN (the wrappers' and the library call's weight and bias
    dtype copies left out of the device times), their ratio, the share of
    the bound and the launch plan's tile fill."""
    def fn():
        return kernel(*args, **kw)

    def both():
        fn(), lib()

    # one profiler session, the two told apart by kernel name
    times = device_times(both)
    dev = sum(v for k, v in times.items() if "conv_fwd" in k)
    lib_dev = sum(v for k, v in times.items() if "copy" not in k and "conv_fwd" not in k)
    if min(dev, lib_dev) <= 0:
        raise AssertionError(f"{case}: a kernel is missing from the profile: {sorted(times)}")
    out = fn()
    bsz, ho, wo, co = (out[0] if isinstance(out, tuple) else out).shape
    plan = K.fwd_plan(bsz, ho, wo, co, torch.cuda.get_device_properties(0).multi_processor_count,
                      pool=kw.get("fuse_pool", False),
                      sources=2 if kname.startswith("dec_conv0") else 1)
    print(f"fwd {case}: kernel {ms:.4f} ms, device {dev:.4f}; cuDNN {lib_ms:.4f}, device "
          f"{lib_dev:.4f}; kernel / cuDNN {dev / lib_dev:.2f} in device time ({ms / lib_ms:.2f} "
          f"by events); {bound / dev:.1%} of the bound in device time ({ops / dev / 1e9:.0f} "
          f"TFLOP/s); {plan.mode} form, tile fill {plan.fill:.3f} (N {plan.n}, {plan.tiles} tiles "
          f"on {plan.grid} blocks)", flush=True)


def line_kind(kname, args):
    """The KERNEL_LINES kind of a case, or None: the head and the tconv by
    wrapper, both dgrad wrappers, the stem (conv3x3_bias_relu or
    conv3x3_dense on one input channel), the fused decoder tail, the fused
    enc0."""
    if kname in ("conv3x3_head", "tconv2x2_bias"):
        return kname
    if kname in DGRAD_KERNELS:
        return "dgrad"
    if kname in ("conv3x3_bias_relu", "conv3x3_dense") and args[0].shape[3] == 1:
        return "stem"
    if kname in ("dec_tail", "enc0_fused"):
        return kname
    return None


def kernel_line(case, kind, kernel, args, kw, ms, ops, n_bytes):
    """A KERNEL_LINES kernel's line (the head conv, the tconv, a dgrad, the
    stem, the decoder tail, the fused enc0): events and device time of the
    kernel and of the library on the same tensors (one profiler session,
    told apart by kernel name; the wrappers' and the library's weight
    copies and flips left out; for the tail the wgmma chain it fuses stands
    in for the library), the bound and its share, for the head the launch
    plan's tile fill, for a dgrad its plan's form, for the stem its strips,
    for the tail its walk and conv0's recompute factor, for the fused enc0
    (the counted chain it fuses standing in for the library) its walk,
    conv1's fill and the stem's recompute factor."""
    mine, lib_name = KERNEL_LINES[kind]
    extra = ""
    if kind == "conv3x3_head":
        x, w, b, kh, bh = args
        wb, bb, khb, bhb = bf(w), bf(b), bf(kh), bf(bh)

        def lib():
            return F.conv2d(F.relu(F.conv2d(to_nchw(x), wb, bb)), khb, bhb)

        bsz, h, wd, _ = x.shape
        plan = K.fwd_plan(bsz, h - 2, wd - 2, 64,
                          torch.cuda.get_device_properties(0).multi_processor_count, head=True)
        extra = f"; tile fill {plan.fill:.3f} ({plan.tiles} tiles on {plan.grid} blocks)"
    elif kind == "tconv2x2_bias":
        x, w, b = args
        wb, bb = bf(w), bf(b)

        def lib():
            return F.conv_transpose2d(to_nchw(x), wb, bb, stride=2)
    elif kind == "dgrad":
        gr, w = args
        wb = bf(w)
        bsz, hg, wg, _ = gr.shape
        ci = w.shape[1]

        def lib():
            return torch.nn.grad.conv2d_input((bsz, ci, hg + 2, wg + 2), wb, to_nchw(gr))

        plan = KT.dgrad_plan(bsz, hg, wg, ci,
                             torch.cuda.get_device_properties(0).multi_processor_count)
        extra = (f"; {plan.mode} form, N {plan.n}, tile fill {plan.fill:.3f} ({plan.tiles} tiles "
                 f"on {plan.grid} blocks)")
    elif kind == "enc0_fused":
        x, w0, b0, w1, b1 = args

        def lib():
            return K.conv3x3_bias_relu(K.conv3x3_bias_relu(x, w0, b0), w1, b1, fuse_pool=True)

        bsz, h, wd, _ = x.shape
        plan = K.enc0_fused_plan(bsz, h - 4, wd - 4,
                                 torch.cuda.get_device_properties(0).multi_processor_count)
        extra = (f"; bands of {K.ENC0_OUT} rows: {plan.nbands} bands x {plan.nj} steps = "
                 f"{plan.steps} steps on {plan.grid} blocks, conv1 fill {plan.fill:.3f}, stem "
                 f"recompute {plan.recompute:.3f}")
    elif kind == "dec_tail":
        skip, up, w0, b0, w1, b1, kh, bh, row_off, col_off = args

        def lib():
            return K.conv3x3_head(K.dec_conv0(skip, up, w0, b0, row_off, col_off), w1, b1, kh, bh)

        plan = K.dec_tail_plan(up.shape[0], up.shape[1] - 4, up.shape[2] - 4,
                               torch.cuda.get_device_properties(0).multi_processor_count)
        extra = (f"; bands of {K.TAIL_OUT} rows: {plan.nbands} bands x {plan.nj} steps = "
                 f"{plan.steps} steps on {plan.grid} blocks, conv0 recompute "
                 f"{plan.recompute:.3f}")
    else:
        x, w, b = args
        wb, bb = bf(w), bf(b)

        def lib():
            return F.conv2d(to_nchw(x), wb, bb)

        bsz, h, wd, _ = x.shape
        plan = K.stem_plan(bsz, h - 2, wd - 2, w.shape[0],
                           torch.cuda.get_device_properties(0).multi_processor_count)
        extra = f"; {plan.strips} strips on {plan.grid} blocks"

    lib_ms = cuda_ms(lib)
    times = device_times(lambda: (kernel(*args, **kw), lib()))
    dev = sum(v for k, v in times.items() if mine in k)
    lib_dev = sum(v for k, v in times.items()
                  if "copy" not in k and "flip" not in k and mine not in k)
    if min(dev, lib_dev) <= 0:
        raise AssertionError(f"{case}: a kernel is missing from the profile: {sorted(times)}")
    t_ops, t_bytes = ops / PEAK_BF16 * 1e3, n_bytes / HBM_BPS * 1e3
    bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
    print(f"{kind} {case}: kernel {ms:.4f} ms, device {dev:.4f}; library ({lib_name}) "
          f"{lib_ms:.4f} ms, device {lib_dev:.4f} (kernel / library {dev / lib_dev:.2f} in "
          f"device time); bound "
          f"{bound:.4f} ms by {by} ({ops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB): "
          f"{bound / dev:.1%} of it in device time, {bound / ms:.1%} by events "
          f"({ops / dev / 1e9:.0f} TFLOP/s, {n_bytes / dev / 1e6:.0f} GB/s){extra}; on {GPU}",
          flush=True)


def same_bits(name, fn):
    """Two launches of fn on the same inputs give the same bits."""
    first, again = fn(), fn()
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    print(f"repeatability {name}: two launches equal bit for bit: {same}", flush=True)
    if not same:
        raise AssertionError(f"{name}: two launches on the same inputs differ")


def cell_frames(rs, n, size, labels=False):
    """Synthetic frames: 15-30 bright elliptic cells (0.70) on a dark
    background (0.25), plus Gaussian noise of std 0.05. With labels, also
    the int32 instance labels (cell k is k + 1; a later cell overwrites an
    earlier one where they overlap)."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    frames, labs = [], []
    for _ in range(n):
        cells = np.zeros((size, size), bool)
        lab = np.zeros((size, size), np.int32)
        for k in range(rs.randint(15, 31)):
            cy, cx = rs.uniform(0, size, 2)
            ry, rx = rs.uniform(15, 45, 2)
            th = rs.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = (dy * np.cos(th) + dx * np.sin(th)) / ry
            v = (dx * np.cos(th) - dy * np.sin(th)) / rx
            inside = u * u + v * v < 1
            cells |= inside
            lab[inside] = k + 1
        img = 0.25 + 0.45 * cells + 0.05 * rs.standard_normal((size, size))
        frames.append(np.clip(img, 0.0, 1.0))
        labs.append(lab)
    frames = np.stack(frames).astype(np.float32)
    return (frames, np.stack(labs)) if labels else frames


def plant_intensity_path(variables, gain=20.0, level=0.475, head_scale=0.05):
    """A seeded stand-in for a trained model. Channel 0 of every encoder
    and decoder block carries the input intensity unchanged (a centre tap
    of 1 from input channel 0, BatchNorm the identity on it), and the head
    thresholds it at `level` (margin gain * (I - level)) beside the random
    head weights scaled by `head_scale`. Every other weight stays random
    at full width. A purely random net puts its masks at 1-3% or 90+%
    foreground with a dense band of logits at the threshold, where bf16
    rounding alone flips 0.1-0.25% of the pixels in either bf16 path;
    this net's masks follow the cells with a margin, as a trained model's
    do, so the pixel-agreement bar tests the kernels and not the band."""
    p, st = variables["params"], variables["batch_stats"]
    for name, block in p.items():
        if not name.startswith(("enc", "dec")):
            continue
        for i in (0, 1):
            k = block[f"conv{i}"]["kernel"]  # (3, 3, CI, CO)
            k[..., 0] = 0.0
            k[1, 1, 0, 0] = 1.0
            block[f"conv{i}"]["bias"][0] = 0.0
            block[f"bn{i}"]["scale"][0], block[f"bn{i}"]["bias"][0] = 1.0, 0.0
            st[name][f"bn{i}"]["mean"][0], st[name][f"bn{i}"]["var"][0] = 0.0, 1.0
    ko = p["outc"]["kernel"]  # (1, 1, 64, 2)
    ko *= head_scale
    ko[0, 0, 0] = (-gain / 2, gain / 2)
    p["outc"]["bias"][:] = (gain * level / 2, -gain * level / 2)
    return variables


@torch.inference_mode()
def main_path(gpu):
    """Predictor.masks_tiled at full width through the kernels. Returns the
    launches, and what phase 4b reuses: the Predictor, its variables, the
    frames and the plain fp32 forward's masks."""
    cfg = ModelConfig()
    variables = plant_intensity_path(fast_random_variables(cfg, SEED))
    frames = cell_frames(np.random.RandomState(SEED), FRAMES, SIZE)
    tile = min_tile_input(SIZE)
    pred = Predictor(cfg, variables, InferConfig(tile_input=tile, tile_batch=BATCH), "cuda")
    if not pred.uses_kernels:
        raise AssertionError("Predictor did not select the kernel forward")

    pred.masks_tiled(frames)  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()
    K.reset_launch_counts()
    masks = pred.masks_tiled(frames)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"main path: masks {masks.shape} {masks.dtype}, launches {launches}", flush=True)
    if masks.shape != (FRAMES, SIZE, SIZE) or masks.dtype != np.uint8:
        raise AssertionError(f"masks {masks.shape} {masks.dtype}")
    if set(np.unique(masks)) - {0, 1}:
        raise AssertionError("masks are not binary")
    grid = plan_tiles(SIZE, SIZE, tile)
    check_launches("main path", launches, DEFAULT_LAUNCHES, chunks(grid))

    x = torch.from_numpy(frames).cuda()
    tiles = extract_tiles(mirror_pad(x, grid), grid).reshape(-1, tile, tile)
    logits = folded_forward_kernels(pred.folded, tiles[..., None])
    o = unet_shapes(tile).output_size
    if logits.shape != (FRAMES, o, o, 2) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"logits {tuple(logits.shape)} not finite or misshapen")
    # the plain forward in fp32 (TF32 off) is the reference the masks are
    # held to; the plain bf16 forward is reported beside it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ref32 = FoldedUNet(dataclasses.replace(cfg, compute_dtype="float32")).cuda()
    ref32.load_state_dict(pred.folded.state_dict())
    fns = {
        name: make_tiled_mask_batch_fn(
            lambda c, net=net: binary_probs_from_logits(net(c[..., None])), grid,
            n_frames=FRAMES, threshold=pred.cfg.threshold, tile_batch=BATCH,
        )
        for name, net in (("fp32", ref32), ("bf16", pred.folded))
    }
    plain = {name: fn(x).cpu().numpy() for name, fn in fns.items()}
    l32 = ref32(tiles[..., None])
    l16 = pred.folded(tiles[..., None])
    margin32 = (l32[..., 1] - l32[..., 0]).abs()

    def rel(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.std()).item()

    print(f"main path: logits rms difference / std: kernel vs fp32 {rel(logits, l32):.3e}, "
          f"plain bf16 vs fp32 {rel(l16, l32):.3e}; fp32 |logit margin| < 1e-2 at "
          f"{float((margin32 < 1e-2).float().mean()):.5f} of pixels", flush=True)
    agreement = float((plain["fp32"] == masks).mean())
    agree16 = float((plain["bf16"] == masks).mean())
    agree16_32 = float((plain["bf16"] == plain["fp32"]).mean())
    print(f"main path: foreground fraction {float(masks.mean()):.4f} "
          f"(plain fp32 {float(plain['fp32'].mean()):.4f}); pixel agreement with the plain "
          f"fp32 forward {agreement:.6f}, with the plain bf16 forward {agree16:.6f} "
          f"(plain bf16 vs fp32 {agree16_32:.6f})", flush=True)
    if agreement < AGREEMENT_BAR:
        raise AssertionError(f"agreement {agreement:.6f} < {AGREEMENT_BAR}")
    plain_fn = fns["bf16"]

    ms = cuda_ms(lambda: pred.masks_tiled(frames), iters=5, warmup=1)
    plain_ms = cuda_ms(lambda: plain_fn(x), iters=5, warmup=1)
    mpix = FRAMES * SIZE * SIZE / 1e6 / (ms / 1e3)
    print(f"main path: {ms:.2f} ms per {FRAMES} frames = {mpix:.2f} MPix/s "
          f"(plain bf16 forward: {plain_ms:.2f} ms = "
          f"{FRAMES * SIZE * SIZE / 1e6 / (plain_ms / 1e3):.2f} MPix/s) on {gpu}", flush=True)
    return launches, dict(pred=pred, variables=variables, frames=frames, ref_masks=plain["fp32"],
                          masks=masks)


def chunks(grid):
    """Forward chunks of one masks_tiled call on FRAMES frames."""
    return -(-FRAMES * grid.ny * grid.nx // BATCH)


def check_launches(name, launches, per_chunk, n_chunks):
    """The wrappers that launched, and how often, must be exactly per_chunk
    times the number of forward chunks."""
    ran = {k: v for k, v in launches.items() if v}
    want = {k: v * n_chunks for k, v in per_chunk.items()}
    if ran != want:
        raise AssertionError(f"{name}: launches {ran}, expected {want}")


@torch.inference_mode()
def variants_path(gpu, main):
    """Phase 4b: Predictor.masks_tiled with each serving variant on the
    main path's frames and variables; launches, masks, logits, agreement
    with the plain fp32 masks of phase 4, times beside the default."""
    cfg, frames, default = ModelConfig(), main["frames"], main["pred"]
    tile = default.cfg.tile_input
    grid = plan_tiles(SIZE, SIZE, tile)
    x = torch.from_numpy(frames).cuda()
    tiles = extract_tiles(mirror_pad(x, grid), grid).reshape(-1, tile, tile)
    o = unet_shapes(tile).output_size
    total = {k: 0 for k in SOURCES}
    for name, (opts, per_chunk) in VARIANTS.items():
        pred = Predictor(cfg, main["variables"], default.cfg, "cuda", **opts)
        pred.masks_tiled(frames)  # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        masks = pred.masks_tiled(frames)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        check_launches(f"variant {name}", launches, per_chunk, chunks(grid))
        for k, v in launches.items():
            total[k] += v
        if (masks.shape != (FRAMES, SIZE, SIZE) or masks.dtype != np.uint8
                or set(np.unique(masks)) - {0, 1}):
            raise AssertionError(f"variant {name}: masks {masks.shape} {masks.dtype} not binary")
        logits = folded_forward_kernels(pred.folded, tiles[..., None], **pred.options)
        if logits.shape != (FRAMES, o, o, 2) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"variant {name}: logits {tuple(logits.shape)} not finite")
        agreement = float((main["ref_masks"] == masks).mean())
        times = {"default": [], name: []}
        for r in range(VARIANT_ROUNDS):
            for k, p in ((("default", default), (name, pred)) if r % 2 == 0
                         else ((name, pred), ("default", default))):
                times[k].append(cuda_ms(lambda p=p: p.masks_tiled(frames), iters=3, warmup=1))
        ms = {k: float(np.median(v)) for k, v in times.items()}
        runs = "; ".join(f"{k} " + ", ".join(f"{t:.2f}" for t in v) for k, v in times.items())
        print(f"variant {name}: launches {per_chunk} per chunk, foreground "
              f"{float(masks.mean()):.4f}, pixel agreement with the plain fp32 forward "
              f"{agreement:.6f}; {ms[name]:.2f} ms = "
              f"{FRAMES * SIZE * SIZE / 1e6 / (ms[name] / 1e3):.2f} MPix/s, default "
              f"{ms['default']:.2f} ms = {FRAMES * SIZE * SIZE / 1e6 / (ms['default'] / 1e3):.2f}"
              f" MPix/s (ms per call, runs of 3 alternating: {runs}) on {gpu}", flush=True)
        if agreement < AGREEMENT_BAR:
            raise AssertionError(f"variant {name}: agreement {agreement:.6f} < {AGREEMENT_BAR}")
        del pred, logits
    return total


@torch.inference_mode()
def train_kernel_parity(stats, c=64):
    """The train step's kernels at its full-width shapes (batch 4, 512^2
    input) against their plain versions, plus the forward kernels with
    relu=False; tier 1's, then the tier-2 option's at enc1 and dec2."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sh = unet_shapes(TRAIN_SIZE)
    b, s = TRAIN_BATCH, TRAIN_SIZE
    e0, up_w = sh.encoder[0], sh.crops[-1]
    off = (e0 - up_w) // 2

    def act(*shape):
        return torch.rand(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def grad(*shape):  # output gradients have both signs
        return (torch.rand(*shape, generator=g, device="cuda") - 0.5).to(torch.bfloat16)

    def bias(n):
        return 0.1 * torch.randn(n, generator=g, device="cuda")

    w64, w128 = he(g, c, c, 3, 3, fan_out=9 * c), he(g, c, 2 * c, 3, 3, fan_out=9 * c)
    u = up_w
    dg = ("conv3x3_dgrad", KT.conv3x3_dgrad, KT.conv3x3_dgrad_plain)
    wg = ("conv3x3_wgrad", KT.conv3x3_wgrad, KT.conv3x3_wgrad_plain)
    fw = ("conv3x3_bias_relu", K.conv3x3_bias_relu, K.conv3x3_bias_relu_plain)
    nr = {"relu": False}

    def dgrad(gr, w):  # (args, library call, operations)
        bb, hg, wgd, co = gr.shape
        ci = w.shape[1]
        return ((gr, w), lambda: torch.nn.grad.conv2d_input((bb, ci, hg + 2, wgd + 2), bf(w),
                                                             to_nchw(gr)),
                conv_ops(bb, hg, wgd, ci, co))

    def wgrad(x, gr):
        co, ci = gr.shape[3], x.shape[3]
        return ((x, gr), lambda: torch.nn.grad.conv2d_weight(to_nchw(x), (co, ci, 3, 3),
                                                             to_nchw(gr)),
                conv_ops(b, gr.shape[1], gr.shape[2], ci, co))

    def fwd(x, w, bb):
        return ((x, w, bb), lambda: F.conv2d(to_nchw(x), bf(w), bf(bb)),
                conv_ops(b, x.shape[1] - 2, x.shape[2] - 2, w.shape[1], w.shape[0]))

    skip, up, b_dec0 = act(b, e0, e0, c), act(b, u, u, c), bias(c)
    cat = torch.cat([skip[:, off:off + u, off:off + u], up], -1)
    up3 = (act(b, u // 2, u // 2, 2 * c), he(g, 2 * c, c, 2, 2, fan_out=4 * c), bias(c))
    g_dec0 = grad(b, u - 2, u - 2, c)
    cases = {
        "dgrad_enc0_conv1": (*dg, *dgrad(grad(b, s - 4, s - 4, c), w64)),
        "dgrad_dec3_conv1": (*dg, *dgrad(grad(b, u - 4, u - 4, c), w64)),
        "dgrad_dec3_conv0": (*dg, *dgrad(grad(b, u - 2, u - 2, c), w128)),
        "wgrad_stem": (*wg, *wgrad(act(b, s, s, 1), grad(b, s - 2, s - 2, c))),
        "wgrad_enc0_conv1": (*wg, *wgrad(act(b, s - 2, s - 2, c), grad(b, s - 4, s - 4, c))),
        "wgrad_dec3_conv1": (*wg, *wgrad(act(b, u - 2, u - 2, c), grad(b, u - 4, u - 4, c))),
        "dec0_wgrad_dec3_conv0": (
            "conv3x3_dec0_wgrad", KT.conv3x3_dec0_wgrad, KT.conv3x3_dec0_wgrad_plain,
            (skip, up, g_dec0, off, off),
            lambda: torch.nn.grad.conv2d_weight(to_nchw(cat), (c, 2 * c, 3, 3), to_nchw(g_dec0)),
            (conv_ops(b, u - 2, u - 2, 2 * c, c), nbytes(*crop_read(skip, up, off, g_dec0)))),
        "stem_relu_false": (*fw, *fwd(act(b, s, s, 1), he(g, c, 1, 3, 3, fan_out=9 * c),
                                      bias(c))),
        "enc0_conv1_relu_false": (*fw, *fwd(act(b, s - 2, s - 2, c), w64, bias(c))),
        "dec3_conv0_relu_false": (
            "dec_conv0", K.dec_conv0, K.dec_conv0_plain, (skip, up, w128, b_dec0, off, off),
            lambda: F.conv2d(to_nchw(cat), bf(w128), bf(b_dec0)),
            (conv_ops(b, u - 2, u - 2, 2 * c, c), nbytes(*crop_read(skip, up, off, w128, b_dec0)))),
        "dec3_conv1_relu_false": (*fw, *fwd(act(b, u - 2, u - 2, c), w64, bias(c))),
        "up3_train": ("tconv2x2_bias", K.tconv2x2_bias, K.tconv2x2_bias_plain, up3,
                      lambda: F.conv_transpose2d(to_nchw(up3[0]), bf(up3[1]), bf(up3[2]), stride=2),
                      conv_ops(b, u // 2, u // 2, 2 * c, c, taps=4)),
    }
    # tier 2: enc1 on the pooled enc0 (254^2, 64 -> 128 -> 128), dec2 on
    # up2 (168^2) and skip1 (250^2) read at (41, 41), 256 -> 128 -> 128
    f1 = 2 * c
    p0, e1, d2 = e0 // 2, sh.encoder[1], sh.crops[-2]
    off2 = (e1 - d2) // 2
    w_e10, w_f1 = he(g, f1, c, 3, 3, fan_out=9 * f1), he(g, f1, f1, 3, 3, fan_out=9 * f1)
    w_d20 = he(g, f1, 2 * f1, 3, 3, fan_out=9 * f1)
    ddg = ("conv3x3_dense_dgrad", KT.conv3x3_dense_dgrad, KT.conv3x3_dgrad_plain)
    dwg = ("conv3x3_dense_wgrad", KT.conv3x3_dense_wgrad, KT.conv3x3_wgrad_plain)
    dfw = ("conv3x3_dense", K.conv3x3_dense, K.conv3x3_bias_relu_plain)
    skip1, up2, b_d20 = act(b, e1, e1, f1), act(b, d2, d2, f1), bias(f1)
    cat2 = torch.cat([skip1[:, off2:off2 + d2, off2:off2 + d2], up2], -1)
    g_d20 = grad(b, d2 - 2, d2 - 2, f1)
    cases.update({
        "dense_dgrad_enc1_conv0": (*ddg, *dgrad(grad(b, p0 - 2, p0 - 2, f1), w_e10)),
        "dense_dgrad_enc1_conv1": (*ddg, *dgrad(grad(b, p0 - 4, p0 - 4, f1), w_f1)),
        "dense_dgrad_dec2_conv0": (*ddg, *dgrad(g_d20, w_d20)),
        "dense_dgrad_dec2_conv1": (*ddg, *dgrad(grad(b, d2 - 4, d2 - 4, f1), w_f1)),
        "dense_wgrad_enc1_conv0": (*dwg, *wgrad(act(b, p0, p0, c), grad(b, p0 - 2, p0 - 2, f1))),
        "dense_wgrad_enc1_conv1": (*dwg, *wgrad(act(b, p0 - 2, p0 - 2, f1),
                                                grad(b, p0 - 4, p0 - 4, f1))),
        "dense_wgrad_dec2_conv1": (*dwg, *wgrad(act(b, d2 - 2, d2 - 2, f1),
                                                grad(b, d2 - 4, d2 - 4, f1))),
        "dec0_dense_wgrad_dec2_conv0": (
            "conv3x3_dec0_dense_wgrad", KT.conv3x3_dec0_dense_wgrad,
            KT.conv3x3_dec0_wgrad_plain, (skip1, up2, g_d20, off2, off2),
            lambda: torch.nn.grad.conv2d_weight(to_nchw(cat2), (f1, 2 * f1, 3, 3),
                                                to_nchw(g_d20)),
            (conv_ops(b, d2 - 2, d2 - 2, 2 * f1, f1),
             nbytes(*crop_read(skip1, up2, off2, g_d20)))),
        "enc1_conv0_dense_relu_false": (*dfw, *fwd(act(b, p0, p0, c), w_e10, bias(f1))),
        "enc1_conv1_dense_relu_false": (*dfw, *fwd(act(b, p0 - 2, p0 - 2, f1), w_f1, bias(f1))),
        "dec2_conv0_dense_relu_false": (
            "dec_conv0_dense", K.dec_conv0_dense, K.dec_conv0_plain,
            (skip1, up2, w_d20, b_d20, off2, off2),
            lambda: F.conv2d(to_nchw(cat2), bf(w_d20), bf(b_d20)),
            (conv_ops(b, d2 - 2, d2 - 2, 2 * f1, f1),
             nbytes(*crop_read(skip1, up2, off2, w_d20, b_d20)))),
        "dec2_conv1_dense_relu_false": (*dfw, *fwd(act(b, d2 - 2, d2 - 2, f1), w_f1, bias(f1))),
    })
    for k, v in cases.items():  # the relu flag rides in the kwargs slot
        cases[k] = (*v[:4], nr if k.endswith("relu_false") else {}, *v[4:])
    run_cases(cases, stats, b)
    for case, (kname, kernel, _, args, *_) in cases.items():
        if kname in DGRAD_KERNELS:  # no atomics, a fixed summation order
            same_bits(f"dgrad {case}", lambda kernel=kernel, args=args: kernel(*args))
    # split-K sums its chunks in a fixed order: a second launch repeats the bits
    x_rep, g_rep = cases["wgrad_enc0_conv1"][3]
    first, again = KT.conv3x3_wgrad(x_rep, g_rep), KT.conv3x3_wgrad(x_rep, g_rep)
    torch.cuda.synchronize()
    same = torch.equal(first, again)
    print(f"wgrad repeatability: two launches at enc0 conv1 {tuple(g_rep.shape)} equal bit for "
          f"bit: {same}", flush=True)
    if not same:
        raise AssertionError("conv3x3_wgrad: two launches on the same inputs differ")
    del first, again

    # the elastic sampler: real recipe fields on synthetic cell frames
    frames, labels = cell_frames(np.random.RandomState(SEED + 2), b, s, labels=True)
    images, masks = torch.from_numpy(frames).cuda(), torch.from_numpy(labels).cuda()
    yy, xx = displaced_coords(draw_elastic(g, b, s, s, "cuda"), RECIPE["elastic_alpha"],
                              RECIPE["elastic_sigma"])
    img, mask = KE.sample_displaced(images, masks, yy, xx)
    ref_img, ref_mask = KE.sample_displaced_plain(images, masks, yy, xx)
    torch.cuda.synchronize()
    err = (img - ref_img).abs().max().item()
    exact = bool(torch.equal(mask, ref_mask))
    print(f"parity sample_displaced: shape {tuple(img.shape)} image max_abs_err {err:.3e} "
          f"(bound {SAMPLER_ATOL:g}), masks exact: {exact}; max |displacement| "
          f"{(yy - torch.arange(s, device='cuda')[None, :, None]).abs().max().item():.1f} px",
          flush=True)
    if not (err <= SAMPLER_ATOL and exact and bool(torch.isfinite(img).all())):
        raise AssertionError("sample_displaced disagrees with its plain version")
    kern = lambda: KE.sample_displaced(images, masks, yy, xx)  # noqa: E731
    event_ms = cuda_ms(kern)
    ms = device_ms(kern)
    plain_ms = device_ms(lambda: KE.sample_displaced_plain(images, masks, yy, xx))
    st = stats["sample_displaced"]
    # per pixel: image, mask, yy, xx read, image and mask written (4 bytes each)
    bound = add_bound(st, 0, PEAK_F32, nbytes(images, masks, yy, xx, img, mask))
    print(f"time sample_displaced (device time, torch.profiler): kernel {ms:.4f} ms (CUDA "
          f"events over back-to-back launches: {event_ms:.4f}), plain {plain_ms:.3f} ms, "
          f"library none (no one PyTorch call reflects as scipy does), bound {bound:.4f} ms "
          f"(batch {b})", flush=True)
    st["max_abs_err"] = err
    add_times(st, ms, plain_ms, None)


def zero_grad_params(name):
    """Parameters whose true gradient is exactly 0: every conv bias that
    feeds a BatchNorm, directly (enc*/dec* conv biases) or through the
    next conv (up*_tconv biases: a per-channel shift of the conv's input
    is a per-channel shift of its output, which BN's mean removes). Their
    gradients are float noise on every path, so they are left out of the
    relative-error comparison (tests/test_lanes_train.py:98-100)."""
    return name.endswith(".bias") and (".conv" in name or "_tconv" in name)


def checked_step(name, step, state, batch, gen, per_step, kernel_levels):
    """One train step after a warm-up, launches counted from 0: exact
    launch counts, finite loss and grad_norm, and every parameter and EMA
    shadow moved but the pre-BN conv biases that the kernel forward
    detaches (those of the levels outside `kernel_levels`). Returns the
    launches."""
    step(state, *batch, gen)  # warm-up: cuDNN choice, allocator
    torch.cuda.synchronize()
    K.reset_launch_counts()
    new, metrics = step(state, *batch, gen)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"{name}: loss {loss:.6f}, grad_norm {gnorm:.6f}, step {new.step}, "
          f"launches {({k: v for k, v in launches.items() if v})}", flush=True)
    check_launches(name, launches, per_step, 1)
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        raise AssertionError(f"{name}: loss or grad_norm not finite")
    # Adam moves every parameter with a nonzero gradient; the middle's
    # pre-BN conv biases are detached on the kernel path and stay put
    detached = [k for k in state.params if zero_grad_params(k) and ".conv" in k
                and k.split(".")[0] not in kernel_levels]
    for part, old, cur in (("params", state.params, new.params),
                           ("EMA params", state.ema_params, new.ema_params),
                           ("EMA batch stats", state.ema_batch_stats, new.ema_batch_stats)):
        still = [k for k in old if k not in detached and torch.equal(old[k], cur[k])]
        if still or not all(torch.isfinite(t).all() for t in cur.values()):
            raise AssertionError(f"{name}: {part} did not all move or are not finite: {still[:5]}")
    print(f"{name}: every parameter and EMA shadow moved except the {len(detached)} detached "
          f"middle biases (kernel levels {', '.join(kernel_levels)})", flush=True)
    return launches


def train_path(gpu):
    """make_train_step at full width through the kernel train forward, at
    tier 1 and with tier2=True. Returns both steps' launches."""
    cfg = TRAIN_MODEL
    dev = torch.device(DEVICE)
    frames, labels = cell_frames(np.random.RandomState(SEED + 3), TRAIN_BATCH, TRAIN_SIZE,
                                 labels=True)
    weights = np.stack([weight_map_np(lab, mode="reference") for lab in labels])
    images, masks, wts = (torch.from_numpy(a).to(dev) for a in (frames, labels, weights))
    valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
    batch = (images, masks, wts, valid)
    state = create_train_state(fast_random_variables(cfg, SEED), cfg, RECIPE_TRAIN,
                               steps_per_epoch=STEPS_PER_EPOCH, device=dev)
    steps = {"kernel": make_train_step(cfg, lanes="auto", assume_valid=True, **RECIPE),
             "kernel_tier2": make_train_step(cfg, lanes="auto", assume_valid=True, tier2=True,
                                             **RECIPE),
             "plain_bf16": make_train_step(cfg, lanes="off", assume_valid=True, **RECIPE)}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    launches = checked_step("train path", steps["kernel"], state, batch, gen, TRAIN_LAUNCHES,
                            ("enc0", "dec3"))
    launches2 = checked_step("train path tier 2", steps["kernel_tier2"], state, batch, gen,
                             TIER2_LAUNCHES, ("enc0", "enc1", "dec2", "dec3"))

    # ---- one step's gradients: both kernel paths vs plain fp32 and plain bf16
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    draws = draw_augment(gen, images, True, RECIPE["aug_gamma"], RECIPE["aug_illum"],
                         RECIPE["aug_noise"])
    augment = make_augmenter(RECIPE["augment"], RECIPE["elastic_alpha"], RECIPE["elastic_sigma"],
                             False, 1.0, RECIPE["standardize"], RECIPE["aug_gamma"],
                             RECIPE["aug_illum"], RECIPE["aug_noise"])
    x, targets, w = augment(images, masks, wts, draws)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    res = {}
    for name, fwd, c in (("kernel", train_forward, cfg),
                         ("kernel_tier2", functools.partial(train_forward, tier2=True), cfg),
                         ("plain_fp32", unet_train_forward, cfg32),
                         ("plain_bf16", unet_train_forward, cfg)):
        res[name] = loss_and_grads(fwd, state, x, targets, w, valid, None, c)
        torch.cuda.synchronize()
    l32 = float(res["plain_fp32"][0])
    errs, lines = {}, []
    for k, g32 in res["plain_fp32"][2].items():
        if zero_grad_params(k):
            continue
        n32 = g32.norm().item()
        errs[k] = [(res[p][2][k] - g32).norm().item() / n32
                   for p in ("kernel", "kernel_tier2", "plain_bf16")]
        lines.append(f"  {k}: tier 1 {errs[k][0]:.3e}, tier 2 {errs[k][1]:.3e}, "
                     f"plain bf16 {errs[k][2]:.3e}")
    print(f"train grads: loss tier 1 {float(res['kernel'][0]):.6f}, tier 2 "
          f"{float(res['kernel_tier2'][0]):.6f}, plain fp32 {l32:.6f}, plain bf16 "
          f"{float(res['plain_bf16'][0]):.6f}; relative L2 gradient error against plain fp32 "
          f"per tensor ({len(lines)} tensors, the zero-gradient conv biases left out):",
          flush=True)
    print("\n".join(lines), flush=True)
    for i, p in enumerate(("kernel", "kernel_tier2")):
        ratio = max(e[i] / max(GRAD_FACTOR * e[2], GRAD_FLOOR) for e in errs.values())
        loss_rel = abs(float(res[p][0]) - l32) / abs(l32)
        print(f"train grads {p}: worst err / max({GRAD_FACTOR} x plain bf16 err, {GRAD_FLOOR}) = "
              f"{ratio:.3f}; median err {np.median([e[i] for e in errs.values()]):.3e}, "
              f"median plain bf16 err {np.median([e[2] for e in errs.values()]):.3e}; loss rel "
              f"{loss_rel:.3e}", flush=True)
        if ratio > 1.0 or loss_rel > LOSS_RTOL:
            raise AssertionError(f"{p} path gradients or loss off the fp32 plain path "
                                 f"(worst ratio {ratio:.3f}, loss rel {loss_rel:.3e})")
    del res

    # ---- time per step: tier 1, tier 2 and plain bf16, same state and data,
    # each timed TIMING_ROUNDS times, the order rotating by one each round
    names = list(steps)
    times = {name: [] for name in names}
    for r in range(TIMING_ROUNDS):
        for name in names[r % 3:] + names[:r % 3]:
            holder = [state]

            def one(fn=steps[name], holder=holder):
                holder[0] = fn(holder[0], *batch, gen)[0]

            times[name].append(cuda_ms(one, iters=5, warmup=2))
    med = {name: float(np.median(t)) for name, t in times.items()}
    runs = "; ".join(f"{name} " + ", ".join(f"{t:.2f}" for t in ts) for name, ts in times.items())
    print(f"train path: median ms per step {med['kernel']:.2f} through the kernels, "
          f"{med['kernel_tier2']:.2f} through the kernels at tier 2, {med['plain_bf16']:.2f} "
          f"plain bf16 (runs of 5 steps, in ms: {runs}); batch {TRAIN_BATCH} at "
          f"{TRAIN_SIZE}^2, best recipe, on {gpu}", flush=True)
    for name in ("kernel", "kernel_tier2"):
        print(f"profile of the {name} step:", flush=True)
        profile_step(steps[name], state, images, masks, wts, valid, gen, med[name])
    return launches, launches2


def profile_step(step, state, images, masks, wts, valid, gen, step_ms, steps=3):
    """torch.profiler over `steps` kernel-path train steps: device time by
    operation, its sum and the wgmma forward's and the dgrad's parts of it;
    the device's idle share of the step time measured without the profiler
    (`step_ms`), which slows the host down."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    holder = [state]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            holder[0] = step(holder[0], images, masks, wts, valid, gen)[0]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_total = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    fwd = sum(e.self_device_time_total for e in kernels if "conv_fwd" in e.key) / 1e3 / steps
    dgrad = sum(e.self_device_time_total for e in kernels if "conv_dgrad" in e.key) / 1e3 / steps
    print(f"profile: {wall:.2f} ms wall per step with the profiler on, {step_ms:.2f} ms "
          f"without; summed device kernel time {dev_total:.3f} ms per step, the wgmma forward "
          f"{fwd:.3f} of it, the dgrad {dgrad:.3f}; idle share {1 - dev_total / step_ms:.3f} of "
          f"the unprofiled step", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=10), flush=True)


def update_path(gpu, stats):
    """The train step's update (csrc/fused_update.cu) at the full parameter
    tree with the recipe's Adam, cosine and EMA 0.999, from a state at epoch
    40 of 80 as the benchmark's training cells take it: one step's
    parameters, moments and shadows bit for bit against the plain `_foreach`
    update on the card and grad_norm within 1e-6 relative, no host sync;
    the device time of the passes (torch.profiler), CUDA events over
    back-to-back updates and the host's time to issue one, each beside the
    plain update's (its global norm included), each wrapper's device time
    beside its plain version's and its bytes bound into `stats`; then two
    recipe steps through the kernel forward, counting the gradients that
    came back strided."""
    import unetseg_tpu_torch.train.state as S
    from unetseg_tpu_torch.ops.kernels.bn_relu import bn_relu_bwd, bn_relu_fwd
    from unetseg_tpu_torch.ops.kernels.update import (
        ema_plain, fused_update, global_norm_plain, update_plain,
    )
    from unetseg_tpu_torch.train.steps import optax_global_norm

    dev, cfg = torch.device(DEVICE), TRAIN_MODEL
    state = create_train_state(fast_random_variables(cfg, SEED), cfg, RECIPE_TRAIN,
                               steps_per_epoch=STEPS_PER_EPOCH, device=dev)
    start = 40 * STEPS_PER_EPOCH
    state = dataclasses.replace(state, step=start, opt_state=dict(state.opt_state, count=start))
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    grads = {k: torch.randn(v.shape, generator=g, device=dev) * 1e-3
             for k, v in state.params.items()}
    new_bs = {k: torch.rand(v.shape, generator=g, device=dev) for k, v in state.batch_stats.items()}
    route = S._flat_route

    def update(st, flat):
        S._flat_route = route if flat else (lambda tree: False)
        try:
            gr = S.Gradients(grads)
            return st.apply_gradients(gr, new_bs), optax_global_norm(gr)
        finally:
            S._flat_route = route

    packed = update(state, True)[0]  # packs the state: the steps below find it packed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, norm = update(packed, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want, ref_norm = update(packed, False)
    torch.cuda.synchronize()
    trees = lambda s: {"params": s.params, "mu": s.opt_state["mu"], "nu": s.opt_state["nu"],  # noqa: E731
                       "ema_params": s.ema_params, "ema_batch_stats": s.ema_batch_stats}
    bad = [f"{n}.{k}" for n, t in trees(want).items() for k in t
           if not torch.equal(trees(got)[n][k], t[k])]
    norm_err = abs(norm.item() - ref_norm.item()) / ref_norm.item()
    n_params = sum(v.numel() for v in state.params.values())
    n_stats = sum(v.numel() for v in state.batch_stats.values())
    print(f"parity fused_update + fused_ema (Adam, EMA, count {start}): {n_params} parameters "
          f"in {len(grads)} leaves, {n_stats} statistics; leaves that differ from the plain "
          f"update: {len(bad)} {bad[:5]}; grad_norm {norm.item():.6f} against {ref_norm.item():.6f}"
          f" (relative {norm_err:.2e}); no host sync under set_sync_debug_mode('error')",
          flush=True)
    if bad or norm_err > 1e-6:
        raise AssertionError("fused_update disagrees with the plain update")

    kernel, plain = (lambda: update(packed, True)), (lambda: update(packed, False))
    times = {}
    for name, fn in (("kernel", kernel), ("plain", plain), ("kernel again", kernel)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / 20
        torch.cuda.synchronize()
        times[name] = (host, cuda_ms(fn, iters=20), device_times(fn))
    dev_k = times["kernel"][2]
    update_ms = sum(v for k, v in dev_k.items() if "update_kernel" in k)
    norm_ms = sum(v for k, v in dev_k.items() if "norm_kernel" in k)
    ema_ms = sum(v for k, v in dev_k.items() if "ema_kernel" in k)
    plain_ms = sum(times["plain"][2].values())
    # Adam: p, g, mu, nu read and p, mu, nu written; each EMA: shadow and
    # new read, shadow written; the norm's partials are under 0.1%
    bound = (7 * n_params + 3 * n_params + 3 * n_stats) * 4 / HBM_BPS * 1e3
    one_pass = (9 * n_params + 3 * n_stats) * 4 / HBM_BPS * 1e3
    kernel_ms = update_ms + norm_ms + ema_ms
    # each wrapper's plain version alone, on the packed state's leaves
    keys = list(packed.params)
    p_l, g_l = [packed.params[k] for k in keys], [grads[k] for k in keys]
    m_l = [[packed.opt_state[m][k] for k in keys] for m in packed.tx.moments]
    h = packed.tx.scalars(packed.opt_state["count"])
    plain_update_ms = device_ms(lambda: (update_plain("adam", p_l, g_l, m_l, h),
                                         global_norm_plain(g_l)))
    e_s, s_l = list(packed.ema_batch_stats.values()), [new_bs[k] for k in packed.ema_batch_stats]
    plain_ema_ms = device_ms(lambda: (ema_plain(list(packed.ema_params.values()), p_l, 0.01),
                                      ema_plain(e_s, s_l, 0.01)))
    st = stats["fused_update"]
    add_bound(st, 0, PEAK_F32, 7 * n_params * 4)
    add_times(st, update_ms + norm_ms, plain_update_ms, None)
    st = stats["fused_ema"]
    add_bound(st, 0, PEAK_F32, (3 * n_params + 3 * n_stats) * 4)
    add_times(st, ema_ms, plain_ema_ms, None)
    print(f"time fused update (device time, torch.profiler): update pass {update_ms:.4f} ms, "
          f"norm {norm_ms:.4f} (plain update and norm {plain_update_ms:.4f}), EMA passes "
          f"{ema_ms:.4f} (plain {plain_ema_ms:.4f}), sum {kernel_ms:.4f} (CUDA events over "
          f"back-to-back updates {times['kernel'][1]:.4f}, again {times['kernel again'][1]:.4f});"
          f" plain update {plain_ms:.4f} ms device ({times['plain'][1]:.4f} by events); bound "
          f"{bound:.4f} ms in two passes ({one_pass:.4f} in one), share {bound / kernel_ms:.1%};"
          f" host ms to issue one update: kernel {times['kernel'][0]:.3f}, again "
          f"{times['kernel again'][0]:.3f}, plain {times['plain'][0]:.3f}; on {gpu}", flush=True)

    # two recipe steps through the kernel forward: launches and strided gradients
    frames, labels = cell_frames(np.random.RandomState(SEED + 3), TRAIN_BATCH, TRAIN_SIZE,
                                 labels=True)
    weights = np.stack([weight_map_np(lab, mode="reference") for lab in labels])
    batch = [torch.from_numpy(a).to(dev) for a in (frames, labels, weights)]
    batch.append(torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev))
    step = make_train_step(cfg, lanes="auto", assume_valid=True, **RECIPE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bn_relu_fwd.restrided = bn_relu_bwd.restrided = 0
    st = step(state, *batch, gen)[0]
    before = fused_update.restrided
    K.reset_launch_counts()
    st = step(st, *batch, gen)[0]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    print(f"update in a recipe step: fused_update {launches['fused_update']}, fused_ema "
          f"{launches['fused_ema']} launches; {fused_update.restrided - before} of "
          f"{len(grads)} gradients came back strided and were made contiguous; BatchNorm "
          f"inputs copied to contiguous over the two steps: forward {bn_relu_fwd.restrided}, "
          f"backward {bn_relu_bwd.restrided}", flush=True)
    check_launches("update in a recipe step", launches, TRAIN_LAUNCHES, 1)


# phase 6c: the train step's 18 BatchNorms at batch 4 and 512^2: (side of
# the activation, channels), enc0 .. enc4, then dec0 .. dec3. The forward
# reads z twice and writes y, the backward reads gy and z twice and writes
# dz: BN_PASSES passes over the bf16 activation at the bound
BN_SHAPES = [(510, 64), (508, 64), (252, 128), (250, 128), (123, 256), (121, 256),
             (58, 512), (56, 512), (26, 1024), (24, 1024), (46, 512), (44, 512),
             (86, 256), (84, 256), (166, 128), (164, 128), (326, 64), (324, 64)]
BN_FWD_PASSES, BN_BWD_PASSES = 3, 5
BN_STAGES = {"forward": ("stats_kernel", "fwd_finalize_kernel", "apply_kernel"),
             "backward": ("bwd_stats_kernel", "bwd_finalize_kernel", "dz_kernel")}


def bn_path(gpu, stats):
    """The train step's BatchNorm+ReLU (csrc/bn_relu.cu) at the recipe
    step's 18 shapes, unmasked as the recipe runs it: y and dz against the
    plain version in bf16 on the card (max error over the reference's
    max), the same bits on a second run; the device time of each stage of
    the forward and the backward summed over the 18 (torch.profiler, one
    session each), beside the plain version's and the bytes bound; the
    host's time to issue one step's 18 forwards and backwards."""
    from unetseg_tpu_torch.ops.kernels import bn_relu as BN

    g = torch.Generator(device="cuda").manual_seed(SEED + 24)
    cases, errs, n_elems = [], [], 0
    for side, c in BN_SHAPES:
        z = (torch.rand(c, generator=g, device="cuda") * 2 - 1
             + torch.randn(TRAIN_BATCH, side, side, c, generator=g, device="cuda")).bfloat16()
        gy = (0.1 * torch.randn(z.shape, generator=g, device="cuda")).bfloat16()
        gamma = torch.rand(c, generator=g, device="cuda") + 0.5
        beta = torch.rand(c, generator=g, device="cuda") - 0.5
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        args = (z, gamma, beta, rm, rv, None, 0.9, 1e-5)
        y, _, _, saved = BN.bn_relu_fwd(*args)
        dz = BN.bn_relu_bwd(gy, z, gamma, None, saved)[0]
        y2, _, _, saved2 = BN.bn_relu_fwd(*args)
        same = (torch.equal(y, y2) and torch.equal(saved, saved2)
                and torch.equal(dz, BN.bn_relu_bwd(gy, z, gamma, None, saved2)[0]))
        fy, _, _, fsaved = BN.bn_relu_fwd_plain(z.float(), *args[1:])
        fdz = BN.bn_relu_bwd_plain(gy.float(), z.float(), gamma, None, fsaved)[0]
        py, _, _, psaved = BN.bn_relu_fwd_plain(*args)
        pdz = BN.bn_relu_bwd_plain(gy, z, gamma, None, psaved)[0]
        errs.append((rel_err(y, fy), rel_err(dz, fdz), same, rel_err(py, fy), rel_err(pdz, fdz)))
        del fy, fdz, fsaved, py, pdz
        cases.append((args, gy, saved, psaved))
        n_elems += z.numel()
    worst = [max(e[i] for e in errs) for i in (0, 1, 3, 4)]
    bad = [(sh, e) for sh, e in zip(BN_SHAPES, errs) if not e[2] or max(e[:2]) > 1e-2]
    print(f"parity bn_relu at the recipe's 18 BatchNorms ({n_elems} elements): max error over "
          f"the max of the plain version in f32, y {worst[0]:.3e} (the plain version in bf16 "
          f"{worst[2]:.3e}), dz {worst[1]:.3e} (bf16 {worst[3]:.3e}); the same bits on a second "
          f"run: {all(e[2] for e in errs)}", flush=True)
    if bad:
        raise AssertionError(f"bn_relu: shapes off the plain version or not repeatable: {bad}")

    runs = {
        "forward": lambda: [BN.bn_relu_fwd(*a) for a, _, _, _ in cases],
        "backward": lambda: [BN.bn_relu_bwd(gy, a[0], a[1], None, sv) for a, gy, sv, _ in cases],
        "plain forward": lambda: [BN.bn_relu_fwd_plain(*a) for a, _, _, _ in cases],
        "plain backward": lambda: [BN.bn_relu_bwd_plain(gy, a[0], a[1], None, ps)
                                   for a, gy, _, ps in cases],
    }
    dev = {name: device_times(fn, iters=5) for name, fn in runs.items()}
    host = {}
    for name in ("forward", "backward", "plain forward", "plain backward"):
        runs[name]()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name]()
        host[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    elem_bytes = 2 * n_elems
    line = []
    for way, passes in (("forward", BN_FWD_PASSES), ("backward", BN_BWD_PASSES)):
        parts = {k: sum(v for n, v in dev[way].items() if k in n) for k in BN_STAGES[way]}
        ms, plain_ms = sum(dev[way].values()), sum(dev["plain " + way].values())
        st = stats["bn_relu_fwd" if way == "forward" else "bn_relu_bwd"]
        bound = add_bound(st, 0, PEAK_F32, passes * elem_bytes)
        add_times(st, ms, plain_ms, None)
        st["max_abs_err"] = max(e[0 if way == "forward" else 1] for e in errs)
        line.append(f"{way} {ms:.4f} ms ({', '.join(f'{k} {v:.4f}' for k, v in parts.items())}; "
                    f"plain {plain_ms:.4f}; bound {bound:.4f}, share {bound / ms:.1%}; host ms "
                    f"to issue {host[way]:.3f}, plain {host['plain ' + way]:.3f})")
    total = sum(sum(dev[w].values()) for w in ("forward", "backward"))
    plain = sum(sum(dev["plain " + w].values()) for w in ("forward", "backward"))
    bound = (BN_FWD_PASSES + BN_BWD_PASSES) * elem_bytes / HBM_BPS * 1e3
    print(f"time bn_relu over the 18 BatchNorms of a recipe step (device time, torch.profiler, "
          f"summed): {'; '.join(line)}; both ways {total:.4f} ms against plain {plain:.4f} ms; "
          f"bound {bound:.4f} ms ({BN_FWD_PASSES + BN_BWD_PASSES} passes of "
          f"{elem_bytes / 1e9:.3f} GB), share {bound / total:.1%}; on {gpu}", flush=True)


def rel_err(got, ref):
    """max |got - ref| / max |ref|, in f32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max()).item()


def loss_and_edt_parity(stats, labels):
    """The weighted CE pair and the min-plus product at their paths' shapes
    against their plain versions (phase 7)."""
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    b, s = TRAIN_BATCH, TRAIN_SIZE
    o = unet_shapes(s).output_size
    off = (s - o) // 2  # the train step's center crop, 512 -> 324: offset 94
    n = b * o * o
    for c in (2, 3):
        logits = 2 * torch.randn(b, o, o, c, generator=g, device=DEVICE)
        t = torch.randint(0, c, (b, s, s), generator=g, device=DEVICE, dtype=torch.int32)
        w = 1 + 10 * torch.rand(b, s, s, generator=g, device=DEVICE)
        gin = torch.full((b, o, o), 1.0 / n, device=DEVICE)  # the mean's cotangent
        args = (logits, t, w, off, off)
        out, ref = KW.weighted_ce_fwd(*args), KW.weighted_ce_fwd_plain(*args)
        d = KW.weighted_ce_bwd(logits, t, w, gin, off, off)
        dref = KW.weighted_ce_bwd_plain(logits, t, w, gin, off, off)
        torch.cuda.synchronize()
        errs = rel_err(out, ref), rel_err(d, dref)
        print(f"parity weighted_ce C={c}: logits {tuple(logits.shape)} f32, targets and weights "
              f"{tuple(t.shape)} read at ({off}, {off}); max rel err forward {errs[0]:.3e}, "
              f"backward {errs[1]:.3e} (bound {WCE_RTOL:g})", flush=True)
        if max(errs) > WCE_RTOL or not (torch.isfinite(out).all() and torch.isfinite(d).all()):
            raise AssertionError(f"weighted CE (C={c}) disagrees with its plain version")
        # the library yardstick: F.cross_entropy on the cropped targets, times w
        t_crop = t[:, off:off + o, off:off + o].long()
        w_crop = w[:, off:off + o, off:off + o].contiguous()
        lg = logits.clone().requires_grad_(True)
        lib_out = F.cross_entropy(to_nchw(lg), t_crop, reduction="none") * w_crop
        cases = {
            "weighted_ce_fwd": (lambda: KW.weighted_ce_fwd(*args),
                                lambda: KW.weighted_ce_fwd_plain(*args),
                                lambda: F.cross_entropy(to_nchw(logits), t_crop,
                                                        reduction="none") * w_crop,
                                n * (4 * c + 12), errs[0]),
            "weighted_ce_bwd": (lambda: KW.weighted_ce_bwd(logits, t, w, gin, off, off),
                                lambda: KW.weighted_ce_bwd_plain(logits, t, w, gin, off, off),
                                lambda: torch.autograd.grad(lib_out, lg, gin, retain_graph=True),
                                n * (8 * c + 12), errs[1]),
        }
        for name, (kern, plain, lib, n_bytes, err) in cases.items():
            event_ms = cuda_ms(kern)
            ms, plain_ms, lib_ms = device_ms(kern), device_ms(plain), device_ms(lib)
            st = stats[name]
            bound = add_bound(st, n * (6 * c + 4), PEAK_F32, n_bytes)
            print(f"time {name} C={c} (device time, torch.profiler): kernel {ms:.4f} ms (CUDA "
                  f"events over back-to-back launches: {event_ms:.4f}), plain {plain_ms:.4f} "
                  f"ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms ({n_bytes / 1e6:.2f} MB)",
                  flush=True)
            st["max_abs_err"] = max(st["max_abs_err"], err)
            add_times(st, ms, plain_ms, lib_ms)
        del lg, lib_out

    # min-plus: the EDT's two phases for MINPLUS_K instances of real frames
    with torch.inference_mode():
        lab = torch.from_numpy(labels).to(DEVICE)
        planes = torch.cat([lab[i][None] == torch.unique(lab[i])[1:, None, None]
                            for i in range(len(lab))])[:MINPLUS_K]
        if planes.shape[0] < MINPLUS_K:
            raise AssertionError(f"{planes.shape[0]} instances < {MINPLUS_K}")
        col_cost = torch.where(planes, 0.0, KM.BIG)
        i = torch.arange(labels.shape[1], dtype=torch.float32, device=DEVICE)
        dist = (i[:, None] - i[None, :]) ** 2
        g1 = KM.minplus(dist, col_cost)
        phases = {"phase 1 (a shared)": (dist, col_cost), "phase 2 (b shared)": (g1, dist)}
        st = stats["minplus"]
        for name, (a, bm) in phases.items():
            got, ref = KM.minplus(a, bm), KM.minplus_plain(a, bm)
            torch.cuda.synchronize()
            exact = bool(torch.equal(got, ref))
            print(f"parity minplus {name}: {tuple(a.shape)} x {tuple(bm.shape)} -> "
                  f"{tuple(got.shape)}, equal to the plain version: {exact}", flush=True)
            if not exact:
                raise AssertionError(f"minplus {name} differs from its plain version")
            ms = cuda_ms(lambda: KM.minplus(a, bm))
            plain_ms = cuda_ms(lambda: KM.minplus_plain(a, bm), iters=2, warmup=1)
            cand = got.numel() * a.shape[-1]
            bound = add_bound(st, 2 * cand, F32_ISSUE, nbytes(a, bm, got))
            print(f"time minplus {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library "
                  f"none, bound {bound:.3f} ms ({2 * cand / 1e9:.1f} G FADD+FMNMX at the f32 "
                  f"issue rate; {2 * cand / (ms * 1e-3) / 1e12:.1f} T instructions/s, "
                  f"{bound / ms:.0%} of the bound)", flush=True)
            add_times(st, ms, plain_ms, None)


def preprocess_path(labels):
    """weight_map, the preprocess command's dispatcher, in paper mode on the
    card for every frame (phase 8): two min-plus launches per frame, within
    WMAP_ATOL of scipy's host maps."""
    weight_map(labels[0], mode="paper", device=DEVICE)  # warm-up: allocator
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    maps = [weight_map(lab, mode="paper", device=DEVICE) for lab in labels]
    dev_s = time.perf_counter() - t0  # each map ends in a copy to the host
    launches = K.launch_counts()
    t0 = time.perf_counter()
    host = [weight_map_np(lab, mode="paper") for lab in labels]
    host_s = time.perf_counter() - t0
    err = max(float(np.abs(a - h).max()) for a, h in zip(maps, host))
    n_inst = [len(np.unique(lab)) - 1 for lab in labels]
    print(f"preprocess path: {len(labels)} frames {labels.shape[1:]} with {min(n_inst)}-"
          f"{max(n_inst)} instances, launches {launches}; max |device - scipy| {err:.3e} "
          f"(bound {WMAP_ATOL:g}); {dev_s / len(labels) * 1e3:.2f} ms per frame on the card "
          f"(host to host), scipy {host_s / len(labels) * 1e3:.1f} ms per frame", flush=True)
    if launches["minplus"] != 2 * len(labels) or err > WMAP_ATOL:
        raise AssertionError("preprocess path: min-plus not launched twice per frame, or the "
                             "device maps disagree with scipy's")
    # a frame of more instances than one EDT batch holds: two batches
    crowd = np.zeros(labels.shape[1:], np.int32)
    for k in range(CROWD_INSTANCES):
        y, x = 25 * (k // 20), 25 * (k % 20)
        crowd[y:y + 12, x:x + 12] = k + 1
    K.reset_launch_counts()
    got = weight_map(crowd, mode="paper", device=DEVICE)
    n_mp = K.launch_counts()["minplus"]
    err = float(np.abs(got - weight_map_np(crowd, mode="paper")).max())
    print(f"preprocess path: a frame of {CROWD_INSTANCES} instances, min-plus launches {n_mp}, "
          f"max |device - scipy| {err:.3e}", flush=True)
    if n_mp != 4 or err > WMAP_ATOL:
        raise AssertionError("preprocess path: the crowded frame took other than two EDT "
                             "batches, or its map disagrees with scipy's")
    return launches


def states_equal(a, b):
    """Every tensor of two TrainStates bit for bit, and the step."""
    pairs = [(a.params, b.params), (a.batch_stats, b.batch_stats),
             (a.opt_state["mu"], b.opt_state["mu"]), (a.opt_state["nu"], b.opt_state["nu"]),
             (a.ema_params, b.ema_params), (a.ema_batch_stats, b.ema_batch_stats)]
    return (a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
            and all(torch.equal(x[k], y[k]) for x, y in pairs for k in x))


def loop_path(gpu):
    """train() with the best recipe at full width on LOOP_FRAMES synthetic
    frames (phase 9): 2 epochs, a resume for a third, both checkpoint
    streams, and the light checkpoint served by the Predictor."""
    frames, labels = cell_frames(np.random.RandomState(SEED + 6), LOOP_FRAMES, TRAIN_SIZE,
                                 labels=True)
    wmaps = np.stack([weight_map(lab, mode="paper", device=DEVICE) for lab in labels])
    data = HeLaArrays(frames, labels, wmaps, [])
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    d = os.path.join(work, "ckpt")
    cfg = Config(model=TRAIN_MODEL, data=DataConfig(**RECIPE), train=dataclasses.replace(
        RECIPE_TRAIN, num_epochs=LOOP_EPOCHS, checkpoint_dir=d, checkpoint_min_interval=4,
        metrics_jsonl=os.path.join(work, "metrics.jsonl")))
    spe = -(-len(train_val_split(LOOP_FRAMES, cfg.data.val_percent, cfg.train.seed)[0])
            // cfg.train.batch_size)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = train(cfg, data=data, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    steps = LOOP_EPOCHS * spe
    print(f"loop path: {LOOP_EPOCHS} epochs of {spe} steps in {wall:.2f} s (checkpoints "
          f"included), best epoch {res.best_epoch}, history "
          f"{[{k: round(v, 5) for k, v in h.items()} for h in res.history]}, launches {launches}",
          flush=True)
    missing = [k for k in TRAINING if launches[k] == 0]
    if missing or launches["weighted_ce_fwd"] != steps or launches["weighted_ce_bwd"] != steps:
        raise AssertionError(f"loop path: kernels not launched as expected ({missing}; "
                             f"the weighted CE {steps} times each)")
    if not all(np.isfinite(v) for h in res.history for v in h.values()):
        raise AssertionError("loop path: history not finite")
    if ckpt.best_epoch(d) is None or ckpt.latest_epoch(d) != LOOP_EPOCHS - 1:
        raise AssertionError("loop path: the light or the full checkpoint is missing")
    template = create_train_state(0, cfg.model, cfg.train, steps_per_epoch=spe, device=DEVICE)
    restored, epoch, _ = ckpt.restore_checkpoint(d, template)
    if not states_equal(restored, res.state):
        raise AssertionError("loop path: the restored full state differs from the saved one")

    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=LOOP_EPOCHS + 1, resume=True))
    res2 = train(cfg2, data=data, device=DEVICE)
    with open(cfg.train.metrics_jsonl) as f:
        resumed = [json.loads(ln) for ln in f if '"resume"' in ln]
    if (len(res2.history) != 1 or res2.state.step != (LOOP_EPOCHS + 1) * spe
            or [r["epoch"] for r in resumed] != [LOOP_EPOCHS]):
        raise AssertionError(f"loop path: the resume did not continue at epoch {LOOP_EPOCHS}")
    variables = ckpt.restore_params_for_inference(d)
    pred = Predictor(TRAIN_MODEL, variables, InferConfig(
        tile_input=min_tile_input(TRAIN_SIZE), tile_batch=2), DEVICE)
    masks = pred.masks_tiled(frames[:2])
    if masks.shape != (2, TRAIN_SIZE, TRAIN_SIZE) or masks.dtype != np.uint8 or \
            set(np.unique(masks)) - {0, 1}:
        raise AssertionError(f"loop path: served masks {masks.shape} {masks.dtype}")
    print(f"loop path: full checkpoint of epoch {epoch} restored bit for bit; resumed at "
          f"epoch {LOOP_EPOCHS}, step {res2.state.step}; light checkpoint of epoch "
          f"{ckpt.best_epoch(d)} served {masks.shape} uint8 masks, foreground "
          f"{float(masks.mean()):.4f}", flush=True)

    # ---- times: the epoch feed per step, a validation pass, checkpoint writes
    train_idx, val_idx = train_val_split(LOOP_FRAMES, cfg.data.val_percent, cfg.train.seed)
    on_dev = [torch.from_numpy(a).to(DEVICE) for a in (frames, labels, wmaps)]
    mat, vmat = (torch.from_numpy(a).to(DEVICE) for a in epoch_index_matrix(
        train_idx, cfg.train.batch_size, shuffle=True, seed=0))
    val_mat, val_valid = (torch.from_numpy(a).to(DEVICE) for a in epoch_index_matrix(
        val_idx, cfg.train.batch_size, shuffle=False, seed=0))
    epoch_step = make_epoch_train_step(TRAIN_MODEL, assume_valid=True, **RECIPE)
    epoch_eval = make_epoch_eval_step(TRAIN_MODEL, standardize=RECIPE["standardize"])
    holder = [res2.state]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    single = make_train_step(TRAIN_MODEL, assume_valid=True, **RECIPE)
    batch = [t.index_select(0, mat[0]) for t in on_dev]

    def one_epoch():
        holder[0] = epoch_step(holder[0], *on_dev, mat, vmat, gen)[0]

    def single_steps():  # as many steps of one resident batch, as phase 6 times them
        for _ in range(len(mat)):
            holder[0] = single(holder[0], *batch, vmat[0], gen)[0]

    feed, steps = [], []
    for first in (True, False, False, True):  # alternating which goes first
        for fn, out in ((one_epoch, feed), (single_steps, steps))[:: 1 if first else -1]:
            out.append(cuda_ms(fn, iters=2, warmup=1) / len(mat))
    step_ms = float(np.median(feed))
    print(f"loop path: ms per step, epoch feed {', '.join(f'{t:.2f}' for t in feed)}; single "
          f"steps on one resident batch {', '.join(f'{t:.2f}' for t in steps)} (alternating)",
          flush=True)
    val_ms = cuda_ms(lambda: epoch_eval(holder[0], on_dev[0], on_dev[1], val_mat, val_valid),
                     iters=3, warmup=1)
    ck = ckpt.Checkpointer(os.path.join(work, "timed"))
    t0 = time.perf_counter()
    ck.save_light_payload(ckpt.device_light_payload(holder[0]), 0, 1.0)
    light_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.save_full(holder[0], 0, 1.0)
    full_s = time.perf_counter() - t0
    ck.close()
    sizes = {name: os.path.getsize(os.path.join(work, "timed", *parts)) / 1e6 for name, parts in
             (("light", ("0.pt",)), ("full", ("full", "0.pt")))}
    print(f"loop path: {step_ms:.2f} ms per step in the epoch feed (median; {len(mat)} steps of "
          f"{cfg.train.batch_size} at {TRAIN_SIZE}^2), {val_ms:.2f} ms per validation pass "
          f"({len(val_mat)} batch), checkpoint writes {light_s:.2f} s light "
          f"({sizes['light']:.0f} MB), {full_s:.2f} s full ({sizes['full']:.0f} MB), "
          f"synchronous, on {gpu}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def drifting_frames(rs, n, size, pairs=3):
    """n uint8-valued frames (k / 255, as load_image_01 reads a TIFF) of
    16-24 elliptic cells (0.70 on 0.25, noise 0.05) drifting 1-3 px a
    frame, `pairs` of them in touching pairs that move together, so that
    the temporal markers have a history and the watershed has merged
    components to split."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    cells = []  # (cy, cx, ry, rx, th, vy, vx)
    for _ in range(rs.randint(16, 25)):
        speed, way = rs.uniform(1, 3), rs.uniform(0, 2 * np.pi)
        cells.append([*rs.uniform(40, size - 40, 2), *rs.uniform(22, 40, 2), rs.uniform(0, np.pi),
                      speed * np.sin(way), speed * np.cos(way)])
    for a in cells[:pairs]:  # a partner touching each of the first cells
        way = rs.uniform(0, 2 * np.pi)
        d = 0.9 * (a[2] + a[3])
        cells.append([a[0] + d * np.sin(way), a[1] + d * np.cos(way), a[2], a[3], a[4], a[5], a[6]])
    frames = []
    for t in range(n):
        inside = np.zeros((size, size), bool)
        for cy, cx, ry, rx, th, vy, vx in cells:
            dy, dx = yy - cy - t * vy, xx - cx - t * vx
            u = (dy * np.cos(th) + dx * np.sin(th)) / ry
            v = (dx * np.cos(th) - dy * np.sin(th)) / rx
            inside |= u * u + v * v < 1
        img = 0.25 + 0.45 * inside + 0.05 * rs.standard_normal((size, size))
        frames.append(np.round(np.clip(img, 0, 1) * 255))
    return (np.stack(frames) / 255.0).astype(np.float32)


def spiral_mask(size, width=3, step=100):
    """A square spiral path from the top-left corner inward, arms `step`
    apart: one component whose label must travel its whole length."""
    m = np.zeros((size, size), np.uint8)
    y = x = 6
    n = size - 12
    moves, lengths = ((0, 1), (1, 0), (0, -1), (-1, 0)), [n, n, n]
    while n - step > 0:
        n -= step
        lengths += [n, n]
    for k, length in enumerate(lengths):
        dy, dx = moves[k % 4]
        y2, x2 = y + dy * length, x + dx * length
        m[min(y, y2):max(y, y2) + width, min(x, x2):max(x, x2) + width] = 1
        y, x = y2, x2
    return m, sum(lengths)


def write_ensemble_checkpoints(work, members, cfg):
    """Two light checkpoint directories, written by the port's checkpoint
    code: each holds one member's params and another's as the EMA shadow."""
    dirs = []
    for j in range(0, len(members), 2):
        state = create_train_state(members[j], cfg, TrainConfig(ema_decay=0.999), device=DEVICE)
        shadow = create_train_state(members[j + 1], cfg, device=DEVICE)
        state = dataclasses.replace(state, ema_params=shadow.params,
                                    ema_batch_stats=shadow.batch_stats)
        d = os.path.join(work, f"seed{j}")
        ckpt.Checkpointer(d).save_light_payload(ckpt.device_light_payload(state), 0, 1.0)
        dirs.append(d)
        del state, shadow
    return dirs


def run_sequence(pred, frames):
    """The in-memory sequence core with the best recipe's options on tiled
    frames: [(number, mask, instances before the grow)] in frame order."""
    out = pred.predict_frames(frames, list(range(len(frames))), tiled=True,
                              temporal_markers=True, temporal_bidi=True)
    return sorted(out, key=lambda r: r[0])


def sequence_path(gpu, pil):
    """Phase 10: the sequence path. A 4-member ensemble (raw + EMA of two
    light checkpoints) with the best recipe's inference settings runs the
    sequence core on SEQ_FRAMES drifting 512^2 frames through the kernels;
    then device CC, from_torch_checkpoint and, with Pillow, the predict
    command. Returns the ensemble run's launches."""
    cfg = SEQ_MODEL
    icfg = dataclasses.replace(Config.from_json_file(RECIPE_JSON).infer,
                               tile_input=min_tile_input(SIZE), tile_batch=BATCH)
    members = [plant_intensity_path(fast_random_variables(cfg, SEED + 10 + i)) for i in range(4)]
    frames = drifting_frames(np.random.RandomState(SEED + 10), SEQ_FRAMES, SIZE)
    work = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    dirs = write_ensemble_checkpoints(work, members, cfg)
    pred = Predictor.from_checkpoints(dirs, cfg, icfg, ema="both", device=DEVICE)
    if len(pred.members) != 4 or (DEVICE == "cuda" and not pred.uses_kernels):
        raise AssertionError("sequence path: expected 4 members through the kernel forward")
    grid = plan_tiles(SIZE, SIZE, icfg.tile_input)

    pred.masks_tiled(frames[:BATCH])  # warm-up: cuDNN algorithm choice, allocator
    # the native flood is built with g++ at first use: outside the timed core
    watershed(np.zeros((4, 4), np.float32), np.zeros((4, 4)), np.ones((4, 4)))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_sequence(pred, frames)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = K.launch_counts()
    n_chunks = -(-len(frames) * grid.ny * grid.nx // BATCH)
    transforms = 4  # icfg.tta == "flips"
    check_launches("sequence path", launches, {k: v * transforms * len(pred.members)
                                              for k, v in DEFAULT_LAUNCHES.items()}, n_chunks)
    masks = np.stack([b for _, b, _ in got])
    insts = [i for _, _, i in got]
    if (masks.shape != frames.shape or masks.dtype != np.uint8
            or set(np.unique(masks)) - {0, 1}):
        raise AssertionError(f"sequence path: masks {masks.shape} {masks.dtype} not binary")
    for num, _, inst in got:
        sizes = np.bincount(inst.ravel())[1:]
        if inst.dtype != np.uint16 or (sizes[sizes > 0] < icfg.min_cell_size).any():
            raise AssertionError(f"sequence path: frame {num} instances {inst.dtype}, an "
                                 f"instance under {icfg.min_cell_size} px before the grow")

    # the same ensemble and TTA through the plain fp32 forward (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    variables = [ckpt.restore_params_for_inference(d, ema=e) for d in dirs for e in (False, True)]
    plain = Predictor(dataclasses.replace(cfg, compute_dtype="float32"), variables, icfg, DEVICE)
    ref = run_sequence(plain, frames)
    del plain
    ref_masks = np.stack([b for _, b, _ in ref])
    agreement = float((ref_masks == masks).mean())
    same = [k for k in range(len(frames)) if np.array_equal(masks[k], ref_masks[k])]
    same_inst = [k for k in same if np.array_equal(insts[k], ref[k][2])]
    # with temporal markers a frame's instances also depend on the frames
    # before it, and in the backward sweep's window on the window's frames:
    # printed, how many equal frames have every such frame's mask equal too
    window = icfg.temporal_bidi_frames
    closed = [k for k in same if all(j in same for j in range(max(k, window) + 1))]
    print(f"sequence path: {len(pred.members)} members x {transforms} TTA transforms, "
          f"{n_chunks} chunk(s), launches {dict((k, v) for k, v in launches.items() if v)}; "
          f"foreground {float(masks.mean()):.4f}, pixel agreement with the plain fp32 ensemble "
          f"{agreement:.6f}; frames with the same mask bit for bit {len(same)} of {len(frames)}, "
          f"with the same instances too {len(same_inst)}, of which every frame they depend on "
          f"has the same mask {len(closed)}; instances per frame "
          f"{[len(np.unique(i)) - 1 for i in insts]}", flush=True)
    if agreement < AGREEMENT_BAR:
        raise AssertionError(f"sequence path: agreement {agreement:.6f} < {AGREEMENT_BAR}")
    if len(same_inst) != len(same):
        raise AssertionError(f"sequence path: frames {sorted(set(same) - set(same_inst))} have "
                             f"the plain path's mask and other instances (their history masks "
                             f"equal on {len(closed)} of the {len(same)})")
    device_ms = cuda_ms(lambda: pred.masks_tiled(frames), iters=2, warmup=1)
    host_ms = total_s * 1e3 - device_ms
    print(f"sequence path: {device_ms / len(frames):.2f} ms per frame on the device "
          f"(masks_tiled of {len(frames)} frames, 4 members x 4 transforms), "
          f"{host_ms / len(frames):.2f} ms per frame of host post-processing (temporal "
          f"watershed and backward sweep; the core's {total_s * 1e3:.1f} ms less the device "
          f"part), on {gpu}", flush=True)

    # ---- device CC: one member at image_size 512 (324^2 output)
    one = Predictor(cfg, members[0], InferConfig(), DEVICE)
    raw = one.labels_device(frames)
    probs = one.probs(frames)
    fg = (probs > one.cfg.threshold).cpu().numpy()
    if not np.array_equal(raw > 0, fg):
        raise AssertionError("device CC: labels > 0 is not the thresholded probabilities")
    t0 = time.perf_counter()
    want = [get_instance_masks(m, min_size=one.cfg.min_cell_size) for m in fg]
    scipy_ms = (time.perf_counter() - t0) * 1e3
    for k, m in enumerate(want):
        if not np.array_equal(compact_labels(raw[k], min_size=one.cfg.min_cell_size), m):
            raise AssertionError(f"device CC: frame {k} differs from scipy's labels")
    fg_dev = probs > one.cfg.threshold
    cc_ms = cuda_ms(lambda: label_components_device(fg_dev), iters=3, warmup=1)
    _, iters = propagate_labels(fg_dev)
    spiral, length = spiral_mask(SIZE)
    sp_raw, sp_iters = propagate_labels(torch.from_numpy(spiral)[None].to(DEVICE))
    if sp_iters >= 4096 or not np.array_equal(
            compact_labels(sp_raw[0].cpu().numpy(), min_size=1),
            get_instance_masks(spiral, min_size=1)):
        raise AssertionError(f"device CC: the spiral did not converge to scipy's labels "
                             f"({sp_iters} iterations)")
    print(f"device CC: {len(fg)} frames of {fg.shape[1]}^2 equal scipy's labels after "
          f"compact_labels ({sum(len(np.unique(m)) - 1 for m in want)} instances, {iters} "
          f"iterations); label propagation {cc_ms:.2f} ms on the device, scipy "
          f"{scipy_ms:.2f} ms on the host; a {SIZE}^2 spiral of path length {length} converged "
          f"in {sp_iters} iterations (cap 4096), on {gpu}", flush=True)

    # ---- a reference-layout .pth
    pth = os.path.join(work, "reference.pth")
    torch.save(to_reference_state_dict(members[0]), pth)
    from_pth = Predictor.from_torch_checkpoint(pth, cfg, InferConfig(), device=DEVICE)
    a, b = from_pth.probs(frames[:4]), one.probs(frames[:4])
    if not torch.equal(a, b):
        raise AssertionError("from_torch_checkpoint: probabilities differ from the variables'")
    print(f"from_torch_checkpoint: probabilities {tuple(a.shape)} equal bit for bit those of a "
          f"Predictor built from the variables", flush=True)
    del one, from_pth

    # ---- the predict command's file layer, where Pillow is installed
    if pil:
        data = os.path.join(work, "data", "HeLa", "01")
        os.makedirs(data)
        from PIL import Image

        for k, f in enumerate(frames):
            Image.fromarray(np.round(f * 255).astype(np.uint8)).save(
                os.path.join(data, f"t{k:03d}.tif"))
        conf = os.path.join(work, "recipe.json")
        with open(conf, "w") as fh:
            json.dump({"model": dataclasses.asdict(cfg), "infer": dataclasses.asdict(icfg)}, fh)
        out = os.path.join(work, "out")
        res = subprocess.run(
            [sys.executable, "-m", "unetseg_tpu_torch", "predict", "--config", conf,
             "--checkpoint-dir", ",".join(dirs), "--ema-both", "--tiled", "--data-root",
             os.path.dirname(data), "--sequence", "01", "--output-dir", out,
             *(["--cpu"] if DEVICE == "cpu" else [])], capture_output=True, text=True)
        if res.returncode != 0:
            raise AssertionError(f"predict command failed ({res.returncode}):\n{res.stderr}")
        for k in range(len(frames)):
            written = np.array(Image.open(os.path.join(out, "01_RES", f"mask{k:03d}.tif")))
            if not np.array_equal(written > 0, masks[k] > 0):
                raise AssertionError(f"predict command: mask{k:03d}.tif differs from the core's")
        print(f"predict command: the {len(frames)} mask files equal the core's masks", flush=True)
    else:
        print("predict command: Pillow is not installed here; the file layer (TIFF reads and "
              "writes) was not driven", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def ctc_sequence(rs, n, size):
    """A synthetic CTC sequence: n uint8-valued frames (k / 255, as
    load_image_01 reads a TIFF) of cells (0.70 on 0.25, noise 0.05), their
    uint16 instance labels, in which each cell's label is its track id (the
    GT TRA markers and SEG masks both), and the man_track.txt rows
    (label, begin, end, parent). 10-13 elliptic cells (radii 24-34 px)
    drift 0.5-1.5 px a frame, at least 6 px apart from every other cell in
    every frame. One disc of radius 34 divides at frame n // 3 into two
    discs of half its area, 6 px apart, that move apart 1.5 px a frame
    each; one disc of radius 28 leaves the frame across its right edge at
    3 px a frame, and its track ends at the last frame that shows a third
    of it or more."""
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    t_div = n // 3
    objs = []  # label, begin, end, parent, centre(t) -> (y, x), ry, rx, th

    def add(label, begin, end, parent, centre, ry, rx, th=0.0):
        objs.append(dict(label=label, begin=begin, end=end, parent=parent, centre=centre,
                         ry=ry, rx=rx, th=th))

    def clear(c, r, lo, hi):
        """True when a cell of radius r at c(t) for t in [lo, hi] stays
        6 px clear of every other cell alive then."""
        for o in objs:
            ts = np.arange(max(lo, o["begin"]), min(hi, o["end"]) + 1)
            (ay, ax), (by, bx) = c(ts), o["centre"](ts)
            if (np.hypot(ay - by, ax - bx) < r + max(o["ry"], o["rx"]) + 6).any():
                return False
        return True

    def linear(y, x, vy, vx):
        return lambda t: (y + t * vy, x + t * vx)

    # the dividing mother and her two daughters
    rm = 34.0
    rd = rm / np.sqrt(2.0)
    y0, x0 = rs.uniform(120, size - 120, 2)
    way = rs.uniform(0, 2 * np.pi)
    vy, vx = 0.8 * np.sin(way), 0.8 * np.cos(way)
    mother = linear(y0, x0, vy, vx)
    split = rs.uniform(0, np.pi)
    uy, ux = np.sin(split), np.cos(split)
    cy, cx = mother(t_div - 1)
    add(1, 0, t_div - 1, 0, mother, rm, rm)
    for k, sgn in ((2, 1.0), (3, -1.0)):
        add(k, t_div, n - 1, 1,
            lambda t, sgn=sgn: (cy + sgn * uy * (rd + 3 + 1.5 * (t - t_div)),
                                cx + sgn * ux * (rd + 3 + 1.5 * (t - t_div))), rd, rd)
    # the cell that leaves across the right edge, 3 px a frame
    rl = 28.0
    for _ in range(1000):
        leaver = linear(rs.uniform(rl + 10, size - rl - 10), size - 30.0, 0.0, 3.0)
        if clear(leaver, rl, 0, n - 1):
            break
    else:
        raise RuntimeError("ctc_sequence: no room for the leaving cell")
    full = np.pi * rl * rl
    end = 0
    while end + 1 < n:
        ly, lx = leaver(end + 1)
        if ((yy - ly) ** 2 + (xx - lx) ** 2 < rl * rl).sum() < full / 3:
            break
        end += 1
    add(4, 0, end, 0, leaver, rl, rl)
    # the drifting cells, inside the frame throughout
    label = 5
    for _ in range(rs.randint(10, 14)):
        for _ in range(1000):
            ry, rx = rs.uniform(24, 34, 2)
            r = max(ry, rx)
            speed, way = rs.uniform(0.5, 1.5), rs.uniform(0, 2 * np.pi)
            y, x = rs.uniform(r + 4, size - r - 4, 2)
            c = linear(y, x, speed * np.sin(way), speed * np.cos(way))
            ends = (c(0), c(n - 1))
            inside = all(r + 2 <= v <= size - r - 2 for p in ends for v in p)
            if inside and clear(c, r, 0, n - 1):
                add(label, 0, n - 1, 0, c, ry, rx, rs.uniform(0, np.pi))
                label += 1
                break
    frames, labels = [], []
    for t in range(n):
        lab = np.zeros((size, size), np.uint16)
        for o in objs:
            if o["begin"] <= t <= o["end"]:
                oy, ox = o["centre"](t)
                r = max(o["ry"], o["rx"]) + 1
                y0, y1 = max(int(oy - r), 0), min(int(oy + r) + 1, size)
                x0, x1 = max(int(ox - r), 0), min(int(ox + r) + 1, size)
                dy, dx = yy[y0:y1, x0:x1] - oy, xx[y0:y1, x0:x1] - ox
                u = (dy * np.cos(o["th"]) + dx * np.sin(o["th"])) / o["ry"]
                v = (dx * np.cos(o["th"]) - dy * np.sin(o["th"])) / o["rx"]
                lab[y0:y1, x0:x1][u * u + v * v < 1] = o["label"]
        img = 0.25 + 0.45 * (lab > 0) + 0.05 * rs.standard_normal((size, size))
        frames.append(np.round(np.clip(img, 0, 1) * 255))
        labels.append(lab)
    rows = [(o["label"], o["begin"], o["end"], o["parent"]) for o in objs]
    return (np.stack(frames) / 255.0).astype(np.float32), np.stack(labels), rows


def frame_chunks(n_frames, per_call, grid, tile_batch):
    """Forward chunks of the sequence core over n_frames frames, read
    per_call frames (masks_tiled calls) at a time."""
    calls = [min(per_call, n_frames - s) for s in range(0, n_frames, per_call)]
    return sum(-(-k * grid.ny * grid.nx // tile_batch) for k in calls)


def score_both(gt, res, gt_tracks, res_tracks, name):
    """SEG and TRA/DET of res against gt by both backends, held to each
    other: equal counts, |dTRA| and |dDET| < 1e-12, every object's SEG
    within 1e-12. Returns the native (seg, tra) and each backend's
    (SEG ms, TRA/DET ms)."""
    out, ms = {}, {}
    for b in ctc.BACKENDS:
        t0 = time.perf_counter()
        seg = ctc.seg_measure_arrays(gt, res, backend=b)
        t1 = time.perf_counter()
        tra = ctc.tra_det_arrays(gt, res, gt_tracks, res_tracks, backend=b)
        ms[b] = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)
        out[b] = seg, tra
    (sn, tn), (sp, tp) = out["native"], out["python"]
    counts = [{k: float(v) for k, v in t.counts.items()} for t in (tn, tp)]
    if (counts[0] != counts[1] or abs(tn.tra - tp.tra) >= 1e-12 or abs(tn.det - tp.det) >= 1e-12
            or sn.per_object.shape != sp.per_object.shape
            or np.abs(sn.per_object - sp.per_object).max(initial=0.0) >= 1e-12):
        raise AssertionError(f"{name}: the native and python measures differ: counts {counts}, "
                             f"TRA {tn.tra!r} / {tp.tra!r}, DET {tn.det!r} / {tp.det!r}, SEG "
                             f"{sn.value!r} / {sp.value!r}")
    return sn, tn, ms


def measure_ms(ms):
    return ", ".join(f"{m} {ms['native'][i]:.1f} native / {ms['python'][i]:.1f} python"
                     for i, m in enumerate(("SEG", "TRA/DET")))


def write_ctc_root(root, frames, labels, rows, seq="01"):
    """The sequence as sequence `seq` of a CTC data root: <seq>/t*.tif, the
    labels as silver truth <seq>_ST/SEG (every frame), gold <seq>_GT/SEG
    (every CTC_SEG_EVERY-th frame) and <seq>_GT/TRA markers with
    man_track.txt."""
    from PIL import Image

    dirs = {k: os.path.join(root, seq + k) for k in ("", "_ST/SEG", "_GT/SEG", "_GT/TRA")}
    for d in dirs.values():
        os.makedirs(d)
    for t, (f, lab) in enumerate(zip(frames, labels)):
        Image.fromarray(np.round(f * 255).astype(np.uint8)).save(
            os.path.join(dirs[""], f"t{t:03d}.tif"))
        Image.fromarray(lab).save(os.path.join(dirs["_ST/SEG"], f"man_seg{t:03d}.tif"))
        Image.fromarray(lab).save(os.path.join(dirs["_GT/TRA"], f"man_track{t:03d}.tif"))
        if t % CTC_SEG_EVERY == 0:
            Image.fromarray(lab).save(os.path.join(dirs["_GT/SEG"], f"man_seg{t:03d}.tif"))
    with open(os.path.join(dirs["_GT/TRA"], "man_track.txt"), "w") as fh:
        fh.writelines(f"{a} {b} {e} {p}\n" for a, b, e, p in rows)


def cut_recipe(path):
    """configs/best_recipe.json cut to CTC_EPOCHS epochs at SEQ_MODEL's
    width, written to `path`; returns its Config."""
    with open(RECIPE_JSON) as fh:
        recipe = json.load(fh)
    recipe["train"]["num_epochs"] = CTC_EPOCHS
    recipe["model"] = dataclasses.asdict(SEQ_MODEL)  # the recipe's: ModelConfig(), full width
    with open(path, "w") as fh:
        json.dump(recipe, fh)
    return Config.from_json_file(path)


def run_cli(argv):
    """cli.main in this process, its standard output captured: (rc, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def summary_equals_evaluate_ctc(name, row, root, out, seq):
    """A pipeline summary's row for `seq` against the evaluate-ctc command
    run alone on <out>/<seq>_CTC; returns its {SEG, TRA, DET}."""
    alone = {}
    for measure, gt_dir in (("seg", "SEG"), ("tra", "TRA")):
        rc, text = run_cli(["evaluate-ctc", measure, "--gt-dir",
                            os.path.join(root, f"{seq}_GT", gt_dir), "--res-dir",
                            os.path.join(out, f"{seq}_CTC")])
        if rc != 0:
            raise AssertionError(f"{name}: evaluate-ctc {measure} on {seq}: exit code {rc}")
        alone.update(json.loads(text.strip().splitlines()[-1]))
    scores = {k: row[k] for k in ("SEG", "TRA", "DET")}
    if scores != {k: alone[k] for k in scores} or not all(0 <= v <= 1 for v in scores.values()):
        raise AssertionError(f"{name}: {seq} summary {scores} against evaluate-ctc {alone}")
    return scores


def pipeline_run(gpu, frames, labels, rows):
    """Phase 11 (d): the pipeline command in this process on the sequence
    written as a CTC data root, with configs/best_recipe.json cut to
    CTC_EPOCHS epochs at full width: its summary against the evaluate-ctc
    command, its res_track.txt against the track command run alone, and
    its exact launches. Returns the launches."""
    work = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    root, out = os.path.join(work, "data"), os.path.join(work, "out")
    write_ctc_root(root, frames, labels, rows)
    conf = os.path.join(work, "recipe.json")
    cfg = cut_recipe(conf)
    stage_s = {}

    def timed(name, fn):
        def run(args):
            t0 = time.perf_counter()
            rc = fn(args)
            torch.cuda.synchronize()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - t0
            return rc
        return run

    stages = {n: getattr(cli, f"cmd_{n}") for n in ("preprocess", "train", "predict", "track")}
    for n, fn in stages.items():
        setattr(cli, f"cmd_{n}", timed(n, fn))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc, text = run_cli(["pipeline", "--config", conf, "--data-root", root, "--output-dir",
                            out, *(["--cpu"] if DEVICE == "cpu" else [])])
    finally:
        for n, fn in stages.items():
            setattr(cli, f"cmd_{n}", fn)
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    with open(os.path.join(work, "pipeline.log"), "w") as fh:
        fh.write(text)
    if rc != 0:
        raise AssertionError(f"pipeline: exit code {rc}; the end of its output:\n{text[-4000:]}")

    # the launches: every train step's and every forward chunk's, exactly
    n_train = len(train_val_split(CTC_FRAMES, cfg.data.val_percent, cfg.train.seed)[0])
    steps = CTC_EPOCHS * -(-n_train // cfg.train.batch_size)
    icfg = cfg.infer
    grid = plan_tiles(SIZE, SIZE, icfg.tile_input)
    forwards = (frame_chunks(CTC_FRAMES, icfg.tile_batch, grid, icfg.tile_batch)
                * len(TTA_TRANSFORMS[icfg.tta]))
    want = {k: steps * TRAIN_LAUNCHES.get(k, 0) + forwards * DEFAULT_LAUNCHES.get(k, 0)
            for k in {**TRAIN_LAUNCHES, **DEFAULT_LAUNCHES}}
    ran = {k: v for k, v in launches.items() if v}
    if ran != want:
        raise AssertionError(f"pipeline: launches {ran}, expected {want} ({steps} train steps, "
                             f"{forwards} forward chunks)")

    # the summary against evaluate-ctc, res_track.txt against track alone
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)["01"]
    if json.loads(text.strip().splitlines()[-1]) != {"pipeline": {"01": summary}}:
        raise AssertionError("pipeline: the printed summary differs from summary.json")
    ctc_dir = os.path.join(out, "01_CTC")
    scores = summary_equals_evaluate_ctc("pipeline", summary, root, out, "01")
    rc, _ = run_cli(["track", "--instance-dir", os.path.join(out, "01_RES_INST"), "--output",
                     os.path.join(work, "alone.txt")])
    with open(os.path.join(work, "alone.txt"), "rb") as a, \
            open(os.path.join(ctc_dir, "res_track.txt"), "rb") as b:
        if rc != 0 or a.read() != b.read():
            raise AssertionError("pipeline: 01_CTC/res_track.txt differs from the track command's")
    tracks = read_track_file(os.path.join(ctc_dir, "res_track.txt"))
    stage_s["scoring"] = wall - sum(stage_s.values())
    print(f"pipeline: exit 0 in {wall:.2f} s on {CTC_FRAMES} frames of {SIZE}^2 (the best recipe, "
          f"{CTC_EPOCHS} epoch of {steps} steps, base {cfg.model.base_features} "
          f"{cfg.model.compute_dtype}): seconds per stage "
          f"{ {k: round(v, 2) for k, v in stage_s.items()} }; launches {ran} = {steps} steps x "
          f"TRAIN_LAUNCHES + {forwards} forward chunks x the serving kernels; {len(tracks)} "
          f"tracks; summary {scores} equals the evaluate-ctc command's (synthetic sequence, "
          f"1-epoch weights), and 01_CTC/res_track.txt the track command's, on {gpu}", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def scoring_path(gpu, pil):
    """Phase 11: tracking and CTC scoring. (a) a synthetic CTC sequence;
    (b) the known answer: the tracker over the GT labels, relabelled by
    track, scores SEG = TRA = DET = 1 by both backends and finds the
    planted division; (c) the planted net's instances (one member, through
    the kernels) tracked and scored by both backends, held to each other;
    (d) with Pillow, the pipeline command. Returns the launches of (c) and
    (d)."""
    frames, labels, rows = ctc_sequence(np.random.RandomState(SEED + 11), CTC_FRAMES, SIZE)
    gt, gt_tracks = list(labels), [CellTrack(*r) for r in rows]
    t0 = time.perf_counter()
    ctc.build_native()  # g++ at first use: outside the measures' times
    build_s = time.perf_counter() - t0
    t_div = min(r[1] for r in rows if r[3])
    left = next(e for lab, _, e, _ in rows if e < CTC_FRAMES - 1 and lab not in
                {r[3] for r in rows})

    def tracked(masks):
        tracker = Tracker()
        t0 = time.perf_counter()
        tracks = tracker.track_arrays(masks)
        ms = (time.perf_counter() - t0) * 1e3 / len(masks)
        return tracks, [relabel_by_track(m, a) for m, a in zip(masks, tracker.assignments())], ms

    tracks, res, track_ms = tracked(gt)
    kids = {}
    for t in tracks:
        if t.parent_label:
            kids.setdefault(t.parent_label, []).append(t.start_frame)
    seg, tra, ms = score_both(gt, res, gt_tracks, tracks, "known answer")
    if list(kids.values()) != [[t_div, t_div]] or (seg.value, tra.tra, tra.det) != (1.0, 1.0, 1.0):
        raise AssertionError(f"known answer: divisions {kids} (planted: one at frame {t_div}), "
                             f"SEG {seg.value!r}, TRA {tra.tra!r}, DET {tra.det!r}")
    print(f"scoring path: known answer on {CTC_FRAMES} synthetic {SIZE}^2 GT frames "
          f"({len(rows)} tracks, one division at frame {t_div}, one cell leaving at frame "
          f"{left + 1}): the tracker found the division, SEG = TRA = DET = 1.0 by both "
          f"backends, counts { {k: int(v) for k, v in tra.counts.items()} }; "
          f"tracker {track_ms:.2f} ms per frame on the host; {measure_ms(ms)} ms (the native "
          f"library built in {build_s:.2f} s before)", flush=True)

    # (c) the planted net's instances, one member through the kernels
    icfg = InferConfig(tile_input=min_tile_input(SIZE), tile_batch=BATCH)
    pred = Predictor(SEQ_MODEL, plant_intensity_path(fast_random_variables(SEQ_MODEL, SEED + 10)),
                     icfg, DEVICE)
    pred.masks_tiled(frames[:BATCH])  # warm-up
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = sorted(pred.predict_frames(frames, range(CTC_FRAMES), tiled=True), key=lambda r: r[0])
    torch.cuda.synchronize()
    core_s = time.perf_counter() - t0
    launches = K.launch_counts()
    check_launches("scoring path core", launches, DEFAULT_LAUNCHES, frame_chunks(
        CTC_FRAMES, icfg.tile_batch, plan_tiles(SIZE, SIZE, icfg.tile_input), icfg.tile_batch))
    insts = [i for _, _, i in got]
    tracks, res, track_ms = tracked(insts)
    seg, tra, ms = score_both(gt, res, gt_tracks, tracks, "planted net")
    for v in (seg.value, tra.tra, tra.det):
        if not 0.0 <= v <= 1.0:
            raise AssertionError(f"planted net: a measure outside [0, 1]: {v}")
    print(f"scoring path: synthetic sequence, planted weights (not the north-star SEG): SEG "
          f"{seg.value:.6f}, TRA {tra.tra:.6f}, DET {tra.det:.6f} ({len(tracks)} tracks, "
          f"{sum(1 for t in tracks if t.parent_label) // 2} divisions, counts "
          f"{ {k: int(v) for k, v in tra.counts.items()} }), native equals python; the core "
          f"{core_s * 1e3 / CTC_FRAMES:.2f} ms per frame; tracker {track_ms:.2f} ms per frame on "
          f"the host; {measure_ms(ms)} ms, on {gpu}", flush=True)
    del pred
    if pil:
        piped = pipeline_run(gpu, frames, labels, rows)
        launches = {k: v + piped[k] for k, v in launches.items()}
    else:
        print("pipeline: Pillow is not installed here; the pipeline command (TIFF reads and "
              "writes) was not driven", flush=True)
    return launches


def dp_grads(cfg, state, images, masks, weights, valid, draws, tier2, mesh, kernels=True):
    """(loss, new statistics, gradients) of the step make_train_step takes
    with these draws (under a mesh: this rank's rows of them and the
    group's sums) through the kernel train forward, or the plain one
    (`kernels` False), for the comparison; the caller does not count its
    launches."""
    group = None if mesh is None else mesh.data_group
    if mesh is not None:
        draws = draws.rows(mesh.batch_rows(images.shape[0] * mesh.num_data))
    augmenter = make_augmenter(True, RECIPE["elastic_alpha"], RECIPE["elastic_sigma"], False,
                               1.0, RECIPE["standardize"], RECIPE["aug_gamma"],
                               RECIPE["aug_illum"], RECIPE["aug_noise"])
    x, t, w = augmenter(images, masks, weights, draws)
    forward = (functools.partial(train_forward, tier2=tier2, group=group) if kernels
               else functools.partial(unet_train_forward, group=group))
    return loss_and_grads(forward, state, x, t, w, valid, None if bool(valid.all()) else valid,
                          cfg, group)


def dp_errors(got, ref):
    """{quantity: error} of a step's (loss, grad_norm, grads, stats)
    against another's: loss and grad_norm relative, each gradient's
    relative L2 error and the whole gradient's ("all gradients"; not the
    zero-gradient biases), each running statistic's max error over its
    max."""
    (loss, gnorm, grads, stats), (loss1, gnorm1, grads1, stats1) = got, ref
    err = {"loss": abs(loss - loss1) / abs(loss1), "grad_norm": abs(gnorm - gnorm1) / gnorm1}
    keys = [k for k, g in grads1.items() if not zero_grad_params(k) and float(g.norm()) > 0]
    err.update({k: float((grads[k] - grads1[k]).norm() / grads1[k].norm()) for k in keys})
    diff = sum(float((grads[k] - grads1[k]).square().sum()) for k in keys)
    err["all gradients"] = (diff / sum(float(grads1[k].square().sum()) for k in keys)) ** 0.5
    err.update({k: float((stats[k] - v).abs().max() / v.abs().max()) for k, v in stats1.items()})
    return err


def dp_tolerance(key):
    if key in ("loss", "grad_norm"):
        return DP_LOSS_RTOL
    return DP_STATS_RTOL if key.endswith(("running_mean", "running_var")) else DP_GRAD_L2


def dp_compare(name, dp, single, ref=None):
    """Hold the data-parallel step's (loss, grad_norm, grads, stats) to
    the single-process step's (see the phase-12 constants). Without
    `ref`: each quantity but the single gradient tensors within its
    tolerance. With the plain fp32 step's `ref`: each quantity no further
    from ref than max(DP_NOISE_FACTOR x the single step's distance, the
    tolerance). Any miss raises. Returns the worst share of its bound and
    the errors against the single step."""
    vs = dp_errors(dp, single)
    if ref is None:
        errs = {k: v for k, v in vs.items() if dp_tolerance(k) != DP_GRAD_L2}
        errs["all gradients"] = vs["all gradients"]
        bound = {k: dp_tolerance(k) for k in errs}
    else:
        errs, base = dp_errors(dp, ref), dp_errors(single, ref)
        bound = {k: max(DP_NOISE_FACTOR * base[k], dp_tolerance(k)) for k in errs}
    share, at = max((errs[k] / bound[k], k) for k in errs)
    grads = {k: v for k, v in vs.items()
             if dp_tolerance(k) == DP_GRAD_L2 and k != "all gradients"}
    stats = {k: v for k, v in vs.items() if dp_tolerance(k) == DP_STATS_RTOL}
    out = {"share": share, "share_at": at, "loss_rel": vs["loss"],
           "grad_norm_rel": vs["grad_norm"], "grad_all": vs["all gradients"],
           "grad_l2": max(grads.values()), "grad_at": max(grads, key=grads.get),
           "stats": max(stats.values()), "stats_at": max(stats, key=stats.get)}
    if share > 1.0:
        raise AssertionError(f"{name}: the data-parallel step misses its bound at {at}: error "
                             f"{errs[at]:.3e}, bound {bound[at]:.3e}; against the single step "
                             f"{out}")
    return out


def doubled_equal(dp, single):
    """The exact check's comparison: every tensor of the two states bit
    for bit but the running variances and their EMA, whose unbiasing
    factor n / (n - 1) counts the doubled batch (the four-item comparison
    holds them, with the same n on both sides)."""
    pairs = [(dp.params, single.params), (dp.opt_state["mu"], single.opt_state["mu"]),
             (dp.opt_state["nu"], single.opt_state["nu"]), (dp.ema_params, single.ema_params),
             (dp.batch_stats, single.batch_stats), (dp.ema_batch_stats, single.ema_batch_stats)]
    return all(torch.equal(a[k], b[k]) for a, b in pairs for k in a
               if not k.endswith("running_var"))


def doubled(draws):
    """The draws of a batch twice over (the exact check's global draws)."""
    return AugmentDraws(**{f.name: None if getattr(draws, f.name) is None
                           else torch.cat([getattr(draws, f.name)] * 2)
                           for f in dataclasses.fields(draws)})


def dp_worker(rank, work):
    """One rank of phase 12 (`chip_smoke.py --dp-worker RANK DIR`): (a) the
    data-parallel train steps against the single-process step (rank 0
    runs the references, uncounted), each from the seeded state with its
    own draws: five through the kernels (bf16, held through the plain
    fp32 step, see DP_NOISE_FACTOR) and one through the plain forward in
    fp32 (held at the tolerances); (b) tile-sharded masks_tiled. Writes
    DIR/rank<RANK>.json.

    Each step starts from the seeded state: after a few Adam steps this
    net reaches states where the order of the BatchNorm sums alone moves
    some gradients by 10% (measured on the CPU at base 8: splitting the
    sums of any one of enc0.bn0, enc1.bn0, enc1.bn1 into two halves in
    one process moves enc0.conv0's gradient as much as two ranks do),
    which no tolerance for summation order covers."""
    distributed.maybe_initialize(f"file://{work}/rendezvous", DP_RANKS, rank,
                                 local_device_ids=[0])
    torch.backends.cudnn.allow_tf32 = False  # the fp32 steps in fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MeshConfig())
    dev, cfg = mesh.device, TRAIN_MODEL
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = {"rank": rank, "backend": torch.distributed.get_backend(), "device": str(dev),
           "steps": [], "launches": {}}

    def add(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    batch = np.load(os.path.join(work, "batch.npz"))
    images, masks, wts = (torch.from_numpy(batch[k]).to(dev) for k in ("images", "masks", "wts"))
    rows = mesh.batch_rows(TRAIN_BATCH)
    state = create_train_state(fast_random_variables(cfg, SEED), cfg, RECIPE_TRAIN,
                               steps_per_epoch=STEPS_PER_EPOCH, device=dev)
    plan = [("tier 1 step 1", True, False), ("tier 1 step 2", True, False),
            ("tier 1 step 3", True, False)][:DP_STEPS]
    plan += [("tier 1, valid [T, T, T, F]", False, False), ("tier 2", True, True),
             ("plain fp32", True, None)]
    torch.backends.cudnn.deterministic = True  # the exact check compares bits
    for i, (name, all_valid, tier2) in enumerate(plan):
        kernels = tier2 is not None  # else the plain forward in fp32, without cuDNN
        c = cfg if kernels else cfg32
        torch.backends.cudnn.enabled = kernels
        valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
        valid[-1] = all_valid
        gen = torch.Generator(device=dev).manual_seed(SEED + 120 + i)
        draws = draw_augment(gen, images, True, RECIPE["aug_gamma"], RECIPE["aug_illum"],
                             RECIPE["aug_noise"])
        local = (images[rows], masks[rows], wts[rows], valid[rows])

        def make(mesh):
            return make_train_step(c, lanes="auto" if kernels else "off",
                                   assume_valid=all_valid, tier2=bool(tier2), mesh=mesh,
                                   **RECIPE)

        torch.cuda.synchronize()
        distributed.barrier()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        new, metrics = make(mesh)(state, *local, draws=draws)
        torch.cuda.synchronize()
        dp_ms = (time.perf_counter() - t0) * 1e3
        launches = K.launch_counts()
        add(launches)
        per_step = (TIER2_LAUNCHES if tier2 else TRAIN_LAUNCHES) if kernels else PLAIN_LAUNCHES
        check_launches(f"data-parallel {name} (rank {rank})", launches, per_step, 1)
        _, _, grads = dp_grads(c, state, *local, draws, bool(tier2), mesh, kernels)
        rec = {"name": name, "dp_ms": dp_ms, "digest": distributed.tensor_digest(new.params),
               "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}

        # the exact check: the same two items (and draws) on both ranks,
        # with the second half's validity ([T, F] in the masked step)
        mine = (images[:2], masks[:2], wts[:2], valid[2:])
        new2, m2 = make(mesh)(state, *mine, draws=doubled(draws.rows(slice(0, 2))))
        rec["digest_doubled"] = distributed.tensor_digest(new2.params)
        if rank == 0:  # the references: one process, the same state and draws
            single1, s1 = make(None)(state, *mine, draws=draws.rows(slice(0, 2)))
            # grad_norm sums the summed gradients, views into one flat
            # buffer, where the single step sums fresh tensors: the
            # reductions may group them otherwise (1 ulp on the CPU)
            same = (float(m2["loss"]) == float(s1["loss"])
                    and abs(float(m2["grad_norm"]) / float(s1["grad_norm"]) - 1) <= 1e-6
                    and doubled_equal(new2, single1))
            if not same:
                worst = max((float((new2.params[k] - t).abs().max()), k)
                            for k, t in single1.params.items())
                raise AssertionError(
                    f"{name}: two ranks holding the same two items differ from one process on "
                    f"them: loss {float(m2['loss'])} vs {float(s1['loss'])}, grad_norm "
                    f"{float(m2['grad_norm'])} vs {float(s1['grad_norm'])}, worst parameter "
                    f"{worst}")
            del single1

            def single_step(c, lanes, tier2, kernels):
                step1 = make_train_step(c, lanes=lanes, assume_valid=all_valid, tier2=tier2,
                                        **RECIPE)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new1, m1 = step1(state, images, masks, wts, valid, draws=draws)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                _, _, g1 = dp_grads(c, state, images, masks, wts, valid, draws, tier2, None,
                                    kernels)
                return (float(m1["loss"]), float(m1["grad_norm"]), g1, new1.batch_stats), ms

            dp = (rec["loss"], rec["grad_norm"], grads, new.batch_stats)
            single, rec["single_ms"] = single_step(c, "auto" if kernels else "off",
                                                   bool(tier2), kernels)
            ref = single_step(cfg32, "off", False, False)[0] if kernels else None
            rec["held"] = (f"to plain fp32 at {DP_NOISE_FACTOR} x the single step's error"
                           if kernels else "to the single step but the single tensors")
            rec.update(dp_compare(name, dp, single, ref))
            del single, ref
        out["steps"].append(rec)
        del new, new2, grads
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False

    # (b) tile-sharded serving: phase 4's Predictor over the two ranks
    del state
    torch.cuda.empty_cache()
    variables = plant_intensity_path(fast_random_variables(ModelConfig(), SEED))
    frames = cell_frames(np.random.RandomState(SEED), FRAMES, SIZE)
    tile = min_tile_input(SIZE)
    pred = Predictor(ModelConfig(), variables, InferConfig(tile_input=tile, tile_batch=BATCH),
                     dev, mesh=mesh)
    pred.masks_tiled(frames)  # warm-up
    torch.cuda.synchronize()
    distributed.barrier()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    got = pred.masks_tiled(frames)
    torch.cuda.synchronize()
    out["serving_ms"] = (time.perf_counter() - t0) * 1e3
    launches = K.launch_counts()
    add(launches)
    check_launches(f"tile-sharded serving (rank {rank})", launches, DEFAULT_LAUNCHES,
                   chunks(plan_tiles(SIZE, SIZE, tile)))
    want = np.load(os.path.join(work, "phase4_masks.npy"))
    out["serving_differ"] = int((got != want).sum())
    out["serving_shape"] = list(got.shape)
    distributed.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_cli_run(gpu, work, frames, labels):
    """Phase 12 (c): `python -m unetseg_tpu_torch train` twice, joined by
    --coordinator / --num-processes 2 / --process-id, both ranks on the
    card; returns rank 0's checkpoint directory."""
    from PIL import Image

    root = os.path.join(work, "hela")
    for sub in ("01", "01_ST/SEG", "01_ST/WEIGHT_MAPS"):
        os.makedirs(os.path.join(root, sub))
    for t, (f, lab) in enumerate(zip(frames, labels)):
        Image.fromarray(np.round(f * 255).astype(np.uint8)).save(
            os.path.join(root, "01", f"t{t:03d}.tif"))
        Image.fromarray(lab.astype(np.uint16)).save(
            os.path.join(root, "01_ST", "SEG", f"man_seg{t:03d}.tif"))
        np.save(os.path.join(root, "01_ST", "WEIGHT_MAPS", f"weight_map_{t:03d}.npy"),
                weight_map_np(lab, mode="reference"))
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.perf_counter()
    for r in range(DP_RANKS):
        argv = [sys.executable, "-m", "unetseg_tpu_torch", "train", "--config", RECIPE_JSON,
                "--data-root", root, "--sequence", "01", "--epochs", "1",
                "--coordinator", f"file://{work}/cli_rendezvous", "--num-processes",
                str(DP_RANKS), "--process-id", str(r),
                "--checkpoint-dir", os.path.join(work, f"ck{r}"),
                "--metrics-jsonl", os.path.join(work, f"m{r}.jsonl")]
        log = open(os.path.join(work, f"cli{r}.log"), "w")
        procs.append((subprocess.Popen(argv, cwd=here, stdout=log, stderr=subprocess.STDOUT),
                      log))
    codes = wait_all(procs, DP_TIMEOUT)
    wall = time.perf_counter() - t0
    logs = [open(os.path.join(work, f"cli{r}.log")).read() for r in range(DP_RANKS)]
    if codes != [0] * DP_RANKS:
        raise AssertionError(f"dp path (c): exit codes {codes}: {logs}")
    digests = [re.findall(r"parameters sha256 ([0-9a-f]+)", log) for log in logs]
    if not all(len(d) == 1 for d in digests) or digests[0] != digests[1]:
        raise AssertionError(f"dp path (c): the ranks' parameters differ: {digests}")
    ck0 = os.path.join(work, "ck0")
    if os.path.exists(os.path.join(work, "ck1")) or os.path.exists(os.path.join(work, "m1.jsonl")):
        raise AssertionError("dp path (c): rank 1 wrote checkpoints or metrics")
    with open(os.path.join(work, "m0.jsonl")) as f:
        events = [json.loads(ln)["event"] for ln in f]
    if events.count("start") != 1 or "checkpoint_full" not in events:
        raise AssertionError(f"dp path (c): rank 0's metrics {events}")
    full = torch.load(os.path.join(ck0, "full", "0.pt"), map_location="cpu", weights_only=True)
    if distributed.tensor_digest(full["params"]) != digests[0][0]:
        raise AssertionError("dp path (c): the full checkpoint is not the ranks' parameters")
    print(f"dp path (c): the train command on {DP_RANKS} ranks of the card, 1 epoch of "
          f"{DP_CLI_FRAMES // TRAIN_BATCH} steps at full width: exit codes {codes}, {wall:.1f} s "
          f"of command; parameters sha256 {digests[0][0][:16]}... on both ranks and in rank 0's "
          f"full checkpoint; rank 1 wrote no checkpoint and no metrics (rank 0's events "
          f"{events})", flush=True)
    return ck0


def wait_all(procs, timeout):
    """Exit codes of (Popen, log) pairs; stragglers past the timeout are
    killed (and count as failed)."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [p.returncode for p, _ in procs]


def dp_path(gpu, pil, phase4_masks):
    """Phase 12: data parallelism over two ranks on the one card (gloo).
    (a) three tier-1 steps, one with valid [T, T, T, F] and one tier-2
    step, each against the single-process batch-4 step with the same
    draws; (b) tile-sharded masks_tiled against phase 4's masks; (c) with
    Pillow, the train command on two ranks, and its checkpoint served.
    Returns the launches of (a) and (b), both ranks summed."""
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    frames, labels = cell_frames(np.random.RandomState(SEED + 3), TRAIN_BATCH, TRAIN_SIZE,
                                 labels=True)
    wts = np.stack([weight_map_np(lab, mode="reference") for lab in labels])
    np.savez(os.path.join(work, "batch.npz"), images=frames, masks=labels, wts=wts)
    np.save(os.path.join(work, "phase4_masks.npy"), phase4_masks)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = []
    for r in range(DP_RANKS):
        log = open(os.path.join(work, f"worker{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-worker", str(r), work],
            stdout=log, stderr=subprocess.STDOUT), log))
    codes = wait_all(procs, DP_TIMEOUT)
    wall = time.perf_counter() - t0
    logs = [open(os.path.join(work, f"worker{r}.log")).read() for r in range(DP_RANKS)]
    if codes != [0] * DP_RANKS:
        raise AssertionError(f"dp path: worker exit codes {codes}:\n" + "\n".join(logs))
    res = []
    for r in range(DP_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            res.append(json.load(f))
    print(f"dp path: {DP_RANKS} ranks on {res[0]['device']} over {res[0]['backend']}, "
          f"{wall:.1f} s of workers (start-up included)", flush=True)
    for i, rec in enumerate(res[0]["steps"]):
        for key in ("digest", "digest_doubled"):
            if len({rr["steps"][i][key] for rr in res}) != 1:
                raise AssertionError(f"dp path: {rec['name']}: the ranks' parameters differ")
        print(f"dp path (a): {rec['name']}: two ranks holding the same two items match one "
              f"process on them (parameters, optimizer state, EMA and running means bit for "
              f"bit); on four items: loss {rec['loss']:.6f}, grad_norm "
              f"{rec['grad_norm']:.6f}; against the single-process step: loss rel "
              f"{rec['loss_rel']:.2e}, grad_norm rel {rec['grad_norm_rel']:.2e}, the whole "
              f"gradient rel L2 {rec['grad_all']:.2e}, worst tensor "
              f"{rec['grad_l2']:.2e} ({rec['grad_at']}), worst running statistic "
              f"{rec['stats']:.2e} ({rec['stats_at']}); held {rec['held']}: worst share of the bound "
              f"{rec['share']:.3f} ({rec['share_at']}); both ranks' parameters bit for bit "
              f"equal; step {rec['dp_ms']:.1f} ms on 2 ranks vs {rec['single_ms']:.1f} ms in one "
              f"process (wall, rank 0, information only) on {gpu}", flush=True)
    n_pix = phase4_masks.size
    for rr in res:
        if rr["serving_differ"] or rr["serving_shape"] != list(phase4_masks.shape):
            raise AssertionError(
                f"dp path (b): rank {rr['rank']}'s masks {rr['serving_shape']}: "
                f"{rr['serving_differ']} pixels from phase 4's")
    print(f"dp path (b): tile-sharded masks_tiled on {FRAMES} frames ({BATCH} tiles a chunk, "
          f"{BATCH // DP_RANKS} a rank): uint8 masks equal to phase 4's single-rank masks "
          f"bit for bit on both ranks ({n_pix} pixels); {res[0]['serving_ms']:.1f} ms (rank 0 "
          f"wall, information only)", flush=True)
    launches = {}
    for rr in res:
        for k, v in rr["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"dp path: launches of (a) and (b), both ranks: {launches}", flush=True)
    if pil:
        cli_frames, cli_labels = cell_frames(np.random.RandomState(SEED + 12), DP_CLI_FRAMES,
                                             TRAIN_SIZE, labels=True)
        ck0 = dp_cli_run(gpu, work, cli_frames, cli_labels)
        pred = Predictor.from_checkpoint(ck0, TRAIN_MODEL, InferConfig(
            tile_input=min_tile_input(TRAIN_SIZE), tile_batch=2), device=DEVICE)
        served = pred.masks_tiled(cli_frames[:2])
        if served.shape != (2, TRAIN_SIZE, TRAIN_SIZE) or served.dtype != np.uint8 or \
                set(np.unique(served)) - {0, 1}:
            raise AssertionError(f"dp path (c): served masks {served.shape} {served.dtype}")
        print(f"dp path (c): rank 0's checkpoint served {served.shape} uint8 masks", flush=True)
    else:
        print("dp path (c): Pillow is not installed: the train command's run is left out",
              flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return launches


def export_path(gpu, mpl, variables, frames):
    """Phase 13: the default serving forward exported at full width
    (phase 4's planted weights) with a symbolic batch, loaded in a fresh
    process and in this one, held to Predictor.probs at each of
    EXPORT_BATCHES with its exact launches and timed beside it; then
    visualize-augmentation's deformation of one 512^2 frame on the card.
    Returns the launches of the artifact's calls here and of the
    deformation."""
    from unetseg_tpu_torch.infer.export import export_inference, load_exported, save_exported
    from unetseg_tpu_torch.ops.kernels import library
    from unetseg_tpu_torch.utils.profiling import DeviceTimer

    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    cfg, icfg = ModelConfig(), InferConfig(image_size=EXPORT_SIZE)
    frames = frames[:max(EXPORT_BATCHES)]
    timer = DeviceTimer()
    data = export_inference(cfg, variables, icfg, device="cuda")
    export_s = timer.stop()
    path = os.path.join(work, "serving.pt2")
    save_exported(path, data)
    np.save(os.path.join(work, "frames.npy"), frames)
    here = os.path.dirname(os.path.abspath(__file__))
    timer.start()
    res = subprocess.run([sys.executable, "-c", EXPORT_LOADER, here, work,
                          json.dumps(list(EXPORT_BATCHES))], capture_output=True, text=True,
                         timeout=EXPORT_TIMEOUT)
    fresh_s = timer.stop()
    if res.returncode != 0:
        raise AssertionError(f"export: the fresh process failed:\n{res.stdout}\n{res.stderr}")
    fresh = json.loads(res.stdout.strip().splitlines()[-1])
    imported = f"imported: {fresh['imported']}" if fresh["imported"] else "not imported"
    print(f"export: {len(data) / 1e6:.1f} MB artifact (platforms {','.join(fresh['platforms'])}, "
          f"batch symbolic, input {EXPORT_SIZE}^2) in {export_s:.1f} s; a fresh process loaded "
          f"and ran it in {fresh_s:.1f} s with unetseg_tpu_torch.infer.engine and "
          f"unetseg_tpu_torch.train {imported} on {gpu}", flush=True)
    if fresh["imported"]:
        raise AssertionError(f"export: loading imported {fresh['imported']}")
    for b in EXPORT_BATCHES:
        check_launches(f"export (fresh process) batch {b}", fresh["launches"][str(b)],
                       DEFAULT_LAUNCHES, 1)

    fn = load_exported(path, device="cuda")
    ops = {str(n.target) for n in fn.exported.graph.nodes if n.op == "call_function"}
    missing = {f"unetseg.{name}.default" for name in library.OPS} - ops
    if missing:
        raise AssertionError(f"export: the graph does not name {sorted(missing)}")
    pred = Predictor(cfg, variables, icfg, "cuda")
    total = {k: 0 for k in SOURCES}
    out = unet_shapes(EXPORT_SIZE).output_size
    for b in EXPORT_BATCHES:
        x = frames[:b]
        K.reset_launch_counts()
        p = fn(x)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        check_launches(f"export batch {b}", launches, DEFAULT_LAUNCHES, 1)
        for k, v in launches.items():
            total[k] += v
        q = pred.probs(x)
        fresh_p = torch.from_numpy(np.load(os.path.join(work, f"fresh{b}.npy"))).cuda()
        if (tuple(p.shape) != (b, out, out) or not bool(torch.isfinite(p).all())
                or not bool(((p >= 0) & (p <= 1)).all())):
            raise AssertionError(f"export batch {b}: probabilities {tuple(p.shape)} not finite "
                                 f"in [0, 1]")
        same, same_fresh = bool(torch.equal(p, q)), bool(torch.equal(fresh_p, q))
        line = (f"export batch {b}: launches {DEFAULT_LAUNCHES} a call; probabilities equal to "
                f"Predictor.probs bit for bit: {same} (here), {same_fresh} (fresh process)")
        if not (same and same_fresh):
            thr = pred.cfg.threshold
            diff = max((p - q).abs().max().item(), (fresh_p - q).abs().max().item())
            agree = min(float(((p > thr) == (q > thr)).float().mean()),
                        float(((fresh_p > thr) == (q > thr)).float().mean()))
            line += f"; largest difference {diff:.3e}, mask agreement {agree:.6f}"
            if agree < AGREEMENT_BAR:
                raise AssertionError(line)
        print(line, flush=True)

    times = {"artifact": [], "Predictor.probs": []}
    calls = {"artifact": lambda: fn(frames), "Predictor.probs": lambda: pred.probs(frames)}
    for r in range(EXPORT_ROUNDS):
        for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            times[k].append(cuda_ms(calls[k], iters=3, warmup=1))
    runs = "; ".join(f"{k} " + ", ".join(f"{t:.2f}" for t in v) for k, v in times.items())
    b = len(frames)
    print(f"export: batch {b} of {EXPORT_SIZE}^2 frames, ms per call (CUDA events, runs of 3 "
          f"alternating, host frames in): {runs}; median artifact "
          f"{np.median(times['artifact']):.2f} ms = "
          f"{b * EXPORT_SIZE ** 2 / 1e6 / (np.median(times['artifact']) / 1e3):.2f} MPix/s, "
          f"Predictor.probs {np.median(times['Predictor.probs']):.2f} ms (information only) "
          f"on {gpu}", flush=True)
    del fn, pred

    frame, labels = cell_frames(np.random.RandomState(SEED + 13), 1, EXPORT_SIZE, labels=True)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    di, dm = cli.augmentation_arrays(frame[0], labels[0], AUG_ALPHA, AUG_SIGMA, SEED, "cuda")
    aug_ms = (time.perf_counter() - t0) * 1e3
    aug = {k: v for k, v in K.launch_counts().items() if v}
    if aug != {"sample_displaced": 1}:
        raise AssertionError(f"visualize-augmentation: launches {aug}, expected one "
                             f"sample_displaced")
    total["sample_displaced"] += 1
    u = draw_elastic(torch.Generator().manual_seed(SEED), 1, EXPORT_SIZE, EXPORT_SIZE).cuda()
    yy, xx = displaced_coords(u, AUG_ALPHA, AUG_SIGMA)
    ref_img, ref_mask = KE.sample_displaced_plain(torch.from_numpy(frame).cuda(),
                                                  torch.from_numpy(labels).cuda(), yy, xx)
    err = float(np.abs(di - ref_img[0].cpu().numpy()).max())
    exact = bool(np.array_equal(dm, ref_mask[0].cpu().numpy()))
    moved = float((dm != labels[0]).mean())
    if mpl:
        from unetseg_tpu_torch.viz.overlays import save_augmentation_panel

        save_augmentation_panel(os.path.join(work, "augmentation.png"), frame[0], labels[0], di,
                                dm)
    print(f"visualize-augmentation: {EXPORT_SIZE}^2 frame and mask deformed on the card (alpha "
          f"{AUG_ALPHA:g}, sigma {AUG_SIGMA:g}, seed {SEED}): one sample_displaced launch, image "
          f"max_abs_err {err:.3e} against the plain version on the same uniforms (bound "
          f"{SAMPLER_ATOL:g}), mask exact: {exact}, {moved:.3f} of the labels moved; "
          f"{aug_ms:.1f} ms wall with the host copies on {gpu}; panel "
          f"{'written' if mpl else 'not written: matplotlib is not installed'}", flush=True)
    if not (err <= SAMPLER_ATOL and exact and np.isfinite(di).all()):
        raise AssertionError("visualize-augmentation: the deformation disagrees with the plain "
                             "sampler")
    shutil.rmtree(work, ignore_errors=True)
    return total


def bench_path(gpu):
    """Phase 14: the benchmark command and variant (d), each in a
    subprocess from the repository root; checks each JSON line and the
    launches it printed. Returns those launches (one segment call and,
    for the command, one train step)."""
    root = os.path.dirname(os.path.abspath(__file__))
    n = bench.forward_chunks(SIZE, FRAMES, min_tile_input(SIZE), BATCH)
    total = {k: 0 for k in SOURCES}
    for name, (argv, env, opts) in BENCH_RUNS.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], cwd=root, env={**os.environ, **env},
                           capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"bench {name}: exit code {r.returncode}\n{r.stderr[-4000:]}")
        line = r.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        launches = {m.group(1): json.loads(m.group(2)) for m in
                    re.finditer(r"^bench: launches (serving|train step) (\{.*\})$", r.stderr,
                                re.M)}
        want = {"serving": {k: v * n for k, v in
                            bench.serving_launches(ModelConfig(), **opts).items()}}
        keys = BENCH_KEYS
        if "BENCH_TRAIN" not in env:
            want["train step"] = TRAIN_LAUNCHES
            keys += BENCH_TRAIN_KEYS
        print(f"bench {name} on {gpu} ({seconds:.1f} s of subprocess): {line}", flush=True)
        print(f"bench {name}: launches {launches}", flush=True)
        missing = [k for k in keys if k not in rec]
        if missing or not rec["value"] > 0 or rec["device"] != gpu:
            raise AssertionError(f"bench {name}: keys {missing} missing, value {rec.get('value')}, "
                                 f"device {rec.get('device')!r} (expected {gpu!r})")
        if "train step" in want and not rec["train_step_ms"] > 0:
            raise AssertionError(f"bench {name}: train_step_ms {rec['train_step_ms']}")
        if rec["seg_seq01"] is not None or rec["seg_seq02"] is not None:
            raise AssertionError(f"bench {name}: a SEG the port did not compute")
        if launches != want:
            raise AssertionError(f"bench {name}: launches {launches}, expected {want}")
        for counts in launches.values():
            for k, v in counts.items():
                total[k] += v
    return total


def script_steps(lines):
    """[(step, wall seconds)] from the script's `[reproduce HH:MM:SS] text`
    lines, each stamped on this clock as it arrived: a step lasts until the
    next step's line (the last one until the script's exit, `end`)."""
    marks = [(t, re.split(r" \(| from |; | -> |: ", ln.split("] ", 1)[1])[0])
             for t, ln in lines if ln.startswith("[reproduce ")]
    ends = [t for t, _ in marks[1:]] + [lines[-1][0]]
    return [(text, end - t) for (t, text), end in zip(marks, ends)]


def run_script(argv, env, timeout):
    """argv in a new session, its output read line by line and stamped:
    (exit code, [(seconds since start, line)]). The whole session is
    killed at the timeout."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    timer = threading.Timer(timeout, lambda: os.killpg(proc.pid, 9))
    timer.start()
    lines = []
    try:
        for ln in proc.stdout:
            lines.append((time.perf_counter() - t0, ln.rstrip("\n")))
        rc = proc.wait()
    finally:
        timer.cancel()
    lines.append((time.perf_counter() - t0, ""))
    return rc, lines


def flagship_path(gpu, pil):
    """Phase 15: tools/reproduce_flagship_torch.sh on a synthetic
    two-sequence CTC root (see the module docstring). Returns the launches
    of its processes."""
    none = {k: 0 for k in SOURCES}
    if not pil:
        print("flagship: Pillow is not installed here; the script (TIFF reads and writes) was "
              "not driven", flush=True)
        return none
    work = tempfile.mkdtemp(prefix="chip_smoke_flagship_")
    ref = os.path.join(work, "ref")
    for i, seq in enumerate(("01", "02")):
        write_ctc_root(ref, *ctc_sequence(np.random.RandomState(SEED + 15 + i), CTC_FRAMES,
                                          SIZE), seq=seq)
    t0 = time.perf_counter()
    rc, _ = run_cli(["preprocess", "--data-root", ref, "--sequence", "01"])
    pre_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"flagship: preprocess of seq 01: exit code {rc}")
    conf = os.path.join(work, "recipe.json")
    cfg = cut_recipe(conf)
    bin_dir = os.path.join(work, "bin")  # `python` in the script is this interpreter
    os.makedirs(bin_dir)
    with open(os.path.join(bin_dir, "python"), "w") as fh:
        fh.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bin_dir, "python"), 0o755)
    paths = {k: os.path.join(work, v) for k, v in (
        ("DATA", "data/DIC-C2DH-HeLa"), ("RUN", "run"), ("EVAL", "eval"),
        ("LATEST", "docs/results_torch_latest.json"), ("UNETSEG_LAUNCH_LOG", "launches.jsonl"))}
    env = {**os.environ, **paths, "REF": ref, "CONFIG": conf, "PYTHONUNBUFFERED": "1",
           "PATH": bin_dir + os.pathsep + os.environ.get("PATH", "")}
    rc, lines = run_script(["bash", FLAGSHIP_SCRIPT], env, FLAGSHIP_TIMEOUT)
    wall = lines[-1][0]
    with open(os.path.join(work, "script.log"), "w") as fh:
        fh.writelines(ln + "\n" for _, ln in lines)
    if rc != 0:
        logs = ""
        for name in ("train_f0.log", "train_f1.log", "train_f2.log", "flagship/log.txt"):
            path = os.path.join(paths["EVAL"], name)
            if os.path.exists(path):
                with open(path) as fh:
                    logs += f"\n--- {name}:\n" + fh.read()[-3000:]
        raise AssertionError(f"flagship: the script's exit code {rc}:\n"
                             + "\n".join(ln for _, ln in lines[-40:]) + logs)

    # the members: checkpoints whose saved config has the member's seed
    members = [os.path.join(paths["RUN"], f"f{m}") for m in range(FLAGSHIP_MEMBERS)]
    for m, d in enumerate(members):
        saved = ckpt.read_checkpoint_config(d)
        params, _, _ = ckpt.restore_light(d)
        if (not os.path.exists(os.path.join(d, ".done")) or saved["train"]["seed"] != m
                or saved["train"]["num_epochs"] != CTC_EPOCHS
                or not all(torch.isfinite(v).all() for v in params.values())):
            raise AssertionError(f"flagship: member {d}: config {saved['train']}")

    # each process's launches: its train steps', or its ensemble's chunks'
    icfg = cfg.infer
    n_train = len(train_val_split(2 * CTC_FRAMES, cfg.data.val_percent, cfg.train.seed)[0])
    steps = CTC_EPOCHS * -(-n_train // cfg.train.batch_size)
    forwards = (2 * FLAGSHIP_MEMBERS * len(TTA_TRANSFORMS[icfg.tta]) * frame_chunks(
        CTC_FRAMES, icfg.tile_batch, plan_tiles(SIZE, SIZE, icfg.tile_input), icfg.tile_batch))
    want = {"train": {k: steps * v for k, v in TRAIN_LAUNCHES.items()},
            "pipeline": {k: forwards * v for k, v in DEFAULT_LAUNCHES.items()}}
    with open(paths["UNETSEG_LAUNCH_LOG"]) as fh:
        logged = [json.loads(ln) for ln in fh]
    total = dict(none)
    ran = {}
    for rec in logged:
        cmd = rec["argv"][1] if len(rec["argv"]) > 1 else "?"
        ran.setdefault(cmd, []).append(rec["launches"])
        if rec["launches"] != want.get(cmd, {}):
            raise AssertionError(f"flagship: {cmd} launched {rec['launches']}, expected "
                                 f"{want.get(cmd, {})}")
        for k, v in rec["launches"].items():
            total[k] += v
    if len(ran.get("train", [])) != FLAGSHIP_MEMBERS or len(ran.get("pipeline", [])) != 1:
        raise AssertionError(f"flagship: processes that launched kernels {ran}")

    # the summaries against evaluate-ctc, the record, the bench's reader
    out = os.path.join(paths["EVAL"], "flagship")
    with open(os.path.join(out, "summary.json")) as fh:
        summary = json.load(fh)
    scores = {seq: summary_equals_evaluate_ctc("flagship", summary[seq], paths["DATA"], out, seq)
              for seq in ("01", "02")}
    with open(paths["LATEST"]) as fh:
        latest = json.load(fh)
    got = bench.seg_record(paths["LATEST"], recipe_path=conf)
    if ((latest["seg_seq01"], latest["seg_seq02"]) != (scores["01"]["SEG"], scores["02"]["SEG"])
            or latest["device"] != gpu or gpu not in latest["source"]
            or latest["package"] != "unetseg_tpu_torch" or "'flagship'" not in latest["source"]
            or (got["seg_seq01"], got["seg_seq02"]) != (latest["seg_seq01"], latest["seg_seq02"])
            or got["seg_recipe_current"] is not True or got["seg_checkpoints_present"] is not True):
        raise AssertionError(f"flagship: record {latest}, bench reads {got}, summary {scores}")
    if os.path.exists(bench.RESULTS_PATH):
        raise AssertionError(f"flagship: the smoke run wrote {bench.RESULTS_PATH}")
    step_s = script_steps(lines)
    print(f"flagship: tools/reproduce_flagship_torch.sh exit 0 in {wall:.2f} s on two synthetic "
          f"sequences of {CTC_FRAMES} {SIZE}^2 frames (seq 01's weight maps {pre_s:.2f} s before "
          f"it), the best recipe cut to {CTC_EPOCHS} epoch, base {cfg.model.base_features} "
          f"{cfg.model.compute_dtype}, on {gpu}: seconds per step "
          f"{ {k: round(v, 2) for k, v in step_s} }", flush=True)
    print(f"flagship: {FLAGSHIP_MEMBERS} members of {steps} train steps each (launches "
          f"{steps} x TRAIN_LAUNCHES a member), the ensemble eval {forwards} forward chunks x the "
          f"serving kernels ({FLAGSHIP_MEMBERS} members x {len(TTA_TRANSFORMS[icfg.tta])} flips "
          f"x 2 sequences); synthetic-root scores {scores} (they check that the parts agree, "
          f"not quality) equal the evaluate-ctc command's; the record's SEG and card and "
          f"bench.seg_record agree", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return total


def importable(name):
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


def main_bn():
    """Phase 6c alone, after the environment and the build."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = gpu.splitlines()[0]
    info = build()
    print(f"build: {info['seconds']:.1f} s nvcc, {info['path']}", flush=True)
    names = ("sums_kernel", *BN_STAGES["forward"], *BN_STAGES["backward"])
    shown = False
    for ln in info["log"].splitlines():  # ptxas's lines of the BatchNorm kernels
        if "Compiling entry" in ln:
            shown = any(n in ln for n in names)
        if shown:
            print(f"build: ptxas {ln.strip()}", flush=True)
    stats = new_stats()
    bn_path(gpu, stats)
    print(json.dumps({k: {key: v for key, v in stats[k].items() if not key.startswith("_")}
                      for k in ("bn_relu_fwd", "bn_relu_bwd")}))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    global GPU
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    gpu = GPU = gpu.splitlines()[0]
    nvcc = run([nvcc_path(), "--version"]).splitlines()[-1]
    pil, mpl = importable("PIL"), importable("matplotlib")
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
          f"device {torch.cuda.get_device_name(0)} ({gpu}), Pillow "
          f"{'importable' if pil else 'not installed'}, matplotlib "
          f"{'importable' if mpl else 'not installed'}", flush=True)

    t0 = time.perf_counter()
    info = build()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln
            or "Performance Loss" in ln]
    print(f"build: {info['seconds']:.1f} s nvcc ({time.perf_counter() - t0:.1f} s total), "
          f"{info['path']}", flush=True)
    for ln in regs:
        print(f"build: ptxas {ln}", flush=True)

    sh = unet_shapes(min_tile_input(SIZE))
    stats = kernel_parity(sh)
    serving, main = main_path(gpu)
    variants = variants_path(gpu, main)
    phase4_masks = main["masks"]
    export_inputs = main["variables"], main["frames"]
    del main
    train_kernel_parity(stats)
    training, training2 = train_path(gpu)
    update_path(gpu, stats)
    bn_path(gpu, stats)
    pre_labels = cell_frames(np.random.RandomState(SEED + 5), PRE_FRAMES, PRE_SIZE,
                             labels=True)[1]
    loss_and_edt_parity(stats, pre_labels)
    preprocess = preprocess_path(pre_labels)
    loop = loop_path(gpu)
    sequence = sequence_path(gpu, pil)
    scoring = scoring_path(gpu, pil)
    dp = dp_path(gpu, pil, phase4_masks)
    exported = export_path(gpu, mpl, *export_inputs)
    benched = bench_path(gpu)
    flagship = flagship_path(gpu, pil)

    # launches: each path's run (serving call, the four variant calls, the
    # tier-1 and tier-2 train steps, preprocess of PRE_FRAMES frames, the
    # loop's first train(), the sequence core's run, the scoring path's
    # core run and pipeline command, the data-parallel steps and tile-sharded
    # serving of both ranks, the exported artifact's calls and the
    # augmentation panel's deformation, the benchmark's checked segment
    # calls and train step, the flagship script's processes), counted from 0
    paths = (serving, variants, training, training2, preprocess, loop, sequence, scoring, dp,
             exported, benched, flagship)
    record = [
        {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1],
         "launches": sum(p[k] for p in paths),
         **{key: v for key, v in stats[k].items() if not key.startswith("_")}}
        for k in SOURCES
    ]
    missing = [r["name"] for r in record if r["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels launched on no path: {missing}")
    print(json.dumps({"kernels": record}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--bn"]:
        main_bn()
    else:
        main()
