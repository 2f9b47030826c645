#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: require CUDA; print the card's name and power limit; import
     the last slice's modules (bench, graft_entry, parallel, profile_step,
     dp_check, the last host copies) with jax, lstm_ctc_tpu, bench and
     __graft_entry__ refused;
  2. build: compile the kernels from lstm_ctc_tpu_torch/csrc/ (one nvcc per
     source, all started together);
  3. kernel A (K1, BLSTM layer forward) against its plain PyTorch version
     at B=32, T=384, H=P=320, D=640, ragged lengths, with and without
     packed-row resets, in float32 (TF32 off) and bfloat16; each time also
     in us a step, and bfloat16 with resets timed once more as the train
     step calls it (per-step states kept in bfloat16); then, with resets,
     at the widths only 16-block clusters take (H=1024 P=256 D=512, H=P=512
     D=1024, H=P=384 D=768), bfloat16 also each step replayed from the
     kernel's own states; then at the widths of the streamed plan (bf16
     slices that fit no resident plan: H=P=1024 without a projection
     D=2048, H=P=768 D=1536, H=2048 P=512 D=1024; float32 at 2048/512
     only), also two launches bit-equal, and at the widest, H=P=2048
     without a projection D=4096, T=32, float32 and bfloat16; each timing
     line prints the launch: the plan (resident or streamed), blocks a
     cluster (the flagship's must be 8), R, clusters, those resident at
     once, the waves, and the weight bytes a block holds and streams a
     step; the bound is the function's own (each tensor once), the
     streamed plan's weight traffic printed beside it with the rate the
     kernel reads it at;
  4. kernel B (MoE expert mix) against its plain version at N=12288, D=640,
     E=V=72, tau=10, keep 1.0 and 0.9; beside the bf16 kernel, cuBLAS's bare
     product x·W at the same shape (the product alone, not K4's function);
     then past 128 targets (V-tiled): at V=136, 256, 1024 and 4096 (D=640,
     72 experts) against the plain version at N=1100, float32 and bf16,
     keep 1.0 and 0.9, two launches bit-equal; timed in turns at N=12288
     for V=256 and 1024, beside the bound and cuBLAS's bare x·W;
  5. end to end: the flagship model (random weights from a seed) serves
     64 synthetic utterances through ``lstm_ctc_tpu_torch.bin.nnet_forward``
     on cuda, batch 32, in bfloat16 (the default on CUDA); the archive is
     read back and checked and the kernel launch counts are checked.  The
     same forward in float32 must equal the plain versions' float32
     forward.  In bfloat16 the same forward is run once more with every
     kernel launch held to its plain version on the very tensors the model
     gave it, and each launch must have the compute dtype bfloat16: kernel
     B's output, and each step of each layer of kernel A, replayed from the
     kernel's own per-step states; then the flagship forward at B=32,
     T=384 timed, and profiled for K1's and K4's shares of its device time;
  6. K10/K11 (CTC alpha and beta DP) against their plain versions at
     N=96 slots, T=400, S=301, ragged time and label lengths, repeated
     labels, an infeasible pair and an empty label (K11 bit-equal, also at
     widths 1-1024 with resets across 32-step words); timed in turns with
     the plain versions (each also in us a step), and F.ctc_loss timed on
     the same shapes as the library yardstick; then one shape each wrapper
     module refuses, routed before any launch to the plain version (a CTC
     lattice of 1101 positions, a MoE head of V=129 in bf16 (outside the
     kernels' V <= 128 or lcm(V, 128) <= 4096) and of D=1100 in float32
     under the twokernel backward, a bf16 BLSTM layer of H=P=2052 without
     a projection in training, past the layer kernels' 2048 units): equal
     to the plain version, one warning, no kernel launch;
     a bf16 lstm stack of 8 layers of H=P=384 in training, deeper than the
     sixteen-block clusters the card holds at once, layer by layer through
     K1 and K2 (once each a layer); and a streamed bf16 stack of H=P=1024
     without a projection, which K12 has no plan for, each layer through
     the plain scan;
  7. K2 (BLSTM layer backward) against its plain version at B=32, T=384,
     H=P=320, D=640, ragged lengths, with and without resets, float32
     (TF32 off) and bfloat16 (in bfloat16 also each step replayed from
     the kernel's own carries, its dgates against the float64 replay of
     each step); timed in turns; then at phase 3's wide, streamed and
     widest shapes, with resets; then the streamed plan forced where a
     resident plan fits (the flagship width, H=P=512 and H=1024 P=256, at
     the resident plan's R), with half, all (refused where it does not fit
     beside the ring) and as much of wh resident as fits: K1's and K2's
     outputs bit-equal to the resident plan's, and the fuller plans timed
     in turns with it;
  8. training end to end: the flagship's dense-head model (4x320 BLSTM,
     proj 320, peepholes, 72-way head; random weights from a seed) on a
     synthetic labeled corpus of 288 utterances, through nnet_init, then
     nnet_validate, then two epochs of nnet_train (adam 1e-3, batch 32,
     pack factor 3, bf16) each followed by nnet_validate, on cuda: finite
     losses, the last cv_loss below the first, loadable checkpoints, and
     the launch counts (per train step 4 K1, 4 K2, 1 K10, 1 K11; per CV
     batch 4 K1, 1 K10).  One float32 train step through the kernels,
     each K1 and K2 launch held to its plain version on its own tensors,
     against the same step through the plain versions (loss and every
     gradient leaf, next to the plain versions' own response to a
     last-bit change of the weights), one bfloat16 step with every K2,
     K10 and K11 launch held to its plain version on the model's own
     tensors, and a torch.profiler breakdown of one warm train step;
  9. K5 (MoE forward with the tanh stash), K6 (its backward to x and the
     gate, with dz), K8 (K6 without dz) and K9 (the weight gradient) at
     the training shape N=14336, D=640, E=V=72, tau=10, float32 (TF32 off)
     and bfloat16, keep 1.0 and 0.9, each against its plain version (the
     backward ones fed the kernel's own stash); timed in turns with the
     plain versions, and the opt-in twokernel backward (K8 + K9) timed
     against the default (K6 + one torch product for dw), bf16 K9's dw and
     db equal to K7's bit for bit and one K9 call profiled by kernel
     (stage 1 dz and db's partials, stage 2 K7's); beside K6,
     cuBLAS's bare product dz·Wᵀ (the product alone, not K6's function)
     and the time of W's two packed images (fwd_pack, bwd_pack: once a
     train step); then K5 and K6 past 128 targets as phase 4 has K4 (K6
     fed the plain stash; timed at N=14336, keep 0.9);
 10. the flagship MoE model (72 experts, the paper's treatment) trains for
     two iterations of nnet_train_loop (the newbob loop in one process;
     adam 1e-3, keep 0.9, batch 32, pack factor 3, bf16) on the same
     corpus: finite losses, the last cv_loss below the first, and the
     launch counts (per train step 4 K1, 4 K2, 1 K5, 1 K6, 1 K10, 1 K11
     and no K4; per CV batch 4 K1, 1 K4, 1 K10).  Then two train steps in
     the twokernel mode (per step 1 K5, 1 K8, 1 K9 and no K6), and the
     checks of phase 8 on the MoE model: the float32 step (each K1, K2,
     K5 and K6 launch on its own tensors, then end to end under the
     nudge yardstick), a bfloat16 step with every K2, K5, K6, K10 and K11
     launch held to its plain version, and a profiled step (here and in
     phase 8 with K1's share of the step's device time, here also K5's and
     K6's);
 11. K12 (the unidirectional stack's forward) against its plain version
     at the lstm width (4 layers of 320 cells, projection 320, peepholes,
     layers 1-3 residual) and the cudnnlstm width, B=32, T=384, a 120-wide
     input, ragged lengths: float32 (TF32 off) and bfloat16 (each step
     replayed from the kernel's own states), plain, at keep 0.9 (the
     dropped positions zero where the plain mask drops), with the eval-BN
     affine and with non-zero initial states; timed in turns; cuDNN's LSTM
     (torch.nn.LSTM) first checked to give K12's outputs at the cudnnlstm
     width, then timed beside it as the library yardstick in bf16, with its
     weights in one buffer (no copy at a call), the profiler's device time
     of each call beside its time on the events; then, on 16-block
     clusters, at H=1024 P=256 and H=P=512, 448, 384 (lstm), H=P=512
     (cudnnlstm; cuDNN's yardstick there too) and a streaming chunk (B=1,
     16 rows): float32 and bfloat16 at keep 0.9 (lstm) with initial
     states, two bfloat16 launches bit-equal, the launch (blocks, R,
     clusters, waves, those resident at once, shared memory a block),
     timed (beside the plain version at 1024/256 and cudnnlstm 512) and
     through stack_layers beside the parent's route, layer by layer
     through K1; each B = 32 launch in turns with the same launch forced
     onto one row a cell-phase thread (K12 R = 8, K13 R = 4; the streamed
     plan R = 4), bit-equal, in at most 2 waves (K12) and 4 (K13); at
     cudnnlstm 512 K12 + K13 as a train step calls them beside cuDNN's
     forward + backward, on the events and on the device kernels;
 12. K13 (its backward) against its plain version at both widths (keep 0.9
     for lstm), under phase 7's rules (bfloat16: each step replayed from the
     kernel's own carries and input cotangents); timed in turns; then at
     phase 11's 16-block shapes, also two launches bit-equal, and a
     training forward + backward through stack_layers beside the parent's
     route through K1 and K2;
 13. serving: nnet_forward for an lstm and a cudnnlstm model (random
     weights from a seed) on phase 5's corpus, bf16 (launch counts, the
     archive, a float32 run against the plain versions, every bf16 K12
     launch replayed step by step), then 8 utterances of the lstm model
     through --streaming true --chunk-frames 16 (one K12 launch a chunk),
     its output against the offline output, ms per chunk and the
     real-time factor of a session on the card; then a session of phase
     22's model (Kaldi's LSTMP widths, random weights) on 8 utterances:
     one K12 and one K4 launch a chunk, no plain scan on the card, ms per
     chunk beside the parent's route (each layer the plain scan);
 14. training: lstm (keep 0.9), cudnnlstm and lstm_bn through nnet_init,
     then two epochs of nnet_train (adam 1e-3, batch 32, unpacked, bf16)
     each followed by nnet_validate, on phase 8's corpus: launch counts
     (per train step 1 K12 and 1 K13, or for lstm_bn 4 K1 and 4 K2; per CV
     batch 1 K12, through the BN affine for lstm_bn), finite losses, the
     lstm model's last cv_loss below its first, the median step and real
     frames/s, one float32 step with every launch held to its plain
     version, and a profiled lstm train step;
 15. K3 (the BLSTM layer backward with the input side folded in) against
     its plain version at phase 7's shapes with a 640-wide input (the
     flagship's layers 1-3), with and without resets, float32 (TF32 off)
     and bfloat16 (each step replayed from the kernel's own carries, and
     dx, dwx and dbias against the plain input side over the kernel's own
     dgates); timed in turns; then at phase 3's wide and streamed shapes,
     with resets;
 16. K7 (the MoE head's whole backward in one kernel) against its plain
     version at phase 9's shapes, float32 and bfloat16, keep 1.0 and 0.9,
     fed K5's stash; timed in turns, beside the default (K6 + one torch
     product) and the twokernel (K8 + K9) backwards, and bf16 K9 on the same
     inputs (dw and db equal to K7's bit for bit, timed in turns);
 17. the opt-in folds end to end: two train steps of the flagship MoE model
     from phase 10's weights with lstm_fold_dx = true and moe_wgrad_mode =
     kernel in nnet.config, through nnet_train, bf16: finite losses and the
     launch counts (per step 4 K1, 1 K2, 3 K3, 1 K5, 1 K7, 1 K10, 1 K11, no
     K6, K8 or K9); one float32 step with every K3 and K7 launch held to its
     plain version on its own tensors, and the step against the same step
     with both folds off; a profiled bf16 step of each backward variant;
     and the A/B tool (python -m lstm_ctc_tpu_torch.scripts.ab_train_step)
     on default, fold, k7 and twokernel at B=32, T=384;
 18. the shipped recipe: ``egs/synthetic/run.sh`` stages 0-5 (data and LM,
     TLG graph, fbank + CMVN, labels + records, training through
     train_oplr.sh with nnet-init / nnet-train / nnet-validate as separate
     processes, lattice decode + WER) with PYTHON set to the port's shim
     (lstm_ctc_tpu_torch/recipe_python.py --device cuda) and FSTBIN and
     PATH to the native tools lstm_ctc_tpu_torch/_native.py builds (beside
     the kernels' build, phase 2), at the flagship widths (BLSTM 4 x 320,
     projection 320, 72 experts, the capacity corpus), 2 iterations; one
     run.sh a stage, each timed, and the start of a tool through the shim
     (python3 alone, a data tool, a model tool).  Every stage exits 0 and a
     summary WER line exists (~95% after 2 iterations: not gated); no log
     under exp holds a warning, and every model tool's log names the CUDA
     device; a counted in-process nnet_forward of final.nnet with the
     recipe's arguments (--apply-log, the class prior, smoothing 1) over
     the test records equals the recipe's post.ark bit for bit (the same
     kernels on the same batches), with 4 K1 and 1 K4 launches a batch;
     nnet_decode on the dev records, greedy and at beam 4, writes one
     hypothesis a key, and the greedy archive equals
     host.decode.greedy_decode of the same log-posteriors;
 19. the bench: ``python -m lstm_ctc_tpu_torch.bench`` at the full widths
     (bench.py's rows; bf16), every row's rate finite and above 0, every
     MFU in (0, 1] and the device naming the card, its JSON line printed;
     then ``python -m lstm_ctc_tpu_torch.scripts.profile_step`` at B=32,
     T=384: its segments and decomposition, and the full step's device ms
     by kernel;
 20. data parallel on the one card: the flagship MoE model at full width,
     float32 (TF32 off), keep 1.0, on 32 packed rows (pack factor 3): two
     gloo ranks in two processes sharing the card (NCCL refuses two ranks
     on one device), 16 rows each, two adam steps against the same two
     steps in one process: the loss within 1e-4 relative, the parameters'
     update (after - before) within 10x of what the 1-process steps give
     from weights moved one unit in the last place (as a whole and in the
     worst leaf), the ranks' weights equal bit for bit, and each rank's
     launches the 1-process steps' (K1, K2, K5, K6, K10, K11); then an
     NCCL group of one rank at keep 0.9: the 1-process steps bit for bit;
 21. Kaldi's BLSTMP widths end to end: the flagship MoE model at cell 1024
     and projection 256 (layers 2-4 fed 512 wide; random weights from a
     seed), on 16-block K1 and K2: nnet_init, 3 steps of nnet_train (adam
     1e-3, keep 0.9, batch 32, pack factor 3, bf16), 3 more with
     lstm_fold_dx = true (K3 on layers 2-4), nnet_forward on 64
     utterances, on phase 8's corpus: each run counted from zero (per
     train step 4 K1, 4 K2 (or 1 K2 and 3 K3), 1 K5, 1 K6, 1 K10, 1 K11;
     per CV or forward batch 4 K1, 1 K4 and, in CV, 1 K10), no route
     warning and no plain recurrence on the card, finite losses and
     weights, the archive checked; float32 log-posteriors against the
     plain versions';
 22. Kaldi's LSTMP widths end to end: the lstm family at cell 1024 and
     projection 256 (peepholes, residual layers 1-3, the MoE head, keep
     0.9; random weights from a seed) on 16-block K12 and K13: nnet_init,
     nnet_train (adam 1e-3, batch 32, unpacked, bf16), nnet_forward on 64
     utterances and nnet_forward --streaming --chunk-frames 16 on the same
     utterances, each run counted from zero (per train step 1 K12, 1 K13,
     1 K5, 1 K6, 1 K10, 1 K11; per CV or forward batch 1 K12, 1 K4 and, in
     CV, 1 K10; per chunk 1 K12 and 1 K4), no route warning, no K1 or K2
     and no plain scan on the card; float32 log-posteriors against the
     plain versions', the streamed against the offline in float32 and
     bfloat16; the train step and the forward on the parent's route
     (layer by layer through K1 and K2) for the record; then a cudnnlstm
     of H=P=512 through nnet_init, nnet_train and nnet_forward;
 23. a 256-target head end to end: the flagship MoE model (4 x 320
     BLSTM, projection 320, 72 experts, tau 10) over 256 targets, bf16,
     through nnet_init, 3 packed nnet_train steps at keep 0.9 and
     nnet_forward on 64 utterances, each run counted from zero (per train
     step 1 K5 and 1 K6, per CV or forward batch 1 K4), no route warning,
     finite losses and weights; one step's K2 (its dgates against the
     float64 replay), K5, K6, K10 and K11 held to their plain versions;
     float32 log-posteriors against the plain versions'; the train step
     beside the same step with the head's mix computed by the plain
     version (the parent's route), for the record;
 24. the streamed plan end to end: the flagship MoE model with its two
     width keys widened together to 1024 (no projection; layers 2-4 and
     the MoE head fed 2048 wide), bf16, through nnet_init, 3 packed
     nnet_train steps, one more with lstm_fold_dx = true (K3 on layers
     2-4) and nnet_forward on 64 utterances, K1, K2 and K3 on the
     streamed plan, each run counted from zero, no route warning and no
     plain recurrence on the card; one step with K2, K5 and K6 held to
     their plain versions on its own tensors, profiled, beside the same
     step on the parent's route (the plain recurrence) on the host clock,
     the median of three steps after a warm-up step; then the lstm
     family at 2048 cells, projection 512 (past K12's 1024 units, so
     layer by layer on K1 and K2; the stack's refusal its one warning)
     through nnet_init, one nnet_train step and nnet_forward;
 25. prints the kernels' JSON line (with rows for K1, K2 and K3 at
     H=1024, P=256, their launches from phase 21, for K12 and K13 on
     16 blocks at H=1024, P=256 and at the cudnnlstm H=P=512, their
     launches from phase 22, for K4, K5 and K6 at V=256, their
     launches from phase 23, and for K1, K2 and K3 on the streamed plan
     at H=P=1024, their launches from phase 24), the summary lines, the
     nvidia-smi line, and as the last line
     ``{"ok": true, "device": {...}}``.

Tolerances (stated, with their reasons, in PERF.md): kernel vs plain,
float32, max|diff| / max|plain| <= 1e-4 per output; bfloat16 kernel A, the
same ratio <= 2e-2; bfloat16 kernel B, max|diff| <= 5e-2.  On the main
bfloat16 path: kernel A's steps, the ratio <= 1e-3 (one step's rounding
differences only); kernel B, max|diff| <= 5e-2.  End to end on log-posteriors,
float32 kernels vs plain: mean |diff| <= 1e-3 and max |diff| <= 2e-2 (the
random-weight model amplifies last-bit differences about a thousandfold
over 4 layers and ~400 steps).  K10/K11, float32: |diff| <= 1e-4 ·
max(1, |plain|) on finite entries and NEG_INF at the same places.  K2,
float32: max|diff| / max|plain| <= 1e-4 per output; bfloat16, each step
replayed: the carries' ratio <= 1e-3 and dgates within one bf16 rounding
step of the float64 replay of the step, plus a first-order bound on the
float32 computation's error (each float32 sum off by float32's unit
roundoff of the magnitudes of its terms, carried through what follows),
and 1e-6.  K5/K6/K8/K9, bfloat16: the mixed output max|diff| <= 5e-2 (as
K4), th and dz within one bf16 rounding step of the plain versions' (a
last-bit difference of the float32 sums may flip a rounding; th on a
train step's tensors against a float64 replay of tanh(x·W + b) instead:
one bf16 rounding step plus the same first-order bound), dx, dgate, dw and db
max|diff| / max|plain| <= 1e-2 (dz's flipped roundings reach them), K8's
dx and dgate equal to K6's bit for bit.  The float32 train step: each
launch, max|diff| / max|plain| <= 1e-4 on its own tensors; kernels vs
plain end to end, loss within 1e-4 relative, and the whole gradient's
||diff|| / ||plain|| and the worst leaf's max|diff| / max|plain| each
within 10x what the plain versions themselves give when every weight is
moved one unit in the last place (the trained model amplifies last-bit
differences through ~450 steps and 4 layers; the first layer's input
weights show it most).  K12/K13, float32: max|diff| / max|plain| <= 1e-4
per output; bfloat16, each step replayed from the kernel's own states,
carries and input cotangents: the same ratio <= 1e-3, K13's dgates within
one bf16 rounding step; at keep 0.9 the chain is zero wherever the plain
mask drops and non-zero wherever it keeps a non-zero plain value; on 16
blocks also two bfloat16 launches bit-equal.  cuDNN's LSTM against K12
in float32: <= 1e-4.  Streaming against offline
log-posteriors (the same kernel runs both, row by row): max|diff| /
max|offline| <= 1e-4 in float32 and <= 1e-3 in bfloat16.  The families' float32
train step: each launch <= 1e-4 on its own tensors, the loss within 1e-4
relative.  K3, float32: max|diff| / max|plain| <= 1e-4 per output;
bfloat16: K2's per-step rules, dx within one bf16 rounding step of the
plain input side over the kernel's own dgates, plus 2^-20 of the sum of
its terms' magnitudes (two orders of one f32 sum differ by that much near
a cancellation), dwx and dbias ratio <= 1e-3.
K7: K6's rules for dx and dgate and K9's for dw and db (float32 ratio <=
1e-4, bfloat16 <= 1e-2).  K11 bit-equal to its plain version; bf16 K9's dw
and db equal to K7's bit for bit.  The routes: the CTC loss and gradient
within 1e-4 · max(1, |plain|) of the CPU's plain versions; the MoE head and
the BLSTM layer equal to their plain versions on the same tensors.  The float32 step with both folds against the same
step without them: the loss within 1e-4 relative, the gradient under the
nudge yardstick (in float32 the folds change only the order of sums).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from unittest import mock

import numpy as np

F32_REL_TOL = 1e-4
BF16_LSTM_REL_TOL = 2e-2
BF16_ABS_TOL = 5e-2
BF16_STEP_REL_TOL = 1e-3
BF16_MOE_REL_TOL = 1e-2
# two orders of one float32 sum differ by up to a few ulps of the terms'
# magnitude, which near a cancellation exceeds a rounding step of the sum
SUM_ORDER_TOL = 2.0 ** -20  # 16 float32 ulps of sum |terms|
F32_UNIT = 2.0 ** -24  # float32's unit roundoff
E2E_F32_MEAN_TOL = 1e-3
E2E_F32_MAX_TOL = 2e-2
LOGSUMEXP_TOL = 1e-4
CTC_TOL = 1e-4
STEP_LOSS_TOL = 1e-4
STEP_NUDGE_FACTOR = 10.0
MOE_TRAIN_ROWS = 32 * 448  # a train step's rows: B=32 rows of 448 frames
# peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_MS = 3.35e9
BF16_FLOPS_PER_MS = 989e9
F32_FLOPS_PER_MS = 67e9

FLAGSHIP_CONFIG = {
    # the flagship WSJ treatment model (egs/wsj/run_wsj_phn.sh)
    "nnet_type": "blstm",
    "input_dim": 40,
    "left_context": 1,
    "right_context": 1,
    "subsample": 3,
    "num_layers": 4,
    "num_neurons": 320,
    "num_projects": 320,
    "num_targets": 72,
    "use_peepholes": True,
    "dropout_rate": 0.9,
    "num_experts": 72,
    "moe_temp": 10.0,
    "seed": 777,
}


def fail(msg: str) -> None:
    print("chip_smoke: FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()
# the card's name and power limit, as nvidia-smi prints them (set by main)
SMI = "not read"


def phase(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    say("%s [at %.1f s]" % (msg, time.perf_counter() - START))


def elapsed_ms(torch, fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_in_turns(torch, kernel, plain, rounds: int, kernel_reps: int = 4,
                  also=None):
    """Median ms of ``kernel`` and of ``plain``, after a warm-up of both,
    measured in turns (plain then kernel, kernel then plain, ...), so that
    clock and neighbour drift fall on both alike; with ``also`` (another
    launch of the kernel's, timed as it is, after it in each turn) its
    median third."""
    kernels = (kernel,) if also is None else (kernel, also)
    for fn in kernels + (plain,) + kernels + (plain,):
        fn()
    torch.cuda.synchronize()
    times = {fn: [] for fn in kernels + (plain,)}
    for r in range(rounds):
        for fn in ((plain,) + kernels if r % 2 == 0 else kernels + (plain,)):
            times[fn] += [elapsed_ms(torch, fn) for _ in range(
                1 if fn is plain else kernel_reps)]
    return tuple(statistics.median(times[fn])
                 for fn in (kernel, plain) + kernels[1:])


def median_ms(torch, fn, reps: int) -> float:
    """Median ms of ``fn`` on the CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(elapsed_ms(torch, fn) for _ in range(reps))


def errors(got, ref):
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


# the flagship's layers 1-3 (H, P, D) and the widths past its 8-block plans
# that K1, K2 and K3 take with 16 blocks: Kaldi's BLSTMP cell and
# projection (layers 2-4 fed 2P = 512 wide), and H = P = 512 and 384
FLAGSHIP_LAYER = (320, 320, 640)
WIDE_LAYERS = ((1024, 256, 512), (512, 512, 1024), (384, 384, 768))
# the widths of the streamed plan (bf16 slices that fit no resident plan;
# float32 at 2048/512 only): (H, the projection or None, the input width
# 2P of a layer past the first)
STREAMED_LAYERS = ((1024, None, 2048), (768, 768, 1536), (2048, 512, 1024))
STREAMED_F32 = ((2048, 512, 1024),)
# the widest layer K1 and K2 take, H = P = 2048 without a projection (64 MB
# of wh in both directions, past the 50 MB L2), bf16 on the streamed plan
# and float32 on the resident body, held once at a short T
WIDEST_LAYER, WIDEST_STEPS = (2048, None, 4096), 32


def layer_name(dtype, shape, steps=384):
    """'bfloat16' at the flagship's layer shape, else with H, P and D (and
    T where it is not 384)."""
    name = str(dtype).split(".")[-1]
    units, proj, dim = shape
    return (name if shape == FLAGSHIP_LAYER else "%s H=%d P=%d%s D=%d" % (
        name, units, proj or units, "" if proj else " (no projection)",
        dim)) + ("" if steps == 384 else " T=%d" % steps)


# the streamed layer launches at B = 32 held against the same launch forced
# onto the R the parent's one-row launchers took (a cell-phase thread one
# row; as much of wh resident as fits): (H, P) -> (K1's R, K2's R)
ONE_ROW_PLAN = "streamed, wh held as fits"
PARENT_ROWS = {(1024, 1024): (8, 6), (768, 768): (8, 8), (2048, 512): (4, 4),
               (2048, 2048): (4, 2)}


def layer_rows_line(how, steps, ms):
    """A streamed layer launch's R, clusters, waves, shared memory, the
    weight bytes it streams (a block a step, and a launch, with the rate
    it reads them at) and the us a wave-step"""
    nbytes = streamed_bytes(how, steps)
    return ("R=%d, %d clusters in %d wave(s) (%d resident at once), %d "
            "bytes of shared memory a block, %d bytes streamed a block a "
            "step (%.3f GB a launch, read at %.3f TB/s), %.2f us a "
            "wave-step" % (how["rows"], how["clusters"], how["waves"],
                           how["resident"], how["smem_bytes"],
                           how["streamed_bytes"], nbytes / 1e9,
                           nbytes / ms / 1e9,
                           1e3 * ms / (steps * how["waves"])))


def one_row_config(lstm_kernels, device, which, units, out_dim, has_proj,
                   dtype):
    """The launch forced onto the parent's one-row R (PARENT_ROWS), as its
    launcher's config says it"""
    rows = PARENT_ROWS[(units, out_dim)][which == "backward"]
    config = getattr(lstm_kernels, which + "_config")
    return config(device, 32, units, out_dim, has_proj, dtype, rows=rows)


def launch_line(how):
    """A layer kernel's launch, as its launcher chooses it."""
    return ("%s plan, %d blocks a cluster, R=%d rows a cluster, %d "
            "clusters, %d resident at once, %d wave(s), %d bytes of shared "
            "memory a block, weights a block %d bytes held, %d streamed a "
            "step" % ("streamed" if how["streamed"] else "resident",
                      how["blocks"], how["rows"], how["clusters"],
                      how["resident"], how["waves"], how["smem_bytes"],
                      how["held_bytes"], how["streamed_bytes"]))


def layer_launch(lstm_kernels, device, which, args, dtype):
    """K1's (``which`` forward) or K2's launch at this layer's shape, the
    flagship's held to its 8-block plan."""
    steps, b2, h4 = args[0].shape
    units, out_dim = h4 // 4, args[3].shape[1]
    config = getattr(lstm_kernels, which + "_config")
    how = config(device, b2 // 2, units, out_dim, args[4] is not None, dtype)
    if (units, out_dim) == FLAGSHIP_LAYER[:2] and how["blocks"] != 8:
        fail("the flagship layer's %s launch has %d blocks a cluster, not 8"
             % (which, how["blocks"]))
    return how


def streamed_bytes(how, steps):
    """The weight bytes a launch on the streamed plan reads from L2 at every
    step, over the whole launch (0 on a resident plan): the plan's own
    traffic, not its function's, so it is kept out of the bound."""
    if not how["streamed"]:
        return 0
    return how["streamed_bytes"] * how["blocks"] * how["clusters"] * steps


def stream_line(how, steps, ms):
    """The streamed plan's weight traffic a launch and the rate the kernel
    reads it at (its bytes over the kernel's measured time); empty on a
    resident plan."""
    nbytes = streamed_bytes(how, steps)
    if not nbytes:
        return ""
    return ("; the plan's streamed weights %.3f GB a launch, read from L2 "
            "at %.3f TB/s over the kernel's time" % (nbytes / 1e9,
                                                    nbytes / ms / 1e9))


def lstm_fwd_bound(torch, args, outputs, dtype):
    """(least ms, what sets it) of K1 called on ``args`` and returning
    ``outputs``: each tensor once; the products over the live rows (each
    sequence's length, in both directions)."""
    gx, seq, wh = args[0], args[1], args[3]
    units, out_dim = gx.shape[-1] // 4, wh.shape[1]
    rows = 2 * int(seq.sum())
    flops = 2 * rows * (out_dim * 4 * units
                        + (units * out_dim if args[4] is not None else 0))
    peak = BF16_FLOPS_PER_MS if dtype == torch.bfloat16 else F32_FLOPS_PER_MS
    return bound(tensor_bytes(torch, args, outputs), flops, peak)


def check_lstm(torch, pkg, device, dtype, reset, rng, shape=FLAGSHIP_LAYER,
               steps=384):
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    units, out_dim, dim = shape
    batch = 32
    gen = torch.Generator().manual_seed(11)
    fw = cells.init_lstm_cell(gen, dim, units, out_dim, True, device)
    bw = cells.init_lstm_cell(gen, dim, units, out_dim, True, device)
    x = torch.from_numpy(rng.randn(batch, steps, dim).astype(np.float32)).to(device)
    lengths = rng.randint(steps // 2, steps + 1, batch)
    lengths[0] = steps
    seq = torch.from_numpy(lengths.astype(np.int32)).to(device)
    reset_mask = None
    if reset:
        starts = np.zeros((batch, steps), np.float32)
        starts[:, 0] = 1.0
        for b in range(batch):
            starts[b, rng.randint(1, lengths[b], 2)] = 1.0
        reset_mask = torch.from_numpy(starts).to(device)
    x_rev = cells.reverse_sequence(x, seq)
    gx, wh, proj, peep = cells.layer_inputs(fw, bw, x, x_rev, dtype)
    _, keep = cells.step_masks(seq, reset_mask, steps, device)
    args = (gx, seq, keep, wh, proj, peep, 5.0)
    got = lstm_kernels.lstm_layer_forward(*args)
    ref = cells.dual_recurrence(*args)
    torch.cuda.synchronize()
    name = layer_name(dtype, shape, steps)
    worst_abs = worst_rel = 0.0
    for out, g, r in zip(("out", "c_fin", "h_fin"), got, ref):
        if not torch.isfinite(g).all():
            fail("kernel A %s: non-finite %s" % (name, out))
        abs_err, rel_err = errors(g, r)
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
        say("  kernel A %-8s reset=%-5s %-5s max_abs %.3e  rel %.3e"
            % (name, reset, out, abs_err, rel_err))
    tol = F32_REL_TOL if dtype == torch.float32 else BF16_LSTM_REL_TOL
    if worst_rel > tol:
        fail("kernel A %s reset=%s: relative error %.3e > %.1e"
             % (name, reset, worst_rel, tol))
    if dtype == torch.bfloat16 and shape != FLAGSHIP_LAYER:
        # each step from the kernel's own states of the step before, as on
        # the main path (phase 5)
        full = lstm_kernels.lstm_layer_forward(*args, states=True)
        step_rel = max(errors(g, r)[1] for g, r in zip(
            (full[0], full[3], full[4]),
            cells.replay_steps(*args, full[3], full[4])))
        say("  kernel A %s reset=%-5s per step max rel %.3e (bound %.0e)"
            % (name, reset, step_rel, BF16_STEP_REL_TOL))
        if step_rel > BF16_STEP_REL_TOL:
            fail("kernel A %s: a step's relative error %.3e > %.1e"
                 % (name, step_rel, BF16_STEP_REL_TOL))
    if shape in STREAMED_LAYERS + (WIDEST_LAYER,):
        again = lstm_kernels.lstm_layer_forward(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail("kernel A %s: two launches differ" % name)
        say("  kernel A %s reset=%-5s two launches bit-equal" % (name, reset))
    # the streamed plan at B = 32: the launcher's R beside the same launch
    # forced onto the parent's one-row R, held bit for bit (out, the states
    # in both store dtypes, the final c and h) and timed in turns
    forced = None
    if dtype == torch.bfloat16 and (units, out_dim or units) in PARENT_ROWS:
        one = (ONE_ROW_PLAN, PARENT_ROWS[(units, out_dim or units)][0])
        for store in (torch.bfloat16, torch.float32):
            a = lstm_kernels.lstm_layer_forward(*args, states=True,
                                                store_dtype=store)
            b = lstm_kernels.lstm_layer_forward(*args, states=True,
                                                store_dtype=store, _plan=one)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail("kernel A %s: the launcher's R differs from R=%d (states "
                     "in %s)" % (name, one[1], store))
        del a, b
        say("  kernel A %s reset=%-5s the launcher's R bit-equal row for row "
            "to the same launch forced at R=%d (out, c_all, h_all in bf16 "
            "and float32, the final c and h): True" % (name, reset, one[1]))
        forced = lambda: lstm_kernels.lstm_layer_forward(*args, _plan=one)
    timed = time_in_turns(
        torch, lambda: lstm_kernels.lstm_layer_forward(*args),
        lambda: cells.dual_recurrence(*args), rounds=5, also=forced)
    ms, plain_ms = timed[:2]
    how = layer_launch(lstm_kernels, device, "forward", args, dtype)
    say("  kernel A %-8s reset=%-5s kernel %.3f ms (%.2f us a step; %s)  "
        "plain %.3f ms" % (name, reset, ms, ms / steps * 1e3, launch_line(how),
                           plain_ms))
    if shape != FLAGSHIP_LAYER:
        bound_ms, bound_by = lstm_fwd_bound(torch, args, got, dtype)
        say("  kernel A %s reset=%-5s bound %.4f ms (%s)%s"
            % (name, reset, bound_ms, bound_by, stream_line(how, steps, ms)))
        res = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "launch": how}
        if forced is not None:
            fhow = one_row_config(lstm_kernels, device, "forward", units,
                                  out_dim or units, args[4] is not None,
                                  dtype)
            say("  kernel A %s reset=%-5s in turns: the launcher's %s: %.3f "
                "ms; forced at the parent's one-row %s: %.3f ms (%.2fx)"
                % (name, reset, layer_rows_line(how, steps, ms), ms,
                   layer_rows_line(fhow, steps, timed[2]), timed[2],
                   timed[2] / ms))
            res.update(forced_ms=timed[2], forced_launch=fhow)
        return res
    if dtype == torch.bfloat16 and reset:
        # as the train step calls it: the per-step states kept in bf16
        train_ms = median_ms(torch, lambda: lstm_kernels.lstm_layer_forward(
            *args, states=True, store_dtype=torch.bfloat16), reps=20)
        say("  kernel A bfloat16 reset=True as the train step calls it "
            "(states=True, bf16 c_all and h_all): %.3f ms (%.2f us a step)"
            % (train_ms, train_ms / steps * 1e3))
    return worst_abs, ms, plain_ms


def check_moe(torch, pkg, device, dtype, keep_prob, rng, targets=72,
              rows=12288, rounds=10):
    """K4 against its plain version at the flagship head's D = 640 and 72
    experts over ``targets``, at ``rows`` rows: two launches bit-equal,
    then timed in ``rounds`` turns with the plain version, beside its bound
    and, in bf16, cuBLAS's bare x·W (not K4's function)."""
    moe, moe_kernels = pkg["moe"], pkg["moe_kernels"]
    n, dim, experts, tau = rows, 640, 72, 10.0
    ev = experts * targets
    gen = torch.Generator().manual_seed(12)
    params = moe.init_moe(gen, dim, targets, experts, device)
    x = torch.from_numpy(
        (0.5 * rng.randn(n, dim)).astype(np.float32)).to(device)
    b = torch.from_numpy(
        (0.1 * rng.randn(ev)).astype(np.float32)).to(device)
    gate = torch.softmax(torch.from_numpy(
        rng.randn(n, experts).astype(np.float32)).to(device), dim=-1)
    seed = -123457 if keep_prob < 1.0 else None
    args = (x, params["w_expert"], b, gate, experts, tau, keep_prob, seed,
            dtype)
    got = moe_kernels.moe_mix_fused(*args)
    same = torch.equal(got, moe_kernels.moe_mix_fused(*args))
    ref = moe_kernels.moe_mix_reference(*args)
    torch.cuda.synchronize()
    tag = "%-8s V=%d N=%d keep=%.1f" % (str(dtype).split(".")[-1], targets,
                                        n, keep_prob)
    if not torch.isfinite(got).all():
        fail("kernel B %s: non-finite output" % tag)
    abs_err, rel_err = errors(got, ref)
    say("  kernel B %s max_abs %.3e  rel %.3e; two launches bit-equal: %s"
        % (tag, abs_err, rel_err, same))
    if not same:
        fail("kernel B %s: two launches differ" % tag)
    if dtype == torch.float32 and rel_err > F32_REL_TOL:
        fail("kernel B %s: relative error %.3e > %.1e"
             % (tag, rel_err, F32_REL_TOL))
    if dtype == torch.bfloat16 and abs_err > BF16_ABS_TOL:
        fail("kernel B %s: abs error %.3e > %.1e"
             % (tag, abs_err, BF16_ABS_TOL))
    del got, ref
    ms, plain_ms = time_in_turns(
        torch, lambda: moe_kernels.moe_mix_fused(*args),
        lambda: moe_kernels.moe_mix_reference(*args), rounds=rounds)
    # x, out, gate and b read or written once in float32, W once in dtype
    nbytes = 4 * (n * dim + n * targets + n * experts + ev) \
        + dim * ev * dtype.itemsize
    bound_ms, bound_by = bound(nbytes, 2 * n * dim * ev,
                               BF16_FLOPS_PER_MS if dtype == torch.bfloat16
                               else F32_FLOPS_PER_MS)
    result = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "cublas_ms": None}
    say("  kernel B %s on %s: kernel %.3f ms  plain %.3f ms  bound %.4f ms "
        "(%s)" % (tag, SMI, ms, plain_ms, bound_ms, bound_by))
    if dtype == torch.bfloat16 and keep_prob == 1.0:
        xb = x.to(dtype)
        wb = params["w_expert"].to(dtype)
        result["cublas_ms"] = median_ms(
            torch, lambda: torch.mm(xb, wb, out_dtype=torch.float32), reps=20)
        say("  the product alone (not K4's function): cuBLAS x(bf16) "
            "[%d, %d] x W [%d, %d] -> float32 %.3f ms, K4 %.3f ms"
            % (n, dim, dim, ev, result["cublas_ms"], ms))
    return result


def write_corpus(pkg, work, rng, count=64):
    records = pkg["records"]
    scp = os.path.join(work, "feats.scp")
    lengths = {}
    with records.RecordShardWriter(os.path.join(work, "feats.rec")) as writer:
        for i in range(count):
            frames = int(rng.randint(600, 1201))
            key = "utt%03d" % i
            writer.write(key, rng.randn(frames, 40).astype(np.float32))
            lengths[key] = frames
        metas = writer.metas
    with open(scp, "w") as fh:
        for meta in metas:
            fh.write(meta.scp_line())
    return scp, lengths


@contextlib.contextmanager
def plain_versions(pkg):
    """Route the model and the loss through the plain PyTorch versions on
    the card: every kernel wrapper replaced by what it runs on the CPU."""
    cells, lstm_kernels, moe_kernels, ctc_kernels = (
        pkg["cells"], pkg["lstm_kernels"], pkg["moe_kernels"],
        pkg["ctc_kernels"])

    def forward(*args, states=False, store_dtype=None):
        out = cells.dual_recurrence(*args, states=states)
        return out if not states else \
            out[:3] + tuple(s.to(store_dtype) for s in out[3:])

    sk = pkg["lstm_stack_kernels"]

    def stack_forward(*args, states=False, **kwargs):
        out, chain, c_all, h_all, cfin, hfin = sk.stack_forward_reference(
            *args, **kwargs)
        return (out, cfin, hfin) + ((chain, c_all, h_all) if states else ())

    plain = [(sk, "lstm_stack_forward", stack_forward),
             (sk, "lstm_stack_backward", sk.stack_backward_reference),
             (lstm_kernels, "lstm_layer_forward", forward),
             (lstm_kernels, "lstm_layer_backward",
              cells.dual_recurrence_backward),
             (lstm_kernels, "lstm_layer_backward_fold",
              cells.dual_recurrence_backward_fold),
             (ctc_kernels, "ctc_alpha", ctc_kernels.alpha_reference),
             (ctc_kernels, "ctc_beta", ctc_kernels.beta_reference)] + [
        (moe_kernels, name, getattr(moe_kernels, ref)) for name, ref in (
            ("moe_mix_forward", "moe_mix_reference"),
            ("moe_mix_forward_stash", "moe_stash_reference"),
            ("moe_mix_backward", "moe_backward_reference"),
            ("moe_mix_backward_noemit", "moe_backward_noemit_reference"),
            ("moe_mix_wgrad", "moe_wgrad_reference"),
            ("moe_mix_backward_wgrad", "moe_backward_wgrad_reference"))]
    with contextlib.ExitStack() as stack:
        for module, name, fn in plain:
            stack.enter_context(mock.patch.object(module, name, fn))
        yield


@contextlib.contextmanager
def held_to_plain(torch, pkg, dtype, worst):
    """Run each kernel launch of the model, then its plain version on the
    same tensors; fail on a launch of another compute dtype or outside the
    bounds.  ``worst`` collects the largest error per kernel."""
    cells, lstm_kernels, moe_kernels = (
        pkg["cells"], pkg["lstm_kernels"], pkg["moe_kernels"])
    kernel_a, kernel_b = lstm_kernels.lstm_layer_forward, \
        moe_kernels.moe_mix_forward

    def layer(*args):
        out, cfin, hfin, c_all, h_all = kernel_a(*args, states=True)
        if args[3].dtype != dtype or (args[4] is not None
                                      and args[4].dtype != dtype):
            fail("kernel A launched with weights in %s, expected %s"
                 % (args[3].dtype, dtype))
        if not (torch.equal(cfin, c_all[-1]) and torch.equal(hfin, h_all[-1])):
            fail("kernel A's final states are not its last step's")
        # each step from the kernel's own states of the step before
        ref = cells.replay_steps(*args, c_all, h_all)
        rel = max(errors(g, r)[1] for g, r in zip((out, c_all, h_all), ref))
        worst["lstm_fwd"] = max(worst["lstm_fwd"], rel)
        if rel > BF16_STEP_REL_TOL:
            fail("kernel A on the main path: a step's relative error %.3e "
                 "> %.1e" % (rel, BF16_STEP_REL_TOL))
        # the whole sequence, for the record (rounding flips carry on)
        free = cells.dual_recurrence(*args)
        worst["lstm_fwd_seq"] = max(worst["lstm_fwd_seq"], max(
            errors(g, r)[1] for g, r in zip((out, cfin, hfin), free)))
        return out, cfin, hfin

    def mix(*args):
        # (x, w, b, gate, E, tau, keep_prob, seed, compute_dtype)
        got = kernel_b(*args)
        if args[8] != dtype:
            fail("kernel B launched in %s, expected %s" % (args[8], dtype))
        err = errors(got, moe_kernels.moe_mix_reference(*args))[0]
        worst["moe_fwd"] = max(worst["moe_fwd"], err)
        if err > BF16_ABS_TOL:
            fail("kernel B on the main path: abs error %.3e > %.1e"
                 % (err, BF16_ABS_TOL))
        return got

    # a wrapper counts its launches on the name it is bound to, which is
    # the stand-in's while patched; the counted main run is unpatched
    layer.launches = mix.launches = 0
    with mock.patch.object(lstm_kernels, "lstm_layer_forward", layer), \
            mock.patch.object(moe_kernels, "moe_mix_forward", mix):
        yield


def read_archive(kaldi, ark):
    return {k: v for k, v in kaldi.SequentialBaseFloatMatrixReader("ark:" + ark)}


def plain_logposts(torch, pkg, params, state, batcher, config, device):
    """Log-posteriors per key from the plain versions, on the card."""
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.models import apply_model
    posts = {}
    with torch.inference_mode(), plain_versions(pkg):
        for batch in iterate_batches(batcher, shuffle=False):
            logits, _, _, _ = apply_model(
                params, state, torch.from_numpy(batch.nnet_input).to(device),
                torch.from_numpy(batch.sequence_length).to(device), config)
            out = torch.log(torch.softmax(logits, dim=-1)).cpu().numpy()
            for row, key in enumerate(batch.keys):
                posts[key] = out[row, :int(batch.sequence_length[row])]
    return posts


def diff_stats(a, b):
    d = np.concatenate([np.abs(a[k] - b[k]).ravel() for k in sorted(a)])
    return float(d.max()), float(d.mean())


def end_to_end(torch, pkg, device, rng):
    from lstm_ctc_tpu_torch.bin import nnet_forward
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.models import apply_model
    from lstm_ctc_tpu_torch.train.checkpoint import save_checkpoint

    lstm_kernels, moe_kernels = pkg["lstm_kernels"], pkg["moe_kernels"]
    config_f32 = dict(FLAGSHIP_CONFIG, compute_dtype="float32")
    result = {}
    with tempfile.TemporaryDirectory() as work:
        config_path = os.path.join(work, "nnet.config")
        config_f32_path = os.path.join(work, "nnet_f32.config")
        for path, config in ((config_path, FLAGSHIP_CONFIG),
                             (config_f32_path, config_f32)):
            with open(path, "w") as fh:
                fh.write(format_config(config))
        params, state = init_from_config(dict(FLAGSHIP_CONFIG), device)
        nnet = os.path.join(work, "nnet.npz")
        save_checkpoint(nnet, params, state)
        scp, raw_lengths = write_corpus(pkg, work, rng)
        ark = os.path.join(work, "post.ark")
        argv = [scp, config_path, nnet, "ark:" + ark, "--device", "cuda",
                "--batch-size", "32"]
        batcher = build_batcher(scp, FLAGSHIP_CONFIG, 32)
        num_batches = len(batcher.batch_plan(False, None))

        # the main path: bf16, as a user runs it
        lstm_kernels.lstm_layer_forward.launches = 0
        moe_kernels.moe_mix_forward.launches = 0
        start = time.perf_counter()
        written = nnet_forward.main(argv)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - start
        launches = {"lstm_fwd": lstm_kernels.lstm_layer_forward.launches,
                    "moe_fwd": moe_kernels.moe_mix_forward.launches}
        say("  nnet_forward wrote %d utterances in %d batches; launches %s"
            % (written, num_batches, launches))
        if launches["lstm_fwd"] != 4 * num_batches:
            fail("kernel A launched %d times, expected 4 per batch x %d"
                 % (launches["lstm_fwd"], num_batches))
        if launches["moe_fwd"] != num_batches:
            fail("kernel B launched %d times, expected 1 per batch x %d"
                 % (launches["moe_fwd"], num_batches))
        result["launches"] = launches

        posts = read_archive(kaldi, ark)
        if sorted(posts) != sorted(raw_lengths):
            fail("archive keys differ from the corpus keys")
        frames = 0
        for key, mat in posts.items():
            if mat.shape != (raw_lengths[key] // 3, 72):
                fail("%s: shape %s, expected (%d, 72)"
                     % (key, mat.shape, raw_lengths[key] // 3))
            if not np.isfinite(mat).all():
                fail("%s: non-finite log-posteriors" % key)
            m = mat.max(axis=1, keepdims=True)
            lse = (m[:, 0] + np.log(np.exp(mat - m).sum(axis=1)))
            if np.abs(lse).max() > LOGSUMEXP_TOL:
                fail("%s: row logsumexp up to %.3e" % (key, np.abs(lse).max()))
            frames += mat.shape[0]

        start = time.perf_counter()
        nnet_forward.main(argv)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - start
        result["frames"] = frames
        result["fps_cold"] = frames / cold_s
        result["fps_warm"] = frames / warm_s
        say("  end to end: %d frames; %.1f frames/s (first run, %.3f s), "
            "%.1f frames/s (second run, %.3f s)"
            % (frames, frames / cold_s, cold_s, frames / warm_s, warm_s))

        # float32 through the kernels must equal the plain versions
        ark32 = os.path.join(work, "post_f32.ark")
        nnet_forward.main([scp, config_f32_path, nnet, "ark:" + ark32,
                           "--device", "cuda", "--batch-size", "32"])
        posts32 = read_archive(kaldi, ark32)
        ref32 = plain_logposts(torch, pkg, params, state, batcher, config_f32,
                               device)
        worst32, mean32 = diff_stats(posts32, ref32)
        say("  float32 kernels vs plain versions, log-posteriors: max_abs "
            "%.3e mean_abs %.3e" % (worst32, mean32))
        if mean32 > E2E_F32_MEAN_TOL or worst32 > E2E_F32_MAX_TOL:
            fail("float32 log-posteriors differ from the plain versions by "
                 "%.3e on average (bound %.0e), %.3e at most (bound %.0e)"
                 % (mean32, E2E_F32_MEAN_TOL, worst32, E2E_F32_MAX_TOL))

        # bf16, the main path: every launch against its plain version on
        # the same tensors (the model amplifies bf16 rounding too much for
        # a bound on the log-posteriors, see PERF.md)
        worst = {"lstm_fwd": 0.0, "lstm_fwd_seq": 0.0, "moe_fwd": 0.0}
        with held_to_plain(torch, pkg, torch.bfloat16, worst):
            nnet_forward.main([scp, config_path, nnet,
                               "ark:" + os.path.join(work, "post_held.ark"),
                               "--device", "cuda", "--batch-size", "32"])
        say("  bfloat16 main path, each launch vs its plain version: kernel "
            "A per step max rel %.3e (bound %.0e), whole sequence max rel "
            "%.3e (not bounded); kernel B max_abs %.3e (bound %.0e)"
            % (worst["lstm_fwd"], BF16_STEP_REL_TOL, worst["lstm_fwd_seq"],
               worst["moe_fwd"], BF16_ABS_TOL))
        ref_bf16 = plain_logposts(torch, pkg, params, state, batcher,
                                  FLAGSHIP_CONFIG, device)
        say("  bfloat16 log-posteriors (not bounded): kernels vs float32 "
            "plain max_abs %.3e mean_abs %.3e; bfloat16 plain vs float32 "
            "plain max_abs %.3e mean_abs %.3e; kernels vs bfloat16 plain "
            "max_abs %.3e mean_abs %.3e"
            % (diff_stats(posts, ref32) + diff_stats(ref_bf16, ref32)
               + diff_stats(posts, ref_bf16)))

        # one full flagship batch, B=32 T=384, device time per forward
        x = torch.from_numpy(rng.randn(32, 384, 120).astype(np.float32)).to(device)
        seq = torch.full((32,), 384, dtype=torch.int32, device=device)

        def model():
            with torch.inference_mode():
                apply_model(params, state, x, seq, FLAGSHIP_CONFIG)

        def plain_model():
            with plain_versions(pkg):
                model()

        ms, plain_ms = time_in_turns(torch, model, plain_model, rounds=3,
                                     kernel_reps=2)
        say("  flagship forward B=32 T=384: kernels %.3f ms (%.1f frames/s), "
            "plain versions %.3f ms (%.1f frames/s)"
            % (ms, 32 * 384 / ms * 1e3, plain_ms, 32 * 384 / plain_ms * 1e3))
        busy, rows = device_ms(torch, model)
        say("  flagship forward, profiled: device kernels %.3f ms; %s"
            % (busy, kernel_shares(rows, busy)))
        result["model_ms"], result["model_plain_ms"] = ms, plain_ms
    return result


def dp_errors(got, ref, neg_inf):
    """(max |diff| on finite entries, worst |diff| / max(1, |plain|)), and
    whether NEG_INF sits at the same places."""
    neg = ref <= neg_inf * 0.5
    same = bool(((got <= neg_inf * 0.5) == neg).all())
    diff = (got - ref).abs()[~neg]
    rel = diff / ref.abs()[~neg].clamp(min=1.0)
    return float(diff.max()), float(rel.max()), same


def ctc_case(torch, device, rng, slots=96, steps=400, max_u=150, vocab=72):
    """Logits and labels for the DP check: ragged time and label lengths,
    a row of repeated labels, an infeasible pair and an empty label."""
    logits = torch.from_numpy(
        rng.randn(slots, steps, vocab).astype(np.float32)).to(device)
    seq = rng.randint(steps // 2, steps + 1, slots)
    seq[0] = steps
    label_len = np.minimum(rng.randint(max_u // 3, max_u + 1, slots), seq // 2)
    label_len[0] = max_u
    labels = np.full((slots, max_u), -1, np.int64)
    for n in range(slots):
        labels[n, :label_len[n]] = rng.randint(0, vocab - 1, label_len[n])
    labels[1, :label_len[1]] = 7            # every label repeated
    label_len[2], seq[2] = max_u, max_u - 10  # more labels than frames
    labels[2] = rng.randint(0, vocab - 1, max_u)
    label_len[3] = 0                          # empty label
    labels[3] = -1
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)
    return logits, t(seq.astype(np.int32)), t(labels), t(label_len)


def dp_args(torch, pkg, logits, seq, labels, label_len):
    """The alpha and beta kernels' arguments, as ops/ctc builds them."""
    ctc, NEG = pkg["ctc"], pkg["ctc_kernels"].NEG_INF
    steps, vocab = logits.shape[1], logits.shape[2]
    lengths = label_len.long()
    ext, valid, can_skip = ctc._lattice(labels, lengths, vocab - 1)
    lp = torch.log_softmax(logits, -1)
    lp_ext = torch.gather(lp, 2, ext[:, None, :].expand(-1, steps, -1)
                          ).transpose(0, 1).contiguous()
    s = torch.arange(ext.shape[1], device=logits.device)[None, :]
    init = (s == 0) | ((s == 1) & (lengths[:, None] > 0))
    alpha0 = torch.where(init & valid, lp_ext[0],
                         torch.full_like(lp_ext[0], NEG))
    tt = torch.arange(steps, device=logits.device)[:, None]
    time_mask = (tt < seq.long()[None, :]).contiguous()
    end = 2 * lengths[:, None]
    final = (((s == end) | ((s == end - 1) & (lengths[:, None] > 0)))
             & valid).contiguous()
    skip_from = torch.cat([can_skip[:, 2:], torch.zeros_like(
        can_skip[:, :2])], 1).contiguous()
    is_last = (tt == (seq.long() - 1)[None, :]).contiguous()
    valid, can_skip = valid.contiguous(), can_skip.contiguous()
    return ((lp_ext, time_mask, valid, can_skip, alpha0),
            (lp_ext, time_mask, is_last, valid, skip_from, final))


# K11's lane edges: widths that end inside, at and past a warp's 32 lanes
BETA_EDGE_WIDTHS = (1, 2, 31, 32, 33, 64, 301, 1024)
K11_FIRST_MS = 0.355  # K11's first design's time, PERF.md section 6


def beta_edge_inputs(torch, device, width, rng, slots=3, steps=90):
    """K11's arguments at one edge width: a time mask with gaps across
    32-step words, resets (is_last) three times in two rows, at both edges
    of a word and inside one, and random valid, skip_from and final bits."""
    lp = np.log(rng.rand(steps, slots, width).astype(np.float32) + 1e-3)
    time_mask = rng.rand(steps, slots) < 0.85
    time_mask[:, 0] = np.arange(steps) < steps - 3
    is_last = np.zeros((steps, slots), bool)
    is_last[steps - 4, 0] = True
    is_last[[31, 64, 80], 1] = True
    is_last[[12, 32, 63], 2] = True
    time_mask[[12, 31, 32, 63, 64, 80], 1:] = True
    valid = rng.rand(slots, width) < 0.9
    skip_from = rng.rand(slots, width) < 0.5
    skip_from[:, max(width - 2, 0):] = False
    final = rng.rand(slots, width) < 0.3
    final[:, width - 1] = True
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (lp, time_mask, is_last, valid, skip_from, final)]


def check_ctc_dp(torch, pkg, device, rng):
    ctc_kernels = pkg["ctc_kernels"]
    F = torch.nn.functional
    logits, seq, labels, label_len = ctc_case(torch, device, rng)
    alpha_args, beta_args = dp_args(torch, pkg, logits, seq, labels,
                                    label_len)
    steps, slots, width = alpha_args[0].shape
    say("  lattice: N=%d T=%d S=%d" % (slots, steps, width))
    result = {}
    for name, kernel, plain, args in (
            ("ctc_alpha", ctc_kernels.ctc_alpha, ctc_kernels.alpha_reference,
             alpha_args),
            ("ctc_beta", ctc_kernels.ctc_beta, ctc_kernels.beta_reference,
             beta_args)):
        got = kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        abs_err, rel_err, same = dp_errors(got, ref, ctc_kernels.NEG_INF)
        equal = bool(torch.equal(got, ref))
        say("  %s max_abs %.3e  max |diff|/max(1,|plain|) %.3e  NEG_INF "
            "places identical: %s; bit-equal: %s"
            % (name, abs_err, rel_err, same, equal))
        if not same or rel_err > CTC_TOL:
            fail("%s differs from its plain version (rel %.3e, bound %.0e, "
                 "NEG_INF places identical: %s)"
                 % (name, rel_err, CTC_TOL, same))
        if name == "ctc_beta" and not equal:
            fail("K11 is not bit-equal to its plain version")
        ms, plain_ms = time_in_turns(torch, lambda: kernel(*args),
                                     lambda: plain(*args), rounds=3)
        # bytes: lp_ext read and the result written once (masks are small
        # but counted); operations: ~10 per lattice entry and step
        nbytes = (2 * 4 * steps * slots * width + steps * slots * 2
                  + 3 * slots * width + 4 * slots * width)
        bound_ms = max(nbytes / HBM_BYTES_PER_MS,
                       10 * steps * slots * width / F32_FLOPS_PER_MS)
        say("  %s kernel %.3f ms (%.3f us a step)  plain %.3f ms  bound "
            "%.4f ms (bytes)" % (name, ms, ms / steps * 1e3, plain_ms,
                                 bound_ms))
        result[name] = {"max_abs_err": abs_err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms}
    say("  K11 %.3f ms (%.3f us a step) against its first design's %.3f ms "
        "(PERF.md), on %s" % (result["ctc_beta"]["ms"],
                              result["ctc_beta"]["ms"] / steps * 1e3,
                              K11_FIRST_MS, SMI))
    # K11's lane edges, resets across 32-step words: bit-equal to plain
    # (inputs from their own seed: the later phases' draws stay as they were)
    edge_rng = np.random.RandomState(11)
    for width in BETA_EDGE_WIDTHS:
        args = beta_edge_inputs(torch, device, width, edge_rng)
        got = ctc_kernels.ctc_beta(*args)
        ref = ctc_kernels.beta_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail("K11 at width %d is not bit-equal to its plain version"
                 % width)
    say("  K11 at widths %s (resets across 32-step words): bit-equal to "
        "the plain version" % (BETA_EDGE_WIDTHS,))

    # the library yardstick: F.ctc_loss (native CUDA), blank = V-1
    lp = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    lib_args = (labels.clamp(min=0), seq.long(), label_len.long())

    def lib_forward():
        return F.ctc_loss(lp, *lib_args, blank=logits.shape[2] - 1,
                          reduction="none", zero_infinity=True)

    def lib_both():
        x = lp.detach().requires_grad_()
        F.ctc_loss(x, *lib_args, blank=logits.shape[2] - 1,
                   reduction="none", zero_infinity=True).sum().backward()

    def port_both():
        x = logits.detach().requires_grad_()
        pkg["ctc"].ctc_loss(x, seq, labels, label_len).sum().backward()

    fwd_ms, both_ms = time_in_turns(torch, lib_forward, lib_both, rounds=3)
    port_ms, _ = time_in_turns(torch, port_both, lib_both, rounds=3,
                               kernel_reps=1)
    say("  F.ctc_loss forward %.3f ms, forward+backward %.3f ms; the port's "
        "ctc_loss forward+backward (K10, K11 and the glue) %.3f ms"
        % (fwd_ms, both_ms, port_ms))
    result["ctc_alpha"]["library_ms"] = fwd_ms
    result["ctc_beta"]["library_ms"] = both_ms
    result["port_loss_ms"] = port_ms
    return result


def ratio(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(
        float(ref.float().abs().max()), 1e-30)


def long_lattice_case(rng, time_steps=600, vocab=5, max_u=550, peak=6.0):
    """Two rows on a lattice of 2·550 + 1 = 1101 positions, past K10/K11's
    1024: labels without adjacent repeats (row 1: 300 labels in 500
    frames), random logits peaked along one alignment of each row."""
    label_len = np.array([max_u, 300], np.int32)
    seq_len = np.array([time_steps, 500], np.int32)
    labels = np.full((2, max_u), -1, np.int64)
    logits = rng.randn(2, time_steps, vocab).astype(np.float32)
    for b in range(2):
        t = 0
        for u in range(label_len[b]):
            c = rng.randint(0, vocab - 1)
            while u and c == labels[b, u - 1]:
                c = rng.randint(0, vocab - 1)
            labels[b, u] = c
            logits[b, t, c] += peak
            t += 1
            if seq_len[b] - t > label_len[b] - u - 1 and rng.rand() < 0.15:
                logits[b, t, vocab - 1] += peak
                t += 1
    return logits, seq_len, labels, label_len


def routed(torch, fn, wrappers, match):
    """Run ``fn`` (a shape the kernels refuse, on the card): its value, and
    a failure unless the launch counts of ``wrappers`` stayed and one
    warning matched ``match``."""
    before = [w.launches for w in wrappers]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        value = fn()
        torch.cuda.synchronize()
    texts = [str(w.message) for w in seen if re.search(match, str(w.message))]
    if [w.launches for w in wrappers] != before or len(texts) != 1:
        fail("a route launched a kernel or did not warn once: %s, %s"
             % ([w.launches for w in wrappers], texts))
    return value, texts[0]


# the BLSTM layer phase 6 routes: past the layer kernels' 2048 units (H = P
# = 1024 without a projection, routed until the streamed plan took it, now
# runs K1 and K2)
ROUTED_UNITS = 2052


def check_routes(torch, pkg, device, rng):
    """One refused shape per wrapper module, decided before any launch:
    each runs the plain version on the card, equal to it at the existing
    bounds, warns once, and launches no kernel."""
    from lstm_ctc_tpu_torch.models import blstm
    cells, moe, mk, lk = (pkg["cells"], pkg["moe"], pkg["moe_kernels"],
                          pkg["lstm_kernels"])
    ck = pkg["ctc_kernels"]
    # CTC, a lattice of 1101 positions: loss and gradient as on the CPU
    logits, seq_len, labels, label_len = long_lattice_case(rng)
    args = [torch.from_numpy(a) for a in (seq_len, labels, label_len)]
    x = torch.from_numpy(logits).requires_grad_()
    pkg["ctc"].ctc_loss(x, *args).sum().backward()
    xg = torch.from_numpy(logits).to(device).requires_grad_()

    def ctc_step():
        loss = pkg["ctc"].ctc_loss(xg, *[a.to(device) for a in args])
        loss.sum().backward()
        return loss

    loss, text = routed(torch, ctc_step, (ck.ctc_alpha, ck.ctc_beta),
                        "S=1101")
    ref = pkg["ctc"].ctc_loss(x.detach(), *args)
    worst = max(float((loss.detach().cpu() - ref).abs().max()),
                float((xg.grad.cpu() - x.grad).abs().max()))
    say("  route, CTC S=1101: loss and gradient vs the plain version on the "
        "CPU max |diff| %.3e (bound %.0e), no K10/K11 launch; warned: %s"
        % (worst, CTC_TOL, text))
    if worst > CTC_TOL * max(1.0, float(ref.abs().max())):
        fail("the routed CTC differs from its plain version")

    # MoE, one training step each: V = 129 in bf16 under the default
    # backward (outside the kernels' V <= 128 or lcm(V, 128) <= 4096, as
    # the reference's fused_eligible), and D = 1100 in float32 under the
    # twokernel backward
    wrappers = (mk.moe_mix_forward, mk.moe_mix_forward_stash,
                mk.moe_mix_backward, mk.moe_mix_backward_noemit,
                mk.moe_mix_wgrad, mk.moe_mix_backward_wgrad)
    for d, v, dtype, match, mode in (
            (640, 129, torch.bfloat16, "129 targets", "xla"),
            (1100, 72, torch.float32, "width of 1100", "twokernel")):
        gen = torch.Generator().manual_seed(v)
        params = {k: t.to(device).requires_grad_()
                  for k, t in moe.init_moe(gen, d, v, 4).items()}
        xm = torch.from_numpy(rng.randn(2048, d).astype(np.float32)).to(
            device).requires_grad_()
        gout = torch.from_numpy(rng.randn(2048, v).astype(np.float32)).to(
            device)
        leaves = [xm] + list(params.values())

        def head(generator):
            out = moe.apply_moe(params, xm, 4, 10.0, compute_dtype=dtype,
                                keep_prob=0.9, generator=generator,
                                wgrad_mode=mode)
            return out, torch.autograd.grad(out, leaves, gout)

        (out, grads), text = routed(
            torch, lambda: head(torch.Generator(device).manual_seed(0)),
            wrappers, match)
        g = torch.Generator(device).manual_seed(0)
        gate = cells.dropout(g, torch.softmax(
            xm @ params["w_prior"] + params["b_prior"], -1), 0.9)
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=g,
                             device=device, dtype=torch.int32)
        ref = mk.moe_mix_reference(xm, params["w_expert"],
                                   params["b_expert"], gate, 4, 10.0, 0.9,
                                   seed, dtype)
        ref_grads = torch.autograd.grad(ref, leaves, gout)
        same = bool(torch.equal(out, ref)) and all(
            torch.equal(a, b) for a, b in zip(grads, ref_grads))
        say("  route, MoE D=%d V=%d %s training step (%s backward): output "
            "and gradients equal to the plain version's: %s; no K4-K9 "
            "launch; warned: %s"
            % (d, v, str(dtype).split(".")[-1], mode, same, text))
        if not same:
            fail("the routed MoE head differs from its plain version")

    # BLSTM, bf16 H = P = 1024 without a projection in training (wh's
    # slices exceed shared memory even with 16 blocks)
    config = {"nnet_type": "blstm", "input_dim": 40, "num_layers": 1,
              "num_neurons": ROUTED_UNITS, "num_projects": 0,
              "num_targets": 72, "use_peepholes": True,
              "compute_dtype": "bfloat16"}
    params = blstm.init_blstm(torch.Generator().manual_seed(384), config,
                              device)
    leaves = [t.requires_grad_() for t in params["fwd"][0].values()]
    xb = torch.from_numpy(rng.randn(4, 50, 40).astype(np.float32)).to(device)
    seq = torch.tensor([50, 31, 44, 12], device=device)

    def layer():
        logits, _, _ = blstm.apply_blstm(params, xb, seq, config, train=True)
        return logits, torch.autograd.grad(logits.sum(), leaves)

    (logits, grads), text = routed(
        torch, layer, (lk.lstm_layer_forward, lk.lstm_layer_backward,
                       lk.lstm_layer_backward_fold),
        "a layer of %d units exceeds the CUDA layer kernels' 2048"
        % ROUTED_UNITS)
    fw, bw, _ = cells.bilstm_dual_scan(
        params["fwd"][0], params["bwd"][0], xb,
        cells.reverse_sequence(xb, seq), seq, blstm.FORGET_BIAS,
        compute_dtype=torch.bfloat16)
    cat = torch.cat([fw, cells.reverse_sequence(bw, seq)], dim=2)
    ref = (cat.reshape(-1, 2 * ROUTED_UNITS) @ params["head"]["w"]
           + params["head"]["b"]).reshape(logits.shape)
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    same = bool(torch.equal(logits, ref)) and all(
        torch.equal(a, b) for a, b in zip(grads, ref_grads))
    say("  route, BLSTM bf16 H=P=%d (no projection) training: logits and "
        "gradients equal to the plain recurrence's: %s; no K1/K2/K3 launch; "
        "warned: %s"
        % (ROUTED_UNITS, same, text))
    if not same:
        fail("the routed BLSTM layer differs from its plain version")

    # the unidirectional stack, bf16, 8 layers of H = P = 384 in training:
    # K12 and K13 have 16-block plans, but the card holds fewer such
    # clusters at once than the layers of a row tile, so layer by layer,
    # through K1 and K2 (16-block clusters)
    from lstm_ctc_tpu_torch.models import lstm
    sk = pkg["lstm_stack_kernels"]

    def make_stack(units, out_dim, layers):
        stack, width = [], 40
        for _ in range(layers):
            stack.append({k: t.to(device) for k, t in cells.init_lstm_cell(
                torch.Generator().manual_seed(width + units), width, units,
                out_dim, True).items()})
            width = out_dim or units
        return stack

    stack = make_stack(384, 384, 8)
    leaves = [t.requires_grad_() for c in stack for t in c.values()]
    flags = [False] + [True] * (len(stack) - 1)

    def stack_step():
        out, _ = lstm.stack_layers(stack, xb, seq, flags, torch.bfloat16)
        return out, torch.autograd.grad(out.sum(), leaves)

    layer_before = [lk.lstm_layer_forward.launches,
                    lk.lstm_layer_backward.launches]
    (out, grads), text = routed(
        torch, stack_step, (sk.lstm_stack_forward, sk.lstm_stack_backward),
        r"clusters of the CUDA stack forward \(K12\) at once for a bfloat16 "
        "stack of H=384 P=384, fewer than its 8 layers")
    layer_launches = [lk.lstm_layer_forward.launches - layer_before[0],
                      lk.lstm_layer_backward.launches - layer_before[1]]
    if layer_launches != [len(stack)] * 2:
        fail("the refused stack's layers launched K1 and K2 %s times, "
             "expected once each a layer" % layer_launches)
    ref = xb
    for cell, residual in zip(stack, flags):
        o = lstm.layer_forward(cell, ref, seq, torch.bfloat16)
        ref = o + ref if residual else o
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    same = bool(torch.equal(out, ref)) and all(
        torch.equal(a, b) for a, b in zip(grads, ref_grads))
    how = sk.stack_config(device, 1, len(stack), 1, 384, 384, True,
                          torch.bfloat16)
    say("  route, lstm stack bf16 of 8 layers of H=P=384 in training (%d "
        "blocks a cluster, %d resident at once): outputs and gradients "
        "equal to the layer-by-layer composition's: %s; no K12/K13 launch, "
        "K1 and K2 once each a layer; warned: %s"
        % (how["blocks"], how["resident"], same, text))
    if not same or how["rows"]:
        fail("the deep lstm stack was not routed, or differs from its "
             "layer-by-layer version")

    # a bf16 stack of H = P = 2052 without a projection, streamed (carried
    # states): past the stack kernels' 2048 units, for the stack and for
    # one layer of it, so each layer runs the plain scan
    stack = make_stack(ROUTED_UNITS, None, 2)
    states = [tuple(torch.from_numpy(0.1 * rng.randn(4, ROUTED_UNITS).astype(
        np.float32)).to(device) for _ in range(2)) for _ in stack]

    def stream():
        with torch.no_grad():
            return lstm.stack_layers(stack, xb, seq, [False, True],
                                     torch.bfloat16, initial_states=states)

    (got, got_states), text = routed(
        torch, stream, (sk.lstm_stack_forward,),
        "a stack of %d units exceeds the CUDA stack kernels' 2048"
        % ROUTED_UNITS)
    ref, ref_states = xb, []
    with torch.no_grad():
        for cell, residual, state in zip(stack, [False, True], states):
            o, st = cells.lstm_scan(cell, ref, seq, lstm.FORGET_BIAS, state,
                                    torch.bfloat16)
            ref = o + ref if residual else o
            ref_states.append(st)
    same = bool(torch.equal(got, ref)) and all(
        torch.equal(g, r) for a, b in zip(got_states, ref_states)
        for g, r in zip(a, b))
    say("  route, streamed lstm stack bf16 H=P=%d without a projection: "
        "outputs and carried states equal to the plain scans': %s; no K12 "
        "launch; warned: %s" % (ROUTED_UNITS, same, text))
    if not same:
        fail("the routed streamed stack differs from its plain scans")


def lstm_bwd_case(torch, pkg, device, dtype, reset, rng, fold=False,
                  shape=FLAGSHIP_LAYER, steps=384):
    """K2's arguments at a layer shape (H, P, D; the flagship's by
    default) and T = ``steps``, B = 32: a K1 forward with its per-step states in the store dtype,
    and random output cotangents; with ``fold``, K3's: x2 (the D-wide input
    and its reverse) and wx first."""
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    units, out_dim, dim = shape
    batch = 32
    gen = torch.Generator().manual_seed(13)
    fw = cells.init_lstm_cell(gen, dim, units, out_dim, True, device)
    bw = cells.init_lstm_cell(gen, dim, units, out_dim, True, device)
    x = torch.from_numpy(rng.randn(batch, steps, dim).astype(np.float32)).to(device)
    lengths = rng.randint(steps // 2, steps + 1, batch)
    lengths[0] = steps
    seq = torch.from_numpy(lengths.astype(np.int32)).to(device)
    reset_mask = None
    if reset:
        starts = np.zeros((batch, steps), np.float32)
        starts[:, 0] = 1.0
        for b in range(batch):
            starts[b, rng.randint(1, lengths[b], 2)] = 1.0
        reset_mask = torch.from_numpy(starts).to(device)
    x2 = torch.stack([x, cells.reverse_sequence(x, seq)])
    wx, bias = cells.input_weights(fw, bw, dtype)
    gx = cells.input_projection(x2, wx, bias)
    wh, proj, peep = cells.recurrent_weights(fw, bw, dtype)
    _, keep = cells.step_masks(seq, reset_mask, steps, device)
    args = (gx, seq, keep, wh, proj, peep, 5.0)
    out, cfin, hfin, c_all, h_all = lstm_kernels.lstm_layer_forward(
        *args, states=True, store_dtype=dtype)
    dout = torch.from_numpy((0.1 * rng.randn(*out.shape)).astype(
        np.float32)).to(device)
    return ((x2, wx) if fold else ()) + args + (
        c_all, h_all, dout, torch.zeros_like(cfin), torch.zeros_like(hfin))


def check_lstm_bwd(torch, pkg, device, dtype, reset, rng,
                   shape=FLAGSHIP_LAYER, steps=384):
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    args = lstm_bwd_case(torch, pkg, device, dtype, reset, rng, shape=shape,
                         steps=steps)
    name = layer_name(dtype, shape, steps)
    got = lstm_kernels.lstm_layer_backward(*args, store_dtype=dtype)
    ref = cells.dual_recurrence_backward(*args, store_dtype=dtype)
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for out, g, r in zip(("dgates", "dwh", "dproj", "dpeep"), got, ref):
        if g is None:  # no projection
            continue
        if not torch.isfinite(g.float()).all():
            fail("K2 %s: non-finite %s" % (name, out))
        abs_err = float((g.float() - r.float()).abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel,
                                                            ratio(g, r))
        say("  K2 %-8s reset=%-5s %-6s max_abs %.3e  rel %.3e"
            % (name, reset, out, abs_err, ratio(g, r)))
    if dtype == torch.float32 and worst_rel > F32_REL_TOL:
        fail("K2 %s reset=%s: relative error %.3e > %.1e"
             % (name, reset, worst_rel, F32_REL_TOL))
    if dtype == torch.bfloat16:
        # each step from the kernel's own carries (bf16 rounding flips
        # carry on along the sequence, as for K1), and the weight gradients
        # over the kernel's own dgates and the steps' stashes
        full = lstm_kernels.lstm_layer_backward(*args, store_dtype=dtype,
                                                steps=True)
        dgates, dc_in, dh_in = full[0], full[4], full[5]
        dg, dc_out, dh_out, wgrads = cells.replay_backward_steps(
            *args[:-2], dc_in, dh_in, store_dtype=dtype, dgates=dgates)
        step_rel = max(ratio(dc_out[1:], dc_in[:-1]),
                       ratio(dh_out[1:], dh_in[:-1]))
        rounding, k2_f64, plain_f64, old_rule = dgates_held(
            torch, cells, args, dgates, dc_in, dh_in, dg)
        wgrad_rel = weight_grads_rel(full[1:4], wgrads)
        say("  K2 %s reset=%-5s per step: carries max rel %.3e (bound "
            "%.0e); dgates against the float64 replay: worst |diff|/bound "
            "%.3f (the plain f32 replay's %.3f; past one bf16 step of the "
            "plain replay: %d); over the kernel's dgates: dwh, dproj and "
            "dpeep max rel %.3e (bound %.0e)"
            % (name, reset, step_rel, BF16_STEP_REL_TOL, k2_f64, plain_f64,
               old_rule, wgrad_rel, BF16_STEP_REL_TOL))
        if (step_rel > BF16_STEP_REL_TOL or not rounding
                or wgrad_rel > BF16_STEP_REL_TOL):
            fail("K2 bf16 per-step replay or weight gradients outside their "
                 "bounds")
    if shape in STREAMED_LAYERS + (WIDEST_LAYER,):
        again = lstm_kernels.lstm_layer_backward(*args, store_dtype=dtype)
        if not all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(got, again)):
            fail("K2 %s: two launches differ" % name)
        say("  K2 %s reset=%-5s two launches bit-equal" % (name, reset))
    units, out_dim = shape[0], shape[1] or shape[0]
    forced = None
    if dtype == torch.bfloat16 and (units, out_dim) in PARENT_ROWS:
        one = (ONE_ROW_PLAN, PARENT_ROWS[(units, out_dim)][1])
        forced = one_row_backward(torch, lstm_kernels, name, args, one)
    timed = time_in_turns(
        torch, lambda: lstm_kernels.lstm_layer_backward(*args,
                                                        store_dtype=dtype),
        lambda: cells.dual_recurrence_backward(*args, store_dtype=dtype),
        rounds=3, kernel_reps=2, also=forced)
    ms, plain_ms = timed[:2]
    steps = args[0].shape[0]
    how = layer_launch(lstm_kernels, device, "backward", args, dtype)
    bound_ms, bound_by = lstm_bwd_bound(torch, args, got, dtype)
    say("  K2 %-8s reset=%-5s kernel %.3f ms (%.1f us/step; %s)  plain "
        "%.3f ms  bound %.4f ms (%s)%s"
        % (name, reset, ms, 1e3 * ms / steps, launch_line(how), plain_ms,
           bound_ms, bound_by, stream_line(how, steps, ms)))
    res = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "launch": how}
    if forced is not None:
        fhow = one_row_config(lstm_kernels, device, "backward", units,
                              out_dim, args[4] is not None, dtype)
        say("  K2 %s reset=%-5s in turns: the launcher's %s: %.3f ms; forced "
            "at the parent's one-row %s: %.3f ms (%.2fx)"
            % (name, reset, layer_rows_line(how, steps, ms), ms,
               layer_rows_line(fhow, steps, timed[2]), timed[2],
               timed[2] / ms))
        res.update(forced_ms=timed[2], forced_launch=fhow)
    return res


def one_row_backward(torch, lstm_kernels, name, args, one):
    """K2 at the launcher's R against the same launch forced at ``one`` (the
    parent's one-row R), with the states in bf16 (``args``) and float32 (a
    forward of ``args`` that keeps them so): dgates, dc_in, dh_in, the
    out_blk and dout_p stashes, dwh and dproj bit-equal; dpeep (each
    thread's rows added first, in other row tiles) within
    BF16_STEP_REL_TOL.  Returns the forced launch, as ``check_lstm_bwd``
    times it."""
    cases = [(args, torch.bfloat16)]
    states = lstm_kernels.lstm_layer_forward(*args[:7], states=True,
                                             store_dtype=torch.float32)
    cases.append((args[:7] + states[3:] + args[9:], torch.float32))
    names = ("dgates", "dwh", "dproj", "dpeep", "dc_in", "dh_in", "fold",
             "stashes")
    worst = 0.0
    for case, store in cases:
        got, want = (lstm_kernels._backward_launch(
            "K2", None, *case, store, True, plan)
            for plan in (None, one))
        for n, a, b in zip(names, got, want):
            if n == "stashes":
                pairs = list(zip(a, b))
            else:
                pairs = [(a, b)]
            for x, y in pairs:
                if x is None and y is None:
                    continue
                if n == "dpeep":
                    worst = max(worst, ratio(x, y))
                elif not torch.equal(x, y):
                    fail("K2 %s: %s at the launcher's R differs from R=%d "
                         "(states in %s)" % (name, n, one[1], store))
    if worst > BF16_STEP_REL_TOL:
        fail("K2 %s: dpeep at the launcher's R max rel %.3e from R=%d > %.0e"
             % (name, worst, one[1], BF16_STEP_REL_TOL))
    say("  K2 %s the launcher's R bit-equal row for row to the same launch "
        "forced at R=%d (dgates, dc_in, dh_in, the out_blk and dout_p "
        "stashes, dwh, dproj; states in bf16 and float32): True; dpeep max "
        "rel %.2e (bound %.0e)" % (name, one[1], worst, BF16_STEP_REL_TOL))
    return lambda: lstm_kernels.lstm_layer_backward(
        *args, store_dtype=torch.bfloat16, _plan=one)


def weight_grads_rel(got, ref):
    """The largest max|diff|/max|plain| of K2's (dwh, dproj, dpeep) against
    the plain sums ``ref`` (None where the layer has no such weight)."""
    return max(ratio(g, r) for g, r in zip(got, ref) if r is not None)


def lstm_bwd_bound(torch, inputs, outputs, dtype, fold=False):
    """(least ms, what sets it) of K2 (or, with ``fold``, K3) called on
    ``inputs`` (K3: x2, wx, then K2's) and returning ``outputs``: each
    tensor read or written once; the products this run's data needs, over the live rows only (each sequence's length, in both
    directions; past it a row's dgates are zero): the recurrence's (the
    gate recompute, dh_prev and, with a projection, dout_blk), dwh and
    dproj, and K3's dwx and dx."""
    gx, seq, wh = (inputs[2 * fold + i] for i in (0, 1, 3))
    has_proj = inputs[2 * fold + 4] is not None
    h4 = gx.shape[-1]
    units, out_dim = h4 // 4, wh.shape[1]
    rows = 2 * int(seq.sum())
    flops = 2 * rows * out_dim * (2 * h4 + (units if has_proj else 0)) \
        + 2 * rows * (out_dim * h4 + (units * out_dim if has_proj else 0))
    if fold:
        flops += 2 * 2 * rows * h4 * inputs[0].shape[-1]
    peak = BF16_FLOPS_PER_MS if dtype == torch.bfloat16 else F32_FLOPS_PER_MS
    return bound(tensor_bytes(torch, inputs, outputs), flops, peak)


def check_lstm_bwd_fold(torch, pkg, device, dtype, reset, rng,
                        shape=FLAGSHIP_LAYER):
    """Phase 15: K3 against its plain version under phase 7's rules, and
    its input side against the plain one over the kernel's own dgates."""
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    args = lstm_bwd_case(torch, pkg, device, dtype, reset, rng, fold=True,
                         shape=shape)
    name = layer_name(dtype, shape)
    names = ("dx", "dwx", "dbias", "dwh", "dproj", "dpeep")
    got = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=dtype)
    torch.cuda.synchronize()
    for out, g in zip(names, got):
        if g is not None and not torch.isfinite(g.float()).all():
            fail("K3 %s: non-finite %s" % (name, out))
    if dtype == torch.float32:
        ref = cells.dual_recurrence_backward_fold(*args, store_dtype=dtype)
        rels = {out: ratio(g, r) for out, g, r in zip(names, got, ref)
                if g is not None}
        say("  K3 %s reset=%-5s max|diff|/max|plain|: %s"
            % (name, reset, ", ".join("%s %.2e" % kv for kv in rels.items())))
        if max(rels.values()) > F32_REL_TOL:
            fail("K3 %s reset=%s: relative error %.3e > %.1e"
                 % (name, reset, max(rels.values()), F32_REL_TOL))
        worst_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref)
                        if g is not None)
    else:
        # each step from the kernel's own carries, as for K2, and the
        # input side over the kernel's own dgates
        full = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=dtype,
                                                     steps=True)
        dgates, dc_in, dh_in = full[6:]
        dg, dc_out, dh_out, wgrads = cells.replay_backward_steps(
            *args[2:-2], dc_in, dh_in, store_dtype=dtype, dgates=dgates)
        step_rel = max(ratio(dc_out[1:], dc_in[:-1]),
                       ratio(dh_out[1:], dh_in[:-1]))
        rounding = dgates_held(torch, cells, args[2:], dgates, dc_in, dh_in,
                               dg)[0]
        dx, dwx, dbias = cells.fold_input_side(args[0], args[1], dgates,
                                               dtype)
        terms = cells.fold_input_side(args[0], args[1].abs(), dgates.abs(),
                                      torch.float32)[0]
        dx_ok = bool(((full[0].float() - dx.float()).abs()
                      <= 2.0 ** -7 * dx.float().abs()
                      + SUM_ORDER_TOL * terms).all())
        side_rel = max(ratio(full[1], dwx), ratio(full[2], dbias),
                       weight_grads_rel(full[3:6], wgrads))
        say("  K3 %s reset=%-5s per step: carries max rel %.3e (bound "
            "%.0e); dgates within the float64 replay's bound: %s; over the "
            "kernel's dgates: dx within one bf16 rounding step (and 16 f32 "
            "ulps of its terms' sum): %s, dwx, dbias, dwh, dproj and dpeep "
            "max rel %.3e (bound %.0e)"
            % (name, reset, step_rel, BF16_STEP_REL_TOL, rounding, dx_ok,
               side_rel, BF16_STEP_REL_TOL))
        if (step_rel > BF16_STEP_REL_TOL or not rounding or not dx_ok
                or side_rel > BF16_STEP_REL_TOL):
            fail("K3 bf16 per-step replay or input side outside its bounds")
        worst_abs = float((full[0].float() - dx.float()).abs().max())
    ms, plain_ms = time_in_turns(
        torch, lambda: lstm_kernels.lstm_layer_backward_fold(
            *args, store_dtype=dtype),
        lambda: cells.dual_recurrence_backward_fold(*args, store_dtype=dtype),
        rounds=3, kernel_reps=2)
    k2_ms = median_ms(torch, lambda: lstm_kernels.lstm_layer_backward(
        *args[2:], store_dtype=dtype), reps=4)
    how = layer_launch(lstm_kernels, device, "backward", args[2:],
                       dtype)
    bound_ms, bound_by = lstm_bwd_bound(torch, args, got, dtype, fold=True)
    say("  K3 %-8s reset=%-5s kernel %.3f ms (K2 alone on the same inputs "
        "%.3f ms; K2's %s)  plain %.3f ms  bound %.4f ms (%s)%s"
        % (name, reset, ms, k2_ms, launch_line(how), plain_ms, bound_ms,
           bound_by, stream_line(how, args[2].shape[0], ms)))
    result = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "k2_ms": k2_ms,
              "launch": how}
    if dtype == torch.bfloat16 and shape == FLAGSHIP_LAYER:
        result.update(fold_yardsticks(torch, lstm_kernels, args, dtype))
    return result


# K3's launches by kernel: K2's recurrence and weight gradients, then the
# input side (csrc/lstm_bwd_fold.cu and csrc/wg_product.cuh)
K3_KERNELS = (("dx product", r"wg_product_kernel<.*DxOp"),
              ("dwx product", r"wg_product_kernel<.*DwxOp"),
              ("x cast", r"cast_rows_bf16"),
              ("dbias side sum", r"dg_column_sums"),
              ("sums of partials", r"split_sum4|group_sum"),
              ("K2", r"lstm_bwd|lstm_wgrad|peep|wgrad|split_sum_kernel"))


def fold_yardsticks(torch, lstm_kernels, args, dtype):
    """Beside K3 in bf16: cuBLAS's bare products dx = dg·wxᵀ and dwx =
    x(bf16)ᵀ·dg on the same operands (one torch.mm per direction, float32
    out; dg's rows gathered into (b, t) order beforehand, untimed), and one
    profiled K3 launch split by kernel."""
    x2, wx = args[:2]
    full = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=dtype,
                                                 steps=True)
    steps, b2, h4 = full[6].shape
    batch = b2 // 2
    dg = full[6].view(steps, 2, batch, h4).permute(1, 2, 0, 3).reshape(
        2, batch * steps, h4).contiguous()
    xb = x2.to(torch.bfloat16).reshape(2, batch * steps, -1)
    wxb = wx.to(torch.bfloat16)

    def dx_products():
        for g in range(2):
            torch.mm(dg[g], wxb[g].t(), out_dtype=torch.float32)

    def dwx_products():
        for g in range(2):
            torch.mm(xb[g].t(), dg[g], out_dtype=torch.float32)

    dx_ms = median_ms(torch, dx_products, reps=8)
    dwx_ms = median_ms(torch, dwx_products, reps=8)
    busy, split, whole = profiled_split(
        torch, lambda: lstm_kernels.lstm_layer_backward_fold(
            *args, store_dtype=dtype), K3_KERNELS,
        ("dx product", "dwx product", "K2"))
    say("  K3 bfloat16 yardstick: cuBLAS's bare products on the same operands "
        "dx %.4f ms, dwx %.4f ms (both directions); one profiled K3 launch, "
        "device %.3f ms%s: %s"
        % (dx_ms, dwx_ms, busy, "" if whole else " (INCOMPLETE: the profiler "
           "missed kernels in 3 tries)",
           ", ".join("%s %.4f" % kv for kv in split.items())))
    return {"cublas_dx_ms": dx_ms, "cublas_dwx_ms": dwx_ms,
            "device_split": split}


def write_labeled_corpus(pkg, work, rng, count=288):
    """288 utterances of 600-1200 raw 40-dim frames, each with raw/8
    labels drawn from the 71 non-blank classes."""
    records = pkg["records"]
    scp = os.path.join(work, "train.scp")
    with records.RecordShardWriter(os.path.join(work, "train.rec")) as writer:
        for i in range(count):
            frames = int(rng.randint(600, 1201))
            labels = rng.randint(0, 71, frames // 8).astype(np.int32)
            writer.write("spk%03d" % i, rng.randn(frames, 40).astype(
                np.float32), labels)
        metas = writer.metas
    with open(scp, "w") as fh:
        for meta in metas:
            fh.write(meta.scp_line())
    return scp


class Tee:
    """stderr that is also kept, so the log lines can be read back."""

    def __init__(self, stream):
        self.stream, self.lines = stream, []

    def write(self, text):
        self.lines.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def value(self, name):
        hits = [ln for ln in "".join(self.lines).splitlines()
                if ln.startswith("INFO:") and (" %s = " % name in ln
                                               or ":%s = " % name in ln)]
        if not hits:
            fail("no %s line in the log" % name)
        return float(hits[-1].rsplit("=", 1)[1])


KERNEL_NAMES = ("lstm_fwd", "lstm_bwd", "ctc_alpha", "ctc_beta", "moe_fwd",
                "moe_fwd_stash", "moe_bwd", "moe_bwd_noemit", "moe_wgrad",
                "lstm_stack_fwd", "lstm_stack_bwd", "lstm_bwd_fold",
                "moe_bwd_wgrad")


def counters(pkg):
    lstm_kernels, ctc_kernels, moe_kernels, sk = (
        pkg["lstm_kernels"], pkg["ctc_kernels"], pkg["moe_kernels"],
        pkg["lstm_stack_kernels"])
    return {"lstm_stack_fwd": sk.lstm_stack_forward,
            "lstm_stack_bwd": sk.lstm_stack_backward,
            "lstm_fwd": lstm_kernels.lstm_layer_forward,
            "lstm_bwd": lstm_kernels.lstm_layer_backward,
            "lstm_bwd_fold": lstm_kernels.lstm_layer_backward_fold,
            "ctc_alpha": ctc_kernels.ctc_alpha,
            "ctc_beta": ctc_kernels.ctc_beta,
            "moe_fwd": moe_kernels.moe_mix_forward,
            "moe_fwd_stash": moe_kernels.moe_mix_forward_stash,
            "moe_bwd": moe_kernels.moe_mix_backward,
            "moe_bwd_noemit": moe_kernels.moe_mix_backward_noemit,
            "moe_wgrad": moe_kernels.moe_mix_wgrad,
            "moe_bwd_wgrad": moe_kernels.moe_mix_backward_wgrad}


def counts(**given):
    """Launch counts of every kernel: 0 but those given."""
    return dict({k: 0 for k in KERNEL_NAMES}, **given)


def run_counted(torch, pkg, fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    (its value, the counts just after, seconds)."""
    wrappers = counters(pkg)
    for w in wrappers.values():
        w.launches = 0
    tee = Tee(sys.stderr)
    start = time.perf_counter()
    with contextlib.redirect_stderr(tee):
        value = fn()
        torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return value, tee, {k: w.launches for k, w in wrappers.items()}, seconds


def expect_counts(what, got, want):
    if got != want:
        fail("%s: launch counts %s, expected %s" % (what, got, want))


def train_end_to_end(torch, pkg, device, work, scp):
    from lstm_ctc_tpu_torch.bin import nnet_init, nnet_train, nnet_validate
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import param_leaves
    config = dict(FLAGSHIP_CONFIG, num_experts=0)
    result = {"launches": counts()}
    config_path = os.path.join(work, "nnet.config")
    with open(config_path, "w") as fh:
        fh.write(format_config(config))
    common = ["--objective", "ctc", "--batch-size", "32", "--device",
              "cuda", "--report-interval", "0"]
    cv_batches = len(build_batcher(scp, config, 32).batch_plan(False, None))
    train_batcher = build_batcher(scp, config, 32, pack_factor=3)
    train_steps = len(train_batcher.batch_plan(True, 777))
    say("  corpus: %d utterances; %d CV batches; %d train steps an "
        "epoch (pack factor 3, rows of %d frames)"
        % (len(train_batcher._lengths), cv_batches, train_steps,
           train_batcher.row_time))
    cv_counts = counts(lstm_fwd=4 * cv_batches, ctc_alpha=cv_batches)
    train_counts = counts(lstm_fwd=4 * train_steps, lstm_bwd=4 * train_steps,
                          ctc_alpha=train_steps, ctc_beta=train_steps)

    def counted(name, fn, want):
        _, tee, got, seconds = run_counted(torch, pkg, fn)
        expect_counts(name, got, want)
        for k in KERNEL_NAMES:
            result["launches"][k] += got[k]
        return tee, seconds

    nnets = [os.path.join(work, "nnet%d.npz" % i) for i in range(3)]
    tee, _ = counted("nnet_init", lambda: nnet_init.main(
        [scp, config_path, nnets[0]] + common), cv_counts)
    cv = [tee.value("cv_loss")]
    tee, _ = counted("nnet_validate", lambda: nnet_validate.main(
        [scp, config_path, nnets[0]] + common), cv_counts)
    cv.append(tee.value("cv_loss"))
    tr, epoch_s, metrics = [], [], []
    for epoch in (1, 2):
        metrics_file = os.path.join(work, "metrics%d.jsonl" % epoch)
        tee, seconds = counted("nnet_train", lambda: nnet_train.main(
            [scp, config_path, nnets[epoch - 1], nnets[epoch],
             "--optimizer", "adam", "--learn-rate", "1e-3",
             "--pack-factor", "3", "--metrics-file", metrics_file]
            + common), train_counts)
        tr.append(tee.value("tr_loss"))
        epoch_s.append(seconds)
        with open(metrics_file) as fh:
            metrics.append([json.loads(ln) for ln in fh])
        tee, _ = counted("nnet_validate", lambda: nnet_validate.main(
            [scp, config_path, nnets[epoch]] + common), cv_counts)
        cv.append(tee.value("cv_loss"))
    say("  cv_loss %s; tr_loss %s; epochs %.1f s, %.1f s (checkpoint "
        "load, batching and save included)"
        % (["%.4f" % v for v in cv], ["%.4f" % v for v in tr],
           epoch_s[0], epoch_s[1]))
    if not all(math.isfinite(v) for v in cv + tr):
        fail("non-finite tr_loss or cv_loss")
    if not cv[-1] < cv[0]:
        fail("the last cv_loss %.4f is not below the first %.4f"
             % (cv[-1], cv[0]))
    template, state = init_from_config(config, device)
    for path in nnets:
        params, _, _ = load_checkpoint(path, template, state)
        if not all(torch.isfinite(p).all() for p in param_leaves(params)):
            fail("%s holds non-finite weights" % path)
    say("  launches on the main path (init, 3 validations, 2 epochs): %s"
        % result["launches"])
    result.update(step_stats(metrics[1], train_batcher))
    say("  epoch 2: median train step %.1f ms; %.1f real frames/s; "
        "packing fill %.3f" % (result["step_ms"], result["fps"],
                               result["fill"]))
    check_steps(torch, pkg, device, config, nnets[2], train_batcher,
                result["step_ms"])
    return result


def step_stats(steps, train_batcher):
    """An epoch's steps, from its metrics file: the host clock around each
    step, which ends in reading the loss (a synchronisation); every
    utterance's frames are trained once an epoch."""
    frames = sum(train_batcher._lengths)
    return {"step_ms": 1e3 * statistics.median(m["step_time"] for m in steps),
            "fps": frames / sum(m["step_time"] for m in steps),
            "fill": frames / (len(steps) * 32 * train_batcher.row_time)}


def fresh_weights(torch, base, nudge=None):
    """A differentiable copy of the weights ``base``; with a generator
    ``nudge``, each weight moved one unit in the last place, up or down at
    random."""
    from lstm_ctc_tpu_torch.train.checkpoint import tree_map

    def copy(t):
        t = t.detach().clone()
        if nudge is not None:
            up = torch.rand(t.shape, generator=nudge, device=t.device) < 0.5
            t = torch.nextafter(t, torch.where(up, math.inf, -math.inf))
        return t.requires_grad_()
    return tree_map(copy, base)


def step_grads(torch, base, batch, config, nudge=None, context=None):
    """(loss, gradients) of one train step, the L2 term included, from a
    copy of the weights ``base`` (nudged as ``fresh_weights`` does), run
    under ``context``."""
    from lstm_ctc_tpu_torch.train.graph import (compute_losses, l2_loss,
                                                param_leaves)
    params = fresh_weights(torch, base, nudge)
    with context or contextlib.nullcontext():
        metrics, _, _ = compute_losses(params, {}, batch, config, train=True)
        total = metrics["loss"] + 1e-5 * l2_loss(params)
        grads = torch.autograd.grad(total, param_leaves(params))
    return float(total.detach()), grads


def versus(base, step, ref):
    """(loss rel, ||diff||/||ref||, [(leaf ratio, leaf)] worst first) of
    one step's (loss, gradients) against ``ref``'s."""
    from lstm_ctc_tpu_torch.train.checkpoint import leaves_with_path
    (loss, grad), (loss_r, grad_r) = step, ref
    grad_rel = math.sqrt(
        sum(float(((a - b) ** 2).sum()) for a, b in zip(grad, grad_r))
        / sum(float((b ** 2).sum()) for b in grad_r))
    leaves = sorted(((ratio(a, b), key) for a, b, (key, _)
                     in zip(grad, grad_r, leaves_with_path(base))),
                    reverse=True)
    return abs(loss - loss_r) / abs(loss_r), grad_rel, leaves


def hold_to_nudge(base, what, step, ref_what, ref, nudged):
    """Fail unless ``step`` is within 1e-4 of ``ref`` in the loss, and its
    gradients within 10x of what ``nudged`` (``ref``'s step with every
    weight moved one unit in the last place) gives, as a whole and in the
    worst leaf."""
    loss_rel, grad_rel, leaves = versus(base, step, ref)
    n_loss, n_grad, n_leaves = versus(base, nudged, ref)
    grad_bound = STEP_NUDGE_FACTOR * n_grad
    leaf_bound = STEP_NUDGE_FACTOR * n_leaves[0][0]
    say("  the %s with every weight moved one unit in the last place, vs "
        "unmoved: loss rel %.3e; gradient ||diff||/||plain|| %.3e; worst "
        "leaf %s max|diff|/max|plain| %.3e"
        % (ref_what, n_loss, n_grad, n_leaves[0][1], n_leaves[0][0]))
    say("  float32 train step, %s vs %s: loss %.6f vs %.6f (rel %.3e, bound "
        "%.0e); gradient ||diff||/||plain|| %.3e (bound %.3e); worst leaf "
        "%s %.3e (bound %.3e)"
        % (what, ref_what, step[0], ref[0], loss_rel, STEP_LOSS_TOL,
           grad_rel, grad_bound, leaves[0][1], leaves[0][0], leaf_bound))
    say("  gradient leaves, largest max|diff|/max|plain| first: %s %s; "
        "nudged %s %s"
        % (what, ", ".join("%s %.2e" % (k, r) for r, k in leaves[:6]),
           ref_what, ", ".join("%s %.2e" % (k, r) for r, k in n_leaves[:6])))
    if (loss_rel > STEP_LOSS_TOL or grad_rel > grad_bound
            or leaves[0][0] > leaf_bound):
        fail("the float32 train step (%s) differs from the %s by more than "
             "%.0fx a last-bit change of the weights does"
             % (what, ref_what, STEP_NUDGE_FACTOR))
    return loss_rel, grad_rel


def check_steps(torch, pkg, device, config, nnet, train_batcher, step_ms,
                parent=None, held_bf16=None):
    """On one packed batch of the training stream, from the trained weights
    in ``nnet``: the float32 step against the plain versions (each launch
    on its own tensors, then end to end under the nudge yardstick), one
    bfloat16 step with every launch held to its plain version, and a
    profiled bfloat16 step.  ``held_bf16`` names the launches the bf16
    step holds (default: every one).  Returns its device kernels' ms, and
    with ``parent`` = (a route's context, its median step ms) also the same
    step's profiled on that route."""
    from lstm_ctc_tpu_torch.cli import init_from_config, make_shard_fn
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import make_train_step
    moe = bool(config.get("num_experts"))
    batch = make_shard_fn(device)(next(iter(iterate_batches(
        train_batcher, shuffle=True, seed=777))))
    train_config = dict(config, packed_slots_rank_major=True)
    template, state = init_from_config(config, device)
    base, _, _ = load_checkpoint(nnet, template, state)

    # float32: one step's loss and gradients, kernels vs plain
    f32 = dict(train_config, compute_dtype="float32", store_dtype="float32",
               dropout_rate=1.0)

    def grads(plain, nudge=None):
        return step_grads(torch, base, batch, f32, nudge,
                          plain_versions(pkg) if plain else None)

    held = ("lstm_fwd", "lstm_bwd") + (("moe_fwd_stash", "moe_bwd")
                                       if moe else ())
    worst32 = {k: 0.0 for k in held}
    with held_f32(torch, pkg, worst32):
        kernels = grads(False)
    say("  float32 train step, each launch vs its plain version on the same "
        "tensors, max rel: %s (bound %.0e)"
        % (", ".join("%s %.3e" % kv for kv in worst32.items()), F32_REL_TOL))
    if max(worst32.values()) > F32_REL_TOL:
        fail("a float32 launch of the train step differs from its plain "
             "version")
    # what the plain versions themselves make of a last-bit change of
    # every weight: the yardstick for the differences of the kernels
    hold_to_nudge(base, "kernels", kernels, "plain versions",
                  grads(True), grads(True, torch.Generator(device)
                                     .manual_seed(3)))

    # bfloat16: one step, every launch held to its plain version on the
    # tensors the model gave it
    held = held_bf16 or ("lstm_bwd", "ctc_alpha", "ctc_beta") + (
        ("moe_fwd_stash", "moe_bwd") if moe else ())
    worst = {k: 0.0 for k in held}
    init_opt, step = make_train_step(train_config, 1e-3, "adam")
    params = fresh_weights(torch, base)
    with held_in_training(torch, pkg, worst):
        step(params, init_opt(params), {},
             torch.Generator(device).manual_seed(1), batch)
        torch.cuda.synchronize()
    say("  bfloat16 train step, each launch vs its plain version: %sK10 "
        "%.3e, K11 %.3e (bound %.0e on |diff|/max(1,|plain|))"
        % ("K2 per-step carries max rel %.3e (bound %.0e), %s; "
           % (worst["lstm_bwd"], BF16_STEP_REL_TOL, dgates_line(worst))
           if "lstm_bwd" in worst else "", worst["ctc_alpha"],
           worst["ctc_beta"], CTC_TOL))
    if moe:
        say("  bfloat16 train step: K5 out max_abs %.3e (bound %.0e), %s; "
            "K6 dx/dgate max rel %.3e (bound %.0e), dz within one bf16 "
            "rounding step"
            % (worst["moe_fwd_stash"], BF16_ABS_TOL, th_line(worst),
               worst["moe_bwd"], BF16_MOE_REL_TOL))

    busy = profile_step(torch, init_opt, step, fresh_weights(torch, base),
                        batch, device, step_ms)
    if parent is None:
        return busy
    route, route_ms = parent
    say("  the same step on the parent's route:")
    with route():
        return busy, profile_step(torch, init_opt, step,
                                  fresh_weights(torch, base), batch, device,
                                  route_ms)


@contextlib.contextmanager
def held_f32(torch, pkg, worst):
    """Run each K1, K2, K3, K5, K6, K7, K12 and K13 launch, then its plain
    version on the same tensors; ``worst`` collects the largest ratio per
    kernel."""
    cells, lstm_kernels, moe_kernels = (pkg["cells"], pkg["lstm_kernels"],
                                        pkg["moe_kernels"])
    k1, k2 = lstm_kernels.lstm_layer_forward, lstm_kernels.lstm_layer_backward
    k5, k6 = moe_kernels.moe_mix_forward_stash, moe_kernels.moe_mix_backward

    def note(name, got, ref):
        worst[name] = max(worst[name], max(
            ratio(g, r) for g, r in zip(got, ref) if g is not None))
        return got

    def forward(*args, states=False, store_dtype=None):
        return note("lstm_fwd", k1(*args, states=states,
                                   store_dtype=store_dtype),
                    cells.dual_recurrence(*args, states=states))

    def backward(*args, store_dtype=None):
        return note("lstm_bwd", k2(*args, store_dtype=store_dtype),
                    cells.dual_recurrence_backward(*args,
                                                   store_dtype=store_dtype))

    def stash(*args):
        return note("moe_fwd_stash", k5(*args),
                    moe_kernels.moe_stash_reference(*args))

    def mix_backward(*args):
        return note("moe_bwd", k6(*args),
                    moe_kernels.moe_backward_reference(*args))

    k3, k7 = (lstm_kernels.lstm_layer_backward_fold,
              moe_kernels.moe_mix_backward_wgrad)

    def backward_fold(*args, store_dtype=None):
        return note("lstm_bwd_fold", k3(*args, store_dtype=store_dtype),
                    cells.dual_recurrence_backward_fold(
                        *args, store_dtype=store_dtype))

    def mix_backward_wgrad(*args):
        return note("moe_bwd_wgrad", k7(*args),
                    moe_kernels.moe_backward_wgrad_reference(*args))

    sk = pkg["lstm_stack_kernels"]
    k12, k13 = sk.lstm_stack_forward, sk.lstm_stack_backward

    def stack_forward(*args, states=False, **kwargs):
        got = k12(*args, states=states, **kwargs)
        out, chain, c_all, h_all, cfin, hfin = sk.stack_forward_reference(
            *args, **kwargs)
        return note("lstm_stack_fwd", got, (out, cfin, hfin) + (
            (chain, c_all, h_all) if states else ()))

    def stack_backward(*args, **kwargs):
        return note("lstm_stack_bwd", k13(*args, **kwargs),
                    sk.stack_backward_reference(*args, **kwargs))

    stand_ins = ((lstm_kernels, "lstm_layer_forward", forward),
                 (lstm_kernels, "lstm_layer_backward", backward),
                 (moe_kernels, "moe_mix_forward_stash", stash),
                 (moe_kernels, "moe_mix_backward", mix_backward),
                 (lstm_kernels, "lstm_layer_backward_fold", backward_fold),
                 (moe_kernels, "moe_mix_backward_wgrad", mix_backward_wgrad),
                 (sk, "lstm_stack_forward", stack_forward),
                 (sk, "lstm_stack_backward", stack_backward))
    with contextlib.ExitStack() as stack:
        for module, name, fn in stand_ins:
            fn.launches = 0
            stack.enter_context(mock.patch.object(module, name, fn))
        yield


def within_bf16_step(got, ref):
    """Every element within one bf16 rounding step of the plain version's."""
    return bool(((got.float() - ref.float()).abs()
                 <= 2.0 ** -7 * ref.float().abs() + 1e-6).all())


def cell_backward_float64(torch, gates, errs, c0, peep, forget_bias, m, dc,
                          dob, edob):
    """The cell backward of dgates_float64 (K2) and stack_dgates_float64
    (K13) in float64 from the gate sums ``gates`` [..., L or 2, B, 4H] and
    their error bounds ``errs``, c_prev ``c0``, the peepholes ``peep`` [L
    or 2, 3, H] (or None), the mask ``m``, the carried dc, and dout_blk
    ``dob`` with its bound ``edob``: each product and transcendental
    function off by a few u of its value, each sum by u·Σ|terms|, carried
    through the derivatives of what follows.  Returns (dg, err)."""
    u = F32_UNIT
    units = c0.shape[-1]

    def sig(x, e):
        y = torch.sigmoid(x)
        return y, y * (1.0 - y) * e + 4 * u * y

    def tanh(x, e):
        y = torch.tanh(x)
        return y, (1.0 - y * y) * e + 4 * u * y.abs()

    (i, j, f, o), (ei, ej, ef, eo) = (gates.split(units, dim=-1),
                                      errs.split(units, dim=-1))
    pe = None if peep is None else peep.to(torch.float64)
    if pe is not None:
        pi, pf, po = (pe[:, k, None, :] for k in range(3))
        i = i + pi * c0
        ei = ei + u * ((pi * c0).abs() + i.abs())
        f = f + pf * c0
        ef = ef + u * ((pf * c0).abs() + f.abs())
    fb = f + forget_bias
    si, esi = sig(i, ei)
    tj, etj = tanh(j, ej)
    sf, esf = sig(fb, ef + u * fb.abs())
    cn = sf * c0 + si * tj
    ecn = (c0.abs() * esf + tj.abs() * esi + si.abs() * etj
           + u * ((sf * c0).abs() + (si * tj).abs() + cn.abs()))
    if pe is not None:
        o = o + po * cn
        eo = eo + po.abs() * ecn + u * ((po * cn).abs() + o.abs())
    so, eso = sig(o, eo)
    tc, etc = tanh(cn, ecn)
    k_o = tc * so * (1.0 - so)
    d_o = dob * k_o
    e_ko = (so * (1.0 - so)).abs() * etc + (tc * (1.0 - 2 * so)).abs() * eso
    e_do = k_o.abs() * edob + dob.abs() * e_ko + 3 * u * d_o.abs()
    q1 = so * (1.0 - tc * tc)
    t1, t2 = dob * q1, m * dc
    e_t1 = (q1.abs() * edob + dob.abs() * ((1.0 - tc * tc) * eso
                                           + 2 * (so * tc).abs() * etc)
            + 3 * u * t1.abs())
    if pe is not None:
        t3, e_t3 = d_o * po, po.abs() * e_do + u * (d_o * po).abs()
    else:
        t3, e_t3 = torch.zeros_like(t1), torch.zeros_like(t1)
    dcn = t1 + t2 + t3
    e_dcn = e_t1 + e_t3 + 2 * u * (t1.abs() + t2.abs() + t3.abs())
    k_i, k_j = tj * si * (1.0 - si), si * (1.0 - tj * tj)
    k_f = c0 * sf * (1.0 - sf)
    e_ki = (si * (1.0 - si)).abs() * etj + (tj * (1.0 - 2 * si)).abs() * esi
    e_kj = (1.0 - tj * tj) * esi + 2 * (si * tj).abs() * etj
    e_kf = (c0 * (1.0 - 2 * sf)).abs() * esf
    dg = torch.cat([dcn * k_i, dcn * k_j, dcn * k_f, d_o], dim=-1)
    err = torch.cat([k_i.abs() * e_dcn + dcn.abs() * e_ki,
                     k_j.abs() * e_dcn + dcn.abs() * e_kj,
                     k_f.abs() * e_dcn + dcn.abs() * e_kf, e_do], dim=-1)
    return dg, err + 3 * u * dg.abs()


def dgates_float64(torch, cells, args, dc_in, dh_in):
    """The dgates of every step of a K2 (or K3) launch on K2's ``args``
    replayed in float64 from the kernel's own carries entering each step
    (dc_in, dh_in) and the stored states, the products' operands rounded
    to the compute dtype as the kernel rounds them (dout_p formed in
    float32 first, as the kernel forms it).  Returns (dg, err), both [T,
    2B, 4H] float64: err is a first-order bound on the float32
    computation's error in each element, a running error bound: each
    float32 sum off by u·Σ|terms| (u = 2^-24; the gate sums over P and
    gx, dout_blk's over P, dc_new's three terms), each product and
    transcendental function by a few u of its value, carried through the
    derivatives of what follows (the gates' sigmoids and tanhs, c_new,
    dc_new, the factors that take it to each element)."""
    gx, seq, keep, wh, proj, peep, forget_bias, c_all, h_all, dout = args[:10]
    time_steps, b2, h4 = gx.shape
    f64, cdt, u = torch.float64, wh.dtype, F32_UNIT
    gx4, keep4, valid4 = cells._step_views(gx, seq, keep)
    c0 = cells._previous(c_all, keep4).to(f64)
    h_prev = cells._previous(h_all, keep4)
    m = valid4.to(f64)

    def view(x, dtype=f64):
        return x.to(dtype).reshape(time_steps, 2, b2 // 2, x.shape[-1])

    def rounded(x):
        return x.to(cdt).to(f64)

    hq, whq = rounded(h_prev), rounded(wh)
    gx64 = gx4.to(f64)
    gates = gx64 + torch.matmul(hq, whq)
    errs = u * (gx64.abs() + torch.matmul(hq.abs(), whq.abs()))
    dc = view(dc_in)
    dout_p = valid4.float() * (view(dout, torch.float32)
                               + view(dh_in, torch.float32))
    if proj is None:
        dob = m * (view(dout) + view(dh_in))
        edob = u * dob.abs()
    else:
        dq, pt = rounded(dout_p), rounded(proj).transpose(-1, -2)
        dob = torch.matmul(dq, pt)
        edob = u * torch.matmul(dq.abs(), pt.abs())
    dg, err = cell_backward_float64(torch, gates, errs, c0, peep,
                                    forget_bias, m, dc, dob, edob)
    return dg.reshape(time_steps, b2, h4), err.reshape(time_steps, b2, h4)


def dgates_held(torch, cells, args, dgates, dc_in, dh_in, plain_dg):
    """K2's bf16 dgates (as stored) against the float64 replay of its own
    steps: each element within one bf16 rounding step of it plus the
    replay's bound on the float32 computation's error (near a cancellation
    in dc_new that error, not the bf16 rounding, moves an element), and
    1e-6.  Returns (within, the worst |diff| / that bound, the same of the
    plain version's one-step replay ``plain_dg`` (rounded as stored), the
    elements past one bf16 step of the plain replay: the rule until PR
    17)."""
    ref, err = dgates_float64(torch, cells, args, dc_in, dh_in)
    bound = 2.0 ** -7 * ref.abs() + err + 1e-6
    worst = float(((dgates.to(ref.dtype) - ref).abs() / bound).max())
    plain = float(((plain_dg.to(ref.dtype) - ref).abs() / bound).max())
    old_rule = int(((dgates.float() - plain_dg.float()).abs()
                    > 2.0 ** -7 * plain_dg.float().abs() + 1e-6).sum())
    return worst <= 1.0, worst, plain, old_rule


def th_held(torch, args, th, ref_th):
    """K5's tanh stash th (bf16, as stored) against a float64 replay of
    tanh(x·W + b) from its own inputs (x rounded to bf16 as the kernel
    rounds it): each element within one bf16 rounding step of it plus a
    first-order bound on the float32 computation's error (the sum x·W + b
    off by u·Σ|terms|, u = 2^-24, carried through tanh's derivative, and a
    few u of tanh), and 1e-6.  Returns (within, the worst |diff| / that
    bound, the same of the plain version's th ``ref_th``, the elements
    past one bf16 step of the plain version's th: the rule until PR 17)."""
    x, w, b = args[0], args[1], args[2]
    f64 = torch.float64
    xq, wq, b64 = x.to(w.dtype).to(f64), w.to(f64), b.to(f64)
    z = xq @ wq + b64
    terms = xq.abs() @ wq.abs() + b64.abs()
    ref = torch.tanh(z)
    del z
    bound = (2.0 ** -7 * ref.abs() + (1.0 - ref * ref) * F32_UNIT * terms
             + 4 * F32_UNIT * ref.abs() + 1e-6)
    del terms
    worst = float(((th.to(f64) - ref).abs() / bound).max())
    plain = float(((ref_th.to(f64) - ref).abs() / bound).max())
    old_rule = int(((th.float() - ref_th.float()).abs()
                    > 2.0 ** -7 * ref_th.float().abs() + 1e-6).sum())
    return worst <= 1.0, worst, plain, old_rule


def th_line(worst):
    """What held_in_training's K5 found of its tanh stash."""
    k5, plain, old = worst.get("moe_fwd_stash_th", (0.0, 0.0, 0))
    return ("th against the float64 replay: worst |diff|/bound %.3f (the "
            "plain f32 version's %.3f; elements past one bf16 step of the "
            "plain version, the old rule: %d)" % (k5, plain, old))


def dgates_line(worst):
    """What held_in_training's K2 found of its dgates."""
    k2, plain, old = worst.get("lstm_bwd_dgates", (0.0, 0.0, 0))
    return ("dgates against the float64 replay of each step: worst "
            "|diff|/bound %.3f (the plain f32 replay's %.3f; elements past "
            "one bf16 step of the plain replay, the old rule: %d)"
            % (k2, plain, old))


@contextlib.contextmanager
def held_in_training(torch, pkg, worst):
    cells, lstm_kernels, ctc_kernels, moe_kernels = (
        pkg["cells"], pkg["lstm_kernels"], pkg["ctc_kernels"],
        pkg["moe_kernels"])
    k2, k10, k11 = (lstm_kernels.lstm_layer_backward, ctc_kernels.ctc_alpha,
                    ctc_kernels.ctc_beta)
    k5, k6 = moe_kernels.moe_mix_forward_stash, moe_kernels.moe_mix_backward

    def backward(*args, store_dtype=None, steps=False):
        if args[3].dtype != torch.bfloat16 or store_dtype != torch.bfloat16:
            fail("K2 launched in %s with store %s, expected bfloat16"
                 % (args[3].dtype, store_dtype))
        out = k2(*args, store_dtype=store_dtype, steps=True)
        dgates, dc_in, dh_in = out[0], out[4], out[5]
        dg, dc_out, dh_out = cells.replay_backward_steps(
            *args[:-2], dc_in, dh_in, store_dtype=store_dtype)
        rel = max(ratio(dc_out[1:], dc_in[:-1]), ratio(dh_out[1:], dh_in[:-1]))
        rounding, k2_f64, plain_f64, old_rule = dgates_held(
            torch, cells, args, dgates, dc_in, dh_in, dg)
        worst["lstm_bwd"] = max(worst["lstm_bwd"], rel)
        notes = worst.setdefault("lstm_bwd_dgates", [0.0, 0.0, 0])
        notes[0], notes[1] = max(notes[0], k2_f64), max(notes[1], plain_f64)
        notes[2] += old_rule
        if rel > BF16_STEP_REL_TOL or not rounding:
            fail("K2 on the main path: a step's carries differ by %.3e "
                 "(bound %.0e); dgates against the float64 replay: worst "
                 "|diff|/bound %.3f (the plain replay's %.3f)"
                 % (rel, BF16_STEP_REL_TOL, k2_f64, plain_f64))
        return out[:4] if not steps else out

    def held_dp(name, kernel, plain):
        def run(*args):
            got = kernel(*args)
            _, rel, same = dp_errors(got, plain(*args), ctc_kernels.NEG_INF)
            worst[name] = max(worst[name], rel)
            if rel > CTC_TOL or not same:
                fail("%s on the main path: rel %.3e, NEG_INF places "
                     "identical: %s" % (name, rel, same))
            return got
        run.held = name
        return run

    def stash(*args):
        # (x, w, b, gate, seed, E, tau, keep_prob)
        if args[1].dtype != torch.bfloat16:
            fail("K5 launched in %s, expected bfloat16" % args[1].dtype)
        out, th = k5(*args)
        ref_out, ref_th = moe_kernels.moe_stash_reference(*args)
        err = errors(out, ref_out)[0]
        worst["moe_fwd_stash"] = max(worst["moe_fwd_stash"], err)
        th_ok, k5_f64, plain_f64, old_rule = th_held(torch, args, th, ref_th)
        notes = worst.setdefault("moe_fwd_stash_th", [0.0, 0.0, 0])
        notes[0], notes[1] = max(notes[0], k5_f64), max(notes[1], plain_f64)
        notes[2] += old_rule
        if err > BF16_ABS_TOL or not th_ok:
            fail("K5 on the main path: out max_abs %.3e (bound %.0e), th "
                 "against the float64 replay: worst |diff|/bound %.3f (the "
                 "plain version's %.3f)" % (err, BF16_ABS_TOL, k5_f64,
                                            plain_f64))
        return out, th

    def mix_backward(*args):
        dx, dgate, dz = k6(*args)
        ref_dx, ref_dgate, ref_dz = moe_kernels.moe_backward_reference(*args)
        rel = max(ratio(dx, ref_dx), ratio(dgate, ref_dgate))
        worst["moe_bwd"] = max(worst["moe_bwd"], rel)
        if rel > BF16_MOE_REL_TOL or not within_bf16_step(dz, ref_dz):
            fail("K6 on the main path: dx/dgate max rel %.3e (bound %.0e), "
                 "dz within one bf16 rounding step: %s"
                 % (rel, BF16_MOE_REL_TOL, within_bf16_step(dz, ref_dz)))
        return dx, dgate, dz

    stand_ins = ((lstm_kernels, "lstm_layer_backward", backward),
                 (ctc_kernels, "ctc_alpha",
                  held_dp("ctc_alpha", k10, ctc_kernels.alpha_reference)),
                 (ctc_kernels, "ctc_beta",
                  held_dp("ctc_beta", k11, ctc_kernels.beta_reference)),
                 (moe_kernels, "moe_mix_forward_stash", stash),
                 (moe_kernels, "moe_mix_backward", mix_backward))
    # each stand-in is installed where ``worst`` holds its name
    backward.held, stash.held, mix_backward.held = (
        "lstm_bwd", "moe_fwd_stash", "moe_bwd")
    with contextlib.ExitStack() as stack:
        for module, name, fn in stand_ins:
            if fn.held in worst:
                fn.launches = 0
                stack.enter_context(mock.patch.object(module, name, fn))
        yield


def kernel_rows(prof):
    """(device ms, count, name) of each kernel a profile saw, longest
    first."""
    from torch.autograd import DeviceType
    return sorted(((evt.self_device_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and evt.self_device_time_total > 0), reverse=True)


# kernels whose share of a profile's device time is reported: label and a
# pattern of the demangled name (K4 and K5 are one body, K5 with the stash;
# K6 is moe_bwd_wgmma<NI, kEmit, kDb, kTile> with the dz stream and no db
# partials: kEmit and not kDb, as csrc/moe_bwd.cu launches it)
SHARE_KERNELS = (
    ("K1 (lstm_fwd_kernel)", r"lstm_fwd_(streamed_)?kernel"),
    ("K2 (lstm_bwd_kernel)", r"lstm_bwd_(streamed_)?kernel"),
    ("K4 (moe_fwd_wgmma, no stash)", r"moe_fwd_wgmma<[^>]*false>"),
    ("K5 (moe_fwd_wgmma, stash)", r"moe_fwd_wgmma<[^>]*true>"),
    ("K6 (moe_bwd_wgmma, dz)", r"moe_bwd_wgmma<\d+, true, false,"))


def kernel_shares(rows, busy):
    """K1's launches in a profile's kernel rows and its share of the device
    time (either plan), and K2's, K4's, K5's and K6's where they ran."""
    parts = []
    for label, pattern in SHARE_KERNELS:
        hit = [(ms, count) for ms, count, key in rows
               if re.search(pattern, key)]
        if hit or label.startswith("K1"):
            ms = sum(r[0] for r in hit)
            parts.append("%s %.3f ms in %d launches, %.1f%% of it" % (
                label, ms, sum(r[1] for r in hit), 100 * ms / max(busy, 1e-9)))
    return "; ".join(parts)


def profile_step(torch, init_opt, step, params, batch, device, step_ms):
    """torch.profiler over one warm bf16 train step: device time by kernel,
    and the device's busy share of the median unprofiled step."""
    from torch.profiler import ProfilerActivity, profile
    opt_state = init_opt(params)
    gen = torch.Generator(device).manual_seed(2)
    for _ in range(2):                                  # warm
        step(params, opt_state, {}, gen, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, {}, gen, batch)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    busy = sum(r[0] for r in rows)
    say("  profiled train step: device kernels %.1f ms, %.0f%% of the "
        "median step (%.1f ms); %s" % (busy, 100 * busy / step_ms, step_ms,
                                       kernel_shares(rows, busy)))
    for ms, count, key in rows[:16]:
        say("    %9.3f ms  %5d x  %s" % (ms, count, key[:90]))
    # the host's side of the same step: where the device can wait on it
    host = sorted(((evt.self_cpu_time_total / 1e3, evt.count, evt.key)
                   for evt in prof.key_averages()
                   if evt.self_cpu_time_total > 0), reverse=True)
    waits = {evt.key: evt.count for evt in prof.key_averages()
             if evt.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                            "aten::_local_scalar_dense")}
    say("  host: %.1f ms of CPU time in the profiled step; waits on the "
        "device %s; most CPU: %s"
        % (sum(h[0] for h in host), waits, ", ".join(
            "%s %.1f ms (%d x)" % (key[:40], ms, count)
            for ms, count, key in host[:8])))
    return busy


def moe_train_case(torch, pkg, device, rng, targets=72, rows=MOE_TRAIN_ROWS):
    """K5-K9's inputs at the training shape: x [N, 640], the expert
    weights (72 experts over ``targets``), bias, gate, an output cotangent
    and a device seed."""
    n, dim, experts = rows, 640, 72
    gen = torch.Generator().manual_seed(14)
    w = pkg["moe"].init_moe(gen, dim, targets, experts, device)["w_expert"]

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    x = t(0.5 * rng.randn(n, dim))
    b = t(0.1 * rng.randn(experts * targets))
    gate = torch.softmax(t(rng.randn(n, experts)), dim=-1)
    gout = t(rng.randn(n, targets))
    seed = torch.tensor([-123457], dtype=torch.int32, device=device)
    return x, w, b, gate, gout, seed


def bound(nbytes, flops, peak):
    """(least ms, what sets it) for ``nbytes`` moved and ``flops`` done."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_MS, flops / peak
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def held_stats(pairs):
    """{name: (max|diff|/max|plain|, max|diff|, finite)} of (kernel,
    plain) pairs."""
    return {key: (ratio(g, r), errors(g, r)[0],
                  bool(g.float().isfinite().all()))
            for key, (g, r) in pairs.items()}


def check_moe_training(torch, pkg, device, rng, targets=72,
                       rows=MOE_TRAIN_ROWS):
    """K5 and K6 (and, up to 128 targets, K8 and K9) against their plain
    versions at D = 640, 72 experts over ``targets``, ``rows`` rows, K5
    and K6 launched twice (bit-equal); then timed in turns with them (keep
    0.9, as training runs)."""
    mk = pkg["moe_kernels"]
    x, w32, b, gate, gout, seed = moe_train_case(torch, pkg, device, rng,
                                                 targets, rows)
    n, dim = x.shape
    experts, tau = 72, 10.0
    ev = experts * targets
    # the opt-in modes' K7, K8 and K9 take V <= 128 (ops/moe_kernels.py)
    narrow = targets <= mk.MAX_V
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        tag = "%s V=%d N=%d" % (name, targets, n)
        w = w32.to(dtype).contiguous()
        for keep in (1.0, 0.9):
            args = (seed, experts, tau, keep)
            out, th = mk.moe_mix_forward_stash(x, w, b, gate, *args)
            again = mk.moe_mix_forward_stash(x, w, b, gate, *args)
            same = torch.equal(out, again[0]) and torch.equal(th, again[1])
            del again
            # each kernel's plain version freed once held (at V = 1024 in
            # float32 each [N, E·V] tensor is 4.2 GB)
            ref_out, ref_th = mk.moe_stash_reference(x, w, b, gate, *args)
            stats = held_stats({"out": (out, ref_out), "th": (th, ref_th)})
            bf16 = dtype == torch.bfloat16
            steps_ok = [within_bf16_step(th, ref_th)] if bf16 else []
            del ref_out, ref_th
            dx, dgate, dz = mk.moe_mix_backward(th, w, gate, gout, *args)
            again = mk.moe_mix_backward(th, w, gate, gout, *args)
            same = same and all(torch.equal(g, a) for g, a in zip(
                (dx, dgate, dz), again))
            del again
            ref_dx, ref_dgate, ref_dz = mk.moe_backward_reference(
                th, w, gate, gout, *args)
            stats.update(held_stats({"dx": (dx, ref_dx),
                                     "dgate": (dgate, ref_dgate),
                                     "dz": (dz, ref_dz)}))
            steps_ok += [within_bf16_step(dz, ref_dz)] if bf16 else []
            del ref_dx, ref_dgate, ref_dz
            if not same:
                fail("K5 or K6 %s keep=%.1f: two launches differ"
                     % (tag, keep))
            if narrow:
                dx8, dgate8 = mk.moe_mix_backward_noemit(th, w, gate, gout,
                                                         *args)
                dw, db = mk.moe_mix_wgrad(x, th, gate, gout, *args)
                stats.update(held_stats(dict(zip(("dw", "db"), zip(
                    (dw, db), mk.moe_wgrad_reference(x, th, gate, gout,
                                                     *args))))))
            if narrow and dtype == torch.bfloat16:
                # bf16 K9 makes K7's dz bits and db partials, then runs
                # K7's second stage: (dw, db) equal K7's bit for bit
                k7 = mk.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
                if not (torch.equal(dw, k7[2]) and torch.equal(db, k7[3])):
                    fail("K9 bf16 keep=%.1f: dw or db differ from K7's"
                         % keep)
                say("  K9 bfloat16 keep=%.1f: dw and db equal K7's bit for "
                    "bit" % keep)
            torch.cuda.synchronize()
            for key, (_, _, finite) in stats.items():
                if not finite:
                    fail("K5-K9 %s keep=%.1f: non-finite %s"
                         % (tag, keep, key))
            rels = {key: st[0] for key, st in stats.items()}
            abs_err = {key: st[1] for key, st in stats.items()}
            same8 = not narrow or (torch.equal(dx8, dx)
                                   and torch.equal(dgate8, dgate))
            say("  K5/K6%s %s keep=%.1f max|diff|/max|plain|: %s; two "
                "launches bit-equal%s"
                % ("/K9" if narrow else "", tag, keep, ", ".join(
                    "%s %.2e" % kv for kv in rels.items()),
                   "; K8's dx and dgate equal K6's: %s" % same8
                   if narrow else ""))
            if not same8:
                fail("K8 differs from K6 (%s keep=%.1f)" % (tag, keep))
            if dtype == torch.float32:
                if max(rels.values()) > F32_REL_TOL:
                    fail("K5-K9 %s keep=%.1f: relative error %.3e > %.1e"
                         % (tag, keep, max(rels.values()), F32_REL_TOL))
            else:
                grads = [k for k in ("dx", "dgate", "dw", "db") if k in rels]
                grad_rel = max(rels[k] for k in grads)
                say("  K5-K9 %s keep=%.1f: out max_abs %.3e (bound %.0e); "
                    "th, dz within one bf16 rounding step: %s, %s; %s max "
                    "rel %.3e (bound %.0e)"
                    % ((tag, keep, abs_err["out"], BF16_ABS_TOL)
                       + tuple(steps_ok)
                       + (", ".join(grads), grad_rel, BF16_MOE_REL_TOL)))
                if (abs_err["out"] > BF16_ABS_TOL or not all(steps_ok)
                        or grad_rel > BF16_MOE_REL_TOL):
                    fail("K5-K9 %s keep=%.1f outside its bounds"
                         % (tag, keep))
            if keep == 1.0:
                del out, th, dx, dgate, dz
                continue
            # timed in turns with the plain versions, at keep 0.9
            isz = dtype.itemsize
            peak = BF16_FLOPS_PER_MS if dtype == torch.bfloat16 \
                else F32_FLOPS_PER_MS
            flops = 2 * n * dim * ev
            small = n * experts * 4 + n * targets * 4 + dim * ev * isz
            k8_bytes = n * ev * isz + small + n * dim * 4 + n * experts * 4
            cases = (
                ("moe_fwd_stash", mk.moe_mix_forward_stash,
                 mk.moe_stash_reference, (x, w, b, gate) + args,
                 n * dim * 4 + ev * 4 + small + n * ev * isz, "out"),
                ("moe_bwd", mk.moe_mix_backward, mk.moe_backward_reference,
                 (th, w, gate, gout) + args, k8_bytes + n * ev * isz, "dx"),
                ("moe_bwd_noemit", mk.moe_mix_backward_noemit,
                 mk.moe_backward_noemit_reference, (th, w, gate, gout) + args,
                 k8_bytes, "dx"),
                ("moe_wgrad", mk.moe_mix_wgrad, mk.moe_wgrad_reference,
                 (x, th, gate, gout) + args,
                 n * dim * 4 + n * ev * isz + small - dim * ev * isz
                 + dim * ev * 4 + ev * 4, "dw"))
            for kname, kernel, plain, kargs, nbytes, key in cases[
                    :None if narrow else 2]:
                ms, plain_ms = time_in_turns(
                    torch, lambda: kernel(*kargs), lambda: plain(*kargs),
                    rounds=3, kernel_reps=3)
                bound_ms, bound_by = bound(nbytes, flops, peak)
                say("  %-14s %s on %s: kernel %.3f ms  plain %.3f ms  bound "
                    "%.4f ms (%s: %.1f MB, %.1f GFLOP)"
                    % (kname, tag, SMI, ms, plain_ms, bound_ms, bound_by,
                       nbytes / 1e6, flops / 1e9))
                result[(kname, dtype)] = {
                    "max_abs_err": abs_err[key], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}

            def default():
                _, _, dz_ = mk.moe_mix_backward(th, w, gate, gout, *args)
                return mk.product_f32(x.to(dtype).t(), dz_), dz_.float().sum(0)

            def twokernel():
                mk.moe_mix_backward_noemit(th, w, gate, gout, *args)
                return mk.moe_mix_wgrad(x, th, gate, gout, *args)

            if dtype == torch.bfloat16:
                dzb, xb = dz.to(dtype), x.to(dtype)
                wt = w.t()
                for kname, a, bmat in (("moe_fwd_stash", xb, w),
                                       ("moe_bwd", dzb, wt)):
                    result[(kname, dtype)]["cublas_ms"] = median_ms(
                        torch, lambda: torch.mm(a, bmat,
                                                out_dtype=torch.float32),
                        reps=20)
                pack_ms = [median_ms(torch, lambda: pack(w, experts), reps=20)
                           for pack in (mk.fwd_pack, mk.bwd_pack)]
                say("  the products alone (not K5's or K6's function): cuBLAS "
                    "x(bf16) [%d, %d] x W [%d, %d] -> float32 %.3f ms, K5 "
                    "%.3f ms; dz(bf16) x W^T -> float32 %.3f ms, K6 %.3f ms; "
                    "W's packed images (once a train step): fwd_pack %.3f ms, "
                    "bwd_pack %.3f ms"
                    % ((n, dim, dim, ev) + tuple(
                        result[(k, dtype)][f] for k in ("moe_fwd_stash",
                                                        "moe_bwd")
                        for f in ("cublas_ms", "ms")) + tuple(pack_ms)))
                del dzb, xb
            if not narrow:
                continue
            k9 = result[("moe_wgrad", dtype)]
            busy, split, whole = profiled_split(
                torch, lambda: mk.moe_mix_wgrad(x, th, gate, gout, *args),
                K9_KERNELS, (K9_KERNELS[0][0], K9_KERNELS[1][0])
                if dtype == torch.bfloat16 else (K9_KERNELS[4][0],))
            k9["device_split"] = split
            first = (" against its first design's %.3f ms (PERF.md)"
                     % K9_FIRST_MS if dtype == torch.bfloat16 else "")
            say("  K9 %-8s %.3f ms%s, on %s; one profiled call, device %.3f "
                "ms%s: %s"
                % (name, k9["ms"], first, SMI, busy, "" if whole else
                   " (INCOMPLETE: the profiler missed kernels in 3 tries)",
                   ", ".join("%s %.4f" % kv for kv in split.items())))
            two_ms, default_ms = time_in_turns(torch, twokernel, default,
                                               rounds=3, kernel_reps=3)
            dw_default = default()[0]
            say("  %-8s backward: twokernel (K8 + K9) %.3f ms, default (K6 + "
                "torch dw product) %.3f ms; dw twokernel vs default max rel "
                "%.2e" % (name, two_ms, default_ms,
                          ratio(dw, dw_default)))
            result[("twokernel", dtype)] = (two_ms, default_ms)
    return result


# target counts past 128 that the reference's fused kernels take (lcm(V,
# 128) <= 4096), held to the plain versions in phases 4 and 9 at the main
# paths' rows, except where the plain side's [N, E·V] float32 tensors
# (14.5-16.9 GB each at V = 4096) would not fit beside each other
WIDE_TARGETS = (136, 256, 1024, 4096)
WIDE_ROWS = {4096: 1100}


# K9's launches by kernel (csrc/moe_wgrad.cu): bf16 stage 1 makes dz and
# db's partials (csrc/moe_bwd.cu), stage 2 is K7's (csrc/moe_dw.cuh)
K9_KERNELS = (("stage 1 (dz, db partials)", r"moe_dz_db_kernel"),
              ("stage 2 dw product", r"wg_product_kernel"),
              ("x cast", r"cast_rows_bf16"),
              ("sums of partials", r"split_sum|group_sum"),
              ("float32 body", r"moe_wgrad_kernel"))
K9_FIRST_MS = 7.577  # bf16 K9's first design's time, PERF.md section 6


def check_moe_single_kernel(torch, pkg, device, rng):
    """Phase 16: K7 against its plain version at the training shape, fed
    K5's stash, then timed in turns with it (keep 0.9, as training runs;
    phase 9 times the default and twokernel backwards at the same
    shape)."""
    mk = pkg["moe_kernels"]
    x, w32, b, gate, gout, seed = moe_train_case(torch, pkg, device, rng)
    n, dim = x.shape
    experts, tau = 72, 10.0
    ev = experts * 72
    names = ("dx", "dgate", "dw", "db")
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        w = w32.to(dtype).contiguous()
        tol = F32_REL_TOL if dtype == torch.float32 else BF16_MOE_REL_TOL
        for keep in (1.0, 0.9):
            args = (seed, experts, tau, keep)
            _, th = mk.moe_mix_forward_stash(x, w, b, gate, *args)
            kargs = (x, th, w, gate, gout) + args
            got = mk.moe_mix_backward_wgrad(*kargs)
            ref = mk.moe_backward_wgrad_reference(*kargs)
            torch.cuda.synchronize()
            for key, g in zip(names, got):
                if not torch.isfinite(g).all():
                    fail("K7 %s keep=%.1f: non-finite %s" % (name, keep, key))
            rels = {key: ratio(g, r) for key, g, r in zip(names, got, ref)}
            say("  K7 %-8s keep=%.1f max|diff|/max|plain|: %s (bound %.0e)"
                % (name, keep, ", ".join("%s %.2e" % kv
                                         for kv in rels.items()), tol))
            if max(rels.values()) > tol:
                fail("K7 %s keep=%.1f: relative error %.3e > %.0e"
                     % (name, keep, max(rels.values()), tol))
            if keep == 1.0:
                continue
            ms, plain_ms = time_in_turns(
                torch, lambda: mk.moe_mix_backward_wgrad(*kargs),
                lambda: mk.moe_backward_wgrad_reference(*kargs), rounds=3,
                kernel_reps=3)
            nbytes = tensor_bytes(torch, kargs, got)
            peak = BF16_FLOPS_PER_MS if dtype == torch.bfloat16 \
                else F32_FLOPS_PER_MS
            bound_ms, bound_by = bound(nbytes, 2 * 2 * n * dim * ev, peak)
            say("  moe_bwd_wgrad  %-8s kernel %.3f ms  plain %.3f ms  bound "
                "%.4f ms (%s: %.1f MB, %.1f GFLOP)"
                % (name, ms, plain_ms, bound_ms, bound_by, nbytes / 1e6,
                   4 * n * dim * ev / 1e9))
            result[dtype] = {
                "max_abs_err": max(float((g - r).abs().max())
                                   for g, r in zip(got, ref)),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
            result[dtype].update(k7_yardsticks(torch, mk, kargs, got))
            if dtype == torch.bfloat16:
                wargs = (x, th, gate, gout) + args
                k9 = mk.moe_mix_wgrad(*wargs)
                torch.cuda.synchronize()
                if not (torch.equal(k9[0], got[2])
                        and torch.equal(k9[1], got[3])):
                    fail("K9 bf16: dw or db differ from K7's")
                k9_ms, plain9_ms = time_in_turns(
                    torch, lambda: mk.moe_mix_wgrad(*wargs),
                    lambda: mk.moe_wgrad_reference(*wargs), rounds=3,
                    kernel_reps=3)
                say("  K9 bfloat16 on K7's inputs: dw and db equal K7's bit "
                    "for bit; K9 %.3f ms (plain %.3f ms) beside K7 %.3f ms, "
                    "on %s" % (k9_ms, plain9_ms, ms, SMI))
                result[dtype]["k9_ms"] = k9_ms
    return result


# K7's launches by kernel (csrc/moe_bwd_wgrad.cu): stage 1 is K6's body
# with the db epilogue, stage 2 the engine's dw product
K7_KERNELS = (("stage 1 (K6's body, dz, db partials)", r"moe_bwd_wgmma"),
              ("stage 2 dw product", r"wg_product_kernel"),
              ("x cast", r"cast_rows_bf16"),
              ("sums of partials", r"split_sum|group_sum"),
              ("stage 1 (float32 body)", r"moe_bwd_wgrad_kernel"))


def k7_yardsticks(torch, mk, kargs, got):
    """Beside K7: K6 alone on the same inputs (for bf16 K7's dx and dgate
    must equal K6's bit for bit), cuBLAS's bare x(cdt)ᵀ·dz (float32 out),
    and one profiled K7 call split by kernel."""
    x, th, w = kargs[:3]
    args = kargs[5:]
    k6 = mk.moe_mix_backward(th, w, kargs[3], kargs[4], *args)
    k6_ms = median_ms(torch, lambda: mk.moe_mix_backward(
        th, w, kargs[3], kargs[4], *args), reps=6)
    xc = x.to(w.dtype)
    cublas_ms = median_ms(torch, lambda: mk.product_f32(xc.t(), k6[2]),
                          reps=6)
    bf16 = w.dtype == torch.bfloat16
    busy, split, whole = profiled_split(
        torch, lambda: mk.moe_mix_backward_wgrad(*kargs), K7_KERNELS,
        (K7_KERNELS[0][0], K7_KERNELS[1][0]) if bf16 else (K7_KERNELS[4][0],))
    same = bool(torch.equal(got[0], k6[0]) and torch.equal(got[1], k6[1]))
    name = str(w.dtype).split(".")[-1]
    say("  K7 %-8s K6 alone %.3f ms; cuBLAS's bare x(cdt)ᵀ·dz %.4f ms; "
        "dx and dgate equal to K6's bit for bit: %s; one profiled K7 call, "
        "device %.3f ms%s: %s"
        % (name, k6_ms, cublas_ms,
           same if bf16 else "n/a (the float32 body is one kernel of its "
           "own)", busy, "" if whole else " (INCOMPLETE: the profiler missed "
           "kernels in 3 tries)",
           ", ".join("%s %.4f" % kv for kv in split.items())))
    if bf16 and not same:
        fail("K7 bf16: dx or dgate differ from K6's")
    return {"k6_ms": k6_ms, "cublas_ms": cublas_ms, "device_split": split}


def train_moe_end_to_end(torch, pkg, device, work, scp):
    """The treatment model trains through nnet_train_loop; then two steps
    of the twokernel path, and phase 8's step checks on the MoE model."""
    from lstm_ctc_tpu_torch.bin import nnet_train_loop
    from lstm_ctc_tpu_torch.cli import (build_batcher, init_from_config,
                                        make_shard_fn)
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint, tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step, param_leaves
    config = dict(FLAGSHIP_CONFIG)
    config_path = os.path.join(work, "nnet_moe.config")
    with open(config_path, "w") as fh:
        fh.write(format_config(config))
    exp = os.path.join(work, "exp_moe")
    cv_batches = len(build_batcher(scp, config, 32).batch_plan(False, None))
    train_batcher = build_batcher(scp, config, 32, pack_factor=3)
    # the loop's epoch i shuffles with seed i
    steps = sum(len(train_batcher.batch_plan(True, it)) for it in (1, 2))
    cvs = 3 * cv_batches
    want = counts(lstm_fwd=4 * (cvs + steps), lstm_bwd=4 * steps,
                  moe_fwd=cvs, moe_fwd_stash=steps, moe_bwd=steps,
                  ctc_alpha=cvs + steps, ctc_beta=steps)
    argv = ["--tr-tfrecords-scp", scp, "--cv-tfrecords-scp", scp,
            "--nnet-config", config_path, "--dir", exp, "--objective", "ctc",
            "--optimizer", "adam", "--learn-rate", "1e-3", "--max-iter", "2",
            "--batch-size", "32", "--pack-factor", "3", "--shuffle", "true",
            "--cv-goal", "loss", "--report-interval", "0", "--device", "cuda"]
    _, _, got, seconds = run_counted(torch, pkg,
                                     lambda: nnet_train_loop.main(argv))
    expect_counts("nnet_train_loop", got, want)
    result = {"launches": got}
    done = [nnet_train_loop.read_done(os.path.join(exp, "nnet.%d.done" % i))
            for i in range(3)]
    cv = [d["cv_loss"] for d in done]
    tr = [d["tr_loss"] for d in done[1:]]
    with open(os.path.join(exp, "final.nnet")) as fh:
        final = fh.read().strip()
    say("  nnet_train_loop, 2 iterations in %.1f s (3 CV passes of %d "
        "batches, %d train steps): cv_loss %s; tr_loss %s; final model %s; "
        "launches %s" % (seconds, cv_batches, steps,
                         ["%.4f" % v for v in cv], ["%.4f" % v for v in tr],
                         final, got))
    if not all(math.isfinite(v) for v in cv + tr):
        fail("non-finite tr_loss or cv_loss in the MoE training")
    if not cv[-1] < cv[0]:
        fail("MoE training: the last cv_loss %.4f is not below the first "
             "%.4f" % (cv[-1], cv[0]))
    template, state = init_from_config(config, device)
    for i in range(3):
        params, _, _ = load_checkpoint(os.path.join(exp, "nnet.%d" % i),
                                       template, state)
        if not all(torch.isfinite(p).all() for p in param_leaves(params)):
            fail("nnet.%d holds non-finite weights" % i)
    with open(os.path.join(exp, "nnet.2.metrics.jsonl")) as fh:
        result.update(step_stats([json.loads(ln) for ln in fh],
                                 train_batcher))
    result["cv"] = cv
    say("  iteration 2: median MoE train step %.1f ms; %.1f real frames/s; "
        "packing fill %.3f" % (result["step_ms"], result["fps"],
                               result["fill"]))

    # the opt-in twokernel weight gradient: two steps of its own, counted
    base, _, _ = load_checkpoint(os.path.join(exp, "nnet.2"), template,
                                 state)
    shard = make_shard_fn(device)
    batches = [shard(b) for b in itertools.islice(
        iterate_batches(train_batcher, shuffle=True, seed=2), 2)]
    train_config = dict(config, packed_slots_rank_major=True)

    def run_steps(mode, some):
        init_opt, step = make_train_step(
            dict(train_config, moe_wgrad_mode=mode), 1e-3, "adam")
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          base)
        opt_state = init_opt(params)
        gen = torch.Generator(device).manual_seed(5)
        for batch in some:
            step(params, opt_state, {}, gen, batch)

    _, _, got2, _ = run_counted(torch, pkg,
                                lambda: run_steps("twokernel", batches))
    expect_counts("twokernel steps", got2, counts(
        lstm_fwd=8, lstm_bwd=8, moe_fwd_stash=2, moe_bwd_noemit=2,
        moe_wgrad=2, ctc_alpha=2, ctc_beta=2))
    for k in KERNEL_NAMES:
        result["launches"][k] += got2[k]
    two_ms, xla_ms = time_in_turns(
        torch, lambda: run_steps("twokernel", batches[:1]),
        lambda: run_steps("xla", batches[:1]), rounds=2, kernel_reps=1)
    say("  MoE train step on the device clock: twokernel %.1f ms, default "
        "%.1f ms; twokernel launches %s" % (two_ms, xla_ms, got2))
    result["twokernel_step_ms"], result["xla_step_ms"] = two_ms, xla_ms

    check_steps(torch, pkg, device, config, os.path.join(exp, "nnet.2"),
                train_batcher, result["step_ms"])
    return result


# --- phases 15-17: the opt-in folds, K3 and K7 ---

# the A/B's variants (each profiled in this process), and the two the
# A/B tool runs (python -m lstm_ctc_tpu_torch.scripts.ab_train_step, a
# subprocess a variant, most of its time a process reaching the card)
AB_VARIANTS = ("default=", "fold=lstm_fold_dx=true",
               "k7=moe_wgrad_mode=kernel", "twokernel=moe_wgrad_mode=twokernel")
AB_TOOL_VARIANTS = AB_VARIANTS[:2]
AB_STEPS = 30


def fold_subset(work, scp, config, steps=2, name="folds.scp",
                pack_factor=3):
    """An scp ``name`` of the first utterances of ``scp`` that nnet_train
    packs (``pack_factor``, batch 32, its shuffle seed 777) into ``steps``
    steps; returns (its path, its batcher)."""
    from lstm_ctc_tpu_torch.cli import build_batcher
    from lstm_ctc_tpu_torch.host.data import scan_scp
    metas = scan_scp(scp)
    path = os.path.join(work, name)
    for count in range(32, len(metas) + 1, 4):
        with open(path, "w") as fh:
            for meta in metas[:count]:
                fh.write(meta.scp_line())
        batcher = build_batcher(path, config, 32, pack_factor=pack_factor)
        if len(batcher.batch_plan(True, 777)) >= steps:
            return path, batcher
    fail("the corpus is too small for %d packed train steps" % steps)


def train_folds_end_to_end(torch, pkg, device, work, scp):
    """Phase 17: the flagship MoE model trains two steps with both folds
    through nnet_train (launch counts, finite loss and weights); a float32
    step with both folds against the step without them; a profiled bf16
    step of each A/B variant; and the A/B tool."""
    from lstm_ctc_tpu_torch.bin import nnet_train
    from lstm_ctc_tpu_torch.cli import (build_batcher, init_from_config,
                                        make_shard_fn)
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.scripts import ab_train_step as ab
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint, tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step, param_leaves
    config = dict(FLAGSHIP_CONFIG, lstm_fold_dx=True, moe_wgrad_mode="kernel")
    config_path = os.path.join(work, "nnet_folds.config")
    with open(config_path, "w") as fh:
        fh.write(format_config(config))
    sub_scp, batcher = fold_subset(work, scp, config)
    steps = len(batcher.batch_plan(True, 777))
    nnet_out = os.path.join(work, "nnet_folds.npz")
    _, tee, got, seconds = run_counted(torch, pkg, lambda: nnet_train.main(
        [sub_scp, config_path, os.path.join(work, "exp_moe", "nnet.2"),
         nnet_out, "--optimizer", "adam", "--learn-rate", "1e-3",
         "--pack-factor", "3", "--objective", "ctc", "--batch-size", "32",
         "--device", "cuda", "--report-interval", "0"]))
    expect_counts("nnet_train with both folds", got, counts(
        lstm_fwd=4 * steps, lstm_bwd=steps, lstm_bwd_fold=3 * steps,
        moe_fwd_stash=steps, moe_bwd_wgrad=steps, ctc_alpha=steps,
        ctc_beta=steps))
    tr_loss = tee.value("tr_loss")
    template, state = init_from_config(config, device)
    base, _, _ = load_checkpoint(nnet_out, template, state)
    if not math.isfinite(tr_loss) or not all(
            torch.isfinite(p).all() for p in param_leaves(base)):
        fail("the train steps with both folds gave a non-finite loss or "
             "weights")
    say("  nnet_train, lstm_fold_dx = true and moe_wgrad_mode = kernel: %d "
        "steps (%d utterances, pack factor 3) in %.1f s; tr_loss %.4f; "
        "launches %s" % (steps, len(batcher._lengths), seconds, tr_loss, got))

    # float32: the step with both folds (each K3 and K7 launch held to its
    # plain version) against the same step with both folds off; in float32
    # the folds change only the order of sums
    batch = make_shard_fn(device)(next(iter(iterate_batches(
        build_batcher(scp, config, 32, pack_factor=3), shuffle=True,
        seed=777))))
    f32 = dict(config, packed_slots_rank_major=True, compute_dtype="float32",
               store_dtype="float32", dropout_rate=1.0)
    off = dict(f32, lstm_fold_dx=False, moe_wgrad_mode="xla")
    worst = {k: 0.0 for k in ("lstm_fwd", "lstm_bwd", "lstm_bwd_fold",
                              "moe_fwd_stash", "moe_bwd_wgrad")}
    with held_f32(torch, pkg, worst):
        folded = step_grads(torch, base, batch, f32)
    say("  float32 step with both folds, each launch vs its plain version on "
        "the same tensors, max rel: %s (bound %.0e)"
        % (", ".join("%s %.3e" % kv for kv in worst.items()), F32_REL_TOL))
    if max(worst.values()) > F32_REL_TOL:
        fail("a float32 K3 or K7 launch differs from its plain version")
    loss_rel, grad_rel = hold_to_nudge(
        base, "both folds", folded, "folds off",
        step_grads(torch, base, batch, off),
        step_grads(torch, base, batch, off,
                   torch.Generator(device).manual_seed(3)))
    result = {"launches": got, "steps": steps, "tr_loss": tr_loss,
              "loss_rel": loss_rel, "grad_rel": grad_rel, "device_ms": {}}

    # one profiled bf16 step of each A/B variant, on the A/B's batch, in
    # this process: the profiler's first use in a process is slow, and each
    # of the A/B tool's subprocesses would pay it again
    ab_batch = make_shard_fn(device)(ab.example_batch(ab.FLAGSHIP_CONFIG, 32,
                                                      384))
    for spec in AB_VARIANTS:
        name, overrides = ab.parse_variant(spec)
        cfg = dict(ab.FLAGSHIP_CONFIG, dropout_rate=1.0, **overrides)
        params, net_state = init_from_config(cfg, device)
        params = tree_map(lambda t: t.requires_grad_(), params)
        init_opt, step = make_train_step(cfg, 1e-3, "adam")
        opt_state = init_opt(params)
        gen = torch.Generator(device).manual_seed(1)
        busy, rows = device_ms(torch, lambda: step(params, opt_state,
                                                   net_state, gen, ab_batch))
        result["device_ms"][name] = busy
        say("  profiled bf16 train step (B=32, T=384, keep 1.0), %s: device "
            "kernels %.3f ms; longest: %s"
            % (name, busy, "; ".join("%.3f ms %d x %s" % (ms, n, key[:50])
                                     for ms, n, key in rows[:5])))

    # the A/B tool, one subprocess a variant
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "lstm_ctc_tpu_torch.scripts.ab_train_step"]
    cmd += list(AB_TOOL_VARIANTS) + ["--batch", "32", "--time-steps", "384",
                                "--steps", str(AB_STEPS), "--repeats", "1",
                                "--device", "cuda", "--timeout", "300"]
    start = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, cwd=here,
                         timeout=1000)
    lines = [json.loads(ln) for ln in run.stdout.splitlines()
             if ln.startswith("{")]
    if run.returncode != 0 or not lines or any("error" in ln
                                               for ln in lines):
        fail("the A/B tool failed (%d): %s %s"
             % (run.returncode, run.stdout[-1500:], run.stderr[-1500:]))
    summary = lines[-1]["summary"]
    names = [ab.parse_variant(spec)[0] for spec in AB_TOOL_VARIANTS]
    if sorted(summary) != sorted(names):
        fail("the A/B tool reported %s, expected %s" % (sorted(summary),
                                                          names))
    result["ab"] = summary
    say("  A/B tool (%d steps a variant, %.1f s): %s"
        % (AB_STEPS, time.perf_counter() - start, "; ".join(
            "%s %.1f frames/s (%.1f ms a step)%s"
            % (n, summary[n]["best"], 32 * 384 / summary[n]["best"] * 1e3,
               "" if n == names[0] else ", %+.2f%% vs %s"
               % (summary[n]["vs_" + names[0]], names[0])) for n in names)))
    return result


# --- phases 11-14: the unidirectional families through K12 and K13 ---

# bench.py:494-513's family rows on the flagship front end
LSTM_CONFIG = dict(FLAGSHIP_CONFIG, nnet_type="lstm", num_experts=0)
CUDNN_CONFIG = dict(LSTM_CONFIG, nnet_type="cudnnlstm", num_projects=0,
                    use_peepholes=False)
LSTM_BN_CONFIG = dict(LSTM_CONFIG, use_bn=True)
STACK_LAYERS = 4
CHUNK_ROWS = 16
FRAME_SHIFT_S = 0.01  # one raw fbank frame


def stack_case(torch, pkg, device, dtype, family, rng, keep=1.0,
               affine=False, init=False, full=False, shape=None, batch=32,
               steps=384):
    """K12's arguments at a family's full width (4 layers of 320 cells;
    ``lstm``: projection 320, peepholes, layers 1-3 residual; ``cudnnlstm``:
    neither; ``shape``: (H, P or None) instead), B=32, T=384, a 120-wide
    input, built as lstm_stack_fused builds them; ragged lengths unless
    ``full``."""
    cells, sk = pkg["cells"], pkg["lstm_stack_kernels"]
    dim, layers = 120, STACK_LAYERS
    units, proj = shape or (320, 320 if family == "lstm" else None)
    gen = torch.Generator().manual_seed(15)
    params, d = [], dim
    for _ in range(layers):
        params.append(cells.init_lstm_cell(gen, d, units, proj,
                                           proj is not None, device))
        d = proj or units

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    for p in params:
        p["bias"] = t(0.1 * rng.randn(4 * units))
    x = t(rng.randn(batch, steps, dim))
    lengths = np.full(batch, steps) if full else \
        rng.randint(steps // 2, steps + 1, batch)
    lengths[0] = steps
    seq = torch.from_numpy(lengths.astype(np.int32)).to(device)
    wz, bias, proj_w, peep = sk.stack_weights(params, dtype)
    gx = torch.matmul(x.to(dtype), params[0]["wx"].to(dtype)).float() \
        + params[0]["bias"]
    gx0 = torch.nn.functional.pad(gx.transpose(0, 1),
                                  (0, 0, 0, 0, 0, layers - 1)).contiguous()
    out_dim, lb = proj or units, layers * batch
    scale = 0.1 if init else 0.0
    case = dict(gx0=gx0, mask=sk.stack_mask(seq, steps, layers, device),
                wz=wz, bias=bias, proj=proj_w, peep=peep,
                cinit=t(scale * rng.randn(lb, units)),
                hinit=t(scale * rng.randn(lb, out_dim)),
                residual=(False,) + (family == "lstm",) * (layers - 1),
                forget_bias=1.0, keep_prob=keep,
                seed=torch.tensor([-1234567], dtype=torch.int32,
                                  device=device),
                affine=(t(0.5 + rng.rand(layers, out_dim)),
                        t(0.2 * rng.randn(layers, out_dim))) if affine
                else None)
    return case, params, x, seq


def tensor_bytes(torch, *objs):
    """Bytes of every tensor in ``objs`` (nested in tuples, lists, dicts)."""
    total = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            total += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            total += tensor_bytes(torch, *obj.values())
        elif isinstance(obj, (tuple, list)):
            total += tensor_bytes(torch, *obj)
    return total


def stack_bound(torch, args, outputs, dtype, backward=False):
    """(least ms, what sets it) of K12 (or K13) called with ``args`` and
    returning ``outputs``: each input read and each output written once;
    the products this run's data needs, at the compute dtype's peak.  Only
    the live rows count (the mask's: T steps a layer, cut by each length).
    A layer's gate product is [in, h]·wz, 2P x 4H; layer 0's is h·wh alone,
    P x 4H, since its input product gx0 is done outside (its wz slab is
    zero).  The projection is H x P.  K13 recomputes the gate products and
    adds their two transposes (dz = dgates·wzᵀ, dwz = zᵀ·dgates) and the
    projection's two (dout_blk = dout_p·projᵀ, dproj = out_blkᵀ·dout_p)."""
    wz, proj = args["wz"], args["proj"]
    layers, p2, h4 = wz.shape
    out_dim, units = p2 // 2, h4 // 4
    live = args["mask"].view(args["mask"].shape[0], layers, -1).sum(
        dim=(0, 2)).tolist()
    gate0, gate = 2 * out_dim * h4, 2 * p2 * h4
    projection = 0 if proj is None else 2 * units * out_dim
    if backward:
        gate0, gate, projection = 3 * gate0, 3 * gate, 2 * projection
    flops = live[0] * (gate0 + projection) + sum(live[1:]) * (gate
                                                             + projection)
    nbytes = tensor_bytes(torch, args, outputs)
    peak = BF16_FLOPS_PER_MS if dtype == torch.bfloat16 else F32_FLOPS_PER_MS
    return bound(nbytes, flops, peak)


def stack_how(sk, device, case, backward=False, store_dtype=None):
    """K12's (K13's) launch plan for ``case``, as its launcher chooses it."""
    steps, batch, h4 = case["gx0"].shape
    layers, p2, _ = case["wz"].shape
    return sk.stack_config(device, steps, layers, batch, h4 // 4, p2 // 2,
                           case["proj"] is not None, case["wz"].dtype,
                           backward, store_dtype or case["wz"].dtype)


def stack_launch(sk, device, case, ms, backward=False, store_dtype=None):
    """How K12 (K13) launched on ``case``: blocks a cluster, R rows a
    cluster, the clusters, the waves, those resident at once, the lag K,
    the shared memory a block, and the us per wavefront step (``ms`` over
    the waves' S steps each)."""
    steps, batch, h4 = case["gx0"].shape
    layers = case["wz"].shape[0]
    how = stack_how(sk, device, case, backward, store_dtype)
    return ("%d blocks a cluster, R=%d rows a cluster, %d clusters in %d "
            "wave(s) of up to %d (%d resident at once), lag K=%d, %d bytes "
            "of shared memory a block, %.2f us per wavefront step" % (
                how["blocks"], how["rows"], layers * how["tiles"],
                how["waves"], layers * how["per_wave"], how["resident"],
                how["lag"], how["smem_bytes"],
                1e3 * ms / (steps * how["waves"])))


def check_stack_fwd(torch, pkg, device, rng):
    """Phase 11: K12 against its plain version at both families' widths."""
    sk = pkg["lstm_stack_kernels"]
    result = {}
    for family in ("lstm", "cudnnlstm"):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            worst_abs = 0.0
            for keep, affine, init in ((1.0, False, False),
                                       (0.9, False, True),
                                       (1.0, True, True)):
                case, _, _, _ = stack_case(torch, pkg, device, dtype, family,
                                           rng, keep, affine, init)
                got = sk.lstm_stack_forward(**case, states=True)
                if dtype == torch.float32:
                    out, chain, c_all, h_all, cfin, hfin = \
                        sk.stack_forward_reference(**case)
                    ref = (out, cfin, hfin, chain, c_all, h_all)
                    names = ("out", "cfin", "hfin", "chain", "c_all",
                             "h_all")
                    tol = F32_REL_TOL
                else:
                    # each step from the kernel's own states of the step
                    # before (bf16 rounding flips carry on, as for K1)
                    ref = sk.stack_replay_steps(
                        **case, chain=got[3], c_all=got[4], h_all=got[5])
                    got, names, tol = got[3:], ("chain", "c_all", "h_all"), \
                        BF16_STEP_REL_TOL
                torch.cuda.synchronize()
                for n, g in zip(names, got):
                    if not torch.isfinite(g).all():
                        fail("K12 %s %s: non-finite %s" % (family, name, n))
                rels = {n: ratio(g, r) for n, g, r in zip(names, got, ref)}
                worst_abs = max(worst_abs, max(errors(g, r)[0]
                                               for g, r in zip(got, ref)))
                dropped = keep == 1.0 or dropped_as_plain(
                    sk, case, got[names.index("chain")],
                    ref[names.index("chain")])
                say("  K12 %-9s %-8s keep=%.1f affine=%-5s init=%-5s max rel "
                    "%s; dropped positions as the plain mask's: %s"
                    % (family, name, keep, affine, init,
                       ", ".join("%s %.2e" % kv for kv in rels.items()),
                       dropped))
                if max(rels.values()) > tol or not dropped:
                    fail("K12 %s %s keep=%.1f affine=%s: outside its bounds "
                         "(ratio bound %.0e)" % (family, name, keep, affine,
                                                 tol))
            # timed in turns with the plain version: the serving case
            case, _, _, _ = stack_case(torch, pkg, device, dtype, family, rng)
            ms, plain_ms = time_in_turns(
                torch, lambda: sk.lstm_stack_forward(**case),
                lambda: sk.stack_forward_reference(**case), rounds=3,
                kernel_reps=3)
            bound_ms, bound_by = stack_bound(
                torch, case, sk.lstm_stack_forward(**case), dtype)
            steps = case["gx0"].shape[0]
            if stack_how(sk, device, case)["blocks"] != 8:
                fail("K12 at the %s width left its 8-block plan" % family)
            say("  K12 %-9s %-8s kernel %.3f ms (%.1f us per layer-step; "
                "%s)  plain %.3f ms  bound %.4f ms (%s)"
                % (family, name, ms, 1e3 * ms / (steps * STACK_LAYERS),
                   stack_launch(sk, device, case, ms), plain_ms, bound_ms,
                   bound_by))
            result[(family, dtype)] = {
                "max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by}
    return result


def cudnn_lstm(torch, params, device):
    """torch.nn.LSTM (cuDNN) carrying a cudnnlstm stack's weights: TF's
    gate order (i, j, f, o) mapped to torch's (i, f, g, o), the forget bias
    folded into bias_ih."""
    units = params[0]["bias"].shape[0] // 4
    lstm = torch.nn.LSTM(params[0]["wx"].shape[0], units,
                         num_layers=len(params)).to(device)

    def order(w):
        i, j, f, o = w.split(units, dim=-1)
        return torch.cat([i, f, j, o], dim=-1)

    forget = torch.zeros(4 * units, device=device)
    forget[units:2 * units] = 1.0
    with torch.no_grad():
        for k, p in enumerate(params):
            getattr(lstm, "weight_ih_l%d" % k).copy_(order(p["wx"]).t())
            getattr(lstm, "weight_hh_l%d" % k).copy_(order(p["wh"]).t())
            getattr(lstm, "bias_ih_l%d" % k).copy_(order(p["bias"]) + forget)
            getattr(lstm, "bias_hh_l%d" % k).zero_()
    lstm.flatten_parameters()
    return lstm


def flatten_cudnn(torch, lstm):
    """Lay an nn.LSTM's weights out in one cuDNN buffer.  flatten_parameters()
    leaves bf16 weights where they are (torch.backends.cudnn.is_acceptable
    takes only f16, f32 and f64), and cuDNN then copies them into one buffer
    at every call; fail unless they share one storage after."""
    from torch.backends.cudnn import rnn
    with torch.no_grad():
        torch._cudnn_rnn_flatten_weight(
            lstm._flat_weights, 4, lstm.input_size,
            rnn.get_cudnn_mode(lstm.mode), lstm.hidden_size, lstm.proj_size,
            lstm.num_layers, lstm.batch_first, lstm.bidirectional)
    if len({w.untyped_storage().data_ptr() for w in lstm._flat_weights}) != 1:
        fail("cuDNN's LSTM weights are not in one buffer")


def device_ms(torch, fn):
    """torch.profiler over one warm call of ``fn``: the device time of its
    kernels, and (ms, count, name) of each, longest first.  The profiled
    region starts with 64 short spin kernels, left out of the rows: late in
    a long run the profiler lost the records of a region's first kernels
    (phase 16 saw none of K7's seven, phase 15 not K2's within K3)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    rows = [r for r in kernel_rows(prof) if "spin_kernel" not in r[2]]
    return sum(r[0] for r in rows), rows


def profiled_split(torch, fn, groups, need, tries=3):
    """(device ms, kernel_split) of one profiled call of ``fn``, taken again
    (up to ``tries`` times) while a group of ``need`` saw no kernel; the
    split of the last try, and whether it is complete."""
    for _ in range(tries):
        busy, rows = device_ms(torch, fn)
        split = kernel_split(rows, groups)
        if all(split[label] > 0 for label in need):
            return busy, split, True
    return busy, split, False


def kernel_split(rows, groups):
    """Device ms of a profile's kernel rows by group: ``groups`` is (label,
    pattern of the demangled name) in order, the first match wins; the
    rest is "other"."""
    split = {label: 0.0 for label, _ in groups}
    split["other"] = 0.0
    for ms, _, key in rows:
        label = next((lb for lb, pattern in groups
                      if re.search(pattern, key)), "other")
        split[label] += ms
    return split


def cudnn_yardstick(torch, pkg, device, rng, shape=None, with_stack=False):
    """The library yardstick at the cudnnlstm width (``shape``: (H, None)
    instead of 320; full lengths): cuDNN's LSTM gives K12's outputs in
    float32 (TF32 off); then cuDNN's forward, and its forward plus
    backward, timed in bf16 beside K12 and K13, with its weights in one
    buffer (no copy at a call), and each call's device time from the
    profiler beside its time on the CUDA events.  With ``with_stack``, K12
    and K13 as a training step calls them (K12 storing its states in bf16,
    then K13 on them) timed in turns with cuDNN's forward + backward, on
    the events and on the device kernels: cuDNN's events carry host work
    of its own, so the kernels are compared with it on the device."""
    sk = pkg["lstm_stack_kernels"]
    width = "H=P=%d" % (shape or (320,))[0]
    case, params, x, _ = stack_case(torch, pkg, device, torch.float32,
                                    "cudnnlstm", rng, full=True, shape=shape)
    lstm = cudnn_lstm(torch, params, device)
    steps = x.shape[1]
    with torch.no_grad():
        want = lstm(x.transpose(0, 1))[0]
        got = sk.lstm_stack_forward(**case)[0][STACK_LAYERS - 1:
                                               STACK_LAYERS - 1 + steps]
    rel = ratio(got, want)
    say("  cuDNN LSTM vs K12, float32, cudnnlstm %s: max rel %.3e (bound "
        "%.0e)" % (width, rel, F32_REL_TOL))
    if rel > F32_REL_TOL:
        fail("cuDNN's LSTM and K12 disagree: the weights are not mapped")
    case16, _, _, _ = stack_case(torch, pkg, device, torch.bfloat16,
                                 "cudnnlstm", rng, full=True, shape=shape)
    lstm16 = lstm.to(torch.bfloat16)
    flatten_cudnn(torch, lstm16)
    x16 = x.transpose(0, 1).to(torch.bfloat16).contiguous()

    def forward():
        with torch.no_grad():
            lstm16(x16)

    def both():
        xg = x16.detach().requires_grad_()
        y = lstm16(xg)[0]
        y.backward(torch.ones_like(y))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lib_fwd, k12_ms = time_in_turns(
            torch, forward, lambda: sk.lstm_stack_forward(**case16),
            rounds=3, kernel_reps=3)
        lib_both, _ = time_in_turns(torch, both, forward, rounds=3,
                                    kernel_reps=2)
        fwd_dev, fwd_rows = device_ms(torch, forward)
        both_dev, both_rows = device_ms(torch, both)
        result = {"forward": lib_fwd, "both": lib_both,
                  "forward_device": fwd_dev, "both_device": both_dev}
        if with_stack:
            result.update(stack_beside_cudnn(torch, sk, case16, both))
    compacted = [w for w in caught if "contiguous chunk" in str(w.message)]
    if compacted:
        fail("cuDNN copied its weights at a call: %s" % compacted[0].message)
    say("  cuDNN bf16, cudnnlstm %s, full lengths, weights in one buffer "
        "(no compaction warning): forward %.3f ms on the events, %.3f ms of "
        "device kernels (K12, one launch, %.3f ms); forward + backward %.3f "
        "ms, %.3f ms of device kernels"
        % (width, lib_fwd, fwd_dev, k12_ms, lib_both, both_dev))
    if with_stack:
        say("  K12 + K13 bf16, cudnnlstm %s (K12 with its states in bf16, "
            "then K13 on them; K13's gate-input and weight-gradient "
            "products included): %.3f ms on the events, %.3f ms of device "
            "kernels, beside cuDNN's forward + backward in the same turns "
            "%.3f ms on the events, %.3f ms of device kernels: %.2fx on the "
            "device kernels, which the kernel table compares (cuDNN's "
            "events carry %.3f ms of host work beyond its kernels), %.2fx "
            "on the events"
            % (width, result["stack_ms"], result["stack_device"],
               result["cudnn_ms"], both_dev,
               result["stack_device"] / both_dev,
               result["cudnn_ms"] - both_dev,
               result["stack_ms"] / result["cudnn_ms"]))
    for tag, rows in (("forward", fwd_rows), ("forward + backward",
                                              both_rows)):
        say("    cuDNN %s kernels: %s" % (tag, "; ".join(
            "%.3f ms %d x %s" % (ms, count, key[:60])
            for ms, count, key in rows[:5])))
    return result


def stack_beside_cudnn(torch, sk, case, cudnn_both):
    """K12 and K13 on ``case`` (bf16) as a training step calls them, timed
    in turns with ``cudnn_both`` (cuDNN's forward + backward; median of
    3), and the device time of one call of each from the profiler."""
    bf16 = torch.bfloat16
    args = {k: v for k, v in case.items() if k != "affine"}
    out = sk.lstm_stack_forward(**args)[0]
    dout = torch.ones_like(out)

    def stack():
        out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
            **args, states=True, store_dtype=bf16)
        sk.lstm_stack_backward(**args, chain=chain, c_all=c_all, h_all=h_all,
                               dout=dout, dcfin=torch.zeros_like(cfin),
                               dhfin=torch.zeros_like(hfin),
                               store_dtype=bf16)

    stack_ms, cudnn_ms = time_in_turns(torch, stack, cudnn_both, rounds=3,
                                       kernel_reps=1)
    return {"stack_ms": stack_ms, "cudnn_ms": cudnn_ms,
            "stack_device": device_ms(torch, stack)[0]}


def check_stack_bwd(torch, pkg, device, rng):
    """Phase 12: K13 against its plain version, under phase 7's rules."""
    sk = pkg["lstm_stack_kernels"]
    names = ("dgates", "dwz", "dbias", "dproj", "dpeep", "dcinit", "dhinit")
    result = {}
    for family in ("lstm", "cudnnlstm"):
        keep = 0.9 if family == "lstm" else 1.0
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            case, _, _, _ = stack_case(torch, pkg, device, dtype, family, rng,
                                       keep)
            case.pop("affine")
            out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
                **case, states=True, store_dtype=dtype)
            dout = torch.from_numpy((0.1 * rng.randn(*out.shape)).astype(
                np.float32)).to(device)
            args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                        dout=dout, dcfin=torch.zeros_like(cfin),
                        dhfin=torch.zeros_like(hfin), store_dtype=dtype)
            got = sk.lstm_stack_backward(**args)
            ref = sk.stack_backward_reference(**args)
            torch.cuda.synchronize()
            rels = {}
            for n, g, r in zip(names, got, ref):
                if g is None:
                    continue
                if not torch.isfinite(g.float()).all():
                    fail("K13 %s %s: non-finite %s" % (family, name, n))
                rels[n] = ratio(g, r)
            say("  K13 %-9s %-8s keep=%.1f max|diff|/max|plain|: %s"
                % (family, name, keep, ", ".join("%s %.2e" % kv
                                                 for kv in rels.items())))
            if dtype == torch.float32 and max(rels.values()) > F32_REL_TOL:
                fail("K13 %s f32: relative error %.3e > %.1e"
                     % (family, max(rels.values()), F32_REL_TOL))
            if dtype == torch.bfloat16:
                full = sk.lstm_stack_backward(**args, steps_out=True)
                dc_in, dh_in, din = full[7:]
                replay = {k: v for k, v in args.items()
                          if k not in ("dcfin", "dhfin")}
                dg, dc_out, dh_out, din_out = sk.stack_replay_backward_steps(
                    **replay, dc_in=dc_in, dh_in=dh_in, din=din)
                step_rel = max(ratio(dc_out[1:], dc_in[:-1]),
                               ratio(dh_out[1:], dh_in[:-1]),
                               ratio(din_out[1:], din[1:]))
                rounding = within_bf16_step(full[0], dg)
                # the weight gradients over the kernel's own dgates and the
                # replayed steps' stashes
                wgrads = sk.stack_replay_backward_steps(
                    **replay, dc_in=dc_in, dh_in=dh_in, din=din,
                    dgates=full[0])[4]
                wgrad_rels = {n: ratio(g, r) for n, g, r in zip(
                    ("dwz", "dbias", "dproj", "dpeep"),
                    (full[1], full[2], full[3], full[4]), wgrads)
                    if r is not None}
                say("  K13 %-9s bfloat16 per step: carries and din max rel "
                    "%.3e (bound %.0e); dgates within one bf16 rounding "
                    "step: %s; over the kernel's dgates: %s (bound %.0e)"
                    % (family, step_rel, BF16_STEP_REL_TOL, rounding,
                       ", ".join("%s %.2e" % kv for kv in wgrad_rels.items()),
                       BF16_STEP_REL_TOL))
                if step_rel > BF16_STEP_REL_TOL or not rounding or max(
                        wgrad_rels.values()) > BF16_STEP_REL_TOL:
                    fail("K13 %s bf16 per-step replay or weight gradients "
                         "outside their bounds" % family)
            ms, plain_ms = time_in_turns(
                torch, lambda: sk.lstm_stack_backward(**args),
                lambda: sk.stack_backward_reference(**args), rounds=2,
                kernel_reps=2)
            bound_ms, bound_by = stack_bound(torch, args, got, dtype, True)
            steps = case["gx0"].shape[0]
            if stack_how(sk, device, case, True, dtype)["blocks"] != 8:
                fail("K13 at the %s width left its 8-block plan" % family)
            say("  K13 %-9s %-8s kernel %.3f ms (%.1f us per layer-step; "
                "%s)  plain %.3f ms  bound %.4f ms (%s)"
                % (family, name, ms, 1e3 * ms / (steps * STACK_LAYERS),
                   stack_launch(sk, device, case, ms, True, dtype), plain_ms,
                   bound_ms, bound_by))
            result[(family, dtype)] = {
                "max_abs_err": float((got[0].float() - ref[0].float()).abs()
                                     .max()),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}
    return result


# phases 11-12 at the widths past the 8-block plans, on 16-block clusters:
# Kaldi's nnet3 LSTMP cell and projection, the lstm family at H = P = 512,
# 448 and 384, and the cudnnlstm family at H = P = 512 (cuDNN's LSTM takes
# it too); (family, H, P or None); then a streaming chunk at Kaldi's
# widths (batch 1, 16 model rows)
WIDE_STACKS = (("lstm", 1024, 256), ("lstm", 512, 512), ("lstm", 448, 448),
               ("lstm", 384, 384), ("cudnnlstm", 512, None))
STREAM_SHAPE = dict(batch=1, steps=CHUNK_ROWS)
# ... and on the streamed plan (bf16 slices that fit no resident plan;
# float32 reads its slices from L2, 128 units a block past 1024): Sak,
# Senior and Beaufays' LSTMP (2048 cells, projection 512), the cudnnlstm
# family at H = P = 768 and 1024, and H = P = 2048 at T = 32 (as phases 3
# and 7 hold K1 and K2 there; float32 too at the 2048-cell shapes);
# (family, H, P or None, T);
# then a streaming chunk at Sak's widths
STREAMED_STACKS = (("lstm", 2048, 512, 384), ("cudnnlstm", 768, None, 384),
                   ("cudnnlstm", 1024, None, 384),
                   ("cudnnlstm", 2048, None, 32))
SAK = ("lstm", 2048, 512)


def wide_cases(torch):
    """Phases 11-12's 16-block cases, in order: (key, family, H, P or None,
    stack_case's shape arguments, the dtypes held, the plain version timed
    beside the kernel, the stack through stack_layers timed beside the
    parent's route, on the streamed plan).  key: (family, H, P, False) at
    B = 32, T = 384, (.., True) for a streaming chunk, (.., T) at another
    T."""
    both, bf16 = (torch.float32, torch.bfloat16), (torch.bfloat16,)
    cases = [((family, units, proj, False), family, units, proj, {}, both,
              (units, proj) in ((1024, 256), (512, None)), True, False)
             for family, units, proj in WIDE_STACKS]
    cases.append((("lstm", 1024, 256, True), "lstm", 1024, 256,
                  STREAM_SHAPE, both, False, False, False))
    for family, units, proj, steps in STREAMED_STACKS:
        full = steps == 384
        cases.append(((family, units, proj, False if full else steps),
                      family, units, proj, {} if full else dict(steps=steps),
                      both if units == 2048 else bf16,
                      units == 1024 or proj is not None,
                      full and units != 768, True))
    cases.append((SAK + (True,),) + SAK + (STREAM_SHAPE, both, True, False,
                                          True))
    return cases


def wide_name(family, units, proj, batch=32, steps=384):
    return "%s H=%d P=%d%s" % (family, units, proj or units,
                               " B=%d T=%d" % (batch, steps)
                               if (batch, steps) != (32, 384) else "")


def stack_stream_line(how, layers, steps, ms):
    """The streamed plan's weight traffic a launch (every block of every
    cluster reads its streamed slices at every step of its wave) and the
    rate the kernel reads it at; empty on a resident plan."""
    if not how["streamed"]:
        return ""
    nbytes = how["streamed_bytes"] * how["blocks"] * layers * how["tiles"] \
        * steps
    return ("; the plan's streamed weights %.3f GB a launch (%d bytes a "
            "block a step, %d held), read from L2 at %.3f TB/s over the "
            "kernel's time" % (nbytes / 1e9, how["streamed_bytes"],
                               how["held_bytes"], nbytes / ms / 1e9))


# the 16-block launches at B = 32 held against the same launch forced onto
# one row a cell-phase thread: the streamed plan at R = 4 (as much of wh
# resident as fits), where the launcher's R (16 or 32 rows a cluster, a
# cell-phase thread several rows) runs 1-2 waves and R = 4 runs 8; the
# resident plan at the R its one-row launcher took at Kaldi's LSTMP widths
# (K12 8 in 4 waves, K13 4 in 8), where the launcher's (K12 16-32, K13
# 8-16) runs at most 2 waves (K12) and 4 (K13); (K12's, K13's) plan and R,
# and the most waves the launcher's R may take at T = 384
ONE_ROW = {True: ((("streamed, wh held as fits", 4), 2),
                  (("streamed, wh held as fits", 4), 2)),
           False: ((("resident", 8), 2), (("resident", 4), 4))}


def rows_line(how, rows, resident, batch, layers, steps, ms):
    """R, the waves and the us a wave-step of a launch of ``rows`` rows a
    cluster (the waves of a forced R from the clusters the launcher's plan
    holds at once)"""
    tiles = -(-batch // rows)
    waves = -(-tiles // max(1, min(tiles, resident // layers)))
    return "R=%d in %d wave(s), %.2f us a wave-step" % (
        rows, waves, 1e3 * ms / (steps * waves))


def one_row(torch, sk, name, how, case, args=None):
    """K12 (with ``args``, K13 on them) at the launcher's R beside the same
    launch forced onto one row a cell-phase thread (ONE_ROW), timed in
    turns (median of 2), and held to it: K12's outputs and states, K13's
    dgates, weight products, carries and din bit-equal; K13's column sums
    (each thread's rows added first) within BF16_STEP_REL_TOL; each line
    with both launches' R and waves and the launcher's clusters resident
    at once and shared memory a block."""
    steps, batch = case["gx0"].shape[:2]
    forced, most = ONE_ROW[bool(how["streamed"])][args is not None]
    if args is None:
        what = "K12"
        run = lambda **kw: sk.lstm_stack_forward(**case, **kw)
        got, want = run(states=True), run(states=True, _plan=forced)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        sums = 0.0
    else:
        what = "K13"
        run = lambda **kw: sk.lstm_stack_backward(**args, **kw)
        got, want = run(steps_out=True), run(steps_out=True, _plan=forced)
        names = ("dgates", "dwz", "dbias", "dproj", "dpeep", "dcinit",
                 "dhinit", "dc_in", "dh_in", "din")
        same = all(a is None and b is None or torch.equal(a, b)
                   for n, a, b in zip(names, got, want)
                   if n not in ("dbias", "dpeep"))
        sums = max(ratio(a, b) for n, a, b in zip(names, got, want)
                   if n in ("dbias", "dpeep") and b is not None)
    del got, want
    ms, forced_ms = time_in_turns(torch, run, lambda: run(_plan=forced),
                                  rounds=2, kernel_reps=1)
    layers = case["wz"].shape[0]
    say("  %s %s bfloat16 on the %s plan at the launcher's %s (%d clusters "
        "resident at once, %d bytes of shared memory a block): %.3f ms; "
        "forced at %s: %.3f ms (%.2fx); bit-equal row for row: %s%s"
        % (what, name, "streamed" if how["streamed"] else "resident",
           rows_line(how, how["rows"], how["resident"], batch, layers, steps,
                     ms), how["resident"], how["smem_bytes"], ms,
           rows_line(how, forced[1], how["resident"], batch, layers, steps,
                     forced_ms), forced_ms, forced_ms / ms, same,
           "" if args is None else "; column sums max rel %.2e (bound %.0e)"
           % (sums, BF16_STEP_REL_TOL)))
    if not same or sums > BF16_STEP_REL_TOL:
        fail("%s %s at R=%d differs from R=%d" % (what, name, how["rows"],
                                                 forced[1]))
    # the wavefront's S steps are T + L - 1
    if steps - layers + 1 == 384 and (how["rows"] <= forced[1]
                                      or how["waves"] > most):
        fail("%s %s launches R=%d in %d waves, not more rows than %d in at "
             "most %d" % (what, name, how["rows"], how["waves"], forced[1],
                          most))
    return {"ms": ms, "forced_ms": forced_ms, "forced_rows": forced[1],
            "rows": how["rows"], "waves": how["waves"], "col_sums_rel": sums}


def dropped_as_plain(sk, case, kchain, pchain):
    """The kernel's chain is zero where the plain mask drops and non-zero
    where the plain version keeps a non-zero value."""
    steps, lb, out_dim = kchain.shape
    drop = sk._drop_mask(case["seed"], case["keep_prob"], steps,
                         STACK_LAYERS, lb // STACK_LAYERS, out_dim,
                         kchain.device).view(kchain.shape)
    return bool((kchain[drop == 0] == 0).all()) and bool(
        (kchain[(drop > 0) & (pchain.float().abs() > 1e-6)] != 0).all())


def stack_routes(torch, pkg, params, x, seq, family, dtype, train):
    """Two callables running a stack through ``models.lstm.stack_layers``
    as the model does: through the stack kernels (K12, and K13 with
    ``train``), and through the parent's route for the shapes K12 had no
    plan for, layer by layer through K1 (and K2), the stack route refused;
    each counted once, K12 (K13) once, K1 (K2) once a layer."""
    from lstm_ctc_tpu_torch.models import lstm
    flags = [False] + [family == "lstm"] * (len(params) - 1)
    cells_ = [{k: v.detach().clone().requires_grad_(train)
               for k, v in p.items()} for p in params]
    leaves = [t for c in cells_ for t in c.values()]

    def stack():
        with torch.set_grad_enabled(train):
            out, _ = lstm.stack_layers(cells_, x, seq, flags, dtype)
            if train:
                torch.autograd.grad(out.float().square().sum(), leaves)

    def route():
        with mock.patch.object(lstm, "stack_eligible",
                               lambda *args, **kwargs: False):
            stack()

    layers = len(params)
    for fn, want in ((stack, counts(lstm_stack_fwd=1,
                                    lstm_stack_bwd=int(train))),
                     (route, counts(lstm_fwd=layers,
                                    lstm_bwd=layers * int(train)))):
        _, _, got, _ = run_counted(torch, pkg, fn)
        expect_counts("the stack's %s" % ("route" if fn is route else
                                          "kernels"), got, want)
    return stack, route


def check_stack_fwd_wide(torch, pkg, device, rng):
    """Phase 11 at wide_cases: K12 on 16-block clusters, resident or
    streamed, against its plain version (float32 ratio; bfloat16 each step
    replayed; keep 0.9 dropped as the plain mask), two bfloat16 launches
    bit-equal, its launch, and its time beside the plain version's and the
    parent's route (the stack through stack_layers, by K12 and layer by
    layer through K1)."""
    sk = pkg["lstm_stack_kernels"]
    result = {}
    for (key, family, units, proj, shape, dtypes, plain_timed, routes,
         streamed) in wide_cases(torch):
        shape = dict(shape, shape=(units, proj))
        name = wide_name(family, units, proj, shape.get("batch", 32),
                         shape.get("steps", 384))
        keep = 0.9 if family == "lstm" else 1.0
        worst = 0.0
        for dtype in dtypes:
            case, _, _, _ = stack_case(torch, pkg, device, dtype, family, rng,
                                       keep, init=True, **shape)
            how = stack_how(sk, device, case)
            if dtype == torch.bfloat16 and (how["blocks"] != 16
                                            or how["streamed"] != streamed):
                fail("K12 %s bf16 has %d blocks a cluster (streamed %s), not "
                     "16 (%s)" % (name, how["blocks"], how["streamed"],
                                  streamed))
            got = sk.lstm_stack_forward(**case, states=True)
            if dtype == torch.float32:
                out, chain, c_all, h_all, cfin, hfin = \
                    sk.stack_forward_reference(**case)
                ref, names = (out, cfin, hfin, chain, c_all, h_all), \
                    ("out", "cfin", "hfin", "chain", "c_all", "h_all")
                tol, same = F32_REL_TOL, True
            else:
                again = sk.lstm_stack_forward(**case, states=True)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ref = sk.stack_replay_steps(**case, chain=got[3],
                                            c_all=got[4], h_all=got[5])
                got, names, tol = got[3:], ("chain", "c_all", "h_all"), \
                    BF16_STEP_REL_TOL
            torch.cuda.synchronize()
            for n, g in zip(names, got):
                if not torch.isfinite(g).all():
                    fail("K12 %s: non-finite %s" % (name, n))
            rels = {n: ratio(g, r) for n, g, r in zip(names, got, ref)}
            worst = max(worst, max(errors(g, r)[0] for g, r in zip(got, ref)))
            dropped = keep == 1.0 or dropped_as_plain(
                sk, case, got[names.index("chain")],
                ref[names.index("chain")])
            say("  K12 %s %s keep=%.1f init: max rel %s; dropped as the "
                "plain mask: %s; %s"
                % (name, str(dtype).split(".")[-1], keep, ", ".join(
                    "%s %.2e" % kv for kv in rels.items()), dropped,
                   "two launches bit-equal: %s" % same
                   if dtype == torch.bfloat16 else "f32 %d blocks a "
                   "cluster" % how["blocks"]))
            if max(rels.values()) > tol or not dropped or not same:
                fail("K12 %s %s outside its bounds (ratio bound %.0e)"
                     % (name, dtype, tol))
            del got, ref
        # timed, bf16: K12 alone (beside its plain version where it is
        # the row of a table), and the stack beside the parent's route
        case, params, x, seq = stack_case(torch, pkg, device, torch.bfloat16,
                                          family, rng, **shape)
        if plain_timed:
            ms, plain_ms = time_in_turns(
                torch, lambda: sk.lstm_stack_forward(**case),
                lambda: sk.stack_forward_reference(**case), rounds=2,
                kernel_reps=1 if streamed else 3)
        else:
            ms, plain_ms = median_ms(
                torch, lambda: sk.lstm_stack_forward(**case), 5), None
        bound_ms, bound_by = stack_bound(
            torch, case, sk.lstm_stack_forward(**case), torch.bfloat16)
        how = stack_how(sk, device, case)
        res = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "launch": how}
        steps = case["gx0"].shape[0]
        line = ("  K12 %s bfloat16 kernel %.3f ms (%s)%s bound %.4f ms (%s)%s"
                % (name, ms, stack_launch(sk, device, case, ms),
                   "" if plain_ms is None else "  plain %.3f ms" % plain_ms,
                   bound_ms, bound_by,
                   stack_stream_line(how, STACK_LAYERS, steps, ms)))
        if shape.get("batch", 32) == 32:
            res["one_row"] = one_row(torch, sk, name, how, case)
        if routes:
            stack, route = stack_routes(torch, pkg, params, x, seq, family,
                                        torch.bfloat16, False)
            res["stack_ms"], res["route_ms"] = time_in_turns(
                torch, stack, route, rounds=2 if streamed else 3,
                kernel_reps=1 if streamed else 2)
            line += ("; forward through stack_layers: the stack %.3f ms, "
                     "layer by layer through K1 (the parent's route) %.3f ms"
                     % (res["stack_ms"], res["route_ms"]))
        say(line)
        result[key] = res
        del case, params, x
        torch.cuda.empty_cache()
    return result


def check_stack_forced(torch, pkg, device, rng):
    """Phase 11: the streamed plan forced (lstm_stack_kernels' internal
    ``_plan``, lstm_kernels.PLANS) where the resident plan fits, at Kaldi's
    LSTMP widths (16 blocks), bf16, B=32, T=384: K12 at R=4 and 8 and K13
    at R=4, with half of wh resident and with as much as fits, each equal
    bit for bit to the resident plan at the same R, and timed against it
    (median of 3).  K13's resident plan of 16 blocks is the streamed plan's
    kernel with every weight held, so its half holds the held pass against
    the ring's within one kernel body."""
    sk = pkg["lstm_stack_kernels"]
    case, _, _, _ = stack_case(torch, pkg, device, torch.bfloat16, "lstm",
                               rng, 0.9, init=True, shape=(1024, 256))
    case.pop("affine")
    plans = ("streamed", "streamed, wh held as fits")
    result = {}
    for rows in (4, 8):
        want = sk.lstm_stack_forward(**case, states=True,
                                     _plan=("resident", rows))
        times = {"resident": median_ms(torch, lambda: sk.lstm_stack_forward(
            **case, _plan=("resident", rows)), 3)}
        for plan in plans:
            got = sk.lstm_stack_forward(**case, states=True,
                                        _plan=(plan, rows))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail("K12 forced %s at R=%d differs from the resident plan"
                     % (plan, rows))
            times[plan] = median_ms(torch, lambda: sk.lstm_stack_forward(
                **case, _plan=(plan, rows)), 3)
        result[("K12", rows)] = times
    out, cfin, hfin, chain, c_all, h_all = want
    args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                dout=0.1 * torch.ones_like(out), dcfin=torch.zeros_like(cfin),
                dhfin=torch.zeros_like(hfin), store_dtype=torch.float32)
    want = sk.lstm_stack_backward(**args, _plan=("resident", 4))
    times = {"resident": median_ms(torch, lambda: sk.lstm_stack_backward(
        **args, _plan=("resident", 4)), 3)}
    for plan in plans:
        got = sk.lstm_stack_backward(**args, _plan=(plan, 4))
        if not all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, want)):
            fail("K13 forced %s at R=4 differs from the resident plan"
                 % plan)
        times[plan] = median_ms(torch, lambda: sk.lstm_stack_backward(
            **args, _plan=(plan, 4)), 3)
    result[("K13", 4)] = times
    plans = []
    for what, how in (("K12", stack_how(sk, device, case)),
                      ("K13", stack_how(sk, device, case, True,
                                        torch.float32))):
        plans.append("%s R=%d in %d wave(s), %d clusters resident at once, "
                     "%d bytes of shared memory a block"
                     % (what, how["rows"], how["waves"], how["resident"],
                        how["smem_bytes"]))
    say("  the streamed plan forced where the resident plan fits (lstm "
        "H=1024 P=256, bf16, B=32, T=384, 16 blocks), bit-equal to the "
        "resident plan at the same R: %s (the launcher's own resident "
        "plans there, K13's states in float32: %s)" % ("; ".join(
            "%s R=%d: %s" % (k[0], k[1], ", ".join(
                "%s %.3f ms" % kv for kv in t.items()))
            for k, t in result.items()), "; ".join(plans)))
    return result


def per_layer(torch, x, w):
    """x ``[S, L, B, K]`` by each layer's w ``[L, K, N]``, one product a
    layer (matmul would copy w once a step)."""
    steps, layers, batch, depth = x.shape
    y = torch.matmul(x.transpose(0, 1).reshape(layers, -1, depth), w)
    return y.view(layers, steps, batch, -1).transpose(0, 1)


def stack_dgates_float64(torch, sk, args, dc_in, dh_in, din, s0, s1):
    """The dgates of wavefront steps s0 .. s1-1 of a K13 launch on ``args``
    replayed in float64 from the kernel's own carries entering each step
    (dc_in, dh_in), its layers' input cotangents din (the chain cotangent
    of the layer below) and the stored states, the products' operands
    rounded to the compute dtype as the kernel rounds them (dout_p formed
    in float32 first): dgates_float64's rule for K2, on the stack's steps.
    The gate sums of layers l >= 1 add gx_l (in_prev·wx_l, a float32
    product) and the bias in float32 before h·wh, one more rounding in the
    bound.  Returns (dg, err), [s1 - s0, L·B, 4H] float64."""
    gx0, wz, proj = args["gx0"], args["wz"], args["proj"]
    _, layers, batch, units, out_dim = sk._dims(gx0, wz)
    steps = s1 - s0
    f64, cdt, u = torch.float64, wz.dtype, F32_UNIT

    def rounded(x):
        return x.to(cdt).to(f64)

    def view(x, dtype=f64):
        return x[s0:s1].to(dtype).reshape(steps, layers, batch, x.shape[-1])

    c0 = sk._previous(args["c_all"], args["cinit"], layers)[s0:s1].to(f64)
    zq = rounded(torch.cat([sk._inputs_before(args["chain"], layers),
                            sk._previous(args["h_all"], args["hinit"],
                                         layers)], dim=-1)[s0:s1])
    wzq = rounded(wz)
    b64 = args["bias"].to(f64)[:, None, :]
    gx64 = torch.zeros(steps, layers, batch, 4 * units, dtype=f64,
                       device=gx0.device)
    gx64[:, 0] = gx0[s0:s1].to(f64)
    gates = per_layer(torch, zq, wzq) + b64 + gx64
    errs = u * (per_layer(torch, zq.abs(), wzq.abs()) + b64.abs()
                + gx64.abs() + gates.abs())
    del zq
    m32 = args["mask"][s0:s1].view(steps, layers, batch, 1).float()
    m = m32.to(f64)
    drop = sk._drop_mask(args["seed"], args["keep_prob"], gx0.shape[0],
                         layers, batch, out_dim, gx0.device)
    dchain = sk._chain_cotangents(args["dout"].float(),
                                  din.transpose(0, 1).float(), drop)[s0:s1]
    dout_p = m32 * (dchain + view(dh_in, torch.float32))
    if proj is None:
        dob = m * (dchain.to(f64) + view(dh_in))
        edob = u * dob.abs()
    else:
        dq, pt = rounded(dout_p), rounded(proj).transpose(-1, -2)
        dob = per_layer(torch, dq, pt)
        edob = u * per_layer(torch, dq.abs(), pt.abs())
    dg, err = cell_backward_float64(torch, gates, errs, c0, args["peep"],
                                    args["forget_bias"], m, view(dc_in), dob,
                                    edob)
    lb = layers * batch
    return dg.reshape(steps, lb, -1), err.reshape(steps, lb, -1)


def stack_dgates_held(torch, sk, args, dgates, dc_in, dh_in, din, plain_dg,
                      piece=16):
    """K13's bf16 dgates (as stored) against stack_dgates_float64, a
    ``piece`` of steps at a time (float64 at B = 32, T = 384 and 2048 cells
    would not fit the card's memory at once), as dgates_held holds K2's:
    (the worst |diff| / bound, the same of the plain f32 one-step replay
    ``plain_dg``, the elements past one bf16 step of it: the old rule)."""
    worst = plain = 0.0
    old_rule = 0
    for s0 in range(0, dgates.shape[0], piece):
        s1 = min(dgates.shape[0], s0 + piece)
        ref, err = stack_dgates_float64(torch, sk, args, dc_in, dh_in, din,
                                        s0, s1)
        bound = 2.0 ** -7 * ref.abs() + err + 1e-6
        worst = max(worst, float(((dgates[s0:s1].to(ref.dtype) - ref).abs()
                                  / bound).max()))
        plain = max(plain, float(((plain_dg[s0:s1].to(ref.dtype) - ref).abs()
                                  / bound).max()))
        got, pd = dgates[s0:s1].float(), plain_dg[s0:s1].float()
        old_rule += int(((got - pd).abs() > 2.0 ** -7 * pd.abs()
                         + 1e-6).sum())
        del ref, err, bound
    return worst, plain, old_rule


def check_stack_bwd_wide(torch, pkg, device, rng):
    """Phase 12 at wide_cases: K13 on 16-block clusters, resident or
    streamed, against its plain version (float32 ratio; bfloat16 each step
    replayed: the carries and din within 1e-3, dgates by dgates_float64's
    rule on the stack's steps, the weight gradients over its own dgates),
    two bfloat16 launches bit-equal, its launch, and a training forward and
    backward beside the parent's route (layer by layer through K1 and
    K2)."""
    sk = pkg["lstm_stack_kernels"]
    names = ("dgates", "dwz", "dbias", "dproj", "dpeep", "dcinit", "dhinit")
    result = {}
    for (key, family, units, proj, shape, dtypes, plain_timed, routes,
         streamed) in wide_cases(torch):
        shape = dict(shape, shape=(units, proj))
        name = wide_name(family, units, proj, shape.get("batch", 32),
                         shape.get("steps", 384))
        keep = 0.9 if family == "lstm" else 1.0
        worst = None
        for dtype in dtypes:
            case, params, x, seq = stack_case(torch, pkg, device, dtype,
                                              family, rng, keep, init=True,
                                              **shape)
            case.pop("affine")
            how = stack_how(sk, device, case, True, dtype)
            if dtype == torch.bfloat16 and (how["blocks"] != 16
                                            or how["streamed"] != streamed):
                fail("K13 %s bf16 has %d blocks a cluster (streamed %s), not "
                     "16 (%s)" % (name, how["blocks"], how["streamed"],
                                  streamed))
            out, cfin, hfin, chain, c_all, h_all = sk.lstm_stack_forward(
                **case, states=True, store_dtype=dtype)
            dout = torch.from_numpy((0.1 * rng.randn(*out.shape)).astype(
                np.float32)).to(device)
            args = dict(case, chain=chain, c_all=c_all, h_all=h_all,
                        dout=dout, dcfin=torch.zeros_like(cfin),
                        dhfin=torch.zeros_like(hfin), store_dtype=dtype)
            if dtype == torch.float32:
                got = sk.lstm_stack_backward(**args)
                ref = sk.stack_backward_reference(**args)
                rels = {n: ratio(g, r) for n, g, r in zip(names, got, ref)
                        if g is not None}
                say("  K13 %s float32 keep=%.1f max|diff|/max|plain|: %s "
                    "(%d blocks a cluster)" % (name, keep, ", ".join(
                        "%s %.2e" % kv for kv in rels.items()),
                        how["blocks"]))
                if max(rels.values()) > F32_REL_TOL:
                    fail("K13 %s f32: relative error %.3e > %.1e"
                         % (name, max(rels.values()), F32_REL_TOL))
                worst = float((got[0].float() - ref[0].float()).abs().max())
                del got, ref
                continue
            full = sk.lstm_stack_backward(**args, steps_out=True)
            again = sk.lstm_stack_backward(**args, steps_out=True)
            same = all(a is None and b is None or torch.equal(a, b)
                       for a, b in zip(full, again))
            del again
            dc_in, dh_in, din = full[7:]
            replay = {k: v for k, v in args.items()
                      if k not in ("dcfin", "dhfin")}
            dg, dc_out, dh_out, din_out, wgrads = \
                sk.stack_replay_backward_steps(**replay, dc_in=dc_in,
                                               dh_in=dh_in, din=din,
                                               dgates=full[0])
            step_rel = max(ratio(dc_out[1:], dc_in[:-1]),
                           ratio(dh_out[1:], dh_in[:-1]),
                           ratio(din_out[1:], din[1:]))
            dg64, plain64, old_rule = stack_dgates_held(
                torch, sk, args, full[0], dc_in, dh_in, din, dg)
            if worst is None:
                worst = float((full[0].float() - dg.float()).abs().max())
            wgrad_rels = {n: ratio(g, r) for n, g, r in zip(
                ("dwz", "dbias", "dproj", "dpeep"), full[1:5], wgrads)
                if r is not None}
            finite = all(torch.isfinite(t.float()).all() for t in full
                         if t is not None)
            say("  K13 %s bfloat16 per step: carries and din max rel %.3e "
                "(bound %.0e); dgates against the float64 replay of each "
                "step: worst |diff|/bound %.3f (the plain f32 replay's %.3f; "
                "elements past one bf16 step of the plain replay, the old "
                "rule: %d); over the kernel's dgates: %s (bound %.0e); two "
                "launches bit-equal: %s"
                % (name, step_rel, BF16_STEP_REL_TOL, dg64, plain64, old_rule,
                   ", ".join("%s %.2e" % kv for kv in wgrad_rels.items()),
                   BF16_STEP_REL_TOL, same))
            if step_rel > BF16_STEP_REL_TOL or dg64 > 1.0 or max(
                    wgrad_rels.values()) > BF16_STEP_REL_TOL or not same \
                    or not finite:
                fail("K13 %s bf16 outside its bounds" % name)
        # timed, bf16: K13 alone (beside its plain version where it is the
        # row of a table), and a training step's stack beside the parent's
        # route
        if plain_timed:
            ms, plain_ms = time_in_turns(
                torch, lambda: sk.lstm_stack_backward(**args),
                lambda: sk.stack_backward_reference(**args), rounds=2,
                kernel_reps=1 if streamed else 2)
        else:
            ms, plain_ms = median_ms(
                torch, lambda: sk.lstm_stack_backward(**args), 5), None
        bound_ms, bound_by = stack_bound(torch, args, full[:7],
                                         torch.bfloat16, True)
        how = stack_how(sk, device, case, True, torch.bfloat16)
        res = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "launch": how}
        steps = case["gx0"].shape[0]
        line = ("  K13 %s bfloat16 kernel %.3f ms (%s)%s bound %.4f ms (%s)%s"
                % (name, ms, stack_launch(sk, device, case, ms, True,
                                          torch.bfloat16),
                   "" if plain_ms is None else "  plain %.3f ms" % plain_ms,
                   bound_ms, bound_by,
                   stack_stream_line(how, STACK_LAYERS, steps, ms)))
        if shape.get("batch", 32) == 32:
            res["one_row"] = one_row(torch, sk, name, how, case, args)
        if routes:
            stack, route = stack_routes(torch, pkg, params, x, seq, family,
                                        torch.bfloat16, True)
            res["stack_ms"], res["route_ms"] = time_in_turns(
                torch, stack, route, rounds=2 if streamed else 3,
                kernel_reps=1 if streamed else 2)
            line += ("; forward + backward through stack_layers: the stack "
                     "%.3f ms, layer by layer through K1 and K2 (the "
                     "parent's route) %.3f ms"
                     % (res["stack_ms"], res["route_ms"]))
        say(line)
        result[key] = res
        del case, params, x, args, full
        torch.cuda.empty_cache()
    return result


def check_posteriors(posts, raw_lengths, subsample=3, targets=72):
    """The archive holds every key, (raw // subsample) x ``targets`` finite
    log-posteriors whose rows sum to one; returns the frame count."""
    if sorted(posts) != sorted(raw_lengths):
        fail("archive keys differ from the corpus keys")
    frames = 0
    for key, mat in posts.items():
        if mat.shape != (raw_lengths[key] // subsample, targets):
            fail("%s: shape %s, expected (%d, %d)"
                 % (key, mat.shape, raw_lengths[key] // subsample, targets))
        if not np.isfinite(mat).all():
            fail("%s: non-finite log-posteriors" % key)
        m = mat.max(axis=1, keepdims=True)
        lse = m[:, 0] + np.log(np.exp(mat - m).sum(axis=1))
        if np.abs(lse).max() > LOGSUMEXP_TOL:
            fail("%s: row logsumexp up to %.3e" % (key, np.abs(lse).max()))
        frames += mat.shape[0]
    return frames


@contextlib.contextmanager
def held_stack(torch, pkg, dtype, worst):
    """Run each K12 launch with its per-step states, then replay every step
    from them with the plain version; fail on a launch of another compute
    dtype or a step outside the bound."""
    sk = pkg["lstm_stack_kernels"]
    k12 = sk.lstm_stack_forward
    names = ("gx0", "mask", "wz", "bias", "proj", "peep", "cinit", "hinit",
             "residual", "forget_bias", "keep_prob", "seed", "affine")

    def stand_in(*args, states=False, store_dtype=None, **kwargs):
        kw = dict({"keep_prob": 1.0, "seed": None, "affine": None},
                  **dict(zip(names, args)), **kwargs)
        if kw["wz"].dtype != dtype:
            fail("K12 launched with weights in %s, expected %s"
                 % (kw["wz"].dtype, dtype))
        got = k12(**kw, states=True)
        ref = sk.stack_replay_steps(**kw, chain=got[3], c_all=got[4],
                                    h_all=got[5])
        rel = max(ratio(g, r) for g, r in zip(got[3:], ref))
        worst["lstm_stack_fwd"] = max(worst["lstm_stack_fwd"], rel)
        if rel > BF16_STEP_REL_TOL:
            fail("K12 on the main path: a step's relative error %.3e > %.1e"
                 % (rel, BF16_STEP_REL_TOL))
        return got[:3]

    stand_in.launches = 0
    with mock.patch.object(sk, "lstm_stack_forward", stand_in):
        yield


def serve_families(torch, pkg, device, rng):
    """Phase 13: nnet_forward for an lstm and a cudnnlstm model, then the
    lstm model through --streaming."""
    from lstm_ctc_tpu_torch.bin import nnet_forward
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.models.streaming import StreamingSession
    from lstm_ctc_tpu_torch.host.data import RecordLoader, scan_scp
    from lstm_ctc_tpu_torch.train.checkpoint import save_checkpoint
    result = {"launches": counts()}
    with tempfile.TemporaryDirectory() as work:
        scp, raw_lengths = write_corpus(pkg, work, rng)
        for name, config in (("lstm", LSTM_CONFIG),
                             ("cudnnlstm", CUDNN_CONFIG)):
            paths = {}
            for tag, cfg in (("bf16", config),
                             ("f32", dict(config, compute_dtype="float32"))):
                paths[tag] = os.path.join(work, "%s_%s.config" % (name, tag))
                with open(paths[tag], "w") as fh:
                    fh.write(format_config(cfg))
            params, state = init_from_config(dict(config), device)
            nnet = os.path.join(work, "%s.npz" % name)
            save_checkpoint(nnet, params, state)
            batcher = build_batcher(scp, config, 32)
            batches = len(batcher.batch_plan(False, None))

            def run(config_path, ark, *extra):
                return nnet_forward.main(
                    [scp if not extra else extra[0], config_path, nnet,
                     "ark:" + ark, "--device", "cuda", "--batch-size", "32",
                     "--report-interval", "0"] + list(extra[1:]))

            ark = os.path.join(work, "%s.ark" % name)
            _, _, got, _ = run_counted(torch, pkg,
                                       lambda: run(paths["bf16"], ark))
            expect_counts("nnet_forward %s" % name, got,
                          counts(lstm_stack_fwd=batches))
            for k in KERNEL_NAMES:
                result["launches"][k] += got[k]
            posts = read_archive(kaldi, ark)
            frames = check_posteriors(posts, raw_lengths)
            start = time.perf_counter()
            run(paths["bf16"], ark)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - start
            ark32 = os.path.join(work, "%s_f32.ark" % name)
            run(paths["f32"], ark32)
            posts32 = read_archive(kaldi, ark32)
            ref32 = plain_logposts(torch, pkg, params, state, batcher,
                                   dict(config, compute_dtype="float32"),
                                   device)
            worst32, mean32 = diff_stats(posts32, ref32)
            say("  %s: nnet_forward wrote %d utterances in %d batches "
                "(launches %s); %.1f frames/s (second run, %.3f s); float32 "
                "kernels vs plain versions, log-posteriors max_abs %.3e "
                "mean_abs %.3e" % (name, len(posts), batches, got,
                                   frames / warm_s, warm_s, worst32, mean32))
            if mean32 > E2E_F32_MEAN_TOL or worst32 > E2E_F32_MAX_TOL:
                fail("%s float32 log-posteriors differ from the plain "
                     "versions beyond the bounds" % name)
            worst = {"lstm_stack_fwd": 0.0}
            with held_stack(torch, pkg, torch.bfloat16, worst):
                run(paths["bf16"], os.path.join(work, "held.ark"))
            say("  %s bfloat16 main path, each K12 launch's steps vs the "
                "plain version: max rel %.3e (bound %.0e)"
                % (name, worst["lstm_stack_fwd"], BF16_STEP_REL_TOL))
            result[name] = {"fps": frames / warm_s}
            if name != "lstm":
                continue

            # streaming: 8 utterances through --streaming, chunks of 16
            # model rows, against the offline archives
            keys = sorted(raw_lengths)[:8]
            sub_scp = os.path.join(work, "stream.scp")
            metas = {m.key: m for m in scan_scp(scp)}
            with open(sub_scp, "w") as fh:
                for key in keys:
                    fh.write(metas[key].scp_line())
            chunks = sum(-(-(raw_lengths[k] // 3) // CHUNK_ROWS)
                         for k in keys)
            stream = {}
            for tag, offline in (("bf16", posts), ("f32", posts32)):
                sark = os.path.join(work, "stream_%s.ark" % tag)
                _, _, got, _ = run_counted(torch, pkg, lambda: run(
                    paths[tag], sark, sub_scp, "--streaming", "true",
                    "--chunk-frames", str(CHUNK_ROWS)))
                expect_counts("nnet_forward --streaming", got,
                              counts(lstm_stack_fwd=chunks))
                for k in KERNEL_NAMES:
                    result["launches"][k] += got[k]
                sposts = read_archive(kaldi, sark)
                check_posteriors(sposts, {k: raw_lengths[k] for k in keys})
                worst, mean = diff_stats(sposts, {k: offline[k]
                                                  for k in keys})
                scale = max(float(np.abs(offline[k]).max()) for k in keys)
                stream[tag] = (worst, mean, worst / scale)
            # the same kernel on both sides: held to phase 11's ratio bounds
            # (f32 1e-4, bf16 1e-3), which a chunk-boundary fault that moves
            # a few rows a chunk would break
            say("  --streaming --chunk-frames %d, %d utterances, %d chunks "
                "(launches as counted): vs offline log-posteriors, float32 "
                "max_abs %.3e mean_abs %.3e max|diff|/max|offline| %.3e "
                "(bound %.0e); bfloat16 max_abs %.3e mean_abs %.3e ratio "
                "%.3e (bound %.0e)"
                % ((CHUNK_ROWS, len(keys), chunks) + stream["f32"]
                   + (F32_REL_TOL,) + stream["bf16"] + (BF16_STEP_REL_TOL,)))
            if stream["f32"][2] > F32_REL_TOL \
                    or stream["bf16"][2] > BF16_STEP_REL_TOL:
                fail("streaming output differs from the offline output")

            # ms per chunk and real-time factor: a session on the card
            session = StreamingSession(params, state, config,
                                       chunk_size=CHUNK_ROWS)
            loader = RecordLoader()
            raws = [loader.load(metas[k])[1] for k in keys]
            loader.close()
            session.process(raws[0], flush=True)       # warm
            torch.cuda.synchronize()
            start = time.perf_counter()
            for raw in raws:
                session.reset()
                session.process(raw, flush=True)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            audio_s = FRAME_SHIFT_S * sum(raw.shape[0] for raw in raws)
            result["chunk_ms"] = 1e3 * seconds / chunks
            result["rtf"] = audio_s / seconds
            say("  streaming session on the card: %.3f ms per chunk of %d "
                "rows (%.2f s of audio), real-time factor %.1f (audio "
                "seconds per second, as bench.py defines it; %.4f seconds "
                "per audio second)"
                % (result["chunk_ms"], CHUNK_ROWS,
                   CHUNK_ROWS * 3 * FRAME_SHIFT_S, result["rtf"],
                   seconds / audio_s))
            steps = CHUNK_ROWS + STACK_LAYERS - 1
            how = pkg["lstm_stack_kernels"].stack_config(
                device, steps, STACK_LAYERS, 1, 320, 320, True,
                torch.bfloat16)
            say("  K12 on a chunk (B=1, S=%d): R=%d, %d clusters, lag K=%d: "
                "a chain of about S + (L-1)·K = %d steps (the layers one "
                "after another: %d)" % (
                    steps, how["rows"], STACK_LAYERS * how["tiles"],
                    how["lag"], steps + (STACK_LAYERS - 1) * how["lag"],
                    STACK_LAYERS * steps))
    return result


def family_step_check(torch, pkg, device, config, nnet, batcher, held):
    """One float32 train step from the weights in ``nnet``: each kernel
    launch held to its plain version on its own tensors, and the loss to
    the plain versions' loss."""
    from lstm_ctc_tpu_torch.cli import init_from_config, make_shard_fn
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint, tree_map
    from lstm_ctc_tpu_torch.train.graph import (compute_losses, l2_loss,
                                                param_leaves)
    batch = make_shard_fn(device)(next(iter(iterate_batches(
        batcher, shuffle=True, seed=777))))
    template, state = init_from_config(config, device)
    base, state, _ = load_checkpoint(nnet, template, state)
    f32 = dict(config, compute_dtype="float32", store_dtype="float32",
               dropout_rate=1.0)

    def loss(plain):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          base)
        with (plain_versions(pkg) if plain else contextlib.nullcontext()):
            metrics, _, _ = compute_losses(params, state, batch, f32,
                                           train=True)
            total = metrics["loss"] + 1e-5 * l2_loss(params)
            torch.autograd.grad(total, param_leaves(params))
        return float(total.detach())

    worst = {k: 0.0 for k in held}
    with held_f32(torch, pkg, worst):
        got = loss(False)
    want = loss(True)
    rel = abs(got - want) / abs(want)
    say("  %s float32 train step: each launch vs its plain version on the "
        "same tensors, max rel %s (bound %.0e); loss %.6f vs plain %.6f "
        "(rel %.3e, bound %.0e)"
        % (config.get("use_bn") and "lstm_bn" or config["nnet_type"],
           ", ".join("%s %.3e" % kv for kv in worst.items()), F32_REL_TOL,
           got, want, rel, STEP_LOSS_TOL))
    if max(worst.values()) > F32_REL_TOL or rel > STEP_LOSS_TOL:
        fail("a float32 launch of the family's train step differs from its "
             "plain version")
    return worst


def train_families(torch, pkg, device, work, scp):
    """Phase 14: lstm (keep 0.9), cudnnlstm and lstm_bn through nnet_init /
    nnet_train / nnet_validate on the phase-8 corpus, unpacked."""
    from lstm_ctc_tpu_torch.bin import nnet_init, nnet_train, nnet_validate
    from lstm_ctc_tpu_torch.cli import build_batcher
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.train.graph import make_train_step
    result = {"launches": counts()}
    common = ["--objective", "ctc", "--batch-size", "32", "--device",
              "cuda", "--report-interval", "0"]
    batcher = build_batcher(scp, LSTM_CONFIG, 32)
    cv_batches = len(batcher.batch_plan(False, None))
    steps = len(batcher.batch_plan(True, 777))
    frames = sum(batcher._lengths)
    for name, config in (("lstm", LSTM_CONFIG), ("cudnnlstm", CUDNN_CONFIG),
                         ("lstm_bn", LSTM_BN_CONFIG)):
        if name == "lstm_bn":
            train_counts = counts(lstm_fwd=4 * steps, lstm_bwd=4 * steps,
                                  ctc_alpha=steps, ctc_beta=steps)
        else:
            train_counts = counts(lstm_stack_fwd=steps, lstm_stack_bwd=steps,
                                  ctc_alpha=steps, ctc_beta=steps)
        cv_counts = counts(lstm_stack_fwd=cv_batches, ctc_alpha=cv_batches)
        config_path = os.path.join(work, "%s.config" % name)
        with open(config_path, "w") as fh:
            fh.write(format_config(config))
        nnets = [os.path.join(work, "%s%d.npz" % (name, i)) for i in range(3)]

        def counted(what, fn, want):
            _, tee, got, _ = run_counted(torch, pkg, fn)
            expect_counts("%s %s" % (name, what), got, want)
            for k in KERNEL_NAMES:
                result["launches"][k] += got[k]
            return tee

        cv = [counted("nnet_init", lambda: nnet_init.main(
            [scp, config_path, nnets[0]] + common), cv_counts
        ).value("cv_loss")]
        tr, metrics = [], None
        for epoch in (1, 2):
            metrics_file = os.path.join(work, "%s_metrics%d.jsonl"
                                        % (name, epoch))
            tr.append(counted("nnet_train", lambda: nnet_train.main(
                [scp, config_path, nnets[epoch - 1], nnets[epoch],
                 "--optimizer", "adam", "--learn-rate", "1e-3",
                 "--metrics-file", metrics_file] + common),
                train_counts).value("tr_loss"))
            cv.append(counted("nnet_validate", lambda: nnet_validate.main(
                [scp, config_path, nnets[epoch]] + common),
                cv_counts).value("cv_loss"))
            with open(metrics_file) as fh:
                metrics = [json.loads(ln) for ln in fh]
        step_ms = 1e3 * statistics.median(m["step_time"] for m in metrics)
        fps = frames / sum(m["step_time"] for m in metrics)
        say("  %s: cv_loss %s; tr_loss %s; epoch 2 median train step %.1f "
            "ms, %.1f real frames/s (%d steps of 32 unpacked utterances)"
            % (name, ["%.4f" % v for v in cv], ["%.4f" % v for v in tr],
               step_ms, fps, steps))
        if not all(math.isfinite(v) for v in cv + tr):
            fail("%s: non-finite tr_loss or cv_loss" % name)
        if name == "lstm" and not cv[-1] < cv[0]:
            fail("lstm: the last cv_loss %.4f is not below the first %.4f"
                 % (cv[-1], cv[0]))
        result[name] = {"step_ms": step_ms, "fps": fps, "cv": cv}
        held = ("lstm_fwd", "lstm_bwd") if name == "lstm_bn" \
            else ("lstm_stack_fwd", "lstm_stack_bwd")
        family_step_check(torch, pkg, device, config, nnets[2], batcher, held)
        if name == "lstm":
            from lstm_ctc_tpu_torch.cli import init_from_config, make_shard_fn
            from lstm_ctc_tpu_torch.host.data import iterate_batches
            from lstm_ctc_tpu_torch.train.checkpoint import (load_checkpoint,
                                                             tree_map)
            template, state = init_from_config(config, device)
            base, _, _ = load_checkpoint(nnets[2], template, state)
            init_opt, step = make_train_step(config, 1e-3, "adam")
            batch = make_shard_fn(device)(next(iter(iterate_batches(
                batcher, shuffle=True, seed=777))))
            profile_step(torch, init_opt, step, tree_map(
                lambda t: t.detach().clone().requires_grad_(), base),
                batch, device, step_ms)
    return result


# --- phase 18: the shipped recipe through the shim ---

RECIPE_FLAGS = ["--profile", "capacity", "--num-layers", "4",
                "--num-neurons", "320", "--num-projects", "320",
                "--num-experts", "72", "--max-iter", "2", "--min-iters", "2"]
RECIPE_STAGES = ("data + LM", "TLG graph", "fbank + CMVN",
                 "labels + records", "training (train_oplr.sh)",
                 "lattice decode + WER")


def start_seconds(argv, env, reps=1):
    """Median wall seconds of a command that does little but start (one
    start each: the model tool's ~10 s is mostly importing torch)."""
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        proc = subprocess.run(argv, env=env, capture_output=True, timeout=300)
        times.append(time.perf_counter() - start)
        if proc.returncode != 0:
            fail("%s: exit %d: %s" % (argv[2:4], proc.returncode,
                                       proc.stderr.decode()[-800:]))
    return statistics.median(times)


def tool_start_times(here, env, work):
    """The start of a port tool through the shim on the card's host:
    python3 alone, a data tool (copy-feats on one utterance; no torch) and
    a model tool (nnet-forward --help: torch and the models imported)."""
    from lstm_ctc_tpu_torch.host import kaldi
    one = os.path.join(work, "one.ark")
    with kaldi.TableWriter("ark:" + one, "matrix") as writer:
        writer.Write("u", np.zeros((100, 40), np.float32))
    shim = [sys.executable, os.path.join(here, "lstm_ctc_tpu_torch",
                                         "recipe_python.py"),
            "--device", "cuda"]
    bin_dir = os.path.join(here, "bin")
    return {
        "python3": start_seconds([sys.executable, "-c", "pass"], env),
        "copy-feats (data tool)": start_seconds(
            shim + [os.path.join(bin_dir, "copy-feats.py"), "ark:" + one,
                    "ark:/dev/null"], env),
        "nnet-forward --help (model tool)": start_seconds(
            shim + [os.path.join(bin_dir, "nnet-forward.py"), "--help"],
            env)}


def recipe_end_to_end(torch, pkg, device, work, native):
    """Phase 18: ``egs/synthetic/run.sh`` stages 0-5 at the flagship widths
    through the shim on cuda (one ``run.sh`` a stage, timed), then the
    recipe's posteriors against a counted in-process forward, and
    ``nnet_decode`` greedy and at beam 4."""
    from lstm_ctc_tpu_torch.bin import nnet_decode, nnet_forward
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import parse_config
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.host.decode import greedy_decode
    from lstm_ctc_tpu_torch.models import apply_model
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint

    here = os.path.dirname(os.path.abspath(__file__))
    shim = os.path.join(here, "lstm_ctc_tpu_torch", "recipe_python.py")
    env = dict(os.environ, FSTBIN=native["dir"],
               PATH=native["dir"] + os.pathsep + os.environ["PATH"],
               PYTHON="%s %s --device cuda" % (sys.executable, shim))
    rwork = os.path.join(work, "recipe")
    say("  native tools: %d built in %.1f s (overlapping the kernels' "
        "build) -> %s" % (len(native["built"]), native["seconds"],
                          native["dir"]))
    starts = tool_start_times(here, env, work)
    say("  start of a tool, one start each (s): %s" % ", ".join(
        "%s %.3f" % kv for kv in starts.items()))
    seconds = {}
    out = ""
    for stage, name in enumerate(RECIPE_STAGES):
        start = time.perf_counter()
        proc = subprocess.run(
            ["bash", os.path.join(here, "egs", "synthetic", "run.sh"),
             "--work", rwork, "--stage", str(stage), "--stop-stage",
             str(stage)] + RECIPE_FLAGS,
            env=env, capture_output=True, text=True, timeout=900)
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            fail("recipe stage %d (%s) exit %d:\n%s\n%s"
                 % (stage, name, proc.returncode, proc.stdout[-2000:],
                    proc.stderr[-2000:]))
        out = proc.stdout
    say("  recipe stages, wall s: %s; total %.1f" % (", ".join(
        "%d %s %.1f" % (i, n, seconds[n])
        for i, n in enumerate(RECIPE_STAGES)), sum(seconds.values())))
    best = re.search(r"best WER =====\n(\S+summary [^\n]*)", out)
    if not best:
        fail("no summary WER line in stage 5's output:\n" + out[-2000:])
    say("  best WER (2 iterations; ~95% expected): " + best.group(1))

    exp = os.path.join(rwork, "exp")
    logs = sorted(os.path.join(base, f) for base, _, files in os.walk(exp)
                  for f in files if f.endswith(".log"))
    model_logs = [os.path.join(exp, f) for f in (
        "nnet.0.cv.log", "nnet.1.tr.log", "nnet.1.cv.log", "nnet.2.tr.log",
        "nnet.2.cv.log")] + [os.path.join(exp, "decode_test", "forward.log")]
    for log in logs:
        text = open(log).read()
        if "Warning" in text:
            fail("%s holds a warning: %s" % (log, text[-800:]))
    for log in model_logs:
        if "INFO:tensorflow:device cuda" not in open(log).read():
            fail("%s does not name the CUDA device" % log)

    # the recipe's posteriors against a counted in-process forward
    config_path = os.path.join(exp, "nnet.config")
    final = os.path.join(exp, open(os.path.join(exp,
                                                "final.nnet")).read().strip())
    decode_dir = os.path.join(exp, "decode_test")
    scp = os.path.join(decode_dir, "tfrecords.scp")
    ark = os.path.join(work, "post_inproc.ark")
    config = parse_config(config_path)
    num_batches = len(build_batcher(scp, config, 16).batch_plan(False, None))
    written, _, launches, _ = run_counted(torch, pkg, lambda: nnet_forward.main(
        [scp, config_path, final, "ark:" + ark, "--apply-log", "true",
         "--class-prior", os.path.join(exp, "label.counts"),
         "--smooth-factor", "1", "--device", "cuda"]))
    want = counts(lstm_fwd=4 * num_batches, moe_fwd=num_batches)
    expect_counts("the in-process forward of final.nnet", launches, want)
    recipe_posts = {k: v for k, v in kaldi.SequentialBaseFloatMatrixReader(
        "scp:" + os.path.join(decode_dir, "post.scp"))}
    posts = read_archive(kaldi, ark)
    if sorted(posts) != sorted(recipe_posts) or written != len(posts):
        fail("the in-process forward's keys differ from the recipe's")
    unequal = [k for k in posts if not np.array_equal(posts[k],
                                                      recipe_posts[k])]
    if unequal:
        worst = max(float(np.abs(posts[k] - recipe_posts[k]).max())
                    for k in unequal)
        fail("the recipe's post.ark differs from the in-process forward "
             "on %d of %d utterances (max |diff| %.3e)"
             % (len(unequal), len(posts), worst))
    say("  the recipe's post.ark = the counted in-process forward of %s, "
        "bit for bit (%d utterances, %d batches; launches %s)"
        % (os.path.basename(final), len(posts), num_batches,
           {k: v for k, v in launches.items() if v}))

    # nnet_decode on the dev records, greedy and at beam 4
    dev = os.path.join(rwork, "records", "dev", "tfrecords.scp")
    keys = sorted(line.split()[0] for line in open(dev) if line.strip())
    hyps = {}
    for beam in (1, 4):
        out_ark = os.path.join(work, "hyp_%d.ark" % beam)
        start = time.perf_counter()
        nnet_decode.main([dev, config_path, final, "ark:" + out_ark,
                          "--beam-width", str(beam), "--device", "cuda"])
        torch.cuda.synchronize()
        took = time.perf_counter() - start
        hyps[beam] = {k: [int(x) for x in v] for k, v in
                      kaldi.SequentialInt32VectorReader("ark:" + out_ark)}
        if sorted(hyps[beam]) != keys:
            fail("nnet_decode --beam-width %d: %d hypotheses for %d keys"
                 % (beam, len(hyps[beam]), len(keys)))
        say("  nnet_decode --beam-width %d: %d hypotheses in %.2f s, %d "
            "labels" % (beam, len(keys), took,
                        sum(len(h) for h in hyps[beam].values())))
    params, state = init_from_config(config, device)
    params, state, _ = load_checkpoint(final, params, state)
    greedy = {}
    with torch.inference_mode():
        for batch in iterate_batches(build_batcher(dev, config, 16),
                                     shuffle=False):
            logits, _, _, _ = apply_model(
                params, state, torch.from_numpy(batch.nnet_input).to(device),
                torch.from_numpy(batch.sequence_length).to(device), config)
            lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
            n = len(batch.keys)
            for key, hyp in zip(batch.keys, greedy_decode(
                    lp[:n], batch.sequence_length[:n])):
                greedy[key] = hyp
    if greedy != hyps[1]:
        fail("nnet_decode's greedy archive differs from greedy_decode of "
             "the same log-posteriors")
    say("  nnet_decode greedy = host.decode.greedy_decode of the same "
        "log-posteriors; beam 4 differs from greedy on %d of %d keys"
        % (sum(hyps[4][k] != hyps[1][k] for k in keys), len(keys)))
    return {"launches": launches, "seconds": seconds, "starts": starts,
            "wer": best.group(1)}


# --- phases 19-20: the bench, profile_step and data parallelism ---

BENCH_ROWS = ("flagship_b32_t384", "flagship_b64_t384",
              "recipe_packed_pf3_b32", "lstm_b32_t384", "cudnnlstm_b32_t384",
              "lstm_bn_b32_t384", "streaming_lstm_b1_chunk16")
PROFILE_SEGMENTS = ("fwd_chain", "fwd_logits", "ctc_fwd", "ctc_fwdbwd",
                    "fwd_loss", "grad", "full_step")
# the steps of a timed window of the bench and of profile_step (both 100
# by default; their rates on the card differ little at 30)
BENCH_STEPS = 30


def port_module(here, module, args, timeout):
    """``python -m module args`` from the checkout; (the process, seconds).
    A non-zero exit fails the phase."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module] + list(args),
                          cwd=here, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        fail("python -m %s exit %d:\n%s\n%s" % (module, proc.returncode,
                                                proc.stdout[-2000:],
                                                proc.stderr[-3000:]))
    return proc, seconds


def bench_on_card(here, kind):
    """Phase 19: ``python -m lstm_ctc_tpu_torch.bench`` at full widths,
    every row's rate finite and above 0, every MFU in (0, 1], the device
    named; then ``profile_step`` at B=32, T=384."""
    proc, seconds = port_module(here, "lstm_ctc_tpu_torch.bench",
                                ["--steps", str(BENCH_STEPS)], 900)
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    rows = result["configs"]
    if tuple(r["config"] for r in rows) != BENCH_ROWS:
        fail("the bench's rows are %s" % [r["config"] for r in rows])
    rates = [r["frames_per_sec"] for r in rows if "frames_per_sec" in r] + [
        rows[-1]["ms_per_chunk"], rows[-1]["real_time_factor"],
        result["value"], result["forward_frames_per_sec"]]
    mfus = [result["mfu"]] + [r["mfu"] for r in rows if "mfu" in r]
    if not all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
               for v in rates):
        fail("the bench has a rate that is not finite and above 0: %s"
             % line)
    if not all(0 < m <= 1 for m in mfus):
        fail("the bench has an MFU outside (0, 1]: %s" % mfus)
    if kind not in result["device"]:
        fail("the bench's device %r does not name %s" % (result["device"],
                                                        kind))
    say("  the bench (python -m lstm_ctc_tpu_torch.bench) in %.1f s:" %
        seconds)
    say(line)
    proc, seconds = port_module(
        here, "lstm_ctc_tpu_torch.scripts.profile_step",
        ["--batch", "32", "--time-steps", "384", "--steps",
         str(BENCH_STEPS)], 600)
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    segments = report["segments_ms"]
    if tuple(segments) != PROFILE_SEGMENTS or not all(
            math.isfinite(v) and v > 0 for v in segments.values()):
        fail("profile_step's segments: %s" % segments)
    kernels = report["full_step_device_ms_by_kernel"] or {}
    if not kernels:
        fail("profile_step's full_step profile saw no kernel")
    say("  profile_step (B=32, T=384) in %.1f s: segments ms %s; "
        "decomposition ms %s; %.1f train frames/s, mfu %.4f; full_step "
        "device %.3f ms, longest kernels: %s"
        % (seconds, segments, report["decomposition_ms"],
           report["train_frames_per_sec"], report["mfu"],
           report["full_step_device_ms"], ", ".join(
               "%s %.3f" % (k[:60], v) for k, v in list(kernels.items())[:6])))
    return {"bench": result, "profile": report}


def dp_config(keep):
    """Phase 20's model: the flagship MoE model at full width in float32."""
    return dict(FLAGSHIP_CONFIG, dropout_rate=keep, compute_dtype="float32",
                store_dtype="float32", packed_slots_rank_major=True)


def dp_steps(torch, pkg, device, work, keep, nudge=False):
    """Two adam steps of the MoE model from ``work``'s weights on its batch
    (pack factor 3, 32 rows): this rank's rows under a process group, else
    the whole batch; optionally from the weights moved one unit in the
    last place.  → {"loss", "size", "counts" (JSON), "p0/<leaf>",
    "p/<leaf>"}, the launches counted around the two steps."""
    from lstm_ctc_tpu_torch import parallel
    from lstm_ctc_tpu_torch.cli import init_from_config
    from lstm_ctc_tpu_torch.models.cells import DropoutStreams
    from lstm_ctc_tpu_torch.train.checkpoint import (flatten_tree,
                                                     load_checkpoint)
    from lstm_ctc_tpu_torch.train.graph import make_train_step
    config = dp_config(keep)
    template, state = init_from_config(config, device)
    base, state, _ = load_checkpoint(os.path.join(work, "init.npz"),
                                     template, state)
    params = fresh_weights(torch, base, torch.Generator(device).manual_seed(
        3) if nudge else None)
    p0 = {k: v.copy() for k, v in flatten_tree(params).items()}
    host = dict(np.load(os.path.join(work, "batch.npz")))
    batch = parallel.shard_batch(host, device)
    init_opt, step = make_train_step(config, 1e-3, "adam")
    opt_state = init_opt(params)
    streams = DropoutStreams.for_rank(device, 1, parallel.rank())

    def two_steps():
        out = []
        for _ in range(2):
            _, _, _, m = step(params, opt_state, state, streams, batch)
            out.append((float(m["loss"]), int(m["size"])))
        return out

    metrics, _, launches, _ = run_counted(torch, pkg, two_steps)
    result = {"loss": np.array([m[0] for m in metrics]),
              "size": np.array([m[1] for m in metrics]),
              "counts": np.array(json.dumps(launches))}
    result.update({"p0/" + k: v for k, v in p0.items()})
    result.update({"p/" + k: v for k, v in flatten_tree(params).items()})
    return result


def port_pkg():
    from lstm_ctc_tpu_torch.host.data import records
    from lstm_ctc_tpu_torch.models import cells, moe
    from lstm_ctc_tpu_torch.ops import (ctc, ctc_kernels, lstm_kernels,
                                        lstm_stack_kernels, moe_kernels)
    return {"cells": cells, "moe": moe, "lstm_kernels": lstm_kernels,
            "moe_kernels": moe_kernels, "records": records, "ctc": ctc,
            "ctc_kernels": ctc_kernels,
            "lstm_stack_kernels": lstm_stack_kernels}


def dp_worker(argv):
    """``chip_smoke.py --dp-worker WORK RANK WORLD BACKEND PORT KEEP``: one
    rank of phase 20's process group on card 0; writes its two steps to
    WORK/BACKEND_rankRANK.npz."""
    import torch
    work, rank, world, backend, port, keep = argv
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.environ.update(WORLD_SIZE=world, RANK=rank, LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from lstm_ctc_tpu_torch import parallel
    device = torch.device("cuda", 0)
    if not parallel.join(device, backend):
        fail("rank %s did not join the %s group" % (rank, backend))
    result = dp_steps(torch, port_pkg(), device, work, float(keep))
    parallel.barrier()
    parallel.leave()
    np.savez(os.path.join(work, "%s_rank%s.npz" % (backend, rank)),
             **result)


def run_ranks(here, work, backend, world, keep):
    """``world`` processes of ``dp_worker`` on card 0, started together
    and all stopped before this returns; each rank's result."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-worker", work,
         str(r), str(world), backend, str(port), str(keep)], cwd=here,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail("%s rank %d of %d exit %d:\n%s" % (backend, r, world,
                                                   p.returncode, log[-3000:]))
    return [dict(np.load(os.path.join(work, "%s_rank%d.npz" % (backend, r))))
            for r in range(world)]


def update_gap(got, ref):
    """(||Δgot − Δref|| / ||Δref||, [(leaf max|diff| / max|Δref|, leaf)]
    worst first) of two runs' parameter updates over their own starts."""
    keys = sorted(k[2:] for k in ref if k.startswith("p/"))
    num = den = 0.0
    leaves = []
    for k in keys:
        d_got = got["p/" + k] - got["p0/" + k]
        d_ref = ref["p/" + k] - ref["p0/" + k]
        num += float(((d_got - d_ref) ** 2).sum())
        den += float((d_ref ** 2).sum())
        leaves.append((float(np.abs(d_got - d_ref).max())
                       / max(float(np.abs(d_ref).max()), 1e-30), k))
    return math.sqrt(num / den), sorted(leaves, reverse=True)


def data_parallel_on_card(torch, pkg, device, work, here):
    """Phase 20: two gloo ranks sharing the card, each on 16 of 32 packed
    rows of the flagship MoE model (float32, TF32 off, keep 1.0), against
    the 1-process steps: the loss within 1e-4, the parameters' update
    within 10x of a last-bit change of the weights, the ranks' weights
    equal, each rank's launches the 1-process step's; then an NCCL group
    of one rank at keep 0.9, bit for bit the 1-process steps."""
    from lstm_ctc_tpu_torch.cli import init_from_config
    from lstm_ctc_tpu_torch.graft_entry import _packed_batch
    from lstm_ctc_tpu_torch.train.checkpoint import save_checkpoint
    dp_dir = os.path.join(work, "dp")
    os.makedirs(dp_dir, exist_ok=True)
    config = dp_config(1.0)
    params, state = init_from_config(config, device)
    save_checkpoint(os.path.join(dp_dir, "init.npz"), params, state)
    np.savez(os.path.join(dp_dir, "batch.npz"),
             **_packed_batch(config, num_rows=32, pack_factor=3))
    one = dp_steps(torch, pkg, device, dp_dir, 1.0)
    nudged = dp_steps(torch, pkg, device, dp_dir, 1.0, nudge=True)
    one_keep = dp_steps(torch, pkg, device, dp_dir, 0.9)
    start = time.perf_counter()
    gloo = run_ranks(here, dp_dir, "gloo", 2, 1.0)
    gloo_s = time.perf_counter() - start
    start = time.perf_counter()
    nccl, = run_ranks(here, dp_dir, "nccl", 1, 0.9)
    nccl_s = time.perf_counter() - start

    want = json.loads(str(one["counts"]))
    for name in ("lstm_fwd", "lstm_bwd", "moe_fwd_stash", "moe_bwd",
                 "ctc_alpha", "ctc_beta"):
        if want[name] == 0:
            fail("the 1-process steps launched no %s" % name)
    for r, res in enumerate(gloo):
        got = json.loads(str(res["counts"]))
        if got != want:
            fail("gloo rank %d launched %s, the 1-process steps %s"
                 % (r, got, want))
    loss_rel = float(np.max(np.abs(gloo[0]["loss"] - one["loss"])
                            / np.abs(one["loss"])))
    grad_rel, leaves = update_gap(gloo[0], one)
    n_rel, n_leaves = update_gap(nudged, one)
    say("  two gloo ranks on one card (16 rows each, f32, %.1f s): loss %s "
        "vs 1-process %s (rel %.3e, bound %.0e); sizes %s vs %s"
        % (gloo_s, gloo[0]["loss"].tolist(), one["loss"].tolist(), loss_rel,
           STEP_LOSS_TOL, gloo[0]["size"].tolist(), one["size"].tolist()))
    say("  parameter update after 2 steps, ranks vs 1-process: "
        "||diff||/||update|| %.3e (bound %.3e), worst leaf %s %.3e (bound "
        "%.3e); the 1-process steps from weights moved one unit in the "
        "last place: %.3e, worst leaf %s %.3e"
        % (grad_rel, STEP_NUDGE_FACTOR * n_rel, leaves[0][1], leaves[0][0],
           STEP_NUDGE_FACTOR * n_leaves[0][0], n_rel, n_leaves[0][1],
           n_leaves[0][0]))
    if (loss_rel > STEP_LOSS_TOL or gloo[0]["size"].tolist()
            != one["size"].tolist()
            or grad_rel > STEP_NUDGE_FACTOR * n_rel
            or leaves[0][0] > STEP_NUDGE_FACTOR * n_leaves[0][0]):
        fail("two data-parallel ranks differ from the 1-process steps by "
             "more than the float32 train-step bounds")
    unequal = [k for k in gloo[0] if k.startswith("p/")
               and not np.array_equal(gloo[0][k], gloo[1][k])]
    if unequal:
        fail("the two ranks' weights differ after 2 steps: %s" % unequal[:4])
    nccl_counts = json.loads(str(nccl["counts"]))
    same = [k for k in one_keep if k.startswith("p/")
            and np.array_equal(nccl[k], one_keep[k])]
    say("  NCCL group of 1 rank (keep 0.9, %.1f s): loss %s vs 1-process "
        "%s; %d of %d weight leaves bit-equal; launches %s"
        % (nccl_s, nccl["loss"].tolist(), one_keep["loss"].tolist(),
           len(same), sum(k.startswith("p/") for k in one_keep),
           {k: v for k, v in nccl_counts.items() if v}))
    if (not np.array_equal(nccl["loss"], one_keep["loss"])
            or len(same) != sum(k.startswith("p/") for k in one_keep)
            or nccl_counts != json.loads(str(one_keep["counts"]))):
        fail("the NCCL group of one rank is not the 1-process steps bit "
             "for bit")
    launches = dict(want)
    for res in gloo + [nccl, one_keep, nudged]:
        for k, v in json.loads(str(res["counts"])).items():
            launches[k] += v
    return {"launches": launches, "loss_rel": loss_rel,
            "update_rel": grad_rel, "gloo_s": gloo_s, "nccl_s": nccl_s}


@contextlib.contextmanager
def plain_on_card(module, name, seen):
    """Record in ``seen`` each call of the plain recurrence ``module.name``
    given a tensor on the card."""
    real = getattr(module, name)

    def watched(*args, **kwargs):
        if any(getattr(a, "is_cuda", False) for a in args):
            seen.append(name)
        return real(*args, **kwargs)

    with mock.patch.object(module, name, watched):
        yield


def counted_entry(torch, pkg, what, fn, want, watch, launches=None,
                  allowed=()):
    """Run an entry point from zero counts, with the route warnings of this
    process forgotten and under ``watch(seen)`` (a context that lists in
    ``seen`` each plain recurrence run on the card): it must warn of no
    route but the reasons ``allowed``, run none and launch ``want``; its
    launches are added to ``launches`` when given.  Returns (its log, its
    seconds)."""
    from lstm_ctc_tpu_torch.ops import route
    warned, seen = set(), []  # the reasons the routes warn of
    with mock.patch.object(route, "_warned", warned), watch(seen):
        _, tee, got, seconds = run_counted(torch, pkg, fn)
    warned -= set(allowed)
    if warned or seen:
        fail("%s at the wide widths warned of routes %s and ran a plain "
             "recurrence on the card %d times" % (what, sorted(warned),
                                                   len(seen)))
    expect_counts(what, got, want)
    if launches is not None:
        for k in KERNEL_NAMES:
            launches[k] += got[k]
    say("  %s: %.1f s; launches %s" % (what, seconds, {
        k: v for k, v in got.items() if v}))
    return tee, seconds


# --- phase 21: Kaldi's BLSTMP widths through 16-block K1 and K2 ---

# the flagship treatment model at the cell and projection widths of Kaldi's
# nnet3 (B)LSTMP recipes for Switchboard (cell-dim 1024, recurrent
# projection 256): layers 2-4 fed 512 wide, the MoE head at D = 512
WIDE_CONFIG = dict(FLAGSHIP_CONFIG, num_neurons=1024, num_projects=256)
WIDE_STEPS = 3


def wide_end_to_end(torch, pkg, device, work, scp, rng):
    """Phase 21: the wide model through nnet_init, nnet_train (WIDE_STEPS
    steps, then as many with lstm_fold_dx = true) and nnet_forward on 64
    utterances, bf16, on phase 8's corpus: each run counted from zero (K1
    and K2 once a layer a step, K3 on layers 2-4 with the fold), no route
    warning and no plain recurrence on the card, finite losses and
    weights; then float32 log-posteriors against the plain versions'."""
    from lstm_ctc_tpu_torch.bin import nnet_forward, nnet_init, nnet_train
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import param_leaves
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    wdir = os.path.join(work, "wide")
    os.makedirs(wdir)
    configs = {"bf16": WIDE_CONFIG,
               "fold": dict(WIDE_CONFIG, lstm_fold_dx=True),
               "f32": dict(WIDE_CONFIG, compute_dtype="float32")}
    paths = {}
    for name, config in configs.items():
        paths[name] = os.path.join(wdir, "nnet_%s.config" % name)
        with open(paths[name], "w") as fh:
            fh.write(format_config(config))
    units, out_dim = WIDE_CONFIG["num_neurons"], WIDE_CONFIG["num_projects"]
    for which, kernel in (("forward", "K1"), ("backward", "K2")):
        how = getattr(lstm_kernels, which + "_config")(
            device, 32, units, out_dim, True, torch.bfloat16)
        say("  %s at H=%d P=%d, B=32, bf16: %s"
            % (kernel, units, out_dim, launch_line(how)))
        if how["blocks"] != 16:
            fail("%s at Kaldi's BLSTMP widths has %d blocks a cluster, not "
                 "16" % (kernel, how["blocks"]))
    sub_scp, batcher = fold_subset(wdir, scp, WIDE_CONFIG, WIDE_STEPS,
                                   "wide.scp")
    steps = len(batcher.batch_plan(True, 777))
    cv_batches = len(build_batcher(sub_scp, WIDE_CONFIG, 32).batch_plan(
        False, None))
    common = ["--objective", "ctc", "--batch-size", "32", "--device",
              "cuda", "--report-interval", "0"]
    result = {"launches": counts()}

    def counted(what, fn, want):
        return counted_entry(
            torch, pkg, what, fn, want,
            lambda seen: plain_on_card(cells, "dual_recurrence", seen),
            result["launches"])

    nnets = [os.path.join(wdir, "nnet%d.npz" % i) for i in range(3)]
    tee, _ = counted("nnet_init", lambda: nnet_init.main(
        [sub_scp, paths["bf16"], nnets[0]] + common), counts(
            lstm_fwd=4 * cv_batches, moe_fwd=cv_batches,
            ctc_alpha=cv_batches))
    losses = [tee.value("cv_loss")]
    train_args = ["--optimizer", "adam", "--learn-rate", "1e-3",
                  "--pack-factor", "3"]
    metrics_file = os.path.join(wdir, "metrics.jsonl")
    tee, _ = counted("nnet_train", lambda: nnet_train.main(
        [sub_scp, paths["bf16"], nnets[0], nnets[1], "--metrics-file",
         metrics_file] + train_args + common), counts(
            lstm_fwd=4 * steps, lstm_bwd=4 * steps, moe_fwd_stash=steps,
            moe_bwd=steps, ctc_alpha=steps, ctc_beta=steps))
    losses.append(tee.value("tr_loss"))
    # layers 2-4 (fed 2P = 512 wide, a multiple of 128) fold; layer 1 (fed
    # the 120-wide spliced input) trains through K2
    tee, _ = counted("nnet_train with lstm_fold_dx", lambda: nnet_train.main(
        [sub_scp, paths["fold"], nnets[1], nnets[2]] + train_args + common),
        counts(lstm_fwd=4 * steps, lstm_bwd=steps, lstm_bwd_fold=3 * steps,
               moe_fwd_stash=steps, moe_bwd=steps, ctc_alpha=steps,
               ctc_beta=steps))
    losses.append(tee.value("tr_loss"))
    with open(metrics_file) as fh:
        result.update(step_stats([json.loads(ln) for ln in fh], batcher))
    template, state = init_from_config(WIDE_CONFIG, device)
    for path in nnets:
        params, _, _ = load_checkpoint(path, template, state)
        if not all(torch.isfinite(p).all() for p in param_leaves(params)):
            fail("%s holds non-finite weights" % path)
    if not all(math.isfinite(v) for v in losses):
        fail("non-finite losses at the wide widths: %s" % losses)
    say("  cv_loss %.4f, tr_loss %.4f, tr_loss with the fold %.4f (%d steps "
        "each, %d utterances, pack factor 3); median train step %.1f ms, "
        "%.1f real frames/s (packing fill %.3f)" % (tuple(losses) + (
            steps, len(batcher._lengths), result["step_ms"], result["fps"],
            result["fill"])))

    # serving: 64 utterances, bf16, as a user runs it
    scp64, raw_lengths = write_corpus(pkg, wdir, rng)
    fwd_batches = len(build_batcher(scp64, WIDE_CONFIG, 32).batch_plan(
        False, None))
    ark = os.path.join(wdir, "post.ark")
    _, seconds = counted("nnet_forward", lambda: nnet_forward.main(
        [scp64, paths["bf16"], nnets[2], "ark:" + ark, "--device", "cuda",
         "--batch-size", "32"]), counts(lstm_fwd=4 * fwd_batches,
                                        moe_fwd=fwd_batches))
    posts = read_archive(kaldi, ark)
    check_posteriors(posts, raw_lengths)
    frames = sum(m.shape[0] for m in posts.values())
    result["forward_fps"] = frames / seconds
    say("  nnet_forward: %d utterances, %d frames in %.2f s (%.1f frames/s, "
        "checkpoint load included)" % (len(posts), frames, seconds,
                                       result["forward_fps"]))

    # float32 through the kernels against the plain versions
    ark32 = os.path.join(wdir, "post_f32.ark")
    nnet_forward.main([scp64, paths["f32"], nnets[2], "ark:" + ark32,
                       "--device", "cuda", "--batch-size", "32"])
    params, _, _ = load_checkpoint(nnets[2], template, state)
    ref32 = plain_logposts(torch, pkg, params, state, build_batcher(
        scp64, configs["f32"], 32), configs["f32"], device)
    worst32, mean32 = diff_stats(read_archive(kaldi, ark32), ref32)
    say("  float32 kernels vs plain versions, log-posteriors: max_abs %.3e "
        "mean_abs %.3e (bounds %.0e, %.0e)" % (worst32, mean32,
                                               E2E_F32_MAX_TOL,
                                               E2E_F32_MEAN_TOL))
    if mean32 > E2E_F32_MEAN_TOL or worst32 > E2E_F32_MAX_TOL:
        fail("wide float32 log-posteriors differ from the plain versions by "
             "%.3e on average, %.3e at most" % (mean32, worst32))
    return result


# --- phase 24: the streamed plan of K1, K2 and K3 end to end ---

# the flagship treatment model with its recipes' two width keys widened
# together, num_neurons = num_projects = 1024, i.e. no projection (layers
# 2-4 fed 2048 wide, the MoE head at D = 2048): bf16 slices that fit no
# resident plan; and the lstm family at Sak, Senior and Beaufays' LSTMP
# widths (2048 cells, projection 512), past K12's 1024 units, so layer by
# layer on K1 and K2
STREAMED_CONFIG = dict(FLAGSHIP_CONFIG, num_neurons=1024, num_projects=0)
STREAMED_LSTM_CONFIG = dict(FLAGSHIP_CONFIG, nnet_type="lstm",
                            num_neurons=2048, num_projects=512)
# ... and the cudnnlstm family at H = P = 1024 (both on the streamed K12
# and K13): train steps, utterances served, a streaming session's
SAK_STEPS = 2
STREAMED_CUDNN_CONFIG = dict(CUDNN_CONFIG, num_neurons=1024)
SAK_UTTERANCES = 16
SAK_SESSION = 4


@contextlib.contextmanager
def plain_recurrence_route():
    """The parent's route for a layer of 1024 units without a projection:
    K1 had no plan for it, so the layer kernels refused it and the plain
    recurrence ran under autograd."""
    from lstm_ctc_tpu_torch.ops import lstm_kernels
    with mock.patch.object(lstm_kernels, "layer_eligible",
                           lambda *args, **kwargs: False):
        yield


def check_forced_plans(torch, pkg, device, rng):
    """Phase 7: the streamed plan forced (lstm_kernels' internal ``_plan``)
    where a resident plan fits, at the flagship width (8 blocks), at H = P
    = 512 and at H = 1024, P = 256 (16), B = 32, T = 384, bf16, resets, at
    the resident plan's R as its launcher picks it, with half of wh's steps
    resident (the ring streams wh and proj), with all of them (the ring
    streams proj's rows only; where they do not all fit beside the ring the
    launch is refused on the host, before any launch, and said so) and
    with as many as fit: K1's outputs and states and K2's dgates and
    weight gradients bit-equal to the resident plan's; then the streamed
    plan holding as much of wh as fits (and all of it, where that fits)
    timed in turns with the resident plan: what the resident bodies save.
    Returns {shape: {plan: (K1 ms, resident ms, K2 ms, resident ms)}}."""
    lk = pkg["lstm_kernels"]
    bf16 = torch.bfloat16
    plans = (("streamed", "half of wh resident"),
             ("streamed, wh held", "all of wh resident"),
             ("streamed, wh held as fits", "as much of wh resident as fits"))
    times = {}
    for shape in (FLAGSHIP_LAYER, (512, 512, 1024), (1024, 256, 512)):
        args = lstm_bwd_case(torch, pkg, device, bf16, True, rng, shape=shape)
        units, out_dim = shape[:2]
        rows = [getattr(lk, which + "_config")(
            device, 32, units, out_dim, True, bf16)["rows"]
            for which in ("forward", "backward")]

        def fwd(plan):
            return lk.lstm_layer_forward(*args[:7], states=True,
                                         store_dtype=bf16,
                                         _plan=(plan, rows[0]))

        def bwd(plan):
            return lk.lstm_layer_backward(*args, store_dtype=bf16,
                                          _plan=(plan, rows[1]))

        def refused(run, plan):
            try:
                return run(plan)
            except RuntimeError as err:
                if plan != plans[1][0] or "invalid configuration" not in str(
                        err):
                    raise
                return None

        name = layer_name(bf16, shape)
        fwd_ref, bwd_ref = fwd("resident"), bwd("resident")
        timed = []
        for plan, what in plans:
            got_fwd, got_bwd = refused(fwd, plan), refused(bwd, plan)
            same_fwd = got_fwd is None or all(
                torch.equal(a, b) for a, b in zip(fwd_ref, got_fwd))
            same_bwd = got_bwd is None or all(
                (a is None and b is None) or torch.equal(a, b)
                for a, b in zip(bwd_ref, got_bwd))
            torch.cuda.synchronize()
            say("  the streamed plan forced at %s (%s): K1 at R=%d %s; K2 "
                "at R=%d %s"
                % (name, what, rows[0],
                   "bit-equal to the resident plan: %s" % same_fwd
                   if got_fwd is not None else "refused (no room)",
                   rows[1], "bit-equal: %s" % same_bwd
                   if got_bwd is not None else "refused (no room)"))
            if not (same_fwd and same_bwd):
                fail("the streamed plan differs from the resident plan at %s"
                     % name)
            if plan != "streamed" and got_fwd is not None \
                    and got_bwd is not None:
                timed.append((plan, what))
        times[shape] = {}
        for plan, what in timed:
            k1_ms, k1_res = time_in_turns(
                torch, lambda: fwd(plan), lambda: fwd("resident"), rounds=5,
                kernel_reps=1)
            k2_ms, k2_res = time_in_turns(
                torch, lambda: bwd(plan), lambda: bwd("resident"), rounds=5,
                kernel_reps=1)
            times[shape][what] = (k1_ms, k1_res, k2_ms, k2_res)
            say("  the streamed plan with %s at %s, in turns with the "
                "resident plan at the same R: K1 %.3f ms vs %.3f (%+.1f%%); "
                "K2 %.3f ms vs %.3f (%+.1f%%)"
                % (what, name, k1_ms, k1_res, 100 * (k1_ms / k1_res - 1),
                   k2_ms, k2_res, 100 * (k2_ms / k2_res - 1)))
    return times


ROUTE_STEPS = 3  # the plain recurrence's steps timed in phase 24


def streamed_step(torch, pkg, device, config, nnet, batcher, step_ms):
    """One packed bf16 step of ``config`` from the weights in ``nnet``:
    K2, K5 and K6 held to their plain versions on the step's own tensors
    (K2's dgates against the float64 replay of each step), then the step
    profiled, and the same step on the parent's route (the plain
    recurrence) on the host clock, the median of ROUTE_STEPS after a
    warm-up step, as the kernels' median step (profiling its many
    thousands of small launches would cost the run minutes).  Returns (device ms, the route's
    host ms)."""
    from lstm_ctc_tpu_torch.cli import init_from_config, make_shard_fn
    from lstm_ctc_tpu_torch.host.data import iterate_batches
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import make_train_step
    batch = make_shard_fn(device)(next(iter(iterate_batches(
        batcher, shuffle=True, seed=777))))
    train_config = dict(config, packed_slots_rank_major=True)
    template, state = init_from_config(config, device)
    base, _, _ = load_checkpoint(nnet, template, state)
    init_opt, step = make_train_step(train_config, 1e-3, "adam")
    worst = {"lstm_bwd": 0.0, "moe_fwd_stash": 0.0, "moe_bwd": 0.0}
    params = fresh_weights(torch, base)
    with held_in_training(torch, pkg, worst):
        step(params, init_opt(params), {},
             torch.Generator(device).manual_seed(1), batch)
        torch.cuda.synchronize()
    say("  bfloat16 train step, each launch vs its plain version: K2 "
        "per-step carries max rel %.3e (bound %.0e), %s; K5 out max_abs "
        "%.3e (bound %.0e), %s; K6 dx/dgate max rel %.3e (bound %.0e)"
        % (worst["lstm_bwd"], BF16_STEP_REL_TOL, dgates_line(worst),
           worst["moe_fwd_stash"], BF16_ABS_TOL, th_line(worst),
           worst["moe_bwd"], BF16_MOE_REL_TOL))
    busy = profile_step(torch, init_opt, step, fresh_weights(torch, base),
                        batch, device, step_ms)
    route = []
    with plain_recurrence_route():
        for _ in range(1 + ROUTE_STEPS):  # a warm-up step first
            params = fresh_weights(torch, base)
            torch.cuda.synchronize()
            start = time.perf_counter()
            step(params, init_opt(params), {},
                 torch.Generator(device).manual_seed(2), batch)
            torch.cuda.synchronize()
            route.append(1e3 * (time.perf_counter() - start))
    route_ms = statistics.median(route[1:])
    say("  the same step on the parent's route (the plain recurrence), on "
        "the host clock: median %.1f ms of %d steps after a warm-up step "
        "(%s ms)" % (route_ms, ROUTE_STEPS,
                     ", ".join("%.1f" % v for v in route)))
    return busy, route_ms


def streamed_end_to_end(torch, pkg, device, work, scp, rng):
    """Phase 24: STREAMED_CONFIG through nnet_init, WIDE_STEPS packed steps
    of nnet_train, one with lstm_fold_dx = true (K3 on layers 2-4) and
    nnet_forward on 64 utterances, bf16, on phase 8's corpus, on the
    streamed plan: each run counted from zero (K1 and K2 once a layer a
    step), no route warning and no plain recurrence on the card, finite
    losses and weights, the archive checked; one step held and profiled
    beside the parent's route (streamed_step); then the stack families on
    the streamed K12 and K13 (sak_end_to_end)."""
    from lstm_ctc_tpu_torch.bin import nnet_forward, nnet_init, nnet_train
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.models import lstm
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import param_leaves
    cells, lk = pkg["cells"], pkg["lstm_kernels"]
    sdir = os.path.join(work, "streamed")
    os.makedirs(sdir)
    configs = {"bf16": STREAMED_CONFIG,
               "fold": dict(STREAMED_CONFIG, lstm_fold_dx=True)}
    paths = {}
    for name, config in configs.items():
        paths[name] = os.path.join(sdir, "nnet_%s.config" % name)
        with open(paths[name], "w") as fh:
            fh.write(format_config(config))
    for config in (STREAMED_CONFIG, STREAMED_LSTM_CONFIG):
        units = config["num_neurons"]
        out_dim = config["num_projects"] or units
        for which, kernel in (("forward", "K1"), ("backward", "K2")):
            how = getattr(lk, which + "_config")(
                device, 32, units, out_dim, bool(config["num_projects"]),
                torch.bfloat16)
            say("  %s at %s H=%d P=%d, B=32, bf16: %s"
                % (kernel, config["nnet_type"], units, out_dim,
                   launch_line(how)))
            if not how["streamed"] or how["blocks"] != 16:
                fail("%s at H=%d P=%d is not on the streamed plan"
                     % (kernel, units, out_dim))
    sub_scp, batcher = fold_subset(sdir, scp, STREAMED_CONFIG, WIDE_STEPS,
                                   "streamed.scp")
    steps = len(batcher.batch_plan(True, 777))
    one_scp, one = fold_subset(sdir, scp, STREAMED_CONFIG, 1, "one.scp")
    one_steps = len(one.batch_plan(True, 777))
    cv_batches = len(build_batcher(sub_scp, STREAMED_CONFIG, 32).batch_plan(
        False, None))
    common = ["--objective", "ctc", "--batch-size", "32", "--device",
              "cuda", "--report-interval", "0"]
    result = {"launches": counts()}

    @contextlib.contextmanager
    def watch(seen):
        with plain_on_card(cells, "dual_recurrence", seen), \
                plain_on_card(lstm, "dual_recurrence", seen), \
                plain_on_card(lstm, "lstm_scan", seen):
            yield

    def counted(what, fn, want, allowed=()):
        return counted_entry(torch, pkg, what, fn, want, watch,
                             result["launches"], allowed)

    nnets = [os.path.join(sdir, "nnet%d.npz" % i) for i in range(3)]
    tee, _ = counted("nnet_init", lambda: nnet_init.main(
        [sub_scp, paths["bf16"], nnets[0]] + common), counts(
            lstm_fwd=4 * cv_batches, moe_fwd=cv_batches,
            ctc_alpha=cv_batches))
    losses = [tee.value("cv_loss")]
    train_args = ["--optimizer", "adam", "--learn-rate", "1e-3",
                  "--pack-factor", "3"]
    metrics_file = os.path.join(sdir, "metrics.jsonl")
    tee, _ = counted("nnet_train", lambda: nnet_train.main(
        [sub_scp, paths["bf16"], nnets[0], nnets[1], "--metrics-file",
         metrics_file] + train_args + common), counts(
            lstm_fwd=4 * steps, lstm_bwd=4 * steps, moe_fwd_stash=steps,
            moe_bwd=steps, ctc_alpha=steps, ctc_beta=steps))
    losses.append(tee.value("tr_loss"))
    with open(metrics_file) as fh:
        result.update(step_stats([json.loads(ln) for ln in fh], batcher))
    # layers 2-4 (fed 2048 wide) fold; layer 1 (120 wide) through K2
    tee, _ = counted("nnet_train with lstm_fold_dx", lambda: nnet_train.main(
        [one_scp, paths["fold"], nnets[1], nnets[2]] + train_args + common),
        counts(lstm_fwd=4 * one_steps, lstm_bwd=one_steps,
               lstm_bwd_fold=3 * one_steps, moe_fwd_stash=one_steps,
               moe_bwd=one_steps, ctc_alpha=one_steps, ctc_beta=one_steps))
    losses.append(tee.value("tr_loss"))
    template, state = init_from_config(STREAMED_CONFIG, device)
    for path in nnets:
        params, _, _ = load_checkpoint(path, template, state)
        if not all(torch.isfinite(p).all() for p in param_leaves(params)):
            fail("%s holds non-finite weights" % path)
    say("  cv_loss %.4f, tr_loss %.4f (%d steps, %d utterances, pack factor "
        "3), with the fold %.4f (%d step); median train step %.1f ms, %.1f "
        "real frames/s (packing fill %.3f)" % (
            losses[0], losses[1], steps, len(batcher._lengths), losses[2],
            one_steps, result["step_ms"], result["fps"], result["fill"]))
    result["device_ms"], result["route_ms"] = streamed_step(
        torch, pkg, device, STREAMED_CONFIG, nnets[1], batcher,
        result["step_ms"])

    # serving: 64 utterances, bf16, as a user runs it
    scp64, raw_lengths = write_corpus(pkg, sdir, rng)
    fwd_batches = len(build_batcher(scp64, STREAMED_CONFIG, 32).batch_plan(
        False, None))
    ark = os.path.join(sdir, "post.ark")
    _, seconds = counted("nnet_forward", lambda: nnet_forward.main(
        [scp64, paths["bf16"], nnets[1], "ark:" + ark, "--device", "cuda",
         "--batch-size", "32"]), counts(lstm_fwd=4 * fwd_batches,
                                        moe_fwd=fwd_batches))
    frames = check_posteriors(read_archive(kaldi, ark), raw_lengths)
    result["forward_fps"] = frames / seconds
    say("  nnet_forward: 64 utterances, %d frames in %.2f s (%.1f frames/s, "
        "checkpoint load included)" % (frames, seconds,
                                       result["forward_fps"]))

    # the lstm family at Sak's LSTMP widths (2048 cells, projection 512)
    # and the cudnnlstm family at H = P = 1024 on the streamed K12 and
    # K13, and a streaming session beside the parent's route (each layer
    # the plain scan)
    if not all(math.isfinite(v) for v in losses):
        fail("non-finite losses on the streamed plan: %s" % losses)
    result["sak"] = stack_families_end_to_end(
        torch, pkg, device, os.path.join(sdir, "sak"), scp, rng,
        STREAMED_LSTM_CONFIG, STREAMED_CUDNN_CONFIG, SAK_STEPS,
        SAK_UTTERANCES, True, False)
    result["sak"]["session"] = wide_session(torch, pkg, device, rng,
                                            STREAMED_LSTM_CONFIG, SAK_SESSION)
    return result


def stack_families_end_to_end(torch, pkg, device, wdir, scp, rng, config,
                              cudnn_config, train_steps, utterances, streamed,
                              plain_f32):
    """Phases 22 and 24: the lstm family at ``config``'s widths (MoE head)
    and a ``cudnn_config`` cudnnlstm on the stack kernels, bf16: through
    nnet_init, ``train_steps`` unpacked nnet_train steps (keep 0.9),
    nnet_forward on ``utterances`` utterances offline and --streaming (the
    lstm family also in float32), each run counted from zero (per train
    step 1 K12, 1 K13, 1 K5, 1 K6, 1 K10, 1 K11; per CV or forward batch 1
    K12, 1 K4 and, in CV, 1 K10; per streamed chunk 1 K12 and 1 K4), no
    route warning, no K1 or K2 and no plain scan on the card, the plans
    16-block (on the streamed plan where ``streamed``); streamed against
    offline log-posteriors in both dtypes (and, with ``plain_f32``, the
    float32 ones against the plain versions'); beside the train step and
    the forward, the parent's route timed (layer by layer through K1 and
    K2)."""
    from lstm_ctc_tpu_torch.bin import nnet_forward, nnet_init, nnet_train
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.models import lstm
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import param_leaves
    sk = pkg["lstm_stack_kernels"]
    os.makedirs(wdir)
    configs = {"bf16": config,
               "f32": dict(config, compute_dtype="float32"),
               "cudnn": cudnn_config}
    paths = {}
    for name, cfg in configs.items():
        paths[name] = os.path.join(wdir, "nnet_%s.config" % name)
        with open(paths[name], "w") as fh:
            fh.write(format_config(cfg))
    name = "lstm %d/%d" % (config["num_neurons"], config["num_projects"])
    cname = "cudnnlstm %d" % cudnn_config["num_neurons"]
    for backward, kernel in ((False, "K12"), (True, "K13")):
        for cfg in (config, cudnn_config):
            units = cfg["num_neurons"]
            out_dim = cfg["num_projects"] or units
            how = sk.stack_config(device, 384 + STACK_LAYERS - 1,
                                  STACK_LAYERS, 32, units, out_dim,
                                  bool(cfg["num_projects"]),
                                  torch.bfloat16, backward, torch.bfloat16)
            say("  %s at %s H=%d P=%d, B=32, T=384, bf16: %s plan, %d "
                "blocks a cluster, R=%d, %d clusters in %d wave(s), %d "
                "resident at once, lag K=%d, %d bytes of shared memory a "
                "block, weights a block %d bytes held, %d streamed a step"
                % (kernel, cfg["nnet_type"], units, out_dim,
                   "streamed" if how["streamed"] else "resident",
                   how["blocks"], how["rows"], STACK_LAYERS * how["tiles"],
                   how["waves"], how["resident"], how["lag"],
                   how["smem_bytes"], how["held_bytes"],
                   how["streamed_bytes"]))
            if how["blocks"] != 16 or how["streamed"] != streamed:
                fail("%s at H=%d P=%d: %d blocks a cluster, streamed %s "
                     "(expected 16, %s)" % (kernel, units, out_dim,
                                            how["blocks"], how["streamed"],
                                            streamed))
    sub_scp, batcher = fold_subset(wdir, scp, config, train_steps,
                                   "train.scp", pack_factor=1)
    steps = len(batcher.batch_plan(True, 777))
    cv_batches = len(build_batcher(sub_scp, config, 32).batch_plan(
        False, None))
    frames = sum(batcher._lengths)
    common = ["--objective", "ctc", "--batch-size", "32", "--device",
              "cuda", "--report-interval", "0"]
    result = {"launches": counts(), "cudnn_launches": counts()}

    @contextlib.contextmanager
    def watch(seen, parent=False):
        with parent_route() if parent else contextlib.nullcontext(), \
                plain_on_card(lstm, "lstm_scan", seen):
            yield

    def counted(what, fn, want, parent=False, into="launches"):
        """counted_entry with no plain scan on the card; on the parent's
        route the launches are not added to ``into``."""
        return counted_entry(torch, pkg, what, fn, want,
                             lambda seen: watch(seen, parent),
                             None if parent else result[into])

    nnets = [os.path.join(wdir, "nnet%d.npz" % i) for i in range(3)]
    tee, _ = counted("%s nnet_init" % name, lambda: nnet_init.main(
        [sub_scp, paths["bf16"], nnets[0]] + common), counts(
            lstm_stack_fwd=cv_batches, moe_fwd=cv_batches,
            ctc_alpha=cv_batches))
    losses = [tee.value("cv_loss")]
    train_counts = dict(moe_fwd_stash=steps, moe_bwd=steps, ctc_alpha=steps,
                        ctc_beta=steps)
    stats = {}
    for tag, parent, out, want in (
            ("stack", False, nnets[1], counts(lstm_stack_fwd=steps,
                                              lstm_stack_bwd=steps,
                                              **train_counts)),
            ("route", True, nnets[2], counts(lstm_fwd=STACK_LAYERS * steps,
                                             lstm_bwd=STACK_LAYERS * steps,
                                             **train_counts))):
        metrics_file = os.path.join(wdir, "metrics_%s.jsonl" % tag)
        tee, _ = counted(
            "%s nnet_train%s" % (name, " on the parent's route" if parent
                                 else ""),
            lambda: nnet_train.main(
                [sub_scp, paths["bf16"], nnets[0], out, "--metrics-file",
                 metrics_file, "--optimizer", "adam", "--learn-rate",
                 "1e-3"] + common), want, parent)
        losses.append(tee.value("tr_loss"))
        with open(metrics_file) as fh:
            times = [json.loads(ln)["step_time"] for ln in fh]
        stats[tag] = (1e3 * statistics.median(times), frames / sum(times))
    result["step_ms"], result["fps"] = stats["stack"]
    result["route_step_ms"], result["route_fps"] = stats["route"]
    template, state = init_from_config(config, device)
    for path in nnets:
        params, _, _ = load_checkpoint(path, template, state)
        if not all(torch.isfinite(p).all() for p in param_leaves(params)):
            fail("%s holds non-finite weights" % path)
    say("  %s: cv_loss %.4f, tr_loss %.4f (the parent's route from the same "
        "weights %.4f; %d steps of 32 unpacked utterances, keep 0.9); "
        "median train step %.1f ms, %.1f real frames/s; on the parent's "
        "route (layer by layer through K1 and K2) %.1f ms, %.1f real "
        "frames/s" % ((name,) + tuple(losses) + (
            steps, result["step_ms"], result["fps"], result["route_step_ms"],
            result["route_fps"])))

    # serving: offline and streamed, as a user runs them
    scp_s, raw_lengths = write_corpus(pkg, wdir, rng, count=utterances)
    fwd_batches = len(build_batcher(scp_s, config, 32).batch_plan(False,
                                                                  None))
    chunks = sum(-(-(n // 3) // CHUNK_ROWS) for n in raw_lengths.values())
    streaming_args = ["--streaming", "true", "--chunk-frames",
                      str(CHUNK_ROWS)]

    def forward(tag, nnet, streaming, what, want, into="launches"):
        """nnet_forward of ``nnet`` on the corpus, counted; (its archive,
        its seconds)."""
        ark = os.path.join(wdir, "post_%s%s.ark"
                           % (tag, "_stream" if streaming else ""))
        _, seconds = counted(
            "%s nnet_forward %s%s" % (what, tag, " --streaming" if streaming
                                      else ""),
            lambda: nnet_forward.main(
                [scp_s, paths[tag], nnet, "ark:" + ark, "--device", "cuda",
                 "--batch-size", "32"] + (streaming_args if streaming
                                          else [])), want, into=into)
        posts = read_archive(kaldi, ark)
        check_posteriors(posts, raw_lengths)
        return posts, seconds

    def streamed_vs_offline(posts):
        worst, mean = diff_stats(posts[True], posts[False])
        scale = max(float(np.abs(m).max()) for m in posts[False].values())
        return worst, mean, worst / scale

    posts, seconds = {}, {}
    for tag in ("bf16", "f32"):
        for streaming in (False, True):
            posts[(tag, streaming)], seconds[(tag, streaming)] = forward(
                tag, nnets[1], streaming, name,
                counts(lstm_stack_fwd=chunks, moe_fwd=chunks) if streaming
                else counts(lstm_stack_fwd=fwd_batches, moe_fwd=fwd_batches))
    total = sum(m.shape[0] for m in posts[("bf16", False)].values())
    result["forward_fps"] = total / seconds[("bf16", False)]
    result["stream_chunk_ms"] = 1e3 * seconds[("bf16", True)] / chunks
    _, route_s = counted("%s nnet_forward on the parent's route" % name,
                         lambda: nnet_forward.main(
                             [scp_s, paths["bf16"], nnets[1],
                              "ark:" + os.path.join(wdir, "route.ark"),
                              "--device", "cuda", "--batch-size", "32"]),
                         counts(lstm_fwd=STACK_LAYERS * fwd_batches,
                                moe_fwd=fwd_batches), parent=True)
    result["route_forward_fps"] = total / route_s
    stream = {tag: streamed_vs_offline({s: posts[(tag, s)]
                                        for s in (False, True)})
              for tag in ("bf16", "f32")}
    plain_line = ""
    if plain_f32:
        params, _, _ = load_checkpoint(nnets[1], template, state)
        ref32 = plain_logposts(torch, pkg, params, state, build_batcher(
            scp_s, configs["f32"], 32), configs["f32"], device)
        worst32, mean32 = diff_stats(posts[("f32", False)], ref32)
        plain_line = ("; float32 kernels vs plain versions, log-posteriors: "
                      "max_abs %.3e mean_abs %.3e (bounds %.0e, %.0e)"
                      % (worst32, mean32, E2E_F32_MAX_TOL, E2E_F32_MEAN_TOL))
        if mean32 > E2E_F32_MEAN_TOL or worst32 > E2E_F32_MAX_TOL:
            fail("%s float32 log-posteriors differ from the plain versions "
                 "by %.3e on average, %.3e at most" % (name, mean32, worst32))
    say("  %s nnet_forward: %d utterances, %d frames in %.2f s (%.1f "
        "frames/s, checkpoint load included; the parent's route %.1f "
        "frames/s); --streaming in %d chunks of %d rows: %.2f s (%.3f ms a "
        "chunk, the CLI's whole run); streamed vs offline: float32 max_abs "
        "%.3e mean_abs %.3e ratio %.3e (bound %.0e), bfloat16 max_abs %.3e "
        "mean_abs %.3e ratio %.3e (bound %.0e)%s"
        % ((name, len(raw_lengths), total, seconds[("bf16", False)],
            result["forward_fps"], result["route_forward_fps"], chunks,
            CHUNK_ROWS, seconds[("bf16", True)], result["stream_chunk_ms"])
           + stream["f32"] + (F32_REL_TOL,) + stream["bf16"]
           + (BF16_STEP_REL_TOL, plain_line)))
    if stream["f32"][2] > F32_REL_TOL or stream["bf16"][2] > \
            BF16_STEP_REL_TOL:
        fail("the %s's streamed output differs from its offline output"
             % name)

    # the cudnnlstm family: trains, serves and streams on the stack kernels
    cnets = [os.path.join(wdir, "cudnn%d.npz" % i) for i in range(2)]
    cscp, cbatcher = fold_subset(wdir, scp, cudnn_config, train_steps,
                                 "cudnn.scp", pack_factor=1)
    csteps = len(cbatcher.batch_plan(True, 777))
    ccv = len(build_batcher(cscp, cudnn_config, 32).batch_plan(False, None))
    tee, _ = counted("%s nnet_init" % cname, lambda: nnet_init.main(
        [cscp, paths["cudnn"], cnets[0]] + common),
        counts(lstm_stack_fwd=ccv, ctc_alpha=ccv), into="cudnn_launches")
    closses = [tee.value("cv_loss")]
    tee, _ = counted("%s nnet_train" % cname, lambda: nnet_train.main(
        [cscp, paths["cudnn"], cnets[0], cnets[1], "--optimizer", "adam",
         "--learn-rate", "1e-3"] + common),
        counts(lstm_stack_fwd=csteps, lstm_stack_bwd=csteps,
               ctc_alpha=csteps, ctc_beta=csteps), into="cudnn_launches")
    closses.append(tee.value("tr_loss"))
    cposts, cseconds = {}, {}
    for streaming in (False, True):
        cposts[streaming], cseconds[streaming] = forward(
            "cudnn", cnets[1], streaming, cname,
            counts(lstm_stack_fwd=chunks) if streaming
            else counts(lstm_stack_fwd=fwd_batches), into="cudnn_launches")
    result["cudnn_forward_fps"] = total / cseconds[False]
    cstream = streamed_vs_offline(cposts)
    if not all(math.isfinite(v) for v in losses + closses):
        fail("non-finite losses on the stack kernels: %s, %s"
             % (losses, closses))
    say("  %s: cv_loss %.4f, tr_loss %.4f (%d steps); nnet_forward %.1f "
        "frames/s; streamed vs offline ratio %.3e (bound %.0e)"
        % (cname, closses[0], closses[1], csteps,
           result["cudnn_forward_fps"], cstream[2], BF16_STEP_REL_TOL))
    if cstream[2] > BF16_STEP_REL_TOL:
        fail("the %s's streamed output differs from its offline output"
             % cname)
    return result


# --- phase 23: a 256-target head through K4, K5 and K6 past 128 targets ---

# the flagship treatment model over 256 targets an expert (a subword or
# syllable set; lcm(256, 128) = 256, which the reference's fused kernels
# take), the rest the flagship's: 4 x 320 BLSTM, projection 320, 72
# experts, tau 10
WIDE_HEAD_CONFIG = dict(FLAGSHIP_CONFIG, num_targets=256)


@contextlib.contextmanager
def plain_head():
    """The parent's route for a head past 128 targets: the expert mix by
    its plain version under autograd (the kernels refused, no warning)."""
    from lstm_ctc_tpu_torch.ops import moe_kernels

    def refuse(*args, **kwargs):
        return False

    with mock.patch.object(moe_kernels, "mix_eligible", refuse):
        yield


def wide_head_end_to_end(torch, pkg, device, work, scp, rng):
    """Phase 23: WIDE_HEAD_CONFIG through nnet_init, WIDE_STEPS packed steps
    of nnet_train (keep 0.9) and nnet_forward on 64 utterances, bf16, on
    phase 8's corpus: each run counted from zero (per train step 1 K5 and
    1 K6, per CV or forward batch 1 K4), no route warning and no plain mix
    on the card, finite losses and weights, the archive checked (256
    targets); the same steps from the same weights with the head's mix by
    its plain version (the parent's route), for the step time beside; one
    step with each launch held to its plain version (float32 and bf16) and
    profiled on both routes; bf16 nnet_forward with each launch held to
    its plain version, and float32 log-posteriors against the plain
    versions'."""
    from lstm_ctc_tpu_torch.bin import nnet_forward, nnet_init, nnet_train
    from lstm_ctc_tpu_torch.cli import build_batcher, init_from_config
    from lstm_ctc_tpu_torch.host import kaldi
    from lstm_ctc_tpu_torch.host.config import format_config
    from lstm_ctc_tpu_torch.train.checkpoint import load_checkpoint
    from lstm_ctc_tpu_torch.train.graph import param_leaves
    mk = pkg["moe_kernels"]
    hdir = os.path.join(work, "wide_head")
    os.makedirs(hdir)
    targets = WIDE_HEAD_CONFIG["num_targets"]
    if not mk.mix_eligible(2 * WIDE_HEAD_CONFIG["num_projects"], targets,
                           torch.bfloat16):
        fail("the kernels refuse a head of %d targets" % targets)
    configs = {"bf16": WIDE_HEAD_CONFIG,
               "f32": dict(WIDE_HEAD_CONFIG, compute_dtype="float32")}
    paths = {}
    for name, config in configs.items():
        paths[name] = os.path.join(hdir, "nnet_%s.config" % name)
        with open(paths[name], "w") as fh:
            fh.write(format_config(config))
    sub_scp, batcher = fold_subset(hdir, scp, WIDE_HEAD_CONFIG, WIDE_STEPS,
                                   "head.scp")
    steps = len(batcher.batch_plan(True, 777))
    cv_batches = len(build_batcher(sub_scp, WIDE_HEAD_CONFIG, 32).batch_plan(
        False, None))
    common = ["--objective", "ctc", "--batch-size", "32", "--device",
              "cuda", "--report-interval", "0"]
    result = {"launches": counts()}

    def counted(what, fn, want, parent=False):
        """counted_entry with no plain mix on the card; on the parent's
        route (which runs it) the launches are not added."""
        if parent:
            return counted_entry(torch, pkg, what, fn, want,
                                 lambda seen: plain_head())
        return counted_entry(
            torch, pkg, what, fn, want,
            lambda seen: plain_on_card(mk, "moe_mix_reference", seen),
            result["launches"])

    nnets = [os.path.join(hdir, "nnet%d.npz" % i) for i in range(3)]
    tee, _ = counted("nnet_init", lambda: nnet_init.main(
        [sub_scp, paths["bf16"], nnets[0]] + common), counts(
            lstm_fwd=4 * cv_batches, moe_fwd=cv_batches,
            ctc_alpha=cv_batches))
    losses = [tee.value("cv_loss")]
    layers = counts(lstm_fwd=4 * steps, lstm_bwd=4 * steps, ctc_alpha=steps,
                    ctc_beta=steps)
    stats = {}
    for name, parent, out, want in (
            ("kernels", False, nnets[1],
             dict(layers, moe_fwd_stash=steps, moe_bwd=steps)),
            ("plain", True, nnets[2], layers)):
        metrics_file = os.path.join(hdir, "metrics_%s.jsonl" % name)
        tee, _ = counted(
            "nnet_train" + (" with the plain mix (the parent's route)"
                            if parent else ""),
            lambda: nnet_train.main(
                [sub_scp, paths["bf16"], nnets[0], out, "--metrics-file",
                 metrics_file, "--optimizer", "adam", "--learn-rate", "1e-3",
                 "--pack-factor", "3"] + common), want, parent)
        losses.append(tee.value("tr_loss"))
        with open(metrics_file) as fh:
            stats[name] = step_stats([json.loads(ln) for ln in fh], batcher)
    result.update(stats["kernels"])
    result["plain_step_ms"] = stats["plain"]["step_ms"]
    result["plain_fps"] = stats["plain"]["fps"]
    # one packed step from the trained weights: each launch on the step's
    # own tensors against its plain version (float32; bf16: the head's K5
    # and K6 and the CTC's K10 and K11), then profiled beside the same
    # step with the plain mix (device kernels' ms)
    result["device_ms"], result["plain_device_ms"] = check_steps(
        torch, pkg, device, WIDE_HEAD_CONFIG, nnets[1], batcher,
        result["step_ms"], parent=(plain_head, result["plain_step_ms"]),
        held_bf16=("lstm_bwd", "ctc_alpha", "ctc_beta", "moe_fwd_stash",
                   "moe_bwd"))
    template, state = init_from_config(WIDE_HEAD_CONFIG, device)
    for path in nnets:
        params, _, _ = load_checkpoint(path, template, state)
        if not all(torch.isfinite(p).all() for p in param_leaves(params)):
            fail("%s holds non-finite weights" % path)
    if not all(math.isfinite(v) for v in losses):
        fail("non-finite losses with the 256-target head: %s" % losses)
    say("  cv_loss %.4f, tr_loss %.4f (the plain mix from the same weights "
        "%.4f; %d steps, %d utterances, pack factor 3, keep 0.9, bf16) on "
        "%s: median train step %.1f ms, %.1f real frames/s (packing fill "
        "%.3f); with the plain mix (the parent's route) %.1f ms, %.1f real "
        "frames/s" % (tuple(losses) + (
            steps, len(batcher._lengths), SMI, result["step_ms"],
            result["fps"], result["fill"], result["plain_step_ms"],
            result["plain_fps"])))

    # serving: 64 utterances, bf16, as a user runs it
    scp64, raw_lengths = write_corpus(pkg, hdir, rng)
    fwd_batches = len(build_batcher(scp64, WIDE_HEAD_CONFIG, 32).batch_plan(
        False, None))
    ark = os.path.join(hdir, "post.ark")
    _, seconds = counted("nnet_forward", lambda: nnet_forward.main(
        [scp64, paths["bf16"], nnets[1], "ark:" + ark, "--device", "cuda",
         "--batch-size", "32"]), counts(lstm_fwd=4 * fwd_batches,
                                        moe_fwd=fwd_batches))
    frames = check_posteriors(read_archive(kaldi, ark), raw_lengths,
                              targets=targets)
    result["forward_fps"] = frames / seconds
    say("  nnet_forward: 64 utterances, %d frames of %d targets in %.2f s "
        "(%.1f frames/s, checkpoint load included)"
        % (frames, targets, seconds, result["forward_fps"]))
    # bf16, the main path again: every launch against its plain version on
    # the same tensors, as phase 5 holds the flagship's
    worst = {"lstm_fwd": 0.0, "lstm_fwd_seq": 0.0, "moe_fwd": 0.0}
    with held_to_plain(torch, pkg, torch.bfloat16, worst):
        nnet_forward.main([scp64, paths["bf16"], nnets[1],
                           "ark:" + os.path.join(hdir, "post_held.ark"),
                           "--device", "cuda", "--batch-size", "32"])
    say("  bfloat16 nnet_forward, each launch vs its plain version: K1 per "
        "step max rel %.3e (bound %.0e); K4 max_abs %.3e (bound %.0e)"
        % (worst["lstm_fwd"], BF16_STEP_REL_TOL, worst["moe_fwd"],
           BF16_ABS_TOL))

    # float32 through the kernels against the plain versions
    ark32 = os.path.join(hdir, "post_f32.ark")
    nnet_forward.main([scp64, paths["f32"], nnets[1], "ark:" + ark32,
                       "--device", "cuda", "--batch-size", "32"])
    params, _, _ = load_checkpoint(nnets[1], template, state)
    ref32 = plain_logposts(torch, pkg, params, state, build_batcher(
        scp64, configs["f32"], 32), configs["f32"], device)
    worst32, mean32 = diff_stats(read_archive(kaldi, ark32), ref32)
    say("  float32 kernels vs plain versions, log-posteriors over %d "
        "targets: max_abs %.3e mean_abs %.3e (bounds %.0e, %.0e)"
        % (targets, worst32, mean32, E2E_F32_MAX_TOL, E2E_F32_MEAN_TOL))
    if mean32 > E2E_F32_MEAN_TOL or worst32 > E2E_F32_MAX_TOL:
        fail("float32 log-posteriors of the 256-target head differ from the "
             "plain versions by %.3e on average, %.3e at most"
             % (mean32, worst32))
    return result


# --- phases 13 and 22: Kaldi's LSTMP widths through 16-block K12 and K13 ---

# the lstm family at the cell and recurrent-projection widths of Kaldi's
# nnet3 LSTMP recipes for Switchboard (cell-dim 1024, projection 256), the
# rest the flagship's: 40-dim fbank spliced +-1 and subsampled by 3,
# peepholes, residual layers 1-3, the MoE head (72 experts over 72
# targets, tau 10), keep 0.9, 4 layers; and the cudnnlstm family at H = P
# = 512 (the no-projection shape, which cuDNN's LSTM also computes)
WIDE_LSTM_CONFIG = dict(FLAGSHIP_CONFIG, nnet_type="lstm", num_neurons=1024,
                        num_projects=256)
WIDE_CUDNN_CONFIG = dict(CUDNN_CONFIG, num_neurons=512)
SESSION_UTTERANCES = 8


@contextlib.contextmanager
def parent_route():
    """The parent's route for a stack K12 had no plan for: the stack route
    refused, layer by layer through K1 (and K2), and with carried states
    each layer through the plain scan."""
    from lstm_ctc_tpu_torch.models import lstm

    def refuse(*args, **kwargs):
        return False

    with mock.patch.object(lstm, "stack_eligible", refuse), \
            mock.patch.object(lstm, "stack_layer_eligible", refuse):
        yield


def wide_session(torch, pkg, device, rng, config=None,
                 utterances=SESSION_UTTERANCES):
    """Phase 13 at Kaldi's LSTMP widths (phase 24 at Sak's: ``config``): a
    streaming session of the wide lstm model (random weights) over
    ``utterances`` utterances in chunks of CHUNK_ROWS rows: one K12 and one
    K4 launch a chunk, no plain scan on the card, ms per chunk and the
    real-time factor; then the same on the parent's route (each layer the
    plain scan), timed in turns."""
    from lstm_ctc_tpu_torch.cli import init_from_config
    from lstm_ctc_tpu_torch.models import lstm
    from lstm_ctc_tpu_torch.models.streaming import StreamingSession
    config = config or WIDE_LSTM_CONFIG
    params, state = init_from_config(dict(config), device)
    raws = [rng.randn(int(rng.randint(600, 1201)), 40).astype(np.float32)
            for _ in range(utterances)]
    chunks = sum(-(-(raw.shape[0] // 3) // CHUNK_ROWS) for raw in raws)
    audio_s = FRAME_SHIFT_S * sum(raw.shape[0] for raw in raws)
    session = StreamingSession(params, state, config, chunk_size=CHUNK_ROWS)

    def serve():
        outs = []
        for raw in raws:
            session.reset()
            outs.append(session.process(raw, flush=True))
        return outs

    seen = []
    with plain_on_card(lstm, "lstm_scan", seen):
        outs, _, got, _ = run_counted(torch, pkg, serve)
    expect_counts("the wide streaming session", got,
                  counts(lstm_stack_fwd=chunks, moe_fwd=chunks))
    if seen or not all(np.isfinite(o).all() for o in outs):
        fail("the wide streaming session ran the plain scan on the card %d "
             "times, or wrote non-finite posteriors" % len(seen))
    result = {"chunks": chunks}
    warm = set()
    for route in (False, True, True, False):   # in turns
        with parent_route() if route else contextlib.nullcontext():
            if route not in warm:   # the first run of each route warms it
                serve()
                warm.add(route)
            start = time.perf_counter()
            serve()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
        key = "route_chunk_ms" if route else "chunk_ms"
        result[key] = min(result.get(key, math.inf), 1e3 * seconds / chunks)
    result["rtf"] = audio_s / (result["chunk_ms"] * chunks / 1e3)
    result["route_rtf"] = audio_s / (result["route_chunk_ms"] * chunks / 1e3)
    steps = CHUNK_ROWS + STACK_LAYERS - 1
    units, out_dim = config["num_neurons"], config["num_projects"]
    how = pkg["lstm_stack_kernels"].stack_config(
        device, steps, STACK_LAYERS, 1, units, out_dim, True, torch.bfloat16)
    result["launch"] = how
    say("  wide streaming session (H=%d, P=%d, MoE head, bf16), %d "
        "utterances, %d chunks of %d rows: %.3f ms per chunk, real-time "
        "factor %.1f (the best of two runs); on the parent's route (each "
        "layer the plain scan) %.3f ms per chunk, real-time factor %.1f; "
        "K12 on a chunk: %s plan, %d blocks a cluster, R=%d, %d clusters, "
        "lag K=%d" % (units, out_dim, utterances, chunks, CHUNK_ROWS,
                      result["chunk_ms"], result["rtf"],
                      result["route_chunk_ms"], result["route_rtf"],
                      "streamed" if how["streamed"] else "resident",
                      how["blocks"], how["rows"], STACK_LAYERS * how["tiles"],
                      how["lag"]))
    if how["blocks"] != 16 or how["rows"] != 4:
        fail("K12 on a wide streaming chunk has %d blocks a cluster and R=%d, "
             "not 16 and 4" % (how["blocks"], how["rows"]))
    return result


# the modules of the last slice, imported in phase 1 while jax, the JAX
# package and its top-level scripts cannot be imported at all
BLOCKED = ("jax", "jaxlib", "lstm_ctc_tpu", "bench", "__graft_entry__")
SLICE_MODULES = ("bench", "graft_entry", "parallel", "parallel.mesh",
                 "scripts.profile_step", "scripts.dp_check", "host.nbest",
                 "host.kaldi.nnet1", "host.kaldi.nnet_example",
                 "host.kaldi.randomizer")


def import_blocked():
    """Import ``SLICE_MODULES`` with the names of ``BLOCKED`` refused; fail
    if one of them needs such a module."""
    import importlib
    import importlib.abc

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    blocker = Blocker()
    sys.meta_path.insert(0, blocker)
    try:
        for name in SLICE_MODULES:
            try:
                importlib.import_module("lstm_ctc_tpu_torch." + name)
            except ImportError as exc:
                fail("lstm_ctc_tpu_torch.%s imports a blocked module: %s"
                     % (name, exc))
    finally:
        sys.meta_path.remove(blocker)


def reference_files():
    """Modules loaded from a file of the JAX package's directory."""
    here = os.path.dirname(os.path.abspath(__file__))
    ref = os.path.join(here, "lstm_ctc_tpu") + os.sep
    return sorted(name for name, mod in list(sys.modules.items())
                  if (getattr(mod, "__file__", None) or "").startswith(ref))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if not os.path.isdir(os.path.join(here, "lstm_ctc_tpu_torch")):
        fail("the lstm_ctc_tpu_torch package is not beside this script")
    import_blocked()
    from lstm_ctc_tpu_torch import _build
    pkg = port_pkg()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    global SMI
    SMI = smi
    phase("phase 1 device: %s (%d visible); nvidia-smi: %s"
        % (kind, torch.cuda.device_count(), smi))
    say("  torch %s, CUDA %s; imported with %s blocked: %s"
        % (torch.__version__, torch.version.cuda, ", ".join(BLOCKED),
           ", ".join(SLICE_MODULES)))

    # the native tools of the recipe (phase 18) build beside the kernels
    from lstm_ctc_tpu_torch import _native
    native = {}

    def build_native():
        try:
            native.update(_native.ensure_built())
        except (RuntimeError, OSError) as exc:
            native["error"] = str(exc)

    native_build = threading.Thread(target=build_native)
    native_build.start()
    info = _build.build()
    _build.library()
    phase("phase 2 build: %.1f s -> %s" % (info["seconds"], info["path"]))
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas: " + line.strip())

    rng = np.random.RandomState(0)
    phase("phase 3 K1 (BLSTM layer forward)")
    lstm = {}
    for dtype in (torch.float32, torch.bfloat16):
        for reset in (False, True):
            lstm[(dtype, reset)] = check_lstm(torch, pkg, device, dtype, reset, rng)
    # the widths only 16-block clusters take, from their own seed (the
    # later phases' draws stay as they were)
    wide_rng = np.random.RandomState(21)
    for shape in WIDE_LAYERS:
        for dtype in (torch.float32, torch.bfloat16):
            lstm[(dtype, shape)] = check_lstm(torch, pkg, device, dtype, True,
                                              wide_rng, shape)
    # the streamed plan's widths, from their own seed
    streamed_rng = np.random.RandomState(24)
    for shape in STREAMED_LAYERS:
        for dtype in ((torch.float32,) if shape in STREAMED_F32 else ()) + (
                torch.bfloat16,):
            lstm[(dtype, shape)] = check_lstm(torch, pkg, device, dtype, True,
                                              streamed_rng, shape)
    for dtype in (torch.float32, torch.bfloat16):
        lstm[(dtype, WIDEST_LAYER)] = check_lstm(
            torch, pkg, device, dtype, True, streamed_rng, WIDEST_LAYER,
            WIDEST_STEPS)
    phase("phase 4 K4 (MoE expert mix)")
    moe_res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for keep_prob in (1.0, 0.9):
            moe_res[(72, dtype, keep_prob)] = check_moe(
                torch, pkg, device, dtype, keep_prob, rng)
    # past 128 targets, from their own seed (the later phases' draws stay
    # as they were)
    wide_moe_rng = np.random.RandomState(23)
    for v in WIDE_TARGETS:
        for dtype in (torch.float32, torch.bfloat16):
            for keep_prob in (1.0, 0.9):
                moe_res[(v, dtype, keep_prob)] = check_moe(
                    torch, pkg, device, dtype, keep_prob, wide_moe_rng, v,
                    WIDE_ROWS.get(v, 12288), rounds=3)
        torch.cuda.empty_cache()
    phase("phase 5 serving end to end (nnet_forward, flagship model, cuda)")
    e2e = end_to_end(torch, pkg, device, rng)
    phase("phase 6 K10/K11 (CTC alpha and beta DP), and the routes of "
          "refused shapes")
    dp = check_ctc_dp(torch, pkg, device, rng)
    check_routes(torch, pkg, device, np.random.RandomState(12))
    phase("phase 7 K2 (BLSTM layer backward)")
    bwd = {}
    for dtype in (torch.float32, torch.bfloat16):
        for reset in (False, True):
            bwd[(dtype, reset)] = check_lstm_bwd(torch, pkg, device, dtype,
                                                 reset, rng)
    for shape in WIDE_LAYERS:
        for dtype in (torch.float32, torch.bfloat16):
            bwd[(dtype, shape)] = check_lstm_bwd(torch, pkg, device, dtype,
                                                 True, wide_rng, shape)
    for shape in STREAMED_LAYERS:
        for dtype in ((torch.float32,) if shape in STREAMED_F32 else ()) + (
                torch.bfloat16,):
            bwd[(dtype, shape)] = check_lstm_bwd(torch, pkg, device, dtype,
                                                 True, streamed_rng, shape)
    for dtype in (torch.float32, torch.bfloat16):
        bwd[(dtype, WIDEST_LAYER)] = check_lstm_bwd(
            torch, pkg, device, dtype, True, streamed_rng, WIDEST_LAYER,
            WIDEST_STEPS)
    forced = check_forced_plans(torch, pkg, device, streamed_rng)
    with tempfile.TemporaryDirectory() as work:
        scp = write_labeled_corpus(pkg, work, rng)
        phase("phase 8 training end to end (nnet_init / nnet_train / "
            "nnet_validate, flagship dense-head model, cuda)")
        train = train_end_to_end(torch, pkg, device, work, scp)
        phase("phase 9 K5/K6/K8/K9 (MoE head training kernels)")
        moe_train = check_moe_training(torch, pkg, device, rng)
        moe_train_wide = {}
        for v in WIDE_TARGETS:
            moe_train_wide[v] = check_moe_training(
                torch, pkg, device, wide_moe_rng, v,
                WIDE_ROWS.get(v, MOE_TRAIN_ROWS))
            torch.cuda.empty_cache()
        phase("phase 10 MoE training end to end (nnet_train_loop, flagship "
            "MoE model, cuda)")
        moe_loop = train_moe_end_to_end(torch, pkg, device, work, scp)
        phase("phase 11 K12 (unidirectional stack forward)")
        k12 = check_stack_fwd(torch, pkg, device, rng)
        library = cudnn_yardstick(torch, pkg, device, rng)
        # the widths only 16-block clusters take, from their own seed
        stack_rng = np.random.RandomState(22)
        k12_wide = check_stack_fwd_wide(torch, pkg, device, stack_rng)
        library_wide = cudnn_yardstick(torch, pkg, device, stack_rng,
                                       shape=(512, None), with_stack=True)
        # cuDNN at the streamed plan's cudnnlstm H = P = 1024
        library_streamed = cudnn_yardstick(torch, pkg, device, stack_rng,
                                           shape=(1024, None))
        forced_stack = check_stack_forced(torch, pkg, device, stack_rng)
        phase("phase 12 K13 (unidirectional stack backward)")
        k13 = check_stack_bwd(torch, pkg, device, rng)
        k13_wide = check_stack_bwd_wide(torch, pkg, device, stack_rng)
        phase("phase 13 serving the unidirectional families (nnet_forward, "
            "offline and --streaming, cuda)")
        serve = serve_families(torch, pkg, device, rng)
        session = wide_session(torch, pkg, device, stack_rng)
        phase("phase 14 training the unidirectional families (nnet_init / "
            "nnet_train / nnet_validate, lstm, cudnnlstm, lstm_bn, cuda)")
        families = train_families(torch, pkg, device, work, scp)
        phase("phase 15 K3 (BLSTM layer backward, input side folded in)")
        fold = {}
        for dtype in (torch.float32, torch.bfloat16):
            for reset in (False, True):
                fold[(dtype, reset)] = check_lstm_bwd_fold(
                    torch, pkg, device, dtype, reset, rng)
        for shape in WIDE_LAYERS:
            for dtype in (torch.float32, torch.bfloat16):
                fold[(dtype, shape)] = check_lstm_bwd_fold(
                    torch, pkg, device, dtype, True, wide_rng, shape)
        for shape in STREAMED_LAYERS:
            for dtype in ((torch.float32,) if shape in STREAMED_F32
                          else ()) + (torch.bfloat16,):
                fold[(dtype, shape)] = check_lstm_bwd_fold(
                    torch, pkg, device, dtype, True, streamed_rng, shape)
        phase("phase 16 K7 (MoE head backward with the weight gradient: "
              "bf16 K6's body then the dw product, float32 one kernel)")
        k7 = check_moe_single_kernel(torch, pkg, device, rng)
        phase("phase 17 the opt-in folds end to end (nnet_train, flagship MoE "
            "model, lstm_fold_dx and moe_wgrad_mode = kernel, cuda; the A/B "
            "tool)")
        folds = train_folds_end_to_end(torch, pkg, device, work, scp)
        phase("phase 18 the shipped recipe end to end (egs/synthetic/run.sh "
              "stages 0-5 through the shim, flagship widths, cuda)")
        native_build.join()
        if "error" in native:
            fail("the native tools did not build: %s" % native["error"])
        recipe = recipe_end_to_end(torch, pkg, device, work, native)
        phase("phase 19 the bench (python -m lstm_ctc_tpu_torch.bench, full "
              "widths) and profile_step (B=32, T=384)")
        bench = bench_on_card(here, kind)
        phase("phase 20 data parallel on the one card (two gloo ranks, "
              "flagship MoE model, f32; an NCCL group of one rank)")
        dp_run = data_parallel_on_card(torch, pkg, device, work, here)
        phase("phase 21 Kaldi's BLSTMP widths end to end (4 x 1024 cells, "
              "projection 256, MoE head; nnet_init / nnet_train / "
              "nnet_forward on 16-block K1 and K2, cuda)")
        wide = wide_end_to_end(torch, pkg, device, work, scp, wide_rng)
        phase("phase 22 Kaldi's LSTMP widths end to end (the lstm family, 4 "
              "x 1024 cells, projection 256, MoE head; nnet_init / "
              "nnet_train / nnet_forward, offline and --streaming, on "
              "16-block K12 and K13; cudnnlstm H=P=512, cuda)")
        wide_lstm = stack_families_end_to_end(
            torch, pkg, device, os.path.join(work, "wide_lstm"), scp,
            stack_rng, WIDE_LSTM_CONFIG, WIDE_CUDNN_CONFIG, WIDE_STEPS, 64,
            False, True)
        phase("phase 23 a 256-target head end to end (the flagship MoE "
              "model over 256 targets; nnet_init / nnet_train / "
              "nnet_forward on K4, K5 and K6 V-tiled, bf16, cuda)")
        wide_head = wide_head_end_to_end(torch, pkg, device, work, scp,
                                         wide_moe_rng)
        phase("phase 24 the streamed plan end to end (the flagship MoE "
              "model at H=P=1024 without a projection; nnet_init / "
              "nnet_train / nnet_forward on K1, K2 and K3 streaming their "
              "weights, bf16; the lstm family at 2048/512 and the "
              "cudnnlstm family at H=P=1024 on K12 and K13 streaming "
              "theirs, offline and --streaming, beside the parent's routes, "
              "cuda)")
        streamed = streamed_end_to_end(torch, pkg, device, work, scp,
                                       streamed_rng)

    bad = reference_files()
    if "jax" in sys.modules or bad:
        fail("the port imported jax or files of the reference package: %s"
             % bad[:5])

    launches = dict(train["launches"])
    for run in (e2e, moe_loop, serve, families, folds, recipe, dp_run, wide,
                wide_lstm, wide_head, streamed):
        for k, v in run["launches"].items():
            launches[k] += v
    for runs in (wide_lstm["cudnn_launches"], streamed["sak"]["launches"],
                 streamed["sak"]["cudnn_launches"]):
        for k, v in runs.items():
            launches[k] += v
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            fail("%s was never launched on the main paths" % name)
    a_err, a_ms, a_plain = lstm[(torch.bfloat16, False)]
    k4 = moe_res[(72, torch.bfloat16, 1.0)]
    # K1: gx read and out written once (f32) at B=32, T=384, H=P=320
    k1_bytes = 384 * 64 * (4 * 320 + 320) * 4
    k1_flops = 2 * 384 * 64 * 320 * (4 * 320 + 320)
    k2 = bwd[(torch.bfloat16, True)]
    kernels = [
        {"name": "lstm_fwd", "route": "cuda",
         "source": "lstm_ctc_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "lstm_ctc_tpu/ops/lstm_pallas.py:57",
         "launches": launches["lstm_fwd"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain,
         "bound_ms": max(k1_bytes / HBM_BYTES_PER_MS,
                         k1_flops / BF16_FLOPS_PER_MS),
         "bound_by": "bytes", "library_ms": None},
        {"name": "moe_fwd", "route": "cuda",
         "source": "lstm_ctc_tpu_torch/csrc/moe_fwd.cu",
         "replaces": "lstm_ctc_tpu/ops/moe_pallas.py:212",
         "launches": launches["moe_fwd"], "library_ms": None,
         **{k: k4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")}},
        {"name": "lstm_bwd", "route": "cuda",
         "source": "lstm_ctc_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "lstm_ctc_tpu/ops/lstm_pallas.py:134",
         "launches": launches["lstm_bwd"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
    ]
    # K5-K9: bf16 at keep 0.9, the training shape N=14336
    for name, source, line in (("moe_fwd_stash", "moe_fwd.cu", 217),
                               ("moe_bwd", "moe_bwd.cu", 271),
                               ("moe_bwd_noemit", "moe_bwd.cu", 282),
                               ("moe_wgrad", "moe_wgrad.cu", 289)):
        kernels.append(dict(
            {"name": name, "route": "cuda",
             "source": "lstm_ctc_tpu_torch/csrc/" + source,
             "replaces": "lstm_ctc_tpu/ops/moe_pallas.py:%d" % line,
             "launches": launches[name], "library_ms": None},
            **{k: moe_train[(name, torch.bfloat16)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}))
    for name, line in (("ctc_alpha", 46), ("ctc_beta", 78)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "lstm_ctc_tpu_torch/csrc/ctc_dp.cu",
            "replaces": "lstm_ctc_tpu/ops/ctc_pallas.py:%d" % line,
            "launches": launches[name],
            "max_abs_err": dp[name]["max_abs_err"], "ms": dp[name]["ms"],
            "plain_ms": dp[name]["plain_ms"],
            "bound_ms": dp[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": dp[name]["library_ms"]})
    # K12, K13: bf16 at the lstm width (B=32, T=384, 4 layers of 320,
    # projection 320); the library yardstick is cuDNN at the cudnnlstm
    # width (no PyTorch call has the peephole projected cell)
    for name, line, res, lib in (
            ("lstm_stack_fwd", 64, k12, library["forward"]),
            ("lstm_stack_bwd", 184, k13, library["both"])):
        kernels.append(dict(
            {"name": name, "route": "cuda",
             "source": "lstm_ctc_tpu_torch/csrc/%s.cu" % name,
             "replaces": "lstm_ctc_tpu/ops/lstm_stack_pallas.py:%d" % line,
             "launches": launches[name], "library_ms": lib},
            **res[("lstm", torch.bfloat16)]))
    # K3: bf16 with resets at the flagship's layers 1-3; K7: bf16 at keep
    # 0.9, the training shape N=14336
    for name, source, replaces, res in (
            ("lstm_bwd_fold", "lstm_bwd_fold.cu", "lstm_pallas.py:544",
             fold[(torch.bfloat16, True)]),
            ("moe_bwd_wgrad", "moe_bwd_wgrad.cu", "moe_pallas.py:311",
             k7[torch.bfloat16])):
        kernels.append(dict(
            {"name": name, "route": "cuda",
             "source": "lstm_ctc_tpu_torch/csrc/" + source,
             "replaces": "lstm_ctc_tpu/ops/" + replaces,
             "launches": launches[name], "library_ms": None},
            **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}))
    # K1, K2 and K3 at Kaldi's BLSTMP widths (H=1024, P=256, D=512; bf16,
    # resets), on 16-block clusters; launches from phase 21's runs
    wide_shape = WIDE_LAYERS[0]
    for name, source, replaces, res in (
            ("lstm_fwd", "lstm_fwd.cu", "lstm_pallas.py:57",
             lstm[(torch.bfloat16, wide_shape)]),
            ("lstm_bwd", "lstm_bwd.cu", "lstm_pallas.py:134",
             bwd[(torch.bfloat16, wide_shape)]),
            ("lstm_bwd_fold", "lstm_bwd_fold.cu", "lstm_pallas.py:544",
             fold[(torch.bfloat16, wide_shape)])):
        kernels.append(dict(
            {"name": name + "_wide", "route": "cuda",
             "source": "lstm_ctc_tpu_torch/csrc/" + source,
             "replaces": "lstm_ctc_tpu/ops/" + replaces,
             "launches": wide["launches"][name], "library_ms": None},
            **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}))
    # K1, K2 and K3 on the streamed plan at H = P = 1024 without a
    # projection (D = 2048; bf16, resets), launches from phase 24's runs
    streamed_shape = STREAMED_LAYERS[0]
    for name, source, replaces, res in (
            ("lstm_fwd", "lstm_fwd.cu", "lstm_pallas.py:57",
             lstm[(torch.bfloat16, streamed_shape)]),
            ("lstm_bwd", "lstm_bwd_streamed.cu", "lstm_pallas.py:134",
             bwd[(torch.bfloat16, streamed_shape)]),
            ("lstm_bwd_fold", "lstm_bwd_fold.cu", "lstm_pallas.py:544",
             fold[(torch.bfloat16, streamed_shape)])):
        kernels.append(dict(
            {"name": name + "_streamed", "route": "cuda",
             "source": "lstm_ctc_tpu_torch/csrc/" + source,
             "replaces": "lstm_ctc_tpu/ops/" + replaces,
             "launches": streamed["launches"][name], "library_ms": None},
            **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}))
    # K12 and K13 on 16-block clusters (bf16, B=32, T=384, 4 layers): at
    # Kaldi's LSTMP widths (launches from phase 22's lstm runs; no PyTorch
    # call has the peephole projected cell) and at the cudnnlstm H = P =
    # 512 (launches from phase 22's cudnnlstm runs; cuDNN's LSTM the
    # library yardstick)
    for suffix, key, lib_ms, runs in (
            ("_wide", ("lstm", 1024, 256, False), (None, None), "launches"),
            ("_wide_cudnnlstm", ("cudnnlstm", 512, None, False),
             (library_wide["forward"], library_wide["both"]),
             "cudnn_launches")):
        for name, line, res, lib in (("lstm_stack_fwd", 64, k12_wide,
                                      lib_ms[0]),
                                     ("lstm_stack_bwd", 184, k13_wide,
                                      lib_ms[1])):
            kernels.append(dict(
                {"name": name + suffix, "route": "cuda",
                 "source": "lstm_ctc_tpu_torch/csrc/%s.cu" % name,
                 "replaces": "lstm_ctc_tpu/ops/lstm_stack_pallas.py:%d"
                 % line, "launches": wide_lstm[runs][name],
                 "library_ms": lib},
                **{k: res[key][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}))
    # K12 and K13 on the streamed plan (bf16, B=32, T=384, 4 layers): at
    # Sak's LSTMP widths, 128 units a block (launches from phase 24's lstm
    # runs; no PyTorch call has the peephole projected cell) and at the
    # cudnnlstm H = P = 1024 (launches from phase 24's cudnnlstm runs;
    # cuDNN's LSTM the library yardstick, which computes the same function)
    for suffix, key, lib_ms, runs in (
            ("_streamed", SAK + (False,), (None, None), "launches"),
            ("_streamed_cudnnlstm", ("cudnnlstm", 1024, None, False),
             (library_streamed["forward"], library_streamed["both"]),
             "cudnn_launches")):
        for name, line, res, lib in (("lstm_stack_fwd", 64, k12_wide,
                                      lib_ms[0]),
                                     ("lstm_stack_bwd", 184, k13_wide,
                                      lib_ms[1])):
            kernels.append(dict(
                {"name": name + suffix, "route": "cuda",
                 "source": "lstm_ctc_tpu_torch/csrc/%s.cu" % name,
                 "replaces": "lstm_ctc_tpu/ops/lstm_stack_pallas.py:%d"
                 % line, "launches": streamed["sak"][runs][name],
                 "library_ms": lib},
                **{k: res[key][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}))
    # K4, K5 and K6 V-tiled: bf16 at V = 256 (K4 N=12288 keep 1.0, K5 and
    # K6 N=14336 keep 0.9), launches from phase 23's runs; cuBLAS's bare
    # product is not their function (printed, not the library's time)
    for name, line, res in (
            ("moe_fwd", 212, moe_res[(256, torch.bfloat16, 1.0)]),
            ("moe_fwd_stash", 217, moe_train_wide[256][
                ("moe_fwd_stash", torch.bfloat16)]),
            ("moe_bwd", 271, moe_train_wide[256][("moe_bwd",
                                                  torch.bfloat16)])):
        kernels.append(dict(
            {"name": name + "_v256", "route": "cuda",
             "source": "lstm_ctc_tpu_torch/csrc/%s.cu"
             % ("moe_bwd" if name == "moe_bwd" else "moe_fwd"),
             "replaces": "lstm_ctc_tpu/ops/moe_pallas.py:%d" % line,
             "launches": wide_head["launches"][name], "library_ms": None},
            **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")}))
    two_ms, default_ms = moe_train[("twokernel", torch.bfloat16)]
    say("summary on %s: nnet_forward %.1f frames/s (64 utterances, model "
        "init and checkpoint load included); flagship forward B=32 T=384 "
        "%.1f frames/s; train step (B=32 rows of 448 frames, pack 3, bf16), "
        "median: dense head %.1f ms, %.1f real frames/s (fill %.3f); MoE "
        "head %.1f ms, %.1f real frames/s (fill %.3f); MoE backward at "
        "N=14336: twokernel %.3f ms vs default %.3f ms"
        % (smi, e2e["fps_warm"], 32 * 384 / e2e["model_ms"] * 1e3,
           train["step_ms"], train["fps"], train["fill"],
           moe_loop["step_ms"], moe_loop["fps"], moe_loop["fill"], two_ms,
           default_ms))
    say("summary of the unidirectional families on %s: K12 bf16 %.3f ms "
        "(lstm width) / %.3f ms (cudnnlstm width, cuDNN forward %.3f ms); "
        "K13 bf16 %.3f ms / %.3f ms (cuDNN forward + backward %.3f ms); "
        "nnet_forward lstm %.1f frames/s, cudnnlstm %.1f frames/s; "
        "streaming %.3f ms per chunk of %d rows, real-time factor %.1f; "
        "train step (B=32 unpacked, bf16), median: lstm %.1f ms, %.1f real "
        "frames/s; cudnnlstm %.1f ms, %.1f; lstm_bn %.1f ms, %.1f"
        % (smi, k12[("lstm", torch.bfloat16)]["ms"],
           k12[("cudnnlstm", torch.bfloat16)]["ms"], library["forward"],
           k13[("lstm", torch.bfloat16)]["ms"],
           k13[("cudnnlstm", torch.bfloat16)]["ms"], library["both"],
           serve["lstm"]["fps"], serve["cudnnlstm"]["fps"],
           serve["chunk_ms"], CHUNK_ROWS, serve["rtf"],
           families["lstm"]["step_ms"], families["lstm"]["fps"],
           families["cudnnlstm"]["step_ms"], families["cudnnlstm"]["fps"],
           families["lstm_bn"]["step_ms"], families["lstm_bn"]["fps"]))
    k3 = fold[(torch.bfloat16, True)]
    k7b = k7[torch.bfloat16]
    say("summary of the opt-in folds on %s: K3 bf16 %.3f ms a layer (K2 "
        "alone on the same inputs %.3f ms; cuBLAS's bare dx and dwx "
        "products %.4f + %.4f ms); K7 bf16 %.3f ms (K6 alone %.3f ms, "
        "cuBLAS's bare x(cdt)ᵀ·dz %.4f ms; default backward %.3f ms, "
        "twokernel %.3f ms); float32 step with both folds "
        "vs without: loss rel %.3e, gradient ||diff||/||plain|| %.3e; "
        "profiled bf16 train step (B=32, T=384, keep 1.0), device ms: %s; "
        "A/B frames/s: %s"
        % (smi, k3["ms"], k3["k2_ms"], k3["cublas_dx_ms"],
           k3["cublas_dwx_ms"], k7b["ms"], k7b["k6_ms"], k7b["cublas_ms"],
           default_ms, two_ms, folds["loss_rel"],
           folds["grad_rel"], ", ".join(
               "%s %.3f" % kv for kv in folds["device_ms"].items()),
           ", ".join("%s %.1f" % (n, v["best"])
                     for n, v in folds["ab"].items())))
    k9b, k9f = (moe_train[("moe_wgrad", t)] for t in (torch.bfloat16,
                                                      torch.float32))
    say("summary of the redesigned K11 and K9 on %s: K11 %.3f ms (first "
        "design %.3f); K9 bf16 %.3f ms (first design %.3f), by kernel: %s; "
        "on K7's inputs %.3f ms beside K7 %.3f; K9 float32 %.3f ms; "
        "twokernel backward (K8 + K9) %.3f ms vs default %.3f ms"
        % (smi, dp["ctc_beta"]["ms"], K11_FIRST_MS, k9b["ms"],
           K9_FIRST_MS, ", ".join(
               "%s %.4f" % kv for kv in k9b["device_split"].items()),
           k7b["k9_ms"], k7b["ms"], k9f["ms"], two_ms, default_ms))
    say("summary of the recipe on %s (egs/synthetic/run.sh through the "
        "shim, flagship widths, 2 iterations): stages 0-5 %.1f s (%s); "
        "start of a tool: %s; %s"
        % (smi, sum(recipe["seconds"].values()), ", ".join(
            "%s %.1f" % kv for kv in recipe["seconds"].items()), ", ".join(
            "%s %.3f s" % kv for kv in recipe["starts"].items()),
           recipe["wer"].rsplit("/", 1)[-1]))
    headline = bench["bench"]
    say("summary of the bench on %s: flagship_b32_t384 %.1f frames/s (mfu "
        "%.4f), forward %.1f frames/s; rows %s; profile_step decomposition "
        "ms %s; data parallel, two gloo ranks vs 1 process: loss rel %.3e, "
        "update rel %.3e; NCCL group of 1 bit-equal"
        % (smi, headline["value"], headline["mfu"],
           headline["forward_frames_per_sec"], ", ".join(
               "%s %s" % (r["config"], r.get("frames_per_sec",
                                             r.get("ms_per_chunk")))
               for r in headline["configs"]),
           bench["profile"]["decomposition_ms"], dp_run["loss_rel"],
           dp_run["update_rel"]))
    say("summary of Kaldi's BLSTMP widths on %s (H=1024, P=256; B=32, "
        "T=384, bf16, resets): K1 %.3f ms (%s), K2 %.3f ms (%s), K3 %.3f "
        "ms; H=P=512: K1 %.3f, K2 %.3f, K3 %.3f ms; H=P=384: K1 %.3f, K2 "
        "%.3f, K3 %.3f ms; the wide model's train step (B=32 rows of 448 "
        "frames, pack 3, bf16), median %.1f ms, %.1f real frames/s; "
        "nnet_forward %.1f frames/s"
        % ((smi, lstm[(torch.bfloat16, wide_shape)]["ms"],
            launch_line(lstm[(torch.bfloat16, wide_shape)]["launch"]),
            bwd[(torch.bfloat16, wide_shape)]["ms"],
            launch_line(bwd[(torch.bfloat16, wide_shape)]["launch"]),
            fold[(torch.bfloat16, wide_shape)]["ms"])
           + tuple(res[(torch.bfloat16, shape)]["ms"]
                   for shape in WIDE_LAYERS[1:] for res in (lstm, bwd, fold))
           + (wide["step_ms"], wide["fps"], wide["forward_fps"])))
    wide_rows = []
    for case in wide_cases(torch):
        key, family, units, proj, shape = case[:5]
        f, b = k12_wide[key], k13_wide[key]
        wide_rows.append("%s: K12 %.3f ms%s, K13 %.3f ms%s (%s)%s" % (
            wide_name(family, units, proj, shape.get("batch", 32),
                      shape.get("steps", 384)), f["ms"],
            "" if f["plain_ms"] is None else " (plain %.3f)" % f["plain_ms"],
            b["ms"],
            "" if b["plain_ms"] is None else " (plain %.3f)" % b["plain_ms"],
            "%s plan, K12 R=%d in %d wave(s), K13 R=%d in %d wave(s)" % (
                "streamed" if f["launch"]["streamed"] else "resident",
                f["launch"]["rows"], f["launch"]["waves"],
                b["launch"]["rows"], b["launch"]["waves"]),
            "" if "stack_ms" not in f else "; through stack_layers forward "
            "%.3f ms (the parent's route %.3f), forward + backward %.3f ms "
            "(%.3f)" % (f["stack_ms"], f["route_ms"], b["stack_ms"],
                        b["route_ms"]))
            + ("" if "one_row" not in f else "; in turns with the same "
               "launch forced at K12 R=%d and K13 R=%d: K12 %.3f ms against "
               "%.3f, K13 %.3f against %.3f" % (
                   f["one_row"]["forced_rows"], b["one_row"]["forced_rows"],
                   f["one_row"]["ms"], f["one_row"]["forced_ms"],
                   b["one_row"]["ms"], b["one_row"]["forced_ms"])))
    say("summary of the unidirectional stack on 16-block clusters on %s "
        "(bf16, B=32, T=384, 4 layers unless said; cuDNN's LSTM at H=P=512: "
        "forward %.3f ms, forward + backward %.3f ms on the events, %.3f ms "
        "of device kernels, beside K12 + K13 as a step calls them %.3f ms "
        "on the events, %.3f ms of device kernels; at H=P=1024: %.3f ms, "
        "%.3f ms): %s; the streamed plan forced at H=1024 P=256, bit-equal "
        "to the resident plan: %s"
        % (smi, library_wide["forward"], library_wide["both"],
           library_wide["both_device"], library_wide["stack_ms"],
           library_wide["stack_device"],
           library_streamed["forward"], library_streamed["both"],
           "; ".join(wide_rows), "; ".join(
               "%s R=%d %s" % (k[0], k[1], ", ".join(
                   "%s %.3f ms" % kv for kv in t.items()))
               for k, t in forced_stack.items())))
    say("summary of Kaldi's LSTMP widths on %s (lstm, H=1024, P=256, MoE "
        "head, bf16): train step (B=32 unpacked, keep 0.9), median %.1f "
        "ms, %.1f real frames/s (the parent's route %.1f ms, %.1f); "
        "nnet_forward %.1f frames/s (the parent's route %.1f); a streaming "
        "session %.3f ms per chunk of %d rows, real-time factor %.1f (the "
        "parent's route, the plain scan: %.3f ms, %.1f); nnet_forward "
        "--streaming %.3f ms a chunk (the whole CLI run); cudnnlstm "
        "H=P=512 nnet_forward %.1f frames/s"
        % (smi, wide_lstm["step_ms"], wide_lstm["fps"],
           wide_lstm["route_step_ms"], wide_lstm["route_fps"],
           wide_lstm["forward_fps"], wide_lstm["route_forward_fps"],
           session["chunk_ms"], CHUNK_ROWS, session["rtf"],
           session["route_chunk_ms"], session["route_rtf"],
           wide_lstm["stream_chunk_ms"], wide_lstm["cudnn_forward_fps"]))
    head_rows = []
    for v in WIDE_TARGETS:
        for dtype in (torch.float32, torch.bfloat16):
            timed = [moe_res[(v, dtype, 1.0)]] + [
                moe_train_wide[v][(k, dtype)] for k in ("moe_fwd_stash",
                                                        "moe_bwd")]
            head_rows.append("V=%d %s: K4 %s, K5 %s, K6 %s" % ((
                v, str(dtype).split(".")[-1]) + tuple(
                    "%.3f vs %.3f" % (r["ms"], r["plain_ms"])
                    for r in timed)))
    say("summary of the head past 128 targets on %s (D=640, 72 experts; "
        "K4 N=12288 keep 1.0, K5 and K6 N=14336 keep 0.9; V=4096 N=1100), "
        "kernel vs plain ms: %s; the 256-target flagship's train step (B=32 "
        "rows of 448 frames, pack 3, bf16), median %.1f ms, %.1f real "
        "frames/s, one profiled step's device kernels %.1f ms (with the "
        "plain mix, the parent's route: %.1f ms, %.1f, device %.1f ms); "
        "nnet_forward %.1f frames/s"
        % (smi, "; ".join(head_rows), wide_head["step_ms"], wide_head["fps"],
           wide_head["device_ms"], wide_head["plain_step_ms"],
           wide_head["plain_fps"], wide_head["plain_device_ms"],
           wide_head["forward_fps"]))
    def one_row_note(res):
        if "forced_ms" not in res:
            return ""
        return " (forced at the parent's R=%d: %.3f ms)" % (
            res["forced_launch"]["rows"], res["forced_ms"])

    streamed_rows = []
    for shape in STREAMED_LAYERS:
        for dtype in ((torch.float32,) if shape in STREAMED_F32 else ()) + (
                torch.bfloat16,):
            f, b, fo = (res[(dtype, shape)] for res in (lstm, bwd, fold))
            streamed_rows.append(
                "%s: K1 %.3f ms%s vs plain %.3f, bound %.4f (%s); K2 %.3f%s "
                "vs %.3f, bound %.4f (%s); K3 %.3f vs %.3f, bound %.4f"
                % (layer_name(dtype, shape), f["ms"], one_row_note(f),
                   f["plain_ms"], f["bound_ms"], launch_line(f["launch"]),
                   b["ms"], one_row_note(b), b["plain_ms"], b["bound_ms"],
                   launch_line(b["launch"]), fo["ms"], fo["plain_ms"],
                   fo["bound_ms"]))
    for dtype in (torch.float32, torch.bfloat16):
        f, b = lstm[(dtype, WIDEST_LAYER)], bwd[(dtype, WIDEST_LAYER)]
        streamed_rows.append(
            "%s: K1 %.3f ms%s vs plain %.3f, bound %.4f (%s); K2 %.3f%s vs "
            "%.3f, bound %.4f (%s)"
            % (layer_name(dtype, WIDEST_LAYER, WIDEST_STEPS), f["ms"],
               one_row_note(f), f["plain_ms"], f["bound_ms"],
               launch_line(f["launch"]), b["ms"], one_row_note(b),
               b["plain_ms"], b["bound_ms"], launch_line(b["launch"])))
    forced_rows = ["%s, %s: K1 %.3f vs %.3f ms, K2 %.3f vs %.3f"
                   % ((layer_name(torch.bfloat16, shape), what) + t)
                   for shape, runs in forced.items()
                   for what, t in runs.items()]
    say("summary of the streamed plan on %s (B=32, T=384 unless said, "
        "resets): %s; the streamed plan forced where the resident plan fits, "
        "vs the resident plan at the same R: %s; the flagship MoE model at H=P=1024 "
        "without a projection: train step (B=32 rows of 448 frames, pack 3, "
        "bf16), median %.1f ms, %.1f real frames/s, one profiled step's "
        "device kernels %.1f ms (the same step on the parent's route, the "
        "plain recurrence, after a warm-up step: median %.1f ms of %d on "
        "the host clock); nnet_forward %.1f frames/s"
        % (smi, "; ".join(streamed_rows), "; ".join(forced_rows),
           streamed["step_ms"], streamed["fps"], streamed["device_ms"],
           streamed["route_ms"], ROUTE_STEPS, streamed["forward_fps"]))
    sak = streamed["sak"]
    say("summary of the stack's streamed plan on %s (K12 and K13, 16 "
        "blocks streaming wh and proj; bf16, B=32, T=384, 4 layers): lstm "
        "H=2048 P=512: K12 %.3f ms (plain %.3f), K13 %.3f ms (plain %.3f); "
        "train step (B=32 unpacked, keep 0.9) median %.1f ms, %.1f real "
        "frames/s (the parent's route, layer by layer through K1 and K2: "
        "%.1f ms, %.1f); nnet_forward %.1f frames/s (the parent's route "
        "%.1f); a streaming session %.3f ms per chunk of %d rows, real-time "
        "factor %.1f (the parent's route, each layer the plain scan: %.3f "
        "ms, %.1f); nnet_forward --streaming %.3f ms a chunk (the whole CLI "
        "run); cudnnlstm H=P=1024: K12 %.3f ms, K13 %.3f ms (cuDNN's LSTM "
        "forward %.3f ms, forward + backward %.3f ms), nnet_forward %.1f "
        "frames/s; the build %.1f s"
        % (smi, k12_wide[SAK + (False,)]["ms"],
           k12_wide[SAK + (False,)]["plain_ms"],
           k13_wide[SAK + (False,)]["ms"],
           k13_wide[SAK + (False,)]["plain_ms"], sak["step_ms"],
           sak["fps"], sak["route_step_ms"], sak["route_fps"],
           sak["forward_fps"], sak["route_forward_fps"],
           sak["session"]["chunk_ms"], CHUNK_ROWS, sak["session"]["rtf"],
           sak["session"]["route_chunk_ms"], sak["session"]["route_rtf"],
           sak["stream_chunk_ms"],
           k12_wide[("cudnnlstm", 1024, None, False)]["ms"],
           k13_wide[("cudnnlstm", 1024, None, False)]["ms"],
           library_streamed["forward"], library_streamed["both"],
           sak["cudnn_forward_fps"], info["seconds"]))
    say("chip_smoke: %.1f s of command time on %s (the build %.1f s)"
        % (time.perf_counter() - START, smi, info["seconds"]))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    numbers = [k[key] for k in kernels for key in ("ms", "plain_ms")] + [
        e2e["fps_warm"], train["step_ms"], moe_loop["step_ms"], two_ms,
        default_ms, library["forward"], library["both"], serve["chunk_ms"]] \
        + [families[f]["step_ms"] for f in ("lstm", "cudnnlstm", "lstm_bn")] \
        + [k3["k2_ms"], k3["cublas_dx_ms"], k3["cublas_dwx_ms"],
           k7b["k6_ms"], k7b["cublas_ms"], k7b["k9_ms"], k9f["ms"]] \
        + list(folds["device_ms"].values()) \
        + [v["best"] for v in folds["ab"].values()] \
        + list(recipe["seconds"].values()) + list(recipe["starts"].values()) \
        + list(bench["profile"]["segments_ms"].values()) \
        + [dp_run["gloo_s"], dp_run["nccl_s"]] \
        + [wide["step_ms"], wide["fps"], wide["forward_fps"]] \
        + [res[k] for res in list(k12_wide.values())
           + list(k13_wide.values())
           for k in ("stack_ms", "route_ms") if k in res] \
        + [library_wide[k] for k in ("forward", "both", "both_device",
                                     "stack_ms", "stack_device")] \
        + [library_streamed["forward"], library_streamed["both"]] \
        + [res["one_row"][k] for res in list(k12_wide.values())
           + list(k13_wide.values()) if "one_row" in res
           for k in ("ms", "forced_ms")] \
        + [v for t in forced_stack.values() for v in t.values()] \
        + [res["forced_ms"] for res in list(lstm.values()) + list(bwd.values())
           if isinstance(res, dict) and "forced_ms" in res] \
        + [session[k] for k in ("chunk_ms", "route_chunk_ms")] \
        + [wide_lstm[k] for k in ("step_ms", "fps", "route_step_ms",
                                  "route_fps", "forward_fps",
                                  "route_forward_fps", "stream_chunk_ms",
                                  "cudnn_forward_fps")] \
        + [res[k] for res in list(moe_res.values()) + [
            r for run in moe_train_wide.values() for key, r in run.items()
            if key[0] != "twokernel"] for k in ("ms", "plain_ms", "bound_ms")] \
        + [wide_head[k] for k in ("step_ms", "fps", "plain_step_ms",
                                  "plain_fps", "forward_fps", "device_ms",
                                  "plain_device_ms")] \
        + [streamed[k] for k in ("step_ms", "fps", "device_ms", "route_ms",
                                 "forward_fps")] \
        + [streamed["sak"][k] for k in ("step_ms", "fps", "route_step_ms",
                                        "route_fps", "forward_fps",
                                        "route_forward_fps",
                                        "stream_chunk_ms",
                                        "cudnn_forward_fps")] \
        + [streamed["sak"]["session"][k] for k in ("chunk_ms",
                                                   "route_chunk_ms")]
    if not all(math.isfinite(v) for v in numbers):
        fail("non-finite timing")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2:])
    else:
        main()
