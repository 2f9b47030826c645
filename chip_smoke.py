#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the kernels from lstm_ctc_tpu_torch/csrc/ (one nvcc per
     source, all started together);
  3. kernel A (K1, BLSTM layer forward) against its plain PyTorch version
     at B=32, T=384, H=P=320, D=640, ragged lengths, with and without
     packed-row resets, in float32 (TF32 off) and bfloat16; each time also
     in us a step, and bfloat16 with resets timed once more as the train
     step calls it (per-step states kept in bfloat16);
  4. kernel B (MoE expert mix) against its plain version at N=12288, D=640,
     E=V=72, tau=10, keep 1.0 and 0.9; beside the bf16 kernel, cuBLAS's bare
     product x·W at the same shape (the product alone, not K4's function);
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
     lattice of 1101 positions, a MoE head of V=136 in bf16 and of D=1100
     in float32, a bf16 BLSTM layer of H=P=384 in training, a bf16 lstm
     stack of H=P=384 in training, which K12 has no plan for): equal to
     the plain version, one warning, no kernel launch;
  7. K2 (BLSTM layer backward) against its plain version at B=32, T=384,
     H=P=320, D=640, ragged lengths, with and without resets, float32
     (TF32 off) and bfloat16 (in bfloat16 also each step replayed from
     the kernel's own carries); timed in turns;
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
     train step);
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
     of each call beside its time on the events;
 12. K13 (its backward) against its plain version at both widths (keep 0.9
     for lstm), under phase 7's rules (bfloat16: each step replayed from the
     kernel's own carries and input cotangents); timed in turns;
 13. serving: nnet_forward for an lstm and a cudnnlstm model (random
     weights from a seed) on phase 5's corpus, bf16 (launch counts, the
     archive, a float32 run against the plain versions, every bf16 K12
     launch replayed step by step), then 8 utterances of the lstm model
     through --streaming true --chunk-frames 16 (one K12 launch a chunk),
     its output against the offline output, ms per chunk and the
     real-time factor of a session on the card;
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
     dgates); timed in turns;
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
 19. prints the kernels' JSON line, the summary lines, the nvidia-smi line,
     and as the last line ``{"ok": true, "device": {...}}``.

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
step.  K5/K6/K8/K9, bfloat16: the mixed output max|diff| <= 5e-2 (as K4),
th and dz within one bf16 rounding step of the plain versions' (a last-bit
difference of the float32 sums may flip a rounding), dx, dgate, dw and db
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
mask drops and non-zero wherever it keeps a non-zero plain value.  cuDNN's
LSTM against K12 in float32: <= 1e-4.  Streaming against offline
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


def time_in_turns(torch, kernel, plain, rounds: int, kernel_reps: int = 4):
    """Median ms of ``kernel`` and of ``plain``, after a warm-up of both,
    measured in turns (plain then kernel, kernel then plain, ...), so that
    clock and neighbour drift fall on both alike."""
    for fn in (kernel, plain, kernel, plain):
        fn()
    torch.cuda.synchronize()
    kernel_ms, plain_ms = [], []
    for r in range(rounds):
        for fn in ((plain, kernel) if r % 2 == 0 else (kernel, plain)):
            if fn is kernel:
                kernel_ms += [elapsed_ms(torch, kernel)
                              for _ in range(kernel_reps)]
            else:
                plain_ms.append(elapsed_ms(torch, plain))
    return statistics.median(kernel_ms), statistics.median(plain_ms)


def median_ms(torch, fn, reps: int) -> float:
    """Median ms of ``fn`` on the CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(elapsed_ms(torch, fn) for _ in range(reps))


def errors(got, ref):
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def check_lstm(torch, pkg, device, dtype, reset, rng):
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    batch, steps, dim, units = 32, 384, 640, 320
    gen = torch.Generator().manual_seed(11)
    fw = cells.init_lstm_cell(gen, dim, units, units, True, device)
    bw = cells.init_lstm_cell(gen, dim, units, units, True, device)
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
    worst_abs = worst_rel = 0.0
    for name, g, r in zip(("out", "c_fin", "h_fin"), got, ref):
        if not torch.isfinite(g).all():
            fail("kernel A %s: non-finite %s" % (dtype, name))
        abs_err, rel_err = errors(g, r)
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel, rel_err)
        say("  kernel A %-8s reset=%-5s %-5s max_abs %.3e  rel %.3e"
            % (str(dtype).split(".")[-1], reset, name, abs_err, rel_err))
    tol = F32_REL_TOL if dtype == torch.float32 else BF16_LSTM_REL_TOL
    if worst_rel > tol:
        fail("kernel A %s reset=%s: relative error %.3e > %.1e"
             % (dtype, reset, worst_rel, tol))
    ms, plain_ms = time_in_turns(
        torch, lambda: lstm_kernels.lstm_layer_forward(*args),
        lambda: cells.dual_recurrence(*args), rounds=5)
    say("  kernel A %-8s reset=%-5s kernel %.3f ms (%.2f us a step)  plain "
        "%.3f ms" % (str(dtype).split(".")[-1], reset, ms, ms / steps * 1e3,
                     plain_ms))
    if dtype == torch.bfloat16 and reset:
        # as the train step calls it: the per-step states kept in bf16
        train_ms = median_ms(torch, lambda: lstm_kernels.lstm_layer_forward(
            *args, states=True, store_dtype=torch.bfloat16), reps=20)
        say("  kernel A bfloat16 reset=True as the train step calls it "
            "(states=True, bf16 c_all and h_all): %.3f ms (%.2f us a step)"
            % (train_ms, train_ms / steps * 1e3))
    return worst_abs, ms, plain_ms


def check_moe(torch, pkg, device, dtype, keep_prob, rng):
    moe, moe_kernels = pkg["moe"], pkg["moe_kernels"]
    n, dim, experts, targets, tau = 12288, 640, 72, 72, 10.0
    gen = torch.Generator().manual_seed(12)
    params = moe.init_moe(gen, dim, targets, experts, device)
    x = torch.from_numpy(
        (0.5 * rng.randn(n, dim)).astype(np.float32)).to(device)
    b = torch.from_numpy(
        (0.1 * rng.randn(experts * targets)).astype(np.float32)).to(device)
    gate = torch.softmax(torch.from_numpy(
        rng.randn(n, experts).astype(np.float32)).to(device), dim=-1)
    seed = -123457 if keep_prob < 1.0 else None
    args = (x, params["w_expert"], b, gate, experts, tau, keep_prob, seed,
            dtype)
    got = moe_kernels.moe_mix_fused(*args)
    ref = moe_kernels.moe_mix_reference(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("kernel B %s: non-finite output" % dtype)
    abs_err, rel_err = errors(got, ref)
    say("  kernel B %-8s keep=%.1f max_abs %.3e  rel %.3e"
        % (str(dtype).split(".")[-1], keep_prob, abs_err, rel_err))
    if dtype == torch.float32 and rel_err > F32_REL_TOL:
        fail("kernel B f32 keep=%.1f: relative error %.3e > %.1e"
             % (keep_prob, rel_err, F32_REL_TOL))
    if dtype == torch.bfloat16 and abs_err > BF16_ABS_TOL:
        fail("kernel B bf16 keep=%.1f: abs error %.3e > %.1e"
             % (keep_prob, abs_err, BF16_ABS_TOL))
    ms, plain_ms = time_in_turns(
        torch, lambda: moe_kernels.moe_mix_fused(*args),
        lambda: moe_kernels.moe_mix_reference(*args), rounds=10)
    say("  kernel B %-8s keep=%.1f kernel %.3f ms  plain %.3f ms"
        % (str(dtype).split(".")[-1], keep_prob, ms, plain_ms))
    if dtype == torch.bfloat16 and keep_prob == 1.0:
        xb = x.to(dtype)
        wb = params["w_expert"].to(dtype)
        bare = median_ms(torch, lambda: torch.mm(xb, wb,
                                                 out_dtype=torch.float32),
                         reps=20)
        say("  the product alone (not K4's function): cuBLAS x(bf16) "
            "[%d, %d] x W [%d, %d] -> float32 %.3f ms, K4 %.3f ms"
            % (n, dim, dim, experts * targets, bare, ms))
    return abs_err, ms, plain_ms


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

    # MoE, V = 136 in bf16 and D = 1100 in float32, one training step each
    wrappers = (mk.moe_mix_forward, mk.moe_mix_forward_stash,
                mk.moe_mix_backward, mk.moe_mix_backward_noemit,
                mk.moe_mix_wgrad, mk.moe_mix_backward_wgrad)
    for d, v, dtype, match in ((640, 136, torch.bfloat16, "136 targets"),
                               (1100, 72, torch.float32, "width of 1100")):
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
                                wgrad_mode="twokernel")
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
        say("  route, MoE D=%d V=%d %s training step: output and gradients "
            "equal to the plain version's: %s; no K4-K9 launch; warned: %s"
            % (d, v, str(dtype).split(".")[-1], same, text))
        if not same:
            fail("the routed MoE head differs from its plain version")

    # BLSTM, bf16 H = P = 384 in training
    config = {"nnet_type": "blstm", "input_dim": 40, "num_layers": 1,
              "num_neurons": 384, "num_projects": 384, "num_targets": 72,
              "use_peepholes": True, "compute_dtype": "bfloat16"}
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
        r"forward \(K1\) has no launch plan for a bfloat16 layer of "
        "H=384 P=384")
    fw, bw, _ = cells.bilstm_dual_scan(
        params["fwd"][0], params["bwd"][0], xb,
        cells.reverse_sequence(xb, seq), seq, blstm.FORGET_BIAS,
        compute_dtype=torch.bfloat16)
    cat = torch.cat([fw, cells.reverse_sequence(bw, seq)], dim=2)
    ref = (cat.reshape(-1, 768) @ params["head"]["w"]
           + params["head"]["b"]).reshape(logits.shape)
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    same = bool(torch.equal(logits, ref)) and all(
        torch.equal(a, b) for a, b in zip(grads, ref_grads))
    say("  route, BLSTM bf16 H=P=384 training: logits and gradients equal "
        "to the plain recurrence's: %s; no K1/K2/K3 launch; warned: %s"
        % (same, text))
    if not same:
        fail("the routed BLSTM layer differs from its plain version")

    # the unidirectional stack, bf16 H = P = 384 in training: K12 has no
    # plan, so layer by layer (where K1 refuses too: the plain recurrence)
    from lstm_ctc_tpu_torch.models import lstm
    stack, width = [], 40
    for _ in range(3):
        stack.append({k: t.to(device) for k, t in cells.init_lstm_cell(
            torch.Generator().manual_seed(width), width, 384, 384,
            True).items()})
        width = 384
    leaves = [t.requires_grad_() for c in stack for t in c.values()]
    flags = [False, True, True]

    def stack_step():
        out, _ = lstm.stack_layers(stack, xb, seq, flags, torch.bfloat16)
        return out, torch.autograd.grad(out.sum(), leaves)

    sk = pkg["lstm_stack_kernels"]
    (out, grads), text = routed(
        torch, stack_step, (sk.lstm_stack_forward, sk.lstm_stack_backward,
                            lk.lstm_layer_forward, lk.lstm_layer_backward),
        r"stack forward \(K12\) has no launch plan for a bfloat16 stack "
        "of H=384 P=384")
    ref = xb
    for cell, residual in zip(stack, flags):
        o = lstm.layer_forward(cell, ref, seq, torch.bfloat16)
        ref = o + ref if residual else o
    ref_grads = torch.autograd.grad(ref.sum(), leaves)
    same = bool(torch.equal(out, ref)) and all(
        torch.equal(a, b) for a, b in zip(grads, ref_grads))
    say("  route, lstm stack bf16 H=P=384 training: outputs and gradients "
        "equal to the layer-by-layer plain recurrence's: %s; no K12/K13/"
        "K1/K2 launch; warned: %s" % (same, text))
    if not same:
        fail("the routed lstm stack differs from its layer-by-layer version")


def lstm_bwd_case(torch, pkg, device, dtype, reset, rng, fold=False):
    """K2's arguments at the flagship layer shape: a K1 forward with its
    per-step states in the store dtype, and random output cotangents; with
    ``fold``, K3's: x2 (the 640-wide input and its reverse) and wx first."""
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    batch, steps, dim, units = 32, 384, 640, 320
    gen = torch.Generator().manual_seed(13)
    fw = cells.init_lstm_cell(gen, dim, units, units, True, device)
    bw = cells.init_lstm_cell(gen, dim, units, units, True, device)
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


def check_lstm_bwd(torch, pkg, device, dtype, reset, rng):
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    args = lstm_bwd_case(torch, pkg, device, dtype, reset, rng)
    name = str(dtype).split(".")[-1]
    got = lstm_kernels.lstm_layer_backward(*args, store_dtype=dtype)
    ref = cells.dual_recurrence_backward(*args, store_dtype=dtype)
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for out, g, r in zip(("dgates", "dwh", "dproj", "dpeep"), got, ref):
        if not torch.isfinite(g.float()).all():
            fail("K2 %s: non-finite %s" % (name, out))
        abs_err = float((g.float() - r.float()).abs().max())
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel,
                                                            ratio(g, r))
        say("  K2 %-8s reset=%-5s %-6s max_abs %.3e  rel %.3e"
            % (name, reset, out, abs_err, ratio(g, r)))
    if dtype == torch.float32 and worst_rel > F32_REL_TOL:
        fail("K2 f32 reset=%s: relative error %.3e > %.1e"
             % (reset, worst_rel, F32_REL_TOL))
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
        rounding = within_bf16_step(dgates, dg)
        wgrad_rel = weight_grads_rel(full[1:4], wgrads)
        say("  K2 bfloat16 reset=%-5s per step: carries max rel %.3e (bound "
            "%.0e); dgates within one bf16 rounding step: %s; over the "
            "kernel's dgates: dwh, dproj and dpeep max rel %.3e (bound %.0e)"
            % (reset, step_rel, BF16_STEP_REL_TOL, rounding, wgrad_rel,
               BF16_STEP_REL_TOL))
        if (step_rel > BF16_STEP_REL_TOL or not rounding
                or wgrad_rel > BF16_STEP_REL_TOL):
            fail("K2 bf16 per-step replay or weight gradients outside their "
                 "bounds")
    ms, plain_ms = time_in_turns(
        torch, lambda: lstm_kernels.lstm_layer_backward(*args,
                                                        store_dtype=dtype),
        lambda: cells.dual_recurrence_backward(*args, store_dtype=dtype),
        rounds=3, kernel_reps=2)
    bound_ms, bound_by = lstm_bwd_bound(torch, args, got, dtype)
    steps, b2, h4 = args[0].shape
    how = lstm_kernels.backward_config(device, b2 // 2, h4 // 4,
                                       args[3].shape[1], args[4] is not None,
                                       dtype)
    say("  K2 %-8s reset=%-5s kernel %.3f ms (%.1f us/step; R=%d rows a "
        "cluster, %d clusters, %d bytes of shared memory a block)  plain "
        "%.3f ms  bound %.4f ms (%s)"
        % (name, reset, ms, 1e3 * ms / steps, how["rows"], how["clusters"],
           how["smem_bytes"], plain_ms, bound_ms, bound_by))
    return {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def weight_grads_rel(got, ref):
    """The largest max|diff|/max|plain| of K2's (dwh, dproj, dpeep) against
    the plain sums ``ref`` (None where the layer has no such weight)."""
    return max(ratio(g, r) for g, r in zip(got, ref) if r is not None)


def lstm_bwd_bound(torch, inputs, outputs, dtype, fold=False):
    """(least ms, what sets it) of K2 (or, with ``fold``, K3) called on
    ``inputs`` (K3: x2, wx, then K2's) and returning ``outputs``: each
    tensor read or written once; the products this run's data needs, over
    the live rows only (each sequence's length, in both directions; past
    it a row's dgates are zero): the recurrence's (the gate recompute,
    dout_blk and dh_prev), dwh and dproj, and K3's dwx and dx."""
    gx, seq, wh = (inputs[2 * fold + i] for i in (0, 1, 3))
    h4 = gx.shape[-1]
    units, out_dim = h4 // 4, wh.shape[1]
    rows = 2 * int(seq.sum())
    flops = 2 * rows * out_dim * (2 * h4 + units) \
        + 2 * rows * (out_dim * h4 + units * out_dim)
    if fold:
        flops += 2 * 2 * rows * h4 * inputs[0].shape[-1]
    peak = BF16_FLOPS_PER_MS if dtype == torch.bfloat16 else F32_FLOPS_PER_MS
    return bound(tensor_bytes(torch, inputs, outputs), flops, peak)


def check_lstm_bwd_fold(torch, pkg, device, dtype, reset, rng):
    """Phase 15: K3 against its plain version under phase 7's rules, and
    its input side against the plain one over the kernel's own dgates."""
    cells, lstm_kernels = pkg["cells"], pkg["lstm_kernels"]
    args = lstm_bwd_case(torch, pkg, device, dtype, reset, rng, fold=True)
    name = str(dtype).split(".")[-1]
    names = ("dx", "dwx", "dbias", "dwh", "dproj", "dpeep")
    got = lstm_kernels.lstm_layer_backward_fold(*args, store_dtype=dtype)
    torch.cuda.synchronize()
    for out, g in zip(names, got):
        if not torch.isfinite(g.float()).all():
            fail("K3 %s: non-finite %s" % (name, out))
    if dtype == torch.float32:
        ref = cells.dual_recurrence_backward_fold(*args, store_dtype=dtype)
        rels = {out: ratio(g, r) for out, g, r in zip(names, got, ref)}
        say("  K3 float32 reset=%-5s max|diff|/max|plain|: %s"
            % (reset, ", ".join("%s %.2e" % kv for kv in rels.items())))
        if max(rels.values()) > F32_REL_TOL:
            fail("K3 f32 reset=%s: relative error %.3e > %.1e"
                 % (reset, max(rels.values()), F32_REL_TOL))
        worst_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
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
        rounding = within_bf16_step(dgates, dg)
        dx, dwx, dbias = cells.fold_input_side(args[0], args[1], dgates,
                                               dtype)
        terms = cells.fold_input_side(args[0], args[1].abs(), dgates.abs(),
                                      torch.float32)[0]
        dx_ok = bool(((full[0].float() - dx.float()).abs()
                      <= 2.0 ** -7 * dx.float().abs()
                      + SUM_ORDER_TOL * terms).all())
        side_rel = max(ratio(full[1], dwx), ratio(full[2], dbias),
                       weight_grads_rel(full[3:6], wgrads))
        say("  K3 bfloat16 reset=%-5s per step: carries max rel %.3e (bound "
            "%.0e); dgates within one bf16 rounding step: %s; over the "
            "kernel's dgates: dx within one bf16 rounding step (and 16 f32 "
            "ulps of its terms' sum): %s, dwx, dbias, dwh, dproj and dpeep "
            "max rel %.3e (bound %.0e)"
            % (reset, step_rel, BF16_STEP_REL_TOL, rounding, dx_ok, side_rel,
               BF16_STEP_REL_TOL))
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
    bound_ms, bound_by = lstm_bwd_bound(torch, args, got, dtype, fold=True)
    say("  K3 %-8s reset=%-5s kernel %.3f ms (K2 alone on the same inputs "
        "%.3f ms)  plain %.3f ms  bound %.4f ms (%s)"
        % (name, reset, ms, k2_ms, plain_ms, bound_ms, bound_by))
    result = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "k2_ms": k2_ms}
    if dtype == torch.bfloat16:
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


def check_steps(torch, pkg, device, config, nnet, train_batcher, step_ms):
    """On one packed batch of the training stream, from the trained weights
    in ``nnet``: the float32 step against the plain versions (each launch
    on its own tensors, then end to end under the nudge yardstick), one
    bfloat16 step with every launch held to its plain version, and a
    profiled bfloat16 step."""
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
    held = ("lstm_bwd", "ctc_alpha", "ctc_beta") + (
        ("moe_fwd_stash", "moe_bwd") if moe else ())
    worst = {k: 0.0 for k in held}
    init_opt, step = make_train_step(train_config, 1e-3, "adam")
    params = fresh_weights(torch, base)
    with held_in_training(torch, pkg, worst):
        step(params, init_opt(params), {},
             torch.Generator(device).manual_seed(1), batch)
        torch.cuda.synchronize()
    say("  bfloat16 train step, each launch vs its plain version: K2 "
        "per-step carries max rel %.3e (bound %.0e); K10 %.3e, K11 %.3e "
        "(bound %.0e on |diff|/max(1,|plain|))"
        % (worst["lstm_bwd"], BF16_STEP_REL_TOL, worst["ctc_alpha"],
           worst["ctc_beta"], CTC_TOL))
    if moe:
        say("  bfloat16 train step: K5 out max_abs %.3e (bound %.0e), th "
            "within one bf16 rounding step; K6 dx/dgate max rel %.3e (bound "
            "%.0e), dz within one bf16 rounding step"
            % (worst["moe_fwd_stash"], BF16_ABS_TOL, worst["moe_bwd"],
               BF16_MOE_REL_TOL))

    profile_step(torch, init_opt, step, fresh_weights(torch, base), batch,
                 device, step_ms)


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
        rounding = within_bf16_step(dgates, dg)
        worst["lstm_bwd"] = max(worst["lstm_bwd"], rel)
        if rel > BF16_STEP_REL_TOL or not rounding:
            fail("K2 on the main path: a step's carries differ by %.3e "
                 "(bound %.0e); dgates within one rounding step: %s"
                 % (rel, BF16_STEP_REL_TOL, rounding))
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
        return run

    def stash(*args):
        # (x, w, b, gate, seed, E, tau, keep_prob)
        if args[1].dtype != torch.bfloat16:
            fail("K5 launched in %s, expected bfloat16" % args[1].dtype)
        out, th = k5(*args)
        ref_out, ref_th = moe_kernels.moe_stash_reference(*args)
        err = errors(out, ref_out)[0]
        worst["moe_fwd_stash"] = max(worst["moe_fwd_stash"], err)
        if err > BF16_ABS_TOL or not within_bf16_step(th, ref_th):
            fail("K5 on the main path: out max_abs %.3e (bound %.0e), th "
                 "within one bf16 rounding step: %s"
                 % (err, BF16_ABS_TOL, within_bf16_step(th, ref_th)))
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
    with contextlib.ExitStack() as stack:
        for module, name, fn in stand_ins:
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
# K6 is moe_bwd_wgmma with the dz stream)
SHARE_KERNELS = (
    ("K1 (lstm_fwd_kernel)", r"lstm_fwd_kernel"),
    ("K4 (moe_fwd_wgmma, no stash)", r"moe_fwd_wgmma<[^>]*false>"),
    ("K5 (moe_fwd_wgmma, stash)", r"moe_fwd_wgmma<[^>]*true>"),
    ("K6 (moe_bwd_wgmma, dz)", r"moe_bwd_wgmma<[^>]*true>"))


def kernel_shares(rows, busy):
    """K1's launches in a profile's kernel rows and its share of the device
    time, and K4's, K5's and K6's where they ran."""
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


def moe_train_case(torch, pkg, device, rng):
    """K5-K9's inputs at the training shape: x [N, 640], the expert
    weights, bias, gate, an output cotangent and a device seed."""
    n, dim, experts, targets = MOE_TRAIN_ROWS, 640, 72, 72
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


def check_moe_training(torch, pkg, device, rng):
    """K5, K6, K8 and K9 against their plain versions at the training
    shape, then timed in turns with them (keep 0.9, as training runs)."""
    mk = pkg["moe_kernels"]
    x, w32, b, gate, gout, seed = moe_train_case(torch, pkg, device, rng)
    n, dim = x.shape
    experts, targets, tau = 72, 72, 10.0
    ev = experts * targets
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        w = w32.to(dtype).contiguous()
        for keep in (1.0, 0.9):
            args = (seed, experts, tau, keep)
            out, th = mk.moe_mix_forward_stash(x, w, b, gate, *args)
            ref_out, ref_th = mk.moe_stash_reference(x, w, b, gate, *args)
            dx, dgate, dz = mk.moe_mix_backward(th, w, gate, gout, *args)
            ref_dx, ref_dgate, ref_dz = mk.moe_backward_reference(
                th, w, gate, gout, *args)
            dx8, dgate8 = mk.moe_mix_backward_noemit(th, w, gate, gout, *args)
            dw, db = mk.moe_mix_wgrad(x, th, gate, gout, *args)
            ref_dw, ref_db = mk.moe_wgrad_reference(x, th, gate, gout, *args)
            if dtype == torch.bfloat16:
                # bf16 K9 makes K7's dz bits and db partials, then runs
                # K7's second stage: (dw, db) equal K7's bit for bit
                k7 = mk.moe_mix_backward_wgrad(x, th, w, gate, gout, *args)
                if not (torch.equal(dw, k7[2]) and torch.equal(db, k7[3])):
                    fail("K9 bf16 keep=%.1f: dw or db differ from K7's"
                         % keep)
                say("  K9 bfloat16 keep=%.1f: dw and db equal K7's bit for "
                    "bit" % keep)
            torch.cuda.synchronize()
            pairs = {"out": (out, ref_out), "th": (th, ref_th),
                     "dx": (dx, ref_dx), "dgate": (dgate, ref_dgate),
                     "dz": (dz, ref_dz), "dw": (dw, ref_dw),
                     "db": (db, ref_db)}
            for key, (g, _) in pairs.items():
                if not torch.isfinite(g.float()).all():
                    fail("K5-K9 %s keep=%.1f: non-finite %s"
                         % (name, keep, key))
            rels = {key: ratio(g, r) for key, (g, r) in pairs.items()}
            same8 = torch.equal(dx8, dx) and torch.equal(dgate8, dgate)
            say("  K5/K6/K9 %-8s keep=%.1f max|diff|/max|plain|: %s; K8's "
                "dx and dgate equal K6's: %s"
                % (name, keep, ", ".join("%s %.2e" % kv
                                         for kv in rels.items()), same8))
            if not same8:
                fail("K8 differs from K6 (%s keep=%.1f)" % (name, keep))
            if dtype == torch.float32:
                if max(rels.values()) > F32_REL_TOL:
                    fail("K5-K9 f32 keep=%.1f: relative error %.3e > %.1e"
                         % (keep, max(rels.values()), F32_REL_TOL))
            else:
                out_abs = errors(out, ref_out)[0]
                steps_ok = (within_bf16_step(th, ref_th),
                            within_bf16_step(dz, ref_dz))
                grad_rel = max(rels[k] for k in ("dx", "dgate", "dw", "db"))
                say("  K5-K9 bfloat16 keep=%.1f: out max_abs %.3e (bound "
                    "%.0e); th, dz within one bf16 rounding step: %s, %s; "
                    "dx, dgate, dw, db max rel %.3e (bound %.0e)"
                    % ((keep, out_abs, BF16_ABS_TOL) + steps_ok
                       + (grad_rel, BF16_MOE_REL_TOL)))
                if (out_abs > BF16_ABS_TOL or not all(steps_ok)
                        or grad_rel > BF16_MOE_REL_TOL):
                    fail("K5-K9 bf16 keep=%.1f outside its bounds" % keep)
            if keep == 1.0:
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
                 n * dim * 4 + ev * 4 + small + n * ev * isz, out, ref_out),
                ("moe_bwd", mk.moe_mix_backward, mk.moe_backward_reference,
                 (th, w, gate, gout) + args, k8_bytes + n * ev * isz, dx,
                 ref_dx),
                ("moe_bwd_noemit", mk.moe_mix_backward_noemit,
                 mk.moe_backward_noemit_reference, (th, w, gate, gout) + args,
                 k8_bytes, dx8, ref_dx),
                ("moe_wgrad", mk.moe_mix_wgrad, mk.moe_wgrad_reference,
                 (x, th, gate, gout) + args,
                 n * dim * 4 + n * ev * isz + small - dim * ev * isz
                 + dim * ev * 4 + ev * 4, dw, ref_dw))
            for kname, kernel, plain, kargs, nbytes, got, ref in cases:
                ms, plain_ms = time_in_turns(
                    torch, lambda: kernel(*kargs), lambda: plain(*kargs),
                    rounds=3, kernel_reps=3)
                bound_ms, bound_by = bound(nbytes, flops, peak)
                say("  %-14s %-8s kernel %.3f ms  plain %.3f ms  bound %.4f "
                    "ms (%s: %.1f MB, %.1f GFLOP)"
                    % (kname, name, ms, plain_ms, bound_ms, bound_by,
                       nbytes / 1e6, flops / 1e9))
                result[(kname, dtype)] = {
                    "max_abs_err": errors(got, ref)[0], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by}

            def default():
                _, _, dz_ = mk.moe_mix_backward(th, w, gate, gout, *args)
                return mk.product_f32(x.to(dtype).t(), dz_), dz_.float().sum(0)

            def twokernel():
                mk.moe_mix_backward_noemit(th, w, gate, gout, *args)
                return mk.moe_mix_wgrad(x, th, gate, gout, *args)

            if dtype == torch.bfloat16:
                dzb = dz.to(dtype)
                wt = w.t()
                bare = median_ms(torch, lambda: torch.mm(
                    dzb, wt, out_dtype=torch.float32), reps=20)
                pack_ms = [median_ms(torch, lambda: pack(w, experts), reps=20)
                           for pack in (mk.fwd_pack, mk.bwd_pack)]
                say("  the product alone (not K6's function): cuBLAS dz(bf16) "
                    "[%d, %d] x W^T [%d, %d] -> float32 %.3f ms, K6 %.3f ms; "
                    "W's packed images (once a train step): fwd_pack %.3f ms, "
                    "bwd_pack %.3f ms"
                    % ((n, ev, ev, dim, bare,
                        result[("moe_bwd", dtype)]["ms"]) + tuple(pack_ms)))
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

# the A/B's variants (python -m lstm_ctc_tpu_torch.scripts.ab_train_step)
AB_VARIANTS = ("default=", "fold=lstm_fold_dx=true",
               "k7=moe_wgrad_mode=kernel", "twokernel=moe_wgrad_mode=twokernel")
AB_STEPS = 30


def fold_subset(work, scp, config, steps=2):
    """An scp of the first utterances of ``scp`` that nnet_train packs
    (pack factor 3, batch 32, its shuffle seed 777) into ``steps`` steps;
    returns (its path, its batcher)."""
    from lstm_ctc_tpu_torch.cli import build_batcher
    from lstm_ctc_tpu_torch.host.data import scan_scp
    metas = scan_scp(scp)
    path = os.path.join(work, "folds.scp")
    for count in range(32, len(metas) + 1, 4):
        with open(path, "w") as fh:
            for meta in metas[:count]:
                fh.write(meta.scp_line())
        batcher = build_batcher(path, config, 32, pack_factor=3)
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
    cmd += list(AB_VARIANTS) + ["--batch", "32", "--time-steps", "384",
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
    names = [ab.parse_variant(spec)[0] for spec in AB_VARIANTS]
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
               affine=False, init=False, full=False):
    """K12's arguments at a family's full width (4 layers of 320 cells;
    ``lstm``: projection 320, peepholes, layers 1-3 residual; ``cudnnlstm``:
    neither), B=32, T=384, a 120-wide input, built as lstm_stack_fused
    builds them; ragged lengths unless ``full``."""
    cells, sk = pkg["cells"], pkg["lstm_stack_kernels"]
    batch, steps, dim, units, layers = 32, 384, 120, 320, STACK_LAYERS
    proj = 320 if family == "lstm" else None
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


def stack_launch(sk, device, case, ms, backward=False, store_dtype=None):
    """How K12 (K13) launched on ``case``: R rows a cluster, the clusters,
    the waves, the lag K, the shared memory a block, and the us per
    wavefront step (``ms`` over the waves' S steps each)."""
    steps, batch, h4 = case["gx0"].shape
    layers, p2, _ = case["wz"].shape
    how = sk.stack_config(device, steps, layers, batch, h4 // 4, p2 // 2,
                          case["proj"] is not None, case["wz"].dtype,
                          backward, store_dtype or case["wz"].dtype)
    return ("R=%d rows a cluster, %d clusters in %d wave(s) of up to %d, "
            "lag K=%d, %d bytes of shared memory a block, %.2f us per "
            "wavefront step" % (
                how["rows"], layers * how["tiles"], how["waves"],
                layers * how["per_wave"], how["lag"], how["smem_bytes"],
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
                dropped = True
                if keep < 1.0:
                    # the dropped positions are the plain mask's: zero
                    # where it drops, not zero where it keeps a value the
                    # plain version makes non-zero
                    kchain, pchain = got[names.index("chain")], \
                        ref[names.index("chain")]
                    steps, lb, out_dim = kchain.shape
                    drop = sk._drop_mask(case["seed"], keep, steps,
                                         STACK_LAYERS, lb // STACK_LAYERS,
                                         out_dim, device).view(kchain.shape)
                    dropped = bool((kchain[drop == 0] == 0).all()) and bool(
                        (kchain[(drop > 0) & (pchain.abs() > 1e-6)] != 0)
                        .all())
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


def cudnn_yardstick(torch, pkg, device, rng):
    """The library yardstick at the cudnnlstm width (full lengths): cuDNN's
    LSTM gives K12's outputs in float32 (TF32 off); then cuDNN's forward,
    and its forward plus backward, timed in bf16 beside K12 and K13, with
    its weights in one buffer (no copy at a call), and each call's device
    time from the profiler beside its time on the CUDA events."""
    sk = pkg["lstm_stack_kernels"]
    case, params, x, _ = stack_case(torch, pkg, device, torch.float32,
                                    "cudnnlstm", rng, full=True)
    lstm = cudnn_lstm(torch, params, device)
    steps = x.shape[1]
    with torch.no_grad():
        want = lstm(x.transpose(0, 1))[0]
        got = sk.lstm_stack_forward(**case)[0][STACK_LAYERS - 1:
                                               STACK_LAYERS - 1 + steps]
    rel = ratio(got, want)
    say("  cuDNN LSTM vs K12, float32, cudnnlstm width: max rel %.3e (bound "
        "%.0e)" % (rel, F32_REL_TOL))
    if rel > F32_REL_TOL:
        fail("cuDNN's LSTM and K12 disagree: the weights are not mapped")
    case16, _, _, _ = stack_case(torch, pkg, device, torch.bfloat16,
                                 "cudnnlstm", rng, full=True)
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
    compacted = [w for w in caught if "contiguous chunk" in str(w.message)]
    if compacted:
        fail("cuDNN copied its weights at a call: %s" % compacted[0].message)
    say("  cuDNN bf16, cudnnlstm width, full lengths, weights in one buffer "
        "(no compaction warning): forward %.3f ms on the events, %.3f ms of "
        "device kernels (K12, one launch, %.3f ms); forward + backward %.3f "
        "ms, %.3f ms of device kernels"
        % (lib_fwd, fwd_dev, k12_ms, lib_both, both_dev))
    for tag, rows in (("forward", fwd_rows), ("forward + backward",
                                              both_rows)):
        say("    cuDNN %s kernels: %s" % (tag, "; ".join(
            "%.3f ms %d x %s" % (ms, count, key[:60])
            for ms, count, key in rows[:5])))
    return {"forward": lib_fwd, "both": lib_both}


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


def check_posteriors(posts, raw_lengths, subsample=3):
    """The archive holds every key, (raw // subsample) x 72 finite
    log-posteriors whose rows sum to one; returns the frame count."""
    if sorted(posts) != sorted(raw_lengths):
        fail("archive keys differ from the corpus keys")
    frames = 0
    for key, mat in posts.items():
        if mat.shape != (raw_lengths[key] // subsample, 72):
            fail("%s: shape %s, expected (%d, 72)"
                 % (key, mat.shape, raw_lengths[key] // subsample))
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


def start_seconds(argv, env, reps=3):
    """Median wall seconds of a command that does little but start."""
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
    say("  start of a tool, median of 3 (s): %s" % ", ".join(
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
    from lstm_ctc_tpu_torch import _build
    from lstm_ctc_tpu_torch.host.data import records
    from lstm_ctc_tpu_torch.models import cells, moe
    from lstm_ctc_tpu_torch.ops import (ctc, ctc_kernels, lstm_kernels,
                                        lstm_stack_kernels, moe_kernels)
    pkg = {"cells": cells, "moe": moe, "lstm_kernels": lstm_kernels,
           "moe_kernels": moe_kernels, "records": records, "ctc": ctc,
           "ctc_kernels": ctc_kernels,
           "lstm_stack_kernels": lstm_stack_kernels}

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
    say("  torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

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
    phase("phase 4 K4 (MoE expert mix)")
    moe_res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for keep_prob in (1.0, 0.9):
            moe_res[(dtype, keep_prob)] = check_moe(torch, pkg, device, dtype,
                                                    keep_prob, rng)
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
    with tempfile.TemporaryDirectory() as work:
        scp = write_labeled_corpus(pkg, work, rng)
        phase("phase 8 training end to end (nnet_init / nnet_train / "
            "nnet_validate, flagship dense-head model, cuda)")
        train = train_end_to_end(torch, pkg, device, work, scp)
        phase("phase 9 K5/K6/K8/K9 (MoE head training kernels)")
        moe_train = check_moe_training(torch, pkg, device, rng)
        phase("phase 10 MoE training end to end (nnet_train_loop, flagship "
            "MoE model, cuda)")
        moe_loop = train_moe_end_to_end(torch, pkg, device, work, scp)
        phase("phase 11 K12 (unidirectional stack forward)")
        k12 = check_stack_fwd(torch, pkg, device, rng)
        library = cudnn_yardstick(torch, pkg, device, rng)
        phase("phase 12 K13 (unidirectional stack backward)")
        k13 = check_stack_bwd(torch, pkg, device, rng)
        phase("phase 13 serving the unidirectional families (nnet_forward, "
            "offline and --streaming, cuda)")
        serve = serve_families(torch, pkg, device, rng)
        phase("phase 14 training the unidirectional families (nnet_init / "
            "nnet_train / nnet_validate, lstm, cudnnlstm, lstm_bn, cuda)")
        families = train_families(torch, pkg, device, work, scp)
        phase("phase 15 K3 (BLSTM layer backward, input side folded in)")
        fold = {}
        for dtype in (torch.float32, torch.bfloat16):
            for reset in (False, True):
                fold[(dtype, reset)] = check_lstm_bwd_fold(
                    torch, pkg, device, dtype, reset, rng)
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

    bad = reference_files()
    if "jax" in sys.modules or bad:
        fail("the port imported jax or files of the reference package: %s"
             % bad[:5])

    launches = dict(train["launches"])
    for run in (e2e, moe_loop, serve, families, folds, recipe):
        for k, v in run["launches"].items():
            launches[k] += v
    for name in KERNEL_NAMES:
        if launches[name] == 0:
            fail("%s was never launched on the main paths" % name)
    a_err, a_ms, a_plain = lstm[(torch.bfloat16, False)]
    b_err, b_ms, b_plain = moe_res[(torch.bfloat16, 1.0)]
    # K1: gx read and out written once (f32) at B=32, T=384, H=P=320
    k1_bytes = 384 * 64 * (4 * 320 + 320) * 4
    k1_flops = 2 * 384 * 64 * 320 * (4 * 320 + 320)
    # K4: 2·N·D·E·V at N=12288, D=640, E=V=72; x, out and W (bf16) once
    k4_flops = 2 * 12288 * 640 * 72 * 72
    k4_bytes = 12288 * 640 * 4 + 12288 * 72 * 4 + 640 * 72 * 72 * 2
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
         "launches": launches["moe_fwd"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain,
         "bound_ms": max(k4_bytes / HBM_BYTES_PER_MS,
                         k4_flops / BF16_FLOPS_PER_MS),
         "bound_by": "operations", "library_ms": None},
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
            **moe_train[(name, torch.bfloat16)]))
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
        + list(recipe["seconds"].values()) + list(recipe["starts"].values())
    if not all(math.isfinite(v) for v in numbers):
        fail("non-finite timing")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
