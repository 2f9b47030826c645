#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile both kernels from lstm_ctc_tpu_torch/csrc/;
  3. kernel A (BLSTM layer forward) against its plain PyTorch version at
     B=32, T=384, H=P=320, D=640, ragged lengths, with and without packed-row
     resets, in float32 (TF32 off) and bfloat16;
  4. kernel B (MoE expert mix) against its plain version at N=12288, D=640,
     E=V=72, tau=10, keep 1.0 and 0.9;
  5. end to end: the flagship model (random weights from a seed) serves
     64 synthetic utterances through ``lstm_ctc_tpu_torch.bin.nnet_forward``
     on cuda, batch 32, in bfloat16 (the default on CUDA); the archive is
     read back and checked and the kernel launch counts are checked.  The
     same forward in float32 must equal the plain versions' float32
     forward.  In bfloat16 the same forward is run once more with every
     kernel launch held to its plain version on the very tensors the model
     gave it, and each launch must have the compute dtype bfloat16: kernel
     B's output, and each step of each layer of kernel A, replayed from the
     kernel's own per-step states;
  6. prints the kernels' JSON line, the nvidia-smi line, and as the last
     line ``{"ok": true, "device": {...}}``.

Tolerances (stated, with their reasons, in PERF.md): kernel vs plain,
float32, max|diff| / max|plain| <= 1e-4 per output; bfloat16 kernel A, the
same ratio <= 2e-2; bfloat16 kernel B, max|diff| <= 5e-2.  On the main
bfloat16 path: kernel A's steps, the ratio <= 1e-3 (one step's rounding
differences only); kernel B, max|diff| <= 5e-2.  End to end on log-posteriors,
float32 kernels vs plain: mean |diff| <= 1e-3 and max |diff| <= 2e-2 (the
random-weight model amplifies last-bit differences about a thousandfold
over 4 layers and ~400 steps).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

F32_REL_TOL = 1e-4
BF16_LSTM_REL_TOL = 2e-2
BF16_ABS_TOL = 5e-2
BF16_STEP_REL_TOL = 1e-3
E2E_F32_MEAN_TOL = 1e-3
E2E_F32_MAX_TOL = 2e-2
LOGSUMEXP_TOL = 1e-4

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
    say("  kernel A %-8s reset=%-5s kernel %.3f ms  plain %.3f ms"
        % (str(dtype).split(".")[-1], reset, ms, plain_ms))
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
    """Route the model through the plain PyTorch versions on the card."""
    with mock.patch.object(pkg["lstm_kernels"], "lstm_layer_forward",
                           pkg["cells"].dual_recurrence), \
            mock.patch.object(pkg["moe_kernels"], "moe_mix_fused",
                              pkg["moe_kernels"].moe_mix_reference):
        yield


@contextlib.contextmanager
def held_to_plain(torch, pkg, dtype, worst):
    """Run each kernel launch of the model, then its plain version on the
    same tensors; fail on a launch of another compute dtype or outside the
    bounds.  ``worst`` collects the largest error per kernel."""
    cells, lstm_kernels, moe_kernels = (
        pkg["cells"], pkg["lstm_kernels"], pkg["moe_kernels"])
    kernel_a, kernel_b = lstm_kernels.lstm_layer_forward, \
        moe_kernels.moe_mix_fused

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

    def mix(*args, **kwargs):
        got = kernel_b(*args, **kwargs)
        if kwargs.get("compute_dtype") != dtype:
            fail("kernel B launched in %s, expected %s"
                 % (kwargs.get("compute_dtype"), dtype))
        err = errors(got, moe_kernels.moe_mix_reference(*args, **kwargs))[0]
        worst["moe_fwd"] = max(worst["moe_fwd"], err)
        if err > BF16_ABS_TOL:
            fail("kernel B on the main path: abs error %.3e > %.1e"
                 % (err, BF16_ABS_TOL))
        return got

    # a wrapper counts its launches on the name it is bound to, which is
    # the stand-in's while patched; the counted main run is unpatched
    layer.launches = mix.launches = 0
    with mock.patch.object(lstm_kernels, "lstm_layer_forward", layer), \
            mock.patch.object(moe_kernels, "moe_mix_fused", mix):
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
        moe_kernels.moe_mix_fused.launches = 0
        start = time.perf_counter()
        written = nnet_forward.main(argv)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - start
        launches = {"lstm_fwd": lstm_kernels.lstm_layer_forward.launches,
                    "moe_fwd": moe_kernels.moe_mix_fused.launches}
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
        result["model_ms"], result["model_plain_ms"] = ms, plain_ms
    return result


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
    from lstm_ctc_tpu_torch.ops import lstm_kernels, moe_kernels
    pkg = {"cells": cells, "moe": moe, "lstm_kernels": lstm_kernels,
           "moe_kernels": moe_kernels, "records": records}
    if "jax" in sys.modules or "lstm_ctc_tpu" in sys.modules:
        fail("the port imported jax or the reference package")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    say("phase 1 device: %s (%d visible); nvidia-smi: %s"
        % (kind, torch.cuda.device_count(), smi))
    say("  torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    info = _build.build()
    _build.library()
    say("phase 2 build: %.1f s -> %s" % (info["seconds"], info["path"]))
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas: " + line.strip())

    rng = np.random.RandomState(0)
    say("phase 3 kernel A (BLSTM layer forward)")
    lstm = {}
    for dtype in (torch.float32, torch.bfloat16):
        for reset in (False, True):
            lstm[(dtype, reset)] = check_lstm(torch, pkg, device, dtype, reset, rng)
    say("phase 4 kernel B (MoE expert mix)")
    moe_res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for keep_prob in (1.0, 0.9):
            moe_res[(dtype, keep_prob)] = check_moe(torch, pkg, device, dtype,
                                                    keep_prob, rng)
    say("phase 5 end to end (nnet_forward, flagship model, cuda)")
    e2e = end_to_end(torch, pkg, device, rng)

    a_err, a_ms, a_plain = lstm[(torch.bfloat16, False)]
    b_err, b_ms, b_plain = moe_res[(torch.bfloat16, 1.0)]
    kernels = [
        {"name": "lstm_fwd", "route": "cuda",
         "source": "lstm_ctc_tpu_torch/csrc/lstm_fwd.cu",
         "replaces": "lstm_ctc_tpu/ops/lstm_pallas.py:57",
         "launches": e2e["launches"]["lstm_fwd"], "max_abs_err": a_err,
         "ms": a_ms, "plain_ms": a_plain},
        {"name": "moe_fwd", "route": "cuda",
         "source": "lstm_ctc_tpu_torch/csrc/moe_fwd.cu",
         "replaces": "lstm_ctc_tpu/ops/moe_pallas.py:212",
         "launches": e2e["launches"]["moe_fwd"], "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain},
    ]
    say("summary on %s: nnet_forward %.1f frames/s (64 utterances, model "
        "init and checkpoint load included); flagship forward B=32 T=384 "
        "%.1f frames/s"
        % (smi, e2e["fps_warm"], 32 * 384 / e2e["model_ms"] * 1e3))
    say(json.dumps({"kernels": kernels}))
    say(smi)
    if not all(math.isfinite(v) for v in (a_ms, b_ms, e2e["fps_warm"])):
        fail("non-finite timing")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
