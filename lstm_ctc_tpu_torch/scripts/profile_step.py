"""Per-segment timing breakdown of the flagship train step.

    python -m lstm_ctc_tpu_torch.scripts.profile_step [--batch 32]
        [--time-steps 384] [--steps 100] [--json out.json]
        [--profile-dir DIR] [--tiny] [--device cuda|cpu]

The port's counterpart of ``scripts/profile_step.py``: the step's time is
attributed to the BLSTM chain, the MoE head, the CTC loss, the backward
pass and the optimizer by timing nested segments and differencing them,
each timed as the bench times (``lstm_ctc_tpu_torch/bench.py``: warmed,
then one window of ``--steps`` calls on the host clock ending in
``torch.cuda.synchronize()``):

  fwd_chain   the 4-layer BLSTM chain with a dense head (2P·V, small
              beside the MoE head's E·V)
  fwd_logits  the whole inference forward, MoE head included
  ctc_fwd     the CTC loss on fixed logits
  ctc_fwdbwd  the CTC loss and its gradient
  fwd_loss    the forward and the CTC value
  grad        the training loss's gradient (no optimizer)
  full_step   the train step (gradient, clip, adam)

It prints one line a segment, then a JSON report: ``segments_ms``,
``decomposition_ms`` (the reference's keys), train frames/s, MFU against
the H100's dense bf16 peak (989 TFLOP/s), the device, and for
``full_step`` the device ms of each kernel in one profiled step
(``torch.profiler``; null on the CPU).  ``--profile-dir`` writes a
``torch.profiler`` Chrome trace of each segment there.  The flagship runs
at keep 1.0 in the port's default dtypes; ``--tiny`` is the bench's smoke
width (2 layers of 16, 4 experts).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def profiled(torch, device, fn, trace=None):
    """One profiled call of ``fn`` (warmed first): {kernel name: device ms}
    on a card, longest first, else None; with ``trace``, its Chrome trace
    written there.  The region starts with 64 short spin kernels, left out
    of the rows: without them the profiler has lost the records of a
    region's first kernels on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(64):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize(device)
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    if trace:
        prof.export_chrome_trace(trace)
    if not cuda:
        return None
    rows = sorted(((evt.self_device_time_total / 1e3, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and evt.self_device_time_total > 0
                   and "spin_kernel" not in evt.key), reverse=True)
    return {key: round(ms, 4) for ms, key in rows}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-segment timing of the flagship train step")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--time-steps", type=int, default=384)
    ap.add_argument("--json", default=None)
    ap.add_argument("--profile-dir", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tiny", action="store_true",
                    help="the bench's smoke widths (harness check)")
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)

    import torch

    from lstm_ctc_tpu_torch.bench import (H100_BF16_PEAK_FLOPS, Bench,
                                          device_name,
                                          model_fwd_flops_per_frame)
    from lstm_ctc_tpu_torch.cli import resolve_device
    from lstm_ctc_tpu_torch.graft_entry import FLAGSHIP_CONFIG, _example_batch
    from lstm_ctc_tpu_torch.models import apply_model, init_model
    from lstm_ctc_tpu_torch.ops.ctc import ctc_loss
    from lstm_ctc_tpu_torch.train.graph import compute_losses, param_leaves

    device = resolve_device(args.device)
    config = dict(FLAGSHIP_CONFIG, dropout_rate=1.0)
    if args.tiny:
        config.update(num_layers=2, num_neurons=16, num_projects=16,
                      num_experts=4)
    b, t = args.batch, args.time_steps
    bench = Bench(device, args.steps, smoke=args.tiny)
    batch = bench.on_device(_example_batch(config, batch=b, time_steps=t))
    params, net_state = init_model(torch.Generator().manual_seed(0), config,
                                   device)
    frames = b * t
    segments = {}

    def timeit(name, run_once):
        dt = bench.seconds_per_step(run_once)
        segments[name] = dt
        print("%-12s %8.3f ms  (%.0f frames/s)" % (name, dt * 1e3,
                                                  frames / dt), flush=True)
        if args.profile_dir:
            os.makedirs(args.profile_dir, exist_ok=True)
            profiled(torch, device, run_once,
                     os.path.join(args.profile_dir, name + ".json"))
        return dt

    # fwd_chain: the recurrent chain; the model always applies a head, so
    # it is timed with a dense head and the difference is the MoE head's
    dense_cfg = dict(config, num_experts=0)
    params_dense, _ = init_model(torch.Generator().manual_seed(0), dense_cfg,
                                 device)
    out = {}

    def forward(p, cfg):
        with torch.no_grad():
            return apply_model(p, net_state, batch["nnet_input"],
                               batch["sequence_length"], cfg,
                               train=False)[0]

    timeit("fwd_chain", lambda: forward(params_dense, dense_cfg))
    timeit("fwd_logits", lambda: out.__setitem__(
        "logits", forward(params, config)))

    logits_fixed = out["logits"].float()

    def ctc_value(lg):
        return torch.sum(ctc_loss(lg, batch["sequence_length"],
                                  batch["nnet_target"],
                                  batch["target_length"]))

    def ctc_fwd():
        with torch.no_grad():
            return ctc_value(logits_fixed)

    def ctc_fwdbwd():
        lg = logits_fixed.detach().requires_grad_()
        return torch.autograd.grad(ctc_value(lg), lg)

    timeit("ctc_fwd", ctc_fwd)
    timeit("ctc_fwdbwd", ctc_fwdbwd)

    def fwd_loss():
        with torch.no_grad():
            return compute_losses(params, net_state, batch, config,
                                  train=False)[0]["loss"]

    timeit("fwd_loss", fwd_loss)

    from lstm_ctc_tpu_torch.train.checkpoint import tree_map
    from lstm_ctc_tpu_torch.train.graph import make_train_step
    train_params = tree_map(lambda x: x.detach().clone().requires_grad_(),
                            params)
    leaves = param_leaves(train_params)

    def grad():
        metrics, _, _ = compute_losses(train_params, net_state, batch, config,
                                       train=True)
        return torch.autograd.grad(metrics["loss"], leaves)

    timeit("grad", grad)

    init_opt, train_step = make_train_step(config, learn_rate=1e-3,
                                           optimizer="adam")
    opt_state = init_opt(train_params)
    generator = torch.Generator(device).manual_seed(1)

    def step_once():
        train_step(train_params, opt_state, net_state, generator, batch)

    timeit("full_step", step_once)
    kernels = profiled(torch, device, step_once) \
        if device.type == "cuda" else None

    fwd_flops = model_fwd_flops_per_frame(config)
    full = segments["full_step"]
    report = {
        "batch": b, "time_steps": t,
        "segments_ms": {k: round(v * 1e3, 3) for k, v in segments.items()},
        "decomposition_ms": {
            "blstm_chain_fwd": round(segments["fwd_chain"] * 1e3, 3),
            "moe_head_fwd": round(
                (segments["fwd_logits"] - segments["fwd_chain"]) * 1e3, 3),
            "ctc_fwd": round(segments["ctc_fwd"] * 1e3, 3),
            "ctc_bwd": round(
                (segments["ctc_fwdbwd"] - segments["ctc_fwd"]) * 1e3, 3),
            "backward_minus_forward": round(
                (segments["grad"] - segments["fwd_loss"]) * 1e3, 3),
            "optimizer_and_update": round(
                (segments["full_step"] - segments["grad"]) * 1e3, 3),
        },
        "train_frames_per_sec": round(frames / full, 1),
        "mfu": round(frames / full * 3 * fwd_flops / H100_BF16_PEAK_FLOPS,
                     4),
        "full_step_device_ms_by_kernel": kernels,
        "full_step_device_ms": (round(sum(kernels.values()), 3)
                                if kernels is not None else None),
        "device": device_name(device),
    }
    print(json.dumps(report), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)


if __name__ == "__main__":
    sys.exit(main())
