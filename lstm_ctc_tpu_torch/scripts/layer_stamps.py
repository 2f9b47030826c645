"""Where a wave-step of the streamed K1 and K2 goes, by phase: clock64
stamps in the kernels (``ops/lstm_kernels.stamp_phases``).

    python lstm_ctc_tpu_torch/scripts/layer_stamps.py

For each streamed layer shape of ``layer_parity.py`` (bf16, B = 32, T =
128, and H = P = 2048 at T = 32; seeded, no resets), each kernel runs at
its launcher's R and forced onto the one-row R of the plans before
several rows a cell-phase thread (``ONE_ROW``).  Thread 0 of the first
block of the first cluster sums each phase's cycles over the steps (its
own view: a phase ends at its block barrier, a cluster barrier's phase is
that block's wait); the line gives the cycles a step and each phase's
share, and beside them the launch's time on CUDA events (median of 3,
stamps off) and its us a wave-step, so a phase's us is its share of that.
Needs a CUDA card.
"""

import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
# the package this script lies in, unless PYTHONPATH names another tree
sys.path.append(os.path.dirname(os.path.dirname(HERE)))
from layer_parity import BATCH, SHAPES, case, median_ms  # noqa: E402

# (H, P) -> the one-row R of K1 and K2 (a cell-phase thread one row)
ONE_ROW = {(1024, 1024): (8, 6), (768, 768): (8, 8), (2048, 512): (4, 4),
           (2048, 2048): (4, 2)}
PLAN = "streamed, wh held as fits"


def stamped(lk, which, fn):
    """(cycles a step, [each phase's share]) of one launch of ``fn``"""
    buf = torch.zeros(7, dtype=torch.int64, device="cuda")
    lk.stamp_phases(which, buf)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        lk.stamp_phases(which, None)
    steps, *phases = buf.tolist()
    total = sum(phases)
    return total / max(steps, 1), [p / max(total, 1) for p in phases]


def main():
    import lstm_ctc_tpu_torch.models  # noqa: F401 (the ops' import order)
    from lstm_ctc_tpu_torch.ops import lstm_kernels as lk
    device = torch.device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print("layer_stamps on %s" % smi)
    for units, proj, dim, steps in SHAPES:
        c = case(units, proj, dim, steps, device)
        out_dim = proj or units
        name = "H=%d P=%d T=%d" % (units, out_dim, steps)
        fwd = (c["gx"], c["seq"], None, c["wh"], c["proj"], c["peep"], 1.0)
        _, _, _, c_all, h_all = lk.lstm_layer_forward(
            *fwd, states=True, store_dtype=torch.bfloat16)
        bwd = fwd + (c_all, h_all, c["dout"], c["dcfin"], c["dhfin"])
        for which, k in (("forward", 0), ("backward", 1)):
            config = getattr(lk, which + "_config")
            for rows in (0, ONE_ROW[(units, out_dim)][k]):
                plan = None if not rows else (PLAN, rows)
                if which == "forward":
                    def fn():
                        return lk.lstm_layer_forward(
                            *fwd, states=True, store_dtype=torch.bfloat16,
                            _plan=plan)
                else:
                    def fn():
                        return lk.lstm_layer_backward(
                            *bwd, store_dtype=torch.bfloat16, _plan=plan)
                how = config(device, BATCH, units, out_dim, proj is not None,
                             torch.bfloat16, rows=rows)
                cycles, shares = stamped(lk, which, fn)
                ms = median_ms(fn, reps=3)
                print("%s %s R=%d (%d clusters, %d wave(s)): %.3f ms, %.2f us "
                      "a wave-step; %.0f cycles a step: %s" % (
                          "K1" if k == 0 else "K2", name, how["rows"],
                          how["clusters"], how["waves"], ms,
                          1e3 * ms / (steps * how["waves"]), cycles,
                          ", ".join("%s %.1f%%" % (p, 100 * s) for p, s in
                                    zip(lk.STAMP_PHASES[which], shares)
                                    if s > 0)), flush=True)


if __name__ == "__main__":
    main()
