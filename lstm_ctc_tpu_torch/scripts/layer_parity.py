"""K1, K2 and K3 on the streamed plan, for holding two trees of the port
against each other: their outputs saved, and their times.

Run as a file with the tree under test first on ``PYTHONPATH``, one
process a tree (each builds its kernels from its own sources):

    PYTHONPATH=<tree> python lstm_ctc_tpu_torch/scripts/layer_parity.py \\
        --save <tree>.pt
    python lstm_ctc_tpu_torch/scripts/layer_parity.py --compare A.pt B.pt

``--save`` runs each streamed layer shape (bf16, B = 32, T = 128, seeded)
through K1 (``lstm_layer_forward`` with its states), K2
(``lstm_layer_backward`` with the carries' cotangents) and K3
(``lstm_layer_backward_fold``), saves every output, and prints each
kernel's median time over 5 calls on CUDA events with the tree's path;
``--compare`` prints whether every saved tensor of A equals B's bit for
bit, and exits 1 where one does not.
"""

import argparse
import sys

import numpy as np
import torch

# (H, the projection or None, the layer's input width D)
SHAPES = ((1024, None, 2048), (768, 768, 1536), (2048, 512, 1024))
BATCH, STEPS = 32, 128


def case(units, proj, dim, device):
    """A streamed layer's arguments from a numpy seed (ragged lengths)."""
    rng = np.random.RandomState(units + dim)
    out_dim = proj or units

    def t(*shape, scale=0.1, dtype=torch.float32):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).to(device=device, dtype=dtype)

    lengths = rng.randint(STEPS // 2, STEPS + 1, BATCH)
    lengths[0] = STEPS
    x2 = t(2, BATCH, STEPS, dim, scale=1.0)
    wx = t(2, dim, 4 * units, scale=dim ** -0.5, dtype=torch.bfloat16)
    bias = t(2, 4 * units)
    gx = torch.einsum("zbtd,zdg->tzbg", x2.bfloat16().float(), wx.float())
    gx = (gx + bias[None, :, None]).reshape(STEPS, 2 * BATCH, 4 * units)
    return dict(
        x2=x2, wx=wx, gx=gx.contiguous(),
        seq=torch.from_numpy(lengths.astype(np.int32)).to(device),
        wh=t(2, out_dim, 4 * units, scale=out_dim ** -0.5,
             dtype=torch.bfloat16),
        proj=None if proj is None else t(2, units, out_dim,
                                         scale=units ** -0.5,
                                         dtype=torch.bfloat16),
        peep=None if proj is None else t(2, 3, units),
        dout=t(STEPS, 2 * BATCH, out_dim),
        dcfin=t(2 * BATCH, units), dhfin=t(2 * BATCH, out_dim))


def median_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def save(path):
    import lstm_ctc_tpu_torch.models  # noqa: F401 (the ops' import order)
    from lstm_ctc_tpu_torch.ops import lstm_kernels as lk
    device = torch.device("cuda")
    saved = {}
    for units, proj, dim in SHAPES:
        c = case(units, proj, dim, device)
        name = "H=%d P=%d D=%d" % (units, proj or units, dim)

        def k1():
            return lk.lstm_layer_forward(c["gx"], c["seq"], None, c["wh"],
                                         c["proj"], c["peep"], 1.0,
                                         states=True,
                                         store_dtype=torch.bfloat16)

        out, cfin, hfin, c_all, h_all = k1()
        bwd = (c["gx"], c["seq"], None, c["wh"], c["proj"], c["peep"], 1.0,
               c_all, h_all, c["dout"], c["dcfin"], c["dhfin"])

        def k2():
            return lk.lstm_layer_backward(*bwd, store_dtype=torch.bfloat16,
                                          steps=True)

        def k3():
            return lk.lstm_layer_backward_fold(c["x2"], c["wx"], *bwd,
                                               store_dtype=torch.bfloat16,
                                               steps=True)

        for kernel, fn in (("K1", k1), ("K2", k2), ("K3", k3)):
            for i, v in enumerate(fn()):
                if v is not None:
                    saved["%s %s %d" % (kernel, name, i)] = v.cpu()
            print("%s %s bf16 B=%d T=%d: %.3f ms (%s)"
                  % (kernel, name, BATCH, STEPS, median_ms(fn),
                     lk.__file__))
    torch.save(saved, path)


def compare(a, b):
    x, y = torch.load(a), torch.load(b)
    same = sorted(x) == sorted(y) and all(torch.equal(x[k], y[k]) for k in x)
    print("%d tensors of %s and %s bit-equal: %s" % (len(x), a, b, same))
    return same


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args(argv)
    if args.save:
        save(args.save)
    if args.compare and not compare(*args.compare):
        sys.exit(1)


if __name__ == "__main__":
    main()
