"""K1, K2 and K3 on the streamed plan, and K12 and K13 on each of their
plans, for holding two trees of the port against each other: their
outputs saved, and their times.

Run as a file with the tree under test first on ``PYTHONPATH``, one
process a tree (each builds its kernels from its own sources):

    PYTHONPATH=<tree> python lstm_ctc_tpu_torch/scripts/layer_parity.py \\
        --save <tree>.pt
    python lstm_ctc_tpu_torch/scripts/layer_parity.py --compare A.pt B.pt

``--save`` runs each streamed layer shape (bf16, B = 32, T = 128, and H
= P = 2048 at T = 32; seeded) through K1 (``lstm_layer_forward`` with its
states), K2 (``lstm_layer_backward`` with the carries' cotangents) and K3
(``lstm_layer_backward_fold``), and each stack shape (4 layers, seeded)
through K12 (``lstm_stack_forward`` with its states) and K13
(``lstm_stack_backward``), saves a digest of every output's bytes (K2's
and K3's dpeep and K13's column sums themselves), and prints each
kernel's median time over 5 calls on CUDA events with its launch (R and
waves) and the tree's path; ``--compare`` prints whether every saved
tensor of A equals B's bit for bit (K2's and K3's dpeep and K13's column
sums, dbias and dpeep, within 1e-5 of B's largest where a shape's R may
differ between the trees: their rows are added in another order), and
exits 1 where one does not.
"""

import argparse
import hashlib
import sys

import numpy as np
import torch

# (H, the projection or None, the layer's input width D, T)
SHAPES = ((1024, None, 2048, 128), (768, 768, 1536, 128),
          (2048, 512, 1024, 128), (2048, None, 4096, 32))
BATCH = 32
# the outputs whose rows each thread adds first (dpeep: K2's fourth, K3's
# sixth), which move with R
MOVED = {"K2": (3,), "K3": (5,)}
# the stacks: (H, the projection or None, dtype, B, T, whether the trees'
# R may differ): the 8-block plans (the families' flagship width), the
# 16-block resident plans (Kaldi's LSTMP, H = P = 512 with a projection),
# float32 on 16 blocks, the streamed plans (Sak's LSTMP, the cudnnlstm
# family at 1024), a streaming chunk of 16 rows
STACKS = ((320, 320, "bf16", 32, 128, False),
          (320, None, "bf16", 32, 128, False),
          (1024, 256, "bf16", 32, 128, True),
          (512, 512, "bf16", 32, 128, True),
          (1024, 256, "f32", 32, 64, False),
          (2048, 512, "bf16", 32, 64, False),
          (1024, None, "bf16", 32, 64, False),
          (1024, 256, "bf16", 1, 16, False),
          (2048, 512, "bf16", 1, 16, False))
STACK_LAYERS, STACK_INPUT = 4, 120


def case(units, proj, dim, steps, device):
    """A streamed layer's arguments from a numpy seed (ragged lengths)."""
    rng = np.random.RandomState(units + dim)
    out_dim = proj or units

    def t(*shape, scale=0.1, dtype=torch.float32):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).to(device=device, dtype=dtype)

    lengths = rng.randint(steps // 2, steps + 1, BATCH)
    lengths[0] = steps
    x2 = t(2, BATCH, steps, dim, scale=1.0)
    wx = t(2, dim, 4 * units, scale=dim ** -0.5, dtype=torch.bfloat16)
    bias = t(2, 4 * units)
    gx = torch.einsum("zbtd,zdg->tzbg", x2.bfloat16().float(), wx.float())
    gx = (gx + bias[None, :, None]).reshape(steps, 2 * BATCH, 4 * units)
    return dict(
        x2=x2, wx=wx, gx=gx.contiguous(),
        seq=torch.from_numpy(lengths.astype(np.int32)).to(device),
        wh=t(2, out_dim, 4 * units, scale=out_dim ** -0.5,
             dtype=torch.bfloat16),
        proj=None if proj is None else t(2, units, out_dim,
                                         scale=units ** -0.5,
                                         dtype=torch.bfloat16),
        peep=None if proj is None else t(2, 3, units),
        dout=t(steps, 2 * BATCH, out_dim),
        dcfin=t(2 * BATCH, units), dhfin=t(2 * BATCH, out_dim))


def stack_case(units, proj, dtype, batch, steps, device):
    """A stack's K12 arguments from seeds, as ``lstm_stack_fused`` builds
    them (the lstm family with a projection: peepholes, layers 1-3
    residual, keep 0.9; the cudnnlstm family without), ragged lengths."""
    from lstm_ctc_tpu_torch.models import cells
    from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk
    rng = np.random.RandomState(units + steps)
    gen = torch.Generator().manual_seed(units)
    params, d = [], STACK_INPUT
    for _ in range(STACK_LAYERS):
        params.append(cells.init_lstm_cell(gen, d, units, proj,
                                           proj is not None, device))
        d = proj or units

    def t(*shape, scale=0.1):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32)).to(device)

    for p in params:
        p["bias"] = t(4 * units)
    x = t(batch, steps, STACK_INPUT, scale=1.0)
    lengths = rng.randint(steps // 2, steps + 1, batch)
    lengths[0] = steps
    seq = torch.from_numpy(lengths.astype(np.int32)).to(device)
    wz, bias, proj_w, peep = sk.stack_weights(params, dtype)
    gx = torch.matmul(x.to(dtype), params[0]["wx"].to(dtype)).float() \
        + params[0]["bias"]
    gx0 = torch.nn.functional.pad(
        gx.transpose(0, 1), (0, 0, 0, 0, 0, STACK_LAYERS - 1)).contiguous()
    out_dim, lb = proj or units, STACK_LAYERS * batch
    return dict(gx0=gx0, mask=sk.stack_mask(seq, steps, STACK_LAYERS, device),
                wz=wz, bias=bias, proj=proj_w, peep=peep,
                cinit=t(lb, units), hinit=t(lb, out_dim),
                residual=(False,) + (proj is not None,) * (STACK_LAYERS - 1),
                forget_bias=1.0, keep_prob=0.9 if proj else 1.0,
                seed=torch.tensor([-1234567], dtype=torch.int32,
                                  device=device))


def keep(saved, key, v, whole=False):
    """A digest of v's bytes under ``key`` (``whole``: v itself)."""
    v = v.detach().cpu().contiguous()
    saved[key] = v if whole else "%s %s %s" % (
        v.dtype, tuple(v.shape),
        hashlib.sha256(v.view(torch.uint8).numpy().tobytes()).hexdigest())


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
    for units, proj, dim, steps in SHAPES:
        c = case(units, proj, dim, steps, device)
        name = "H=%d P=%d D=%d" % (units, proj or units, dim) + (
            "" if steps == 128 else " T=%d" % steps)

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
                    sums = i in MOVED.get(kernel, ())
                    keep(saved, "%s %s %d%s" % (kernel, name, i,
                                                " sums" if sums else ""),
                         v, sums)
            how = (lk.forward_config if kernel == "K1" else
                   lk.backward_config)(device, BATCH, units, proj or units,
                                       proj is not None, torch.bfloat16)
            print("%s %s bf16 B=%d T=%d: %.3f ms (R=%d in %d wave(s); %s)"
                  % (kernel, name, BATCH, steps, median_ms(fn), how["rows"],
                     how["waves"], lk.__file__))
    save_stacks(saved, device)
    torch.save(saved, path)


def save_stacks(saved, device):
    from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk
    for units, proj, dt, batch, steps, moved in STACKS:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        c = stack_case(units, proj, dtype, batch, steps, device)
        name = "H=%d P=%d %s B=%d T=%d" % (units, proj or units, dt, batch,
                                            steps)
        # the training path's states: the compute dtype's
        args = dict(c, store_dtype=dtype)

        def k12():
            return sk.lstm_stack_forward(**args, states=True)

        out, cfin, hfin, chain, c_all, h_all = k12()
        gen = torch.Generator().manual_seed(units)
        cots = dict(dout=0.1 * torch.randn(out.shape, generator=gen).to(
            device), dcfin=torch.randn(cfin.shape, generator=gen).to(device),
            dhfin=torch.randn(hfin.shape, generator=gen).to(device))

        def k13():
            return sk.lstm_stack_backward(**args, chain=chain, c_all=c_all,
                                          h_all=h_all, **cots, steps_out=True)

        fns = (("K12", k12, False),) + (() if batch == 1 else
                                        (("K13", k13, True),))
        for kernel, fn, backward in fns:
            for i, v in enumerate(fn()):
                if v is not None:
                    sums = moved and backward and i in (2, 4)
                    keep(saved, "%s %s %d%s" % (kernel, name, i,
                                                " sums" if sums else ""),
                         v, sums)
            how = sk.stack_config(device, steps + STACK_LAYERS - 1,
                                  STACK_LAYERS, batch, units, proj or units,
                                  proj is not None, dtype, backward, dtype)
            print("%s %s: %.3f ms (%d blocks, R=%d in %d wave(s), %s plan; "
                  "%s)" % (kernel, name, median_ms(fn), how["blocks"],
                           how["rows"], how["waves"], "streamed"
                           if how["streamed"] else "resident", sk.__file__))


def compare(a, b):
    x, y = torch.load(a), torch.load(b)
    same = sorted(x) == sorted(y)
    for k in sorted(x) if same else ():
        if k.endswith(" sums"):
            ok = float((x[k] - y[k]).abs().max()) <= 1e-5 * max(
                float(y[k].abs().max()), 1e-30)
        else:
            ok = x[k] == y[k]
        if not ok:
            print("differs: %s" % k)
            same = False
    print("%d tensors of %s and %s bit-equal (column sums of a moved R "
          "within 1e-5): %s" % (len(x), a, b, same))
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
