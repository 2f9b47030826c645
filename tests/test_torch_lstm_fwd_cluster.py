"""K1's step (``csrc/lstm_fwd.cu``), emulated on the CPU.

The kernel runs one cluster of 8 blocks (16 where no 8-block plan fits,
up to H = 1024) per (direction, tile of R batch rows): block q owns hidden
units [q·US, (q+1)·US) and projection columns [q·PS, (q+1)·PS) and holds
its slices of wh and proj (``lstm_kernels._slices``).
A step hands the cell output, then h, from every block to every block by
stores that complete bytes on the receiver's barrier, and each block waits
only on its own barrier.  The packed-row reset is folded into the step:
keep(t+1) scales c and h where they are kept for the next step (h as staged
for the hand-off), while out, c_all, h_all and the final states take the
values before it; gx and keep come from a ring of ``depth`` steps.

Here the blocks of each cluster (8 or 16) run as separate programs under a
scheduler that interleaves them at every point where the kernel's warps
could be overtaken by another block (random orders, and one that runs
each block as far as it can).  Every slice of every buffer carries the
step it belongs to, and every read checks it, so a block overwriting what
a peer still reads fails the test; a barrier checks that each phase is
armed before its first bytes land.  The outputs are held to
``cells.dual_recurrence`` at rtol = atol = 1e-5 in float32.
"""

import random

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels

CLUSTERS = [8, 16]
THREADS = 512
FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)


def cdiv(a, b):
    return -(-a // b)


def round_up(v, m):
    return cdiv(v, m) * m


def fma_split(cols, depth):
    """``lstm_cluster.cuh`` fma_split: (rows of k a slice, slices)."""
    most = min(16, max(1, THREADS // (cols // 4)))
    per = round_up(cdiv(depth, most), 4)
    return per, cdiv(depth, per)


def tsplit(cols, depth, kmax, tmax):
    """``lstm_cluster.cuh`` tsplit (the bf16 products, mma_product_t):
    (rows of k a slice, slices)."""
    tm, ks = cols // 16, cdiv(depth, 16)
    for per in range(kmax, 0, -1):
        slices, groups = cdiv(ks, per), cdiv(tm, tmax)
        if slices * groups <= THREADS // 32:
            return per * 16, slices
    raise ValueError("no split")


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread: the emulation's thousands of small ops
    slow down ~30x when their thread pool shares busy cores (the suite's
    workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Hazard(AssertionError):
    pass


class Barrier:
    """An mbarrier of count 1: armed by its block with the bytes of a
    phase (here counted in slices), completed by the peers' stores."""

    def __init__(self):
        self.completed = 0
        self.armed = False
        self.tx = 0

    def arm(self, slices):
        if self.armed:
            raise Hazard("a phase armed twice")
        self.armed, self.tx = True, self.tx + slices
        self._check()

    def land(self):
        if not self.armed:
            raise Hazard("bytes landed on a phase not yet armed")
        self.tx -= 1
        self._check()

    def _check(self):
        if self.armed and self.tx == 0:
            self.completed += 1
            self.armed = False

    def done(self, parity):
        """try_wait.parity: the phase of this parity has completed."""
        return (self.completed & 1) != parity


def gate_bounds(cluster):
    """``lstm_fwd.cu`` gate_k, gate_t: the gate product's bf16 bounds (16-deep
    steps a slice, tiles a warp) with ``cluster`` blocks."""
    return (4, 5) if cluster == 8 else (8, 2)


class Block:
    """One block's shared memory: h in two buffers (only the first with a
    projection) and the cell output, each [R, C·W] with the step each
    block's slice holds, and the three barriers."""

    def __init__(self, rows, ps, us, cluster):
        self.hq = [torch.zeros(rows, cluster * ps) for _ in range(2)]
        self.hq_step = [[-1] * cluster for _ in range(2)]
        self.cell = torch.zeros(rows, cluster * us)
        self.cell_step = [-1] * cluster
        self.bar = [Barrier() for _ in range(3)]


def cluster_forward(gx, seq, keep, wh, proj, peep, rows, depth, order,
                    double_h=True, split="f32", cluster=8):
    """The kernel's partition and hand-offs in plain torch (float32), with
    ``cluster`` blocks a cluster: (out, cfin, hfin, c_all, h_all).
    ``order(runnable)`` picks the next block to run; ``split`` the k-splits
    of the two products, as the kernel's float32 path or its bf16 path
    splits them (the arithmetic stays float32 here)."""
    steps, b2, h4 = gx.shape
    batch, units = b2 // 2, h4 // 4
    has_proj = proj is not None
    out_dim = proj.shape[2] if has_proj else units
    wh_sl, pj_sl = lstm_kernels._slices(wh, proj, cluster)
    us = wh_sl.shape[-1]
    ps = pj_sl.shape[-1] if has_proj else us
    if split == "f32":
        gate_split, proj_split = fma_split(4 * us, out_dim), fma_split(ps, units)
    else:
        gate_split = tsplit(4 * us, out_dim, *gate_bounds(cluster))
        proj_split = tsplit(ps, units, 4, 1)         # kProjK, kProjT
    out = torch.zeros(steps, b2, out_dim)
    c_all = torch.zeros(steps, b2, units)
    h_all = torch.zeros(steps, b2, out_dim)
    cfin = torch.zeros(b2, units)
    hfin = torch.zeros(b2, out_dim)

    def sliced(a, w, split, depth_):
        """Σ over the k-slices, in slice order, of a[:, k] · w[k]."""
        per, slices = split
        total = None
        for s in range(slices):
            k0, k1 = s * per, min(depth_, (s + 1) * per)
            part = a[:, k0:k1] @ w[k0:k1]
            total = part if total is None else total + part
        return total

    def program(d, b0, q, blocks):
        nr = min(rows, batch - b0)
        me = blocks[q]
        br = torch.arange(b0, b0 + nr)
        rr = d * batch + br
        u0, p0 = q * us, q * ps
        nu = max(0, min(us, units - u0))
        np_ = max(0, min(ps, out_dim - p0))
        w_g = wh_sl[d, q].reshape(-1, 4 * us)            # [P16, 4·US]
        w_p = pj_sl[d, q] if has_proj else None          # [H16, PS]
        ring_gx = [None] * depth
        ring_keep = [None] * depth
        ring_step = [-1] * depth
        in_flight = []                  # the cp.async groups, oldest first
        c_reg = torch.zeros(nr, us)
        h_reg = torch.zeros(nr, ps)
        lens = seq[br][:, None]

        def fetch(s):
            """One cp.async group: step s into its slot, landing only at a
            later wait (an empty group past the last step)."""
            if s < steps:
                slot = s % depth
                g = torch.zeros(nr, 4, us)
                g[:, :, :nu] = gx[s, rr].view(nr, 4, units)[:, :, u0:u0 + nu]
                ring_step[slot] = None                    # not landed yet
                in_flight.append((slot, s, g, keep[s, br][:, None]
                                  if keep is not None else None))
            else:
                in_flight.append(None)

        def wait_pending(n):
            while len(in_flight) > n:
                group = in_flight.pop(0)
                if group is not None:
                    slot, s, g, kp = group
                    ring_gx[slot], ring_keep[slot], ring_step[slot] = g, kp, s

        def ring(s, t):
            """gx(s) from the ring at step t, or keep(s) past step t."""
            slot = s % depth
            if ring_step[slot] != s:
                raise Hazard("step %d: the ring's slot of step %d holds %d"
                             % (t, s, ring_step[slot]))
            return ring_gx[slot] if s == t else ring_keep[slot]

        def send(kind, slot, col0, values, t):
            for peer in blocks:
                if kind == "cell":
                    peer.cell[:nr, col0:col0 + values.shape[1]] = values
                    peer.cell_step[q] = t
                    peer.bar[2].land()
                else:
                    peer.hq[slot][:nr, col0:col0 + values.shape[1]] = values
                    peer.hq_step[slot][q] = t
                    peer.bar[slot].land()

        def read(buf, tags, want):
            if any(tag != want for tag in tags):
                raise Hazard("block %d read step %d's buffer holding %s"
                             % (q, want, tags))
            return buf[:nr].clone()

        if steps > 1:
            me.bar[0].arm(cluster)
        if not has_proj and double_h and steps > 2:
            me.bar[1].arm(cluster)
        if has_proj and steps > 0:
            me.bar[2].arm(cluster)
        for s in range(depth - 1):
            fetch(s)
        yield ("sync",)                                   # cluster.sync
        for t in range(steps):
            nxt = t + 1 < steps
            hb = 0 if has_proj or not double_h else (t + 1) & 1
            if t > 0:
                yield ("wait", hb)
                s_next = t if has_proj or not double_h else t + 1
                if s_next + 1 < steps:
                    me.bar[hb].arm(cluster)
            yield ("run",)
            # block q's slice of a buffer holds columns q·W .., so the
            # buffer's first P (or H) columns are h (or the cell output)
            h_prev = read(me.hq[hb], me.hq_step[hb], t - 1)[:, :out_dim]
            part = sliced(h_prev, w_g, gate_split, out_dim)  # [nr, 4·US]
            wait_pending(depth - 3)
            fetch(t + depth - 1)                          # after the barrier
            yield ("run",)
            g = ring(t, t).reshape(nr, 4 * us) + part
            kn = ring(t + 1, t) if nxt and keep is not None else 1.0
            gi, gj, gf, go = g.view(nr, 4, us).unbind(1)
            cp = c_reg
            pi, pf, po = torch.zeros(3, us)
            if peep is not None:
                pi[:nu], pf[:nu], po[:nu] = peep[d, :, u0:u0 + nu]
            gi = gi + pi * cp
            gf = gf + pf * cp
            cn = (torch.sigmoid(gf + FORGET_BIAS) * cp
                  + torch.sigmoid(gi) * torch.tanh(gj))
            go = go + po * cn
            o = torch.sigmoid(go) * torch.tanh(cn)
            m = (t < lens).float()
            cv = m * cn + (1.0 - m) * cp
            c_reg = kn * cv
            c_all[t, rr, u0:u0 + nu] = cv[:, :nu]
            if has_proj:
                send("cell", None, u0, o, t)
            else:
                hv = m * o + (1.0 - m) * h_reg
                h_reg = kn * hv
                if nxt:
                    send("h", t & 1 if double_h else 0, u0, h_reg, t)
                out[t, rr, u0:u0 + nu] = (m * o)[:, :nu]
                h_all[t, rr, u0:u0 + nu] = hv[:, :nu]
                continue
            yield ("wait", 2)
            if nxt:
                me.bar[2].arm(cluster)
            yield ("run",)
            cfull = read(me.cell, me.cell_step, t)[:, :units]
            o = sliced(cfull, w_p, proj_split, units)     # [nr, PS]
            yield ("run",)
            if nxt and keep is not None:
                kn = ring(t + 1, t)
            m = (t < lens).float()
            hv = m * o + (1.0 - m) * h_reg
            h_reg = kn * hv
            if nxt:
                send("h", 0, p0, h_reg, t)
            out[t, rr, p0:p0 + np_] = (m * o)[:, :np_]
            h_all[t, rr, p0:p0 + np_] = hv[:, :np_]
        cfin[rr, u0:u0 + nu] = c_reg[:, :nu]
        if has_proj:
            hfin[rr, p0:p0 + np_] = h_reg[:, :np_]
        else:
            hfin[rr, u0:u0 + nu] = h_reg[:, :nu]
        yield ("sync",)

    for d in range(2):
        for b0 in range(0, batch, rows):
            blocks = [Block(rows, ps, us, cluster) for _ in range(cluster)]
            _run(blocks, [program(d, b0, q, blocks) for q in range(cluster)],
                 order)
    return out, cfin, hfin, c_all, h_all


def _run(blocks, programs, order):
    """Run the blocks' programs: a block waiting on a barrier phase runs
    only once it completes; at a cluster barrier all must arrive."""
    state = [next(p) for p in programs]
    parity = [[0, 0, 0] for _ in programs]
    live = set(range(len(programs)))
    while live:
        if all(state[i][0] == "sync" for i in live):
            for i in list(live):
                try:
                    state[i] = next(programs[i])
                except StopIteration:
                    live.discard(i)
            continue
        runnable = []
        for i in live:
            kind = state[i][0]
            if kind == "run" or (kind == "wait" and blocks[i].bar[
                    state[i][1]].done(parity[i][state[i][1]])):
                runnable.append(i)
        if not runnable:
            raise Hazard("deadlock: %s" % [state[i] for i in live])
        i = order(sorted(runnable))
        if state[i][0] == "wait":
            parity[i][state[i][1]] ^= 1
        try:
            state[i] = next(programs[i])
        except StopIteration:
            live.discard(i)


def random_order(seed):
    rng = random.Random(seed)
    return lambda runnable: rng.choice(runnable)


def greedy_order(runnable):
    """Run the lowest-numbered block as far as it can go."""
    return runnable[0]


def make_case(seed, batch=5, steps=9, units=64, proj=128, peepholes=True,
              reset=False):
    gen = torch.Generator().manual_seed(seed)
    pair = [cells.init_lstm_cell(gen, 4, units, proj, peepholes)
            for _ in range(2)]
    wh, pj, peep = cells.recurrent_weights(pair[0], pair[1], torch.float32)
    rng = np.random.RandomState(seed)
    seq = rng.randint(steps // 2, steps + 1, batch)
    seq[0] = steps
    seq = torch.from_numpy(seq.astype(np.int32))
    reset_mask = None
    if reset:
        mask = np.zeros((batch, steps), np.float32)
        mask[:, 0] = 1.0
        for b in range(batch):
            if seq[b] > 1:
                mask[b, rng.randint(1, int(seq[b]), 2)] = 1.0
        reset_mask = torch.from_numpy(mask)
    _, keep = cells.step_masks(seq, reset_mask, steps, "cpu")
    gx = torch.from_numpy(rng.randn(steps, 2 * batch, 4 * units)
                          .astype(np.float32))
    return gx, seq, keep, wh, pj, peep


ORDERS = [("random0", random_order(0)), ("random1", random_order(1)),
          ("greedy", greedy_order)]


# each split with 8 blocks a cluster, then with 16
SPLITS = [(split, cluster) for cluster in CLUSTERS for split in ("f32", "bf16")]
SPLIT_IDS = [split if cluster == 8 else "%s-%d" % (split, cluster)
             for split, cluster in SPLITS]


@pytest.mark.parametrize("split,cluster", SPLITS, ids=SPLIT_IDS)
@pytest.mark.parametrize("order", [o for _, o in ORDERS],
                         ids=[n for n, _ in ORDERS])
@pytest.mark.parametrize("proj,peep,reset", [
    (128, True, False), (128, True, True), (128, False, True),
    (None, True, False), (None, True, True), (None, False, False)])
def test_cluster_step_matches_plain(proj, peep, reset, order, split,
                                    cluster):
    gx, seq, keep, wh, pj, pp = make_case(3, proj=proj, peepholes=peep,
                                          reset=reset)
    got = cluster_forward(gx, seq, keep, wh, pj, pp, rows=3, depth=6,
                          order=order, split=split, cluster=cluster)
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, pp, FORGET_BIAS,
                                states=True)
    for name, g, r in zip(("out", "cfin", "hfin", "c_all", "h_all"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("steps,depth", [(1, 3), (2, 3), (3, 4), (7, 3)])
@pytest.mark.parametrize("proj,cluster", [(48, 8), (None, 8), (48, 16),
                                          (None, 16)],
                         ids=["48", "None", "48-16", "None-16"])
def test_cluster_step_short_sequences_and_rings(steps, depth, proj,
                                                cluster):
    """Sequences of 1-3 steps (the barriers' first phases armed or not)
    and the shallowest ring; block 3 onwards owns no projection column at
    P = 48, and the units past H are padding (with 16 blocks, blocks 5
    onwards own no unit)."""
    gx, seq, keep, wh, pj, pp = make_case(5, batch=4, steps=steps,
                                          units=36, proj=proj, reset=True)
    got = cluster_forward(gx, seq, keep, wh, pj, pp, rows=3, depth=depth,
                          order=random_order(steps), cluster=cluster)
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, pp, FORGET_BIAS,
                                states=True)
    for name, g, r in zip(("out", "cfin", "hfin", "c_all", "h_all"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


def test_one_h_buffer_without_projection_is_caught():
    """Without a projection a block may hand off h(t) while a peer still
    reads h(t-1): with one buffer the emulation sees the overwrite."""
    gx, seq, keep, wh, pj, pp = make_case(4, proj=None)
    with pytest.raises(Hazard):
        cluster_forward(gx, seq, keep, wh, pj, pp, rows=3, depth=4,
                        order=greedy_order, double_h=False)


@pytest.mark.parametrize("reset", [False, True])
def test_reset_at_staging_equals_reset_pass(reset):
    """keep(t+1) applied where c and h are kept for the next step gives
    the states of the plain version's reset at the start of step t+1, for
    keep in {0, 1} and also for fractional keep (the product is taken in
    float32 before h is rounded, as the plain version takes it)."""
    gx, seq, keep, wh, pj, pp = make_case(6, proj=128, reset=True)
    if not reset:
        keep = keep * 0.5 + 0.25
    got = cluster_forward(gx, seq, keep, wh, pj, pp, rows=5, depth=5,
                          order=random_order(7))
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, pp, FORGET_BIAS,
                                states=True)
    for name, g, r in zip(("out", "cfin", "hfin", "c_all", "h_all"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("order", [o for _, o in ORDERS[:2]],
                         ids=[n for n, _ in ORDERS[:2]])
@pytest.mark.parametrize("units,proj", [(1024, 256), (512, 512),
                                        (384, 384), (512, None)])
def test_wide_cluster_step_matches_plain(units, proj, order):
    """The widths only 16 blocks take (64 units a block at H = 1024, PS =
    16 projection columns a block at P = 256; 24 units and 32 columns at
    H = P = 384, where blocks 12-15 own no projection column), in both
    products' splits, at B = 3 with R = 2 (two row tiles), T = 4 and resets:
    the same outputs as the plain recurrence."""
    gx, seq, keep, wh, pj, pp = make_case(8, batch=3, steps=4, units=units,
                                          proj=proj, reset=True)
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, pp, FORGET_BIAS,
                                states=True)
    for split in ("f32", "bf16"):
        got = cluster_forward(gx, seq, keep, wh, pj, pp, rows=2, depth=3,
                              order=order, split=split, cluster=16)
        for name, g, r in zip(("out", "cfin", "hfin", "c_all", "h_all"),
                              got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(),
                                       err_msg=name, **TOL)
