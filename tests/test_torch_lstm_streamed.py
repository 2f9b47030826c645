"""The streamed plans of K1 and K2 (``csrc/lstm_fwd.cu``
``lstm_fwd_streamed_kernel``, ``csrc/lstm_bwd_streamed.cu``), emulated on
the CPU.

Where a bf16 layer's weight slices fit no resident plan (H = P = 1024
without a projection, 2048 cells with a projection of 512), a block keeps
the first rows of its wh slice in shared memory and streams the rest (and
its proj rows) from L2 at every step, a chunk of rows at a time, through a
ring of slots: chunk n lands in slot n % slots by a bulk copy that
completes the slot's barrier, readers wait for the barrier's phase n /
slots, and the slot is refilled with chunk n + slots after the block
barrier that ends every warp's reads of chunk n.

Here the blocks of a cluster run as separate programs, each block as
warps (two, with the kernels' ownership rules: warp w the column tiles w,
w + 2, ..; K2's dh tile j warp 1 - j % 2), under a scheduler that
interleaves them at every point where a warp could be overtaken, and that
lands a pending copy at any of them (random orders, and one that runs the
lowest-numbered warp as far as it can go).  The plan's arithmetic is the
kernels' (resident rows, chunk sizes, slots), and every chunk is read from
the padded layout the wrapper gives the streamed plan
(``lstm_kernels._slices`` / ``_proj_rows`` with ``padded``) at the
kernels' element offsets.  Every slot carries the chunk it holds (a refill
marks it in flight at once, the bytes landing later), and every read
checks it before and after the warp's interleaving point, so a refill that
overtakes a reader fails; the hand-off buffers carry the step of each
block's slice, as in ``test_torch_lstm_fwd_cluster.py``.  The outputs are
held to ``cells.dual_recurrence`` and ``cells.dual_recurrence_backward``
at rtol = atol = 1e-5 in float32.
"""

import random

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_kernels

FORGET_BIAS = 5.0
TOL = dict(rtol=1e-5, atol=1e-5)
C = 16  # the streamed plan's blocks a cluster
WARPS = 2  # warps a block in the emulation (the kernels run 16)
SMEM = 232448  # a block's shared memory (kMaxSmemPerBlock)
CHUNK_BYTES = 24576  # lstm_cluster.cuh kChunkBytes
MAX_SLOTS = 4  # kMaxSlots


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread: the emulation's many small ops slow
    down when their thread pool shares busy cores (the suite's workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Hazard(AssertionError):
    pass


def cdiv(a, b):
    return -(-a // b)


def round_up(v, m):
    return cdiv(v, m) * m


def align128(v):
    return round_up(v, 128)


def ring_layout(fixed, wrow, wsteps, slot, cap):
    """(slots, resident 16-deep steps of wh) after `fixed` bytes: the
    kernels' stream_plan / bwd_stream_plan tail."""
    left = max(0, SMEM - fixed)
    slots = min(MAX_SLOTS, left // slot)
    res = min(wsteps, (left - slots * slot) // wrow)
    return slots, res if cap < 0 else min(res, cap)


def fwd_plan(units, out_dim, has_proj, rows, cap=-1):
    """``csrc/lstm_fwd.cu`` stream_plan<16> (bf16), and whether it fits."""
    us = round_up(cdiv(units, C), 8)
    ps = round_up(cdiv(out_dim, C), 16) if has_proj else us
    g = 4 * us
    p = dict(us=us, ps=ps, g=g, lws=g + 8, wsteps=cdiv(out_dim, 16),
             psteps=cdiv(units, 16) if has_proj else 0)
    wrow, prow = 2 * 16 * p["lws"], 2 * 16 * ps
    p["cw"] = max(1, CHUNK_BYTES // wrow)
    p["cp"] = max(1, CHUNK_BYTES // prow) if has_proj else 0
    slot = align128(max(p["cw"] * wrow, p["cp"] * prow))
    hs, qs = C * us + 8, C * ps + 8
    off_part = align128(2 * 8 * qs) + align128(2 * 8 * hs)
    off_gx = off_part + align128(4 * 8 * max(g + 4, ps + 4)) + 128
    fixed = off_gx + align128(4 * 3 * rows * 4 * us) + align128(4 * 3 * rows)
    p["slots"], p["res"] = ring_layout(fixed, wrow, p["wsteps"], slot, cap)
    p["nw"] = cdiv(p["wsteps"] - p["res"], p["cw"])
    p["np"] = cdiv(p["psteps"], p["cp"]) if has_proj else 0
    nbytes = fixed + p["slots"] * slot + p["res"] * wrow
    p["fits"] = (us <= 128 and rows * us <= 512 and rows * ps <= 512
                 and p["slots"] >= 2 and nbytes <= SMEM)
    return p


def bwd_plan(units, out_dim, has_proj, rows, cap=-1, store=2):
    """``csrc/lstm_bwd_streamed.cu`` bwd_stream_plan (bf16, the states in
    `store` bytes: bf16, as the train step keeps them), and whether it
    fits."""
    us = round_up(cdiv(units, C), 8)
    u16, g = round_up(us, 16), 4 * us
    ps = round_up(cdiv(out_dim, C), 4)
    pw, p16 = C * ps, round_up(out_dim, 16)
    p = dict(us=us, u16=u16, g=g, ps=ps, pw=pw, p16=p16, lws=g + 8,
             lpj=p16 + 8, wsteps=p16 // 16,
             utiles=u16 // 16 if has_proj else 0)
    wrow, urow = 2 * 16 * p["lws"], 2 * 16 * p["lpj"]
    p["cw"] = max(1, CHUNK_BYTES // wrow)
    p["cu"] = max(1, CHUNK_BYTES // urow) if has_proj else 0
    slot = align128(max(p["cw"] * wrow, p["cu"] * urow))
    dob_slices = mma_split(u16, p16)[1]
    part = max(dob_slices * 8 * u16 if has_proj else 0, rows * pw,
               3 * rows * us)
    fixed = (2 * align128(2 * 8 * (p16 + 8)) + align128(2 * 8 * (g + 8))
             + 3 * align128(4 * rows * pw)
             + align128(store * rows * out_dim) + align128(store * rows * us)
             + align128(4 * rows * 4 * us) + align128(4 * 3 * rows)
             + align128(4 * rows * us) + align128(4 * C * rows * ps)
             + align128(4 * rows * g) + align128(4 * part) + 128)
    p["slots"], p["res"] = ring_layout(fixed, wrow, p["wsteps"], slot, cap)
    p["nw"] = cdiv(p["wsteps"] - p["res"], p["cw"])
    p["np"] = cdiv(p["utiles"], p["cu"]) if has_proj else 0
    nbytes = fixed + p["slots"] * slot + p["res"] * wrow
    p["fits"] = (us <= 128 and rows * us <= 512 and p["slots"] >= 2
                 and nbytes <= SMEM)
    return p


def mma_split(cols, depth, most=16):
    """``lstm_cluster.cuh`` mma_split: (16-deep steps a slice, slices)."""
    steps, tiles = cdiv(depth, 16), cols // 16
    best, best_cost = (steps, 1), cdiv(tiles, 16) * steps
    for ks in range(2, min(most, steps) + 1):
        per = cdiv(steps, ks)
        cost = cdiv(tiles * cdiv(steps, per), 16) * per
        if cost < best_cost:
            best_cost, best = cost, (per, cdiv(steps, per))
    return best


def largest_rows(plan_fn, *shape):
    """The streamed launchers' R: the largest of {8, 6, 4} (K2: and 2) that
    fits."""
    for rows in (8, 6, 4) if plan_fn is fwd_plan else (8, 6, 4, 2):
        if plan_fn(*shape, rows)["fits"]:
            return rows
    raise AssertionError("no streamed plan")


class Barrier:
    """An mbarrier of count 1, armed with the bytes of a phase (counted in
    landings here) and completed by them."""

    def __init__(self):
        self.completed, self.armed, self.tx = 0, False, 0

    def arm(self, count):
        if self.armed:
            raise Hazard("a phase armed twice")
        self.armed, self.tx = True, self.tx + count
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
        return (self.completed & 1) != parity


class Ring:
    """A block's weight ring: each slot the chunk it holds (("in flight",
    n) from the refill's issue until its bytes land) and its barrier."""

    def __init__(self, slots):
        self.chunk = [None] * slots
        self.data = [None] * slots
        self.bar = [Barrier() for _ in range(slots)]

    def read(self, n, want_rows):
        s = n % len(self.chunk)
        if self.chunk[s] != n:
            raise Hazard("chunk %d read from a slot holding %s"
                         % (n, self.chunk[s]))
        return self.data[s][:want_rows]


def same_group(tag, key):
    """A sync group: the warps tagged ``key``, or every warp ("cluster")."""
    return key == "cluster" or tag == key


class Sched:
    """Runs warps (generators yielding ("run",), ("wait", barrier,
    parity), ("sync", group)) and lands pending copies, in the order
    `order` picks from the runnable candidates (warps by index, then the
    pending landings); ``member(tag, key)`` says whether a warp tagged
    ``tag`` takes part in the sync of group ``key``."""

    def __init__(self, order, member=same_group):
        self.order, self.pending, self.member = order, [], member

    def issue(self, ring, n, data):
        s = n % len(ring.chunk)
        ring.chunk[s] = ("in flight", n)
        ring.bar[s].arm(1)
        self.pending.append((ring, s, n, data))

    def run(self, warps):
        """warps: [(group, generator)]; a group's sync releases when all
        its live warps are at it ("cluster": every warp)."""
        state = [next(g) for _, g in warps]
        live = set(range(len(warps)))

        def advance(i):
            try:
                state[i] = next(warps[i][1])
            except StopIteration:
                live.discard(i)

        while live:
            syncs = {}
            for i in live:
                if state[i][0] == "sync":
                    key = state[i][1]
                    syncs.setdefault(key, []).append(i)
            released = False
            for key, members in syncs.items():
                group = [i for i in live if self.member(warps[i][0], key)]
                if len(members) == len(group):
                    for i in members:
                        advance(i)
                    released = True
            if released:
                continue
            runnable = [i for i in live if state[i][0] == "run"
                        or (state[i][0] == "wait"
                            and state[i][1].done(state[i][2]))]
            cands = sorted(runnable) + [100000 + k for k in
                                        range(len(self.pending))]
            if not cands:
                raise Hazard("deadlock: %s" % [state[i] for i in live])
            pick = self.order(cands)
            if pick >= 100000:
                ring, s, n, data = self.pending.pop(pick - 100000)
                ring.chunk[s], ring.data[s] = n, data
                ring.bar[s].land()
            else:
                advance(pick)
        if self.pending:
            raise Hazard("copies in flight at the end")


def random_order(seed):
    rng = random.Random(seed)
    return lambda cands: rng.choice(cands)


def greedy_order(cands):
    return cands[0]


ORDERS = [("random0", random_order(0)), ("random1", random_order(1)),
          ("greedy", greedy_order)]


def read_tagged(buf, tags, want, nr):
    if any(tag != want for tag in tags):
        raise Hazard("read step %d's buffer holding %s" % (want, tags))
    return buf[:nr].clone()


def wait_chunk(ring, n):
    s = n % len(ring.chunk)
    return ("wait", ring.bar[s], (n // len(ring.chunk)) & 1)


def release(ring, n, w, block, issue, barrier=True):
    """After warp w's reads of chunk n: the block barrier, then warp 0
    issues chunk n + slots into its slot."""
    if barrier:
        yield ("sync", block)
    if w == 0:
        issue(n + len(ring.chunk))


def fwd_streamed(gx, seq, keep, wh, proj, peep, order, cap=-1,
                 barrier_before_refill=True):
    """K1's streamed plan in plain torch (float32): (out, cfin, hfin,
    c_all, h_all)."""
    steps, b2, h4 = gx.shape
    batch, units = b2 // 2, h4 // 4
    has_proj = proj is not None
    out_dim = proj.shape[2] if has_proj else units
    rows = largest_rows(fwd_plan, units, out_dim, has_proj)
    pl = fwd_plan(units, out_dim, has_proj, rows, cap)
    us, ps, g, lws = pl["us"], pl["ps"], pl["g"], pl["lws"]
    p16, h16 = 16 * pl["wsteps"], round_up(units, 16)
    wh_sl, pj_sl = lstm_kernels._slices(wh, proj, C, padded=True)
    assert wh_sl.shape == (2, C, p16, lws)
    wh_flat = wh_sl.reshape(-1)
    pj_flat = pj_sl.reshape(-1) if has_proj else None
    per_step = pl["nw"] + pl["np"]
    total = steps * per_step
    out = torch.zeros(steps, b2, out_dim)
    c_all = torch.zeros(steps, b2, units)
    h_all = torch.zeros(steps, b2, out_dim)
    cfin = torch.zeros(b2, units)
    hfin = torch.zeros(b2, out_dim)

    def chunk_rows(n, d, q):
        """chunk n of block q's sequence, read at the kernel's offsets of
        the padded layout: (rows, the chunk [rows, width])."""
        i = n % per_step
        if i < pl["nw"]:
            r0 = 16 * (pl["res"] + i * pl["cw"])
            nrows = min(16 * pl["cw"], p16 - r0)
            at = (d * C + q) * p16 * lws + r0 * lws
            return nrows, wh_flat[at:at + nrows * lws].view(nrows, lws)
        r0 = 16 * (i - pl["nw"]) * pl["cp"]
        nrows = min(16 * pl["cp"], h16 - r0)
        at = (d * C + q) * h16 * ps + r0 * ps
        return nrows, pj_flat[at:at + nrows * ps].view(nrows, ps)

    class Block:
        def __init__(self):
            self.hq = [torch.zeros(8, C * ps) for _ in range(2)]
            self.hq_tag = [[-1] * C for _ in range(2)]
            self.cell = torch.zeros(8, C * us)
            self.cell_tag = [-1] * C
            self.bar = [Barrier() for _ in range(3)]
            self.ring = Ring(pl["slots"])
            self.part = torch.zeros(8, max(g, ps))
            self.c = self.h = None

    def program(sched, blocks, d, b0, q, w):
        nr = min(rows, batch - b0)
        me = blocks[q]
        br = torch.arange(b0, b0 + nr)
        rr = d * batch + br
        u0, p0 = q * us, q * ps
        nu = max(0, min(us, units - u0))
        np_ = max(0, min(ps, out_dim - p0))
        lens = seq[br][:, None]
        wres = wh_flat[(d * C + q) * p16 * lws:][:16 * pl["res"] * lws]
        wres = wres.view(-1, lws)

        def issue(n):
            if n < total:
                sched.issue(me.ring, n, chunk_rows(n, d, q)[1].clone())

        def product(a, depth, cols, resident, init, chunk):
            """This warp's columns of a · w over the streamed depth."""
            acc = init.clone()
            if resident:
                k = 16 * pl["res"]
                acc += a[:, :k] @ wres[:k, cols]
            else:
                k = 0
            while k < depth:
                nrows = chunk_rows(chunk[0], d, q)[0]
                yield wait_chunk(me.ring, chunk[0])
                part = me.ring.read(chunk[0], nrows)
                yield ("run",)   # the read spans an interleaving point
                part = me.ring.read(chunk[0], nrows)
                k1 = min(depth, k + nrows)
                acc += a[:, k:k1] @ part[:k1 - k, cols]
                k += nrows
                yield from release(me.ring, chunk[0], w, (d, q), issue,
                                   barrier_before_refill)
                chunk[0] += 1
            return acc

        gcols = torch.tensor([c for t in range(w, g // 16, WARPS)
                              for c in range(16 * t, 16 * t + 16)],
                             dtype=torch.long)
        pcols = torch.tensor([c for t in range(w, ps // 16, WARPS)
                              for c in range(16 * t, 16 * t + 16)],
                             dtype=torch.long)
        if w == 0:
            me.c, me.h = torch.zeros(nr, us), torch.zeros(nr, ps)
            if steps > 1:
                me.bar[0].arm(C)
            if not has_proj and steps > 2:
                me.bar[1].arm(C)
            if has_proj and steps > 0:
                me.bar[2].arm(C)
        yield ("sync", "cluster")
        if w == 0:
            for n in range(pl["slots"]):
                issue(n)
        chunk = [0]
        parity = [0, 0, 0]
        for t in range(steps):
            nxt = t + 1 < steps
            hb = 0 if has_proj else (t + 1) & 1
            if t > 0:
                yield ("wait", me.bar[hb], parity[hb])
                parity[hb] ^= 1
                s_next = t if has_proj else t + 1
                if w == 0 and s_next + 1 < steps:
                    me.bar[hb].arm(C)
            yield ("sync", (d, q))                        # gx(t) is in
            h_prev = read_tagged(me.hq[hb], me.hq_tag[hb], t - 1,
                                 nr)[:, :out_dim]
            h_pad = torch.zeros(nr, p16)
            h_pad[:, :out_dim] = h_prev
            gxt = torch.zeros(nr, 4, us)
            gxt[:, :, :nu] = gx[t, rr].view(nr, 4, units)[:, :, u0:u0 + nu]
            acc = yield from product(h_pad, p16, gcols, True,
                                     gxt.reshape(nr, g)[:, gcols], chunk)
            me.part[:nr, gcols] = acc
            yield ("sync", (d, q))
            if w == 0:
                gate = me.part[:nr, :g].view(nr, 4, us)
                gi, gj, gf, go = gate.unbind(1)
                pi, pf, po = torch.zeros(3, us)
                if peep is not None:
                    pi[:nu], pf[:nu], po[:nu] = peep[d, :, u0:u0 + nu]
                cp = me.c
                cn = (torch.sigmoid(gf + pf * cp + FORGET_BIAS) * cp
                      + torch.sigmoid(gi + pi * cp) * torch.tanh(gj))
                o = torch.sigmoid(go + po * cn) * torch.tanh(cn)
                m = (t < lens).float()
                kn = keep[t + 1, br][:, None] if nxt and keep is not None \
                    else 1.0
                cv = m * cn + (1.0 - m) * cp
                me.c = kn * cv
                c_all[t, rr, u0:u0 + nu] = cv[:, :nu]
                if has_proj:
                    for peer in blocks:
                        peer.cell[:nr, u0:u0 + us] = o
                        peer.cell_tag[q] = t
                        peer.bar[2].land()
                else:
                    hv = m * o + (1.0 - m) * me.h
                    me.h = kn * hv
                    if nxt:
                        for peer in blocks:
                            peer.hq[t & 1][:nr, u0:u0 + us] = me.h
                            peer.hq_tag[t & 1][q] = t
                            peer.bar[t & 1].land()
                    out[t, rr, u0:u0 + nu] = (m * o)[:, :nu]
                    h_all[t, rr, u0:u0 + nu] = hv[:, :nu]
            if not has_proj:
                continue
            yield ("wait", me.bar[2], parity[2])
            parity[2] ^= 1
            if w == 0 and nxt:
                me.bar[2].arm(C)
            cell = read_tagged(me.cell, me.cell_tag, t, nr)[:, :units]
            c_pad = torch.zeros(nr, h16)
            c_pad[:, :units] = cell
            acc = yield from product(c_pad, h16, pcols, False,
                                     torch.zeros(nr, len(pcols)), chunk)
            me.part[:nr, pcols] = acc
            yield ("sync", (d, q))
            if w == 0:
                o = me.part[:nr, :ps]
                m = (t < lens).float()
                kn = keep[t + 1, br][:, None] if nxt and keep is not None \
                    else 1.0
                hv = m * o + (1.0 - m) * me.h
                me.h = kn * hv
                if nxt:
                    for peer in blocks:
                        peer.hq[0][:nr, p0:p0 + ps] = me.h
                        peer.hq_tag[0][q] = t
                        peer.bar[0].land()
                out[t, rr, p0:p0 + np_] = (m * o)[:, :np_]
                h_all[t, rr, p0:p0 + np_] = hv[:, :np_]
        if w == 0:
            cfin[rr, u0:u0 + nu] = me.c[:, :nu]
            if has_proj:
                hfin[rr, p0:p0 + np_] = me.h[:, :np_]
            else:
                hfin[rr, u0:u0 + nu] = me.h[:, :nu]
        yield ("sync", "cluster")

    for d in range(2):
        for b0 in range(0, batch, rows):
            sched = Sched(order)
            blocks = [Block() for _ in range(C)]
            sched.run([((d, q), program(sched, blocks, d, b0, q, w))
                       for q in range(C) for w in range(WARPS)])
    return out, cfin, hfin, c_all, h_all


def bwd_streamed(gx, seq, keep, wh, proj, peep, c_all, h_all, dout, dcfin,
                 dhfin, order, cap=-1, barrier_before_refill=True):
    """K2's streamed plan in plain torch (float32): (dgates, dh_in,
    dpeep)."""
    steps, b2, h4 = gx.shape
    batch, units = b2 // 2, h4 // 4
    has_proj = proj is not None
    out_dim = h_all.shape[2]
    rows = largest_rows(bwd_plan, units, out_dim, has_proj)
    pl = bwd_plan(units, out_dim, has_proj, rows, cap)
    us, u16, g, ps, pw, p16 = (pl[k] for k in ("us", "u16", "g", "ps", "pw",
                                               "p16"))
    lws, lpj = pl["lws"], pl["lpj"]
    wh_sl, pj_rows = lstm_kernels._backward_slices(wh, proj, C, padded=True)
    assert wh_sl.shape == (2, C, p16, lws)
    wh_flat = wh_sl.reshape(-1)
    if has_proj:
        assert pj_rows.shape == (2, C, u16, lpj)
        pj_flat = pj_rows.reshape(-1)
    per_step = pl["np"] + pl["nw"]
    total = pl["nw"] + steps * per_step
    dgates = torch.zeros(steps, b2, h4)
    dh_in = torch.zeros(steps, b2, out_dim)
    sums = {}

    def chunk_rows(n, d, q):
        i = pl["np"] + n if n < pl["nw"] else (n - pl["nw"]) % per_step
        if i < pl["np"]:
            r0 = 16 * i * pl["cu"]
            nrows = min(16 * pl["cu"], u16 - r0)
            at = (d * C + q) * u16 * lpj + r0 * lpj
            return r0, nrows, pj_flat[at:at + nrows * lpj].view(nrows, lpj)
        r0 = 16 * (pl["res"] + (i - pl["np"]) * pl["cw"])
        nrows = min(16 * pl["cw"], p16 - r0)
        at = (d * C + q) * p16 * lws + r0 * lws
        return r0, nrows, wh_flat[at:at + nrows * lws].view(nrows, lws)

    class Block:
        def __init__(self, nr):
            self.ring = Ring(pl["slots"])
            self.dh = torch.zeros(nr, pw)
            self.dh_tag = [-1] * C
            self.inbox = torch.zeros(C, nr, ps)
            self.inbox_tag = [-1] * C
            self.gsum = None
            self.part_h = torch.zeros(nr, p16)
            self.part_d = torch.zeros(nr, u16)
            self.gq = None
            self.dc = None
            self.sums = torch.zeros(3, us)

    def program(sched, blocks, d, b0, q, w):
        nr = min(rows, batch - b0)
        me = blocks[q]
        br = torch.arange(b0, b0 + nr)
        rr = d * batch + br
        u0 = q * us
        nu = max(0, min(us, units - u0))
        p0 = q * ps
        lens = seq[br][:, None]
        wres = wh_flat[(d * C + q) * p16 * lws:][:16 * pl["res"] * lws]
        wres = wres.view(-1, lws)
        gcols = [c for t in range(w, g // 16, WARPS)
                 for c in range(16 * t, 16 * t + 16)]

        def issue(n):
            if n < total:
                sched.issue(me.ring, n, chunk_rows(n, d, q)[2].clone())

        def next_chunk(chunk):
            yield from release(me.ring, chunk[0], w, (d, q), issue,
                               barrier_before_refill)
            chunk[0] += 1

        def staged(tt):
            """gx(tt) of the block's units [nr, G] and h_prev, c_prev of
            step tt, kept (zero at tt = 0)."""
            kp = keep[tt, br][:, None] if keep is not None else 1.0
            gxt = torch.zeros(nr, 4, us)
            gxt[:, :, :nu] = gx[tt, rr].view(nr, 4, units)[:, :, u0:u0 + nu]
            hp = torch.zeros(nr, p16)
            cp = torch.zeros(nr, us)
            if tt > 0:
                hp[:, :out_dim] = kp * h_all[tt - 1, rr]
                cp[:, :nu] = kp * c_all[tt - 1, rr][:, u0:u0 + nu]
            return gxt.reshape(nr, g), hp, cp

        def wh_pass(chunk, dh_on, gate_tt):
            """4: dh's partial from me.gq (by rows p, the tile j of warp
            1 - j % 2) and the gate sums of step gate_tt (this warp's
            columns); the gate sums into me.gsum."""
            gx_t, hp, _ = staged(gate_tt) if gate_tt is not None else (
                None, None, None)
            acc = gx_t[:, gcols].clone() if gate_tt is not None else None

            def rows_at(wrows, r0, nrows):
                if acc is not None:
                    acc.add_(hp[:, r0:r0 + nrows] @ wrows[:nrows, gcols])
                if dh_on:
                    for j in range(r0 // 16, (r0 + nrows) // 16):
                        if w == WARPS - 1 - j % WARPS:
                            blk = wrows[16 * j - r0:16 * j - r0 + 16, :g]
                            me.part_h[:, 16 * j:16 * j + 16] = me.gq @ blk.t()

            rows_at(wres, 0, 16 * pl["res"])
            for _ in range(pl["nw"]):
                r0, nrows, _ = chunk_rows(chunk[0], d, q)
                yield wait_chunk(me.ring, chunk[0])
                me.ring.read(chunk[0], nrows)
                yield ("run",)
                rows_at(me.ring.read(chunk[0], nrows), r0, nrows)
                yield from next_chunk(chunk)
            if acc is not None:
                me.gsum[:, gcols] = acc
            yield ("sync", (d, q))

        if w == 0:
            me.dh[:, :out_dim] = dhfin[rr]
            me.dc = torch.zeros(nr, us)
            me.dc[:, :nu] = dcfin[rr][:, u0:u0 + nu]
            me.gsum = torch.zeros(nr, g)
        yield ("sync", "cluster")
        if w == 0:
            for n in range(pl["slots"]):
                issue(n)
        chunk = [0]
        yield ("sync", (d, q))
        yield from wh_pass(chunk, False, steps - 1)
        for t in range(steps - 1, -1, -1):
            kp = keep[t, br][:, None] if keep is not None else 1.0
            m = (t < lens).float()
            dh = read_tagged(me.dh, me.dh_tag, -1 if t == steps - 1 else t + 1,
                             nr)
            if w == 0:
                dh_in[t, rr, p0:p0 + ps] = dh[:, p0:p0 + ps][:, :max(
                    0, min(ps, out_dim - p0))]
            dq = torch.zeros(nr, p16)
            dq[:, :out_dim] = m * (dout[t, rr] + dh[:, :out_dim])
            yield ("sync", (d, q))
            # 2. dout_blk over proj's chunks of rows, this warp's tiles
            for _ in range(pl["np"]):
                r0, nrows, _ = chunk_rows(chunk[0], d, q)
                yield wait_chunk(me.ring, chunk[0])
                me.ring.read(chunk[0], nrows)
                yield ("run",)
                block = me.ring.read(chunk[0], nrows)
                for j in range(w, nrows // 16, WARPS):
                    me.part_d[:, r0 + 16 * j:r0 + 16 * j + 16] = (
                        dq @ block[16 * j:16 * j + 16, :p16].t())
                yield from next_chunk(chunk)
            # 3. the cell backward (warp 0)
            if w == 0:
                _, _, c0 = staged(t)
                gi, gj, gf, go = me.gsum.view(nr, 4, us).unbind(1)
                pi, pf, po = torch.zeros(3, us)
                if peep is not None:
                    pi[:nu], pf[:nu], po[:nu] = peep[d, :, u0:u0 + nu]
                si, tj = torch.sigmoid(gi + pi * c0), torch.tanh(gj)
                sf = torch.sigmoid(gf + pf * c0 + FORGET_BIAS)
                cn = sf * c0 + si * tj
                so, tc = torch.sigmoid(go + po * cn), torch.tanh(cn)
                if has_proj:
                    db = me.part_d[:, :us]
                else:
                    db = torch.zeros(nr, us)
                    db[:, :nu] = (m * (dout[t, rr] + dh[:, :out_dim]))[
                        :, u0:u0 + nu]
                dcv = me.dc
                d_o = db * tc * so * (1 - so)
                dcn = db * so * (1 - tc * tc) + m * dcv + d_o * po
                d_f = dcn * c0 * sf * (1 - sf)
                d_i = dcn * tj * si * (1 - si)
                d_j = dcn * si * (1 - tj * tj)
                me.dc = kp * (dcn * sf + (1 - m) * dcv + d_f * pf
                              + d_i * pi)
                dg = torch.stack([d_i, d_j, d_f, d_o], 1)   # [nr, 4, US]
                dg[:, :, nu:] = 0.0
                for k in range(4):
                    at = k * units + u0
                    dgates[t, rr, at:at + nu] = dg[:, k, :nu]
                me.sums[0] += (d_i * c0).sum(0)
                me.sums[1] += (d_f * c0).sum(0)
                me.sums[2] += (d_o * cn).sum(0)
                me.gq = dg.reshape(nr, g)
            yield ("sync", (d, q))
            # 4. the pass over wh
            yield from wh_pass(chunk, True, t - 1 if t > 0 else None)
            # 5a. reduce-scatter into the owners' inboxes (warp 0)
            if w == 0:
                for owner in range(C):
                    blocks[owner].inbox[q] = torch.nn.functional.pad(
                        me.part_h, (0, pw - p16))[:, owner * ps:
                                                  (owner + 1) * ps]
                    blocks[owner].inbox_tag[q] = t
            yield ("sync", "cluster")
            # 5b. the partials in block order, the new slice to every block
            if w == 0:
                s = read_tagged(me.inbox[0], [me.inbox_tag[0]], t, nr)
                for b in range(1, C):
                    s = s + read_tagged(me.inbox[b], [me.inbox_tag[b]], t,
                                        nr)
                cols = torch.arange(p0, p0 + ps)
                new = kp * ((1 - m) * dh[:, p0:p0 + ps] + s)
                new[:, cols >= out_dim] = 0.0
                for peer in blocks:
                    peer.dh[:, p0:p0 + ps] = new
                    peer.dh_tag[q] = t
            yield ("sync", "cluster")
        if w == 0:
            sums[(d, b0, q)] = (u0, nu, me.sums)

    for d in range(2):
        for b0 in range(0, batch, rows):
            sched = Sched(order)
            nr = min(rows, batch - b0)
            blocks = [Block(nr) for _ in range(C)]
            sched.run([((d, q), program(sched, blocks, d, b0, q, w))
                       for q in range(C) for w in range(WARPS)])
    dpeep = torch.zeros(2, 3, units)
    for (d, _, _), (u0, nu, s) in sorted(sums.items()):
        dpeep[d, :, u0:u0 + nu] += s[:, :nu]
    return dgates, dh_in, dpeep


def make_case(seed, units, out_dim, batch=2, steps=3, reset=True):
    """A layer's inputs from a numpy seed: gx, the lengths, keep (packed
    rows reset inside the sequence), the weights (with peepholes)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    pair = [cells.init_lstm_cell(gen, 4, units, out_dim, True)
            for _ in range(2)]
    wh, pj, peep = cells.recurrent_weights(pair[0], pair[1], torch.float32)
    seq = torch.from_numpy(np.array([steps, steps - 1][:batch], np.int32))
    reset_mask = None
    if reset:
        mask = np.zeros((batch, steps), np.float32)
        mask[:, 0] = 1.0
        mask[0, steps - 1] = 1.0
        reset_mask = torch.from_numpy(mask)
    _, keep = cells.step_masks(seq, reset_mask, steps, "cpu")
    gx = torch.from_numpy(rng.randn(steps, 2 * batch, 4 * units)
                          .astype(np.float32))
    return gx, seq, keep, wh, pj, peep, rng


# H = P = 1024 without a projection; 2048 cells with a projection of 512
SHAPES = [(1024, None), (2048, 512)]
SHAPE_IDS = ["1024-noproj", "2048x512"]


@pytest.mark.parametrize("order", [o for _, o in ORDERS],
                         ids=[n for n, _ in ORDERS])
@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_streamed_forward_matches_plain(units, proj, order):
    gx, seq, keep, wh, pj, peep, _ = make_case(1, units, proj)
    got = fwd_streamed(gx, seq, keep, wh, pj, peep, order)
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, peep, FORGET_BIAS,
                                states=True)
    for name, g, r in zip(("out", "cfin", "hfin", "c_all", "h_all"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("order", [o for _, o in ORDERS],
                         ids=[n for n, _ in ORDERS])
@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_streamed_backward_matches_plain(units, proj, order):
    gx, seq, keep, wh, pj, peep, rng = make_case(2, units, proj)
    _, _, _, c_all, h_all = cells.dual_recurrence(
        gx, seq, keep, wh, pj, peep, FORGET_BIAS, states=True)
    out_dim = h_all.shape[2]
    dout = torch.from_numpy(rng.randn(*h_all.shape).astype(np.float32))
    dcfin = torch.from_numpy(rng.randn(gx.shape[1], units)
                             .astype(np.float32))
    dhfin = torch.from_numpy(rng.randn(gx.shape[1], out_dim)
                             .astype(np.float32))
    args = (gx, seq, keep, wh, pj, peep, FORGET_BIAS, c_all, h_all, dout,
            dcfin, dhfin)
    dgates, _, _, dpeep, _, dh_in = cells.dual_recurrence_backward(
        *args, steps=True)
    got = bwd_streamed(gx, seq, keep, wh, pj, peep, c_all, h_all, dout,
                       dcfin, dhfin, order)
    for name, g, r in zip(("dgates", "dh_in", "dpeep"), got,
                          (dgates, dh_in, dpeep)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_streamed_plans_stream_and_fill_the_ring(units, proj):
    """The plans the emulation runs are the kernels' at these shapes: K1's
    largest R (8 at 1024 units, 4 at 2048), K2's at most that, two to four
    slots, the rest of shared memory holding wh's first rows, and chunks to
    stream every step; with the resident rows capped at half of wh (the
    forced plan's cap) the ring streams the rest."""
    out_dim = proj or units
    rows_f = largest_rows(fwd_plan, units, out_dim, proj is not None)
    rows_b = largest_rows(bwd_plan, units, out_dim, proj is not None)
    assert rows_f == 512 // max(64, units // 16)
    assert rows_b <= rows_f
    for plan in (fwd_plan, bwd_plan):
        rows = rows_f if plan is fwd_plan else rows_b
        pl = plan(units, out_dim, proj is not None, rows)
        assert 2 <= pl["slots"] <= MAX_SLOTS
        assert pl["res"] < pl["wsteps"] and pl["nw"] > 0
        half = plan(units, out_dim, proj is not None, rows,
                    pl["wsteps"] // 2)
        assert half["res"] == min(pl["res"], pl["wsteps"] // 2)
        assert half["nw"] >= pl["nw"]


@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_padded_layout_read_back_at_the_kernel_offsets(units, proj):
    """128 (or 64) units a block: row r of block q's wh slice lies at
    element ((d·C + q)·P16 + r)·LWS of the padded layout, gate-major, with
    8 zeros after its 4·US columns; proj's rows of K2 at ((d·C + q)·U16 +
    u)·LPJ, and K1's proj slices unpadded as the resident plans'."""
    gen = torch.Generator().manual_seed(4)
    out_dim = proj or units
    wh = torch.randn(2, out_dim, 4 * units, generator=gen)
    pj = torch.randn(2, units, out_dim, generator=gen) if proj else None
    us = round_up(cdiv(units, C), 8)
    lws, p16 = 4 * us + 8, round_up(out_dim, 16)
    flat = lstm_kernels._slices(wh, pj, C, padded=True)[0].reshape(-1)
    gates = wh.view(2, out_dim, 4, units)
    for d in range(2):
        for q in (0, 7, C - 1):
            for r in (0, out_dim // 2, out_dim - 1, p16 - 1):
                row = flat[((d * C + q) * p16 + r) * lws:][:lws]
                assert not row[4 * us:].any()
                for k in range(4):
                    u = torch.arange(q * us, q * us + us)
                    want = torch.zeros(us)
                    ok = (u < units) & (r < out_dim)
                    if r < out_dim:
                        want[ok] = gates[d, r, k, u[ok]]
                    assert torch.equal(row[k * us:(k + 1) * us], want)
    if pj is None:
        return
    assert torch.equal(lstm_kernels._slices(wh, pj, C, padded=True)[1],
                       lstm_kernels._slices(wh, pj, C)[1])
    u16, lpj = round_up(us, 16), p16 + 8
    rows = lstm_kernels._proj_rows(pj, C, padded=True).reshape(-1)
    for d in range(2):
        for q in (0, C - 1):
            for j in (0, us - 1, u16 - 1):
                row = rows[((d * C + q) * u16 + j) * lpj:][:lpj]
                u = q * us + j
                assert not row[out_dim:].any()
                if j < us and u < units:
                    assert torch.equal(row[:out_dim], pj[d, u])
                else:
                    assert not row.any()


def test_refill_before_the_block_barrier_is_caught():
    """Without the block barrier between a chunk's last read and its
    refill, warp 0 refills the slot while warp 1 still reads it: the
    emulation sees the slot in flight."""
    gx, seq, keep, wh, pj, peep, _ = make_case(3, 1024, None)
    with pytest.raises(Hazard, match="in flight"):
        fwd_streamed(gx, seq, keep, wh, pj, peep, greedy_order,
                     barrier_before_refill=False)
