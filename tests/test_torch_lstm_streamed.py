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


THREADS = 512  # a block's threads (kThreads)


def thread_rows(rows, us):
    """``lstm_cluster.cuh`` thread_rows: a cell-phase thread's rows (it owns
    unit tid % US of rows tid / US, + THREADS / US, ..)."""
    return cdiv(rows, THREADS // us)


def cell_rows(rows, units=128):
    """``lstm_cluster.cuh`` cell_rows: the most rows a thread owns with R
    rows a cluster, up to ``units`` a block (8 at most)."""
    return min(8, cdiv(rows, THREADS // units))


def fwd_plan(units, out_dim, has_proj, rows, cap=-1):
    """``csrc/lstm_fwd.cu`` stream_plan<16> (bf16), and whether it fits:
    the full h, the cell output and the sums of ``arow`` rows (8, or 16
    past 8 rows), no ring of gx; ``bytes`` of shared memory a block and its
    weight bytes ``held`` and ``streamed`` a step."""
    us = round_up(cdiv(units, C), 8)
    ps = round_up(cdiv(out_dim, C), 16) if has_proj else us
    g = 4 * us
    arow = 16 if rows > 8 else 8
    p = dict(us=us, ps=ps, g=g, arow=arow, lws=g + 8,
             wsteps=cdiv(out_dim, 16),
             psteps=cdiv(units, 16) if has_proj else 0)
    wrow, prow = 2 * 16 * p["lws"], 2 * 16 * ps
    p["cw"] = max(1, CHUNK_BYTES // wrow)
    p["cp"] = max(1, CHUNK_BYTES // prow) if has_proj else 0
    slot = align128(max(p["cw"] * wrow, p["cp"] * prow))
    hs, qs = C * us + 8, C * ps + 8
    fixed = (align128(2 * arow * qs) + align128(2 * arow * hs)
             + align128(4 * arow * max(g + 4, ps + 4)) + 128)
    p["slots"], p["res"] = ring_layout(fixed, wrow, p["wsteps"], slot, cap)
    p["nw"] = cdiv(p["wsteps"] - p["res"], p["cw"])
    p["np"] = cdiv(p["psteps"], p["cp"]) if has_proj else 0
    p["bytes"] = fixed + p["slots"] * slot + p["res"] * wrow
    p["held"] = 2 * 16 * g * p["res"]
    p["streamed"] = (2 * 16 * g * (p["wsteps"] - p["res"])
                     + 2 * 16 * ps * p["psteps"])
    p["fits"] = (us <= 128 and rows <= 16
                 and thread_rows(rows, us) <= cell_rows(rows)
                 and thread_rows(rows, ps) <= cell_rows(rows)
                 and p["slots"] >= 2 and p["bytes"] <= SMEM)
    return p


def bwd_plan(units, out_dim, has_proj, rows, cap=-1, store=2):
    """``csrc/lstm_bwd_streamed.cu`` bwd_stream_plan (bf16, the states in
    `store` bytes: bf16, as the train step keeps them), and whether it
    fits: a block keeps only its own P-slice (its units without a
    projection) of the carry dh and of dout, the A operands of ``arow``
    rows; ``bytes``, ``held`` and ``streamed`` as fwd_plan's."""
    us = round_up(cdiv(units, C), 8)
    u16, g = round_up(us, 16), 4 * us
    ps = round_up(cdiv(out_dim, C), 4) if has_proj else us
    pw, p16 = C * ps, round_up(out_dim, 16)
    arow = 16 if rows > 8 else 8
    p = dict(us=us, u16=u16, g=g, ps=ps, pw=pw, p16=p16, arow=arow,
             lws=g + 8, lpj=p16 + 8, wsteps=p16 // 16,
             utiles=u16 // 16 if has_proj else 0)
    wrow, urow = 2 * 16 * p["lws"], 2 * 16 * p["lpj"]
    p["cw"] = max(1, CHUNK_BYTES // wrow)
    p["cu"] = max(1, CHUNK_BYTES // urow) if has_proj else 0
    slot = align128(max(p["cw"] * wrow, p["cu"] * urow))
    part = max(mma_split(u16, p16)[1] * arow * u16 if has_proj else 0,
               3 * (THREADS // us) * us)
    aq = align128(2 * arow * (p16 + 8))
    fixed = (aq * (2 if has_proj else 1) + align128(2 * arow * (g + 8))
             + align128(4 * rows * ps) + align128(4 * 2 * rows * ps)
             + (0 if store == 2 else align128(store * rows * out_dim))
             + align128(store * 2 * rows * us) + align128(4 * 3 * rows)
             + align128(4 * rows * us) + align128(4 * C * rows * ps)
             + align128(4 * rows * g) + align128(4 * part) + 128)
    p["slots"], p["res"] = ring_layout(fixed, wrow, p["wsteps"], slot, cap)
    p["nw"] = cdiv(p["wsteps"] - p["res"], p["cw"])
    p["np"] = cdiv(p["utiles"], p["cu"]) if has_proj else 0
    p["bytes"] = fixed + p["slots"] * slot + p["res"] * wrow
    p["held"] = 2 * 16 * g * p["res"]
    p["streamed"] = (2 * 16 * g * (p["wsteps"] - p["res"])
                     + 2 * 16 * p16 * p["utiles"])
    p["fits"] = (us <= 128 and rows <= 16
                 and thread_rows(rows, us) <= cell_rows(rows)
                 and p["slots"] >= 2 and p["bytes"] <= SMEM)
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


# the R the streamed launchers try (16 on 16 blocks only)
LAYER_ROWS = (2, 4, 6, 8, 16)


def launch_rows(plan_fn, units, out_dim, has_proj, batch, resident=7,
                **kw):
    """The streamed launchers' choice (choose_streamed, launch_plan): (R,
    clusters, waves) with the fewest waves, then the fewest clusters, then
    the smallest R, where the card holds ``resident`` sixteen-block
    clusters at once (7 on an H100) and a layer runs 2·ceil(B/R)."""
    best = None
    for rows in LAYER_ROWS:
        if not plan_fn(units, out_dim, has_proj, rows, **kw)["fits"]:
            continue
        clusters = 2 * cdiv(batch, rows)
        waves = cdiv(clusters, resident)
        if best is None or (waves, clusters) < best[0]:
            best = ((waves, clusters), rows)
    assert best is not None, "no streamed plan"
    (waves, clusters), rows = best
    return rows, clusters, waves


def cell_threads(rows, us, nr):
    """A phase's rows in turn: for each of a thread's rows i, the rows rb0
    + i·RS of the threads rb0 < RS = THREADS // US (US: the units, or the
    projection columns, a block), below nr, as (rb0, row) pairs; every row
    of the tile comes exactly once."""
    rs = THREADS // us
    turns = []
    for i in range(thread_rows(rows, us)):
        turns.append([(rb0, rb0 + i * rs) for rb0 in range(rs)
                      if rb0 + i * rs < nr])
    turns = [turn for turn in turns if turn]
    seen = sorted(r for turn in turns for _, r in turn)
    assert seen == list(range(nr)), "a row owned twice or not at all"
    assert len(turns) <= cell_rows(rows)
    return turns


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
                 barrier_before_refill=True, rows=None):
    """K1's streamed plan in plain torch (float32), at the launcher's R (or
    ``rows``): (out, cfin, hfin, c_all, h_all).  The cell phase (and with
    a projection the masking phase) takes a thread's rows in turn
    (cell_threads), handing each turn's rows off to every block: a
    receiver's barrier counts a landing a block and turn."""
    steps, b2, h4 = gx.shape
    batch, units = b2 // 2, h4 // 4
    has_proj = proj is not None
    out_dim = proj.shape[2] if has_proj else units
    rows = rows or launch_rows(fwd_plan, units, out_dim, has_proj, batch)[0]
    pl = fwd_plan(units, out_dim, has_proj, rows, cap)
    assert pl["fits"]
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
            self.hq = [torch.zeros(pl["arow"], C * ps) for _ in range(2)]
            self.hq_tag = [[-1] * C for _ in range(2)]
            self.cell = torch.zeros(pl["arow"], C * us)
            self.cell_tag = [-1] * C
            self.bar = [Barrier() for _ in range(3)]
            self.ring = Ring(pl["slots"])
            self.part = torch.zeros(pl["arow"], max(g, ps))
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
        # the cell phase's and the masking phase's rows in turn; a
        # receiver's barrier counts one landing a block and turn
        cell_turns = [torch.tensor([r for _, r in turn])
                      for turn in cell_threads(rows, us, nr)]
        h_turns = [torch.tensor([r for _, r in turn])
                   for turn in cell_threads(rows, ps, nr)] if has_proj \
            else cell_turns
        n_c, n_h = C * len(cell_turns), C * len(h_turns)

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
                me.bar[0].arm(n_h)
            if not has_proj and steps > 2:
                me.bar[1].arm(n_h)
            if has_proj and steps > 0:
                me.bar[2].arm(n_c)
        yield ("sync", "cluster")
        if w == 0:
            for n in range(pl["slots"]):
                issue(n)
        chunk = [0]
        parity = [0, 0, 0]
        pi, pf, po = torch.zeros(3, us)
        if peep is not None:
            pi[:nu], pf[:nu], po[:nu] = peep[d, :, u0:u0 + nu]
        for t in range(steps):
            nxt = t + 1 < steps
            hb = 0 if has_proj else (t + 1) & 1
            if t > 0:
                yield ("wait", me.bar[hb], parity[hb])
                parity[hb] ^= 1
                s_next = t if has_proj else t + 1
                if w == 0 and s_next + 1 < steps:
                    me.bar[hb].arm(n_h)
            yield ("sync", (d, q))
            h_prev = read_tagged(me.hq[hb], me.hq_tag[hb], t - 1,
                                 nr)[:, :out_dim]
            h_pad = torch.zeros(nr, p16)
            h_pad[:, :out_dim] = h_prev
            # gx(t) read from L2 into the sums' init
            gxt = torch.zeros(nr, 4, us)
            gxt[:, :, :nu] = gx[t, rr].view(nr, 4, units)[:, :, u0:u0 + nu]
            acc = yield from product(h_pad, p16, gcols, True,
                                     gxt.reshape(nr, g)[:, gcols], chunk)
            me.part[:nr, gcols] = acc
            yield ("sync", (d, q))
            if w == 0:
                m_all = (t < lens).float()
                kn_all = keep[t + 1, br][:, None] if nxt and keep is not None \
                    else torch.ones(nr, 1)
                for turn in cell_turns:
                    gate = me.part[turn, :g].view(len(turn), 4, us)
                    gi, gj, gf, go = gate.unbind(1)
                    cp = me.c[turn]
                    cn = (torch.sigmoid(gf + pf * cp + FORGET_BIAS) * cp
                          + torch.sigmoid(gi + pi * cp) * torch.tanh(gj))
                    o = torch.sigmoid(go + po * cn) * torch.tanh(cn)
                    m, kn = m_all[turn], kn_all[turn]
                    cv = m * cn + (1.0 - m) * cp
                    me.c[turn] = kn * cv
                    c_all[t, rr[turn], u0:u0 + nu] = cv[:, :nu]
                    if has_proj:
                        for peer in blocks:
                            peer.cell[turn, u0:u0 + us] = o
                            peer.cell_tag[q] = t
                            peer.bar[2].land()
                    else:
                        hv = m * o + (1.0 - m) * me.h[turn]
                        me.h[turn] = kn * hv
                        if nxt:
                            for peer in blocks:
                                peer.hq[t & 1][turn, u0:u0 + us] = me.h[turn]
                                peer.hq_tag[t & 1][q] = t
                                peer.bar[t & 1].land()
                        out[t, rr[turn], u0:u0 + nu] = (m * o)[:, :nu]
                        h_all[t, rr[turn], u0:u0 + nu] = hv[:, :nu]
            if not has_proj:
                continue
            yield ("wait", me.bar[2], parity[2])
            parity[2] ^= 1
            if w == 0 and nxt:
                me.bar[2].arm(n_c)
            cell = read_tagged(me.cell, me.cell_tag, t, nr)[:, :units]
            c_pad = torch.zeros(nr, h16)
            c_pad[:, :units] = cell
            acc = yield from product(c_pad, h16, pcols, False,
                                     torch.zeros(nr, len(pcols)), chunk)
            me.part[:nr, pcols] = acc
            yield ("sync", (d, q))
            if w == 0:
                m_all = (t < lens).float()
                kn_all = keep[t + 1, br][:, None] if nxt and keep is not None \
                    else torch.ones(nr, 1)
                for turn in h_turns:
                    o = me.part[turn, :ps]
                    m, kn = m_all[turn], kn_all[turn]
                    hv = m * o + (1.0 - m) * me.h[turn]
                    me.h[turn] = kn * hv
                    if nxt:
                        for peer in blocks:
                            peer.hq[0][turn, p0:p0 + ps] = me.h[turn]
                            peer.hq_tag[0][q] = t
                            peer.bar[0].land()
                    out[t, rr[turn], p0:p0 + np_] = (m * o)[:, :np_]
                    h_all[t, rr[turn], p0:p0 + np_] = hv[:, :np_]
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
                 dhfin, order, cap=-1, barrier_before_refill=True, rows=None,
                 inbox_barrier=True):
    """K2's streamed plan in plain torch (float32), at the launcher's R (or
    ``rows``): (dgates, dh_in, dpeep).  A block keeps the carry dh and
    dout of its own P-slice only (its units without a projection): the
    pass over wh writes each 8-column half of its dh partial's 16-column
    tiles straight into the owners' inboxes (tile j's half h by warp 1 -
    (2·j + h) % 2), and each owner, after the cluster barrier, adds the 16
    partials in block order, updates its slice and writes the step
    before's dout_p of it into every block (dq: the A operand of
    dout_blk); the cell phase takes a thread's rows in turn, each thread's
    peephole sums its rows in order.  Without ``inbox_barrier`` the
    cluster barrier that ends an owner's reads of its inboxes is left
    out."""
    steps, b2, h4 = gx.shape
    batch, units = b2 // 2, h4 // 4
    has_proj = proj is not None
    out_dim = h_all.shape[2]
    rows = rows or launch_rows(bwd_plan, units, out_dim, has_proj, batch)[0]
    pl = bwd_plan(units, out_dim, has_proj, rows, cap)
    assert pl["fits"]
    us, u16, g, ps, p16 = (pl[k] for k in ("us", "u16", "g", "ps", "p16"))
    lws, lpj = pl["lws"], pl["lpj"]
    rs = THREADS // us
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
            self.dh = None                      # [nr, PS] the carry's slice
            self.dq = torch.zeros(nr, p16)      # dout_p, from every owner
            self.dq_tag = [-1] * C
            # [C sources][nr][PS] and each column's step; the step last
            # read of each source's
            self.inbox = torch.zeros(C, nr, ps)
            self.inbox_tag = [[-1] * ps for _ in range(C)]
            self.inbox_read = [-1] * C
            self.gsum = torch.zeros(nr, g)
            self.part_d = torch.zeros(nr, u16)
            self.gq = None
            self.dc = None
            self.sums = torch.zeros(rs, 3, us)  # a thread's rows' sums

    def program(sched, blocks, d, b0, q, w):
        nr = min(rows, batch - b0)
        me = blocks[q]
        br = torch.arange(b0, b0 + nr)
        rr = d * batch + br
        u0, p0 = q * us, q * ps
        nu = max(0, min(us, units - u0))
        npq = max(0, min(ps, out_dim - p0))
        own = torch.arange(p0, p0 + npq)
        lens = seq[br][:, None]
        wres = wh_flat[(d * C + q) * p16 * lws:][:16 * pl["res"] * lws]
        wres = wres.view(-1, lws)
        gcols = [c for t in range(w, g // 16, WARPS)
                 for c in range(16 * t, 16 * t + 16)]
        pi, pf, po = torch.zeros(3, us)
        if peep is not None:
            pi[:nu], pf[:nu], po[:nu] = peep[d, :, u0:u0 + nu]

        def issue(n):
            if n < total:
                sched.issue(me.ring, n, chunk_rows(n, d, q)[2].clone())

        def fetch(tt):
            """What step tt reads that no carry feeds (the kernel's cp.async
            a step ahead): dout of the owned P-slice, h_prev and c_prev kept
            (times keep(tt); zero at tt = 0), the mask and keep (the gate
            inputs are read as the pass over wh starts)."""
            kp = keep[tt, br][:, None] if keep is not None else \
                torch.ones(nr, 1)
            hp = torch.zeros(nr, p16)
            cp = torch.zeros(nr, us)
            if tt > 0:
                hp[:, :out_dim] = kp * h_all[tt - 1, rr]
                cp[:, :nu] = kp * c_all[tt - 1, rr][:, u0:u0 + nu]
            return dict(t=tt, dout=dout[tt, rr][:, own], hp=hp, cp=cp,
                        m=(tt < lens).float(), kp=kp)

        def gate_inputs(tt):
            gxt = torch.zeros(nr, 4, us)
            gxt[:, :, :nu] = gx[tt, rr].view(nr, 4, units)[:, :, u0:u0 + nu]
            return gxt.reshape(nr, g)

        def to_inboxes(c0, value, t):
            """dh partial columns c0 .. c0 + 7 (half a 16-column tile) of
            this step into the inbox[q] of each owner of them"""
            for owner in range(c0 // ps, (c0 + 7) // ps + 1):
                lo, hi = max(c0, owner * ps), min(c0 + 8, (owner + 1) * ps)
                peer = blocks[owner]
                tags = peer.inbox_tag[q]
                for c in range(lo - owner * ps, hi - owner * ps):
                    if tags[c] not in (-1, peer.inbox_read[q]):
                        raise Hazard("block %d's inbox overwritten before "
                                     "its owner read it" % owner)
                    tags[c] = t
                peer.inbox[q][:, lo - owner * ps:hi - owner * ps] = \
                    value[:, lo - c0:hi - c0]

        def wh_pass(chunk, dh_t, st):
            """4: with dh_t, this step's dh partial from me.gq (by rows p)
            into the owners' inboxes; with ``st`` (the step before's staged
            loads) the gate sums, this warp's columns, into me.gsum, which
            holds their init (gx) from the pass's start."""
            acc = None
            if st is not None:
                me.gsum[:, gcols] = gate_inputs(st["t"])[:, gcols]
                acc = torch.zeros(nr, len(gcols))

            def rows_at(wrows, r0, nrows):
                if acc is not None:
                    acc.add_(st["hp"][:, r0:r0 + nrows] @ wrows[:nrows, gcols])
                if dh_t is not None:
                    for j in range(r0 // 16, (r0 + nrows) // 16):
                        for h in range(2):
                            if w != WARPS - 1 - (2 * j + h) % WARPS:
                                continue
                            blk = wrows[16 * j - r0 + 8 * h:][:8, :g]
                            to_inboxes(16 * j + 8 * h, me.gq @ blk.t(), dh_t)

            rows_at(wres, 0, 16 * pl["res"])
            for _ in range(pl["nw"]):
                r0, nrows, _ = chunk_rows(chunk[0], d, q)
                yield wait_chunk(me.ring, chunk[0])
                me.ring.read(chunk[0], nrows)
                yield ("run",)
                rows_at(me.ring.read(chunk[0], nrows), r0, nrows)
                yield from release(me.ring, chunk[0], w, (d, q), issue,
                                   barrier_before_refill)
                chunk[0] += 1
            if acc is not None:
                me.gsum[:, gcols] += acc
            yield ("sync", (d, q))

        def share_dq(st, v):
            """dout_p of the staged step over the owned slice, from the
            carry's slice v, into every block's dq"""
            for peer in blocks:
                peer.dq[:, p0:p0 + npq] = st["m"] * (st["dout"] + v)
                peer.dq_tag[q] = st["t"]

        if w == 0:
            me.dh = torch.zeros(nr, ps)
            me.dh[:, :npq] = dhfin[rr][:, own]
            me.dc = torch.zeros(nr, us)
            me.dc[:, :nu] = dcfin[rr][:, u0:u0 + nu]
        yield ("sync", "cluster")
        if w == 0:
            for n in range(pl["slots"]):
                issue(n)
        chunk = [0]
        staged = fetch(steps - 1)
        yield ("sync", (d, q))
        if w == 0 and has_proj:
            share_dq(staged, me.dh[:, :npq])
        yield ("sync", "cluster")
        yield from wh_pass(chunk, None, staged)
        for t in range(steps - 1, -1, -1):
            cur = staged
            m, kp = cur["m"], cur["kp"]
            if t > 0:
                staged = fetch(t - 1)
            if w == 0:
                # 1. the stash of the owned slice
                dh_in[t, rr[:, None], own[None, :]] = me.dh[:, :npq]
            yield ("sync", (d, q))
            # 2. dout_blk over proj's chunks of rows, this warp's tiles
            for _ in range(pl["np"]):
                r0, nrows, _ = chunk_rows(chunk[0], d, q)
                yield wait_chunk(me.ring, chunk[0])
                me.ring.read(chunk[0], nrows)
                read_tagged(me.dq, me.dq_tag, t, nr)
                yield ("run",)
                block = me.ring.read(chunk[0], nrows)
                dq = read_tagged(me.dq, me.dq_tag, t, nr)
                for j in range(w, nrows // 16, WARPS):
                    me.part_d[:, r0 + 16 * j:r0 + 16 * j + 16] = (
                        dq @ block[16 * j:16 * j + 16, :p16].t())
                yield from release(me.ring, chunk[0], w, (d, q), issue,
                                   barrier_before_refill)
                chunk[0] += 1
            # 3. the cell backward (warp 0), a thread's rows in turn
            if w == 0:
                dgq = torch.zeros(nr, 4, us)
                for turn in cell_threads(rows, us, nr):
                    ri = torch.tensor([r for _, r in turn])
                    c0, mr, kr = cur["cp"][ri], m[ri], kp[ri]
                    gi, gj, gf, go = me.gsum[ri].view(len(ri), 4, us).unbind(1)
                    si, tj = torch.sigmoid(gi + pi * c0), torch.tanh(gj)
                    sf = torch.sigmoid(gf + pf * c0 + FORGET_BIAS)
                    cn = sf * c0 + si * tj
                    so, tc = torch.sigmoid(go + po * cn), torch.tanh(cn)
                    if has_proj:
                        db = me.part_d[ri, :us]
                    else:
                        # PS = US: the units' own columns
                        db = torch.zeros(len(ri), us)
                        db[:, :nu] = (mr * (cur["dout"][ri]
                                            + me.dh[ri, :npq]))[:, :nu]
                    dcv = me.dc[ri]
                    d_o = db * tc * so * (1 - so)
                    dcn = db * so * (1 - tc * tc) + mr * dcv + d_o * po
                    d_f = dcn * c0 * sf * (1 - sf)
                    d_i = dcn * tj * si * (1 - si)
                    d_j = dcn * si * (1 - tj * tj)
                    me.dc[ri] = kr * (dcn * sf + (1 - mr) * dcv + d_f * pf
                                      + d_i * pi)
                    dg = torch.stack([d_i, d_j, d_f, d_o], 1)   # [n, 4, US]
                    dg[:, :, nu:] = 0.0
                    for k in range(4):
                        at = k * units + u0
                        dgates[t, rr[ri], at:at + nu] = dg[:, k, :nu]
                    dgq[ri] = dg
                    # each thread's peephole sums, its rows in order
                    thr = torch.tensor([rb0 for rb0, _ in turn])
                    me.sums[thr, 0] += d_i * c0
                    me.sums[thr, 1] += d_f * c0
                    me.sums[thr, 2] += d_o * cn
                me.gq = dgq.reshape(nr, g)
            yield ("sync", (d, q))
            # 4. the step before's staged loads, the pass over wh
            yield from wh_pass(chunk, t, staged if t > 0 else None)
            yield ("sync", "cluster")
            # 5. the partials in block order, the carry's slice, the step
            # before's dout_p into every block (warp 0, whenever it gets
            # there)
            yield ("run",)
            if w == 0:
                s = None
                for b in range(C):
                    part = read_tagged(me.inbox[b], me.inbox_tag[b][:npq], t,
                                       nr)[:, :npq]
                    s = part if s is None else s + part
                    me.inbox_read[b] = t
                me.dh[:, :npq] = kp * ((1 - m) * me.dh[:, :npq] + s)
                if has_proj and t > 0:
                    share_dq(staged, me.dh[:, :npq])
            if inbox_barrier:
                yield ("sync", "cluster")
        if w == 0:
            # the row tile's peephole sums: the threads' in row order
            tot = torch.zeros(3, us)
            for rb0 in range(min(rs, nr)):
                tot = tot + me.sums[rb0]
            sums[(d, b0, q)] = (u0, nu, tot)

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
    """A layer's inputs from a numpy seed: gx, the lengths (every second
    row one step short), keep (packed rows reset inside the sequence), the
    weights (with peepholes)."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    pair = [cells.init_lstm_cell(gen, 4, units, out_dim, True)
            for _ in range(2)]
    wh, pj, peep = cells.recurrent_weights(pair[0], pair[1], torch.float32)
    seq = torch.from_numpy(np.array([steps, steps - 1] * batch,
                                    np.int32)[:batch])
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


# H = P = 1024 without a projection (64 units a block); 2048 cells with a
# projection of 512 (128 a block)
SHAPES = [(1024, None), (2048, 512)]
SHAPE_IDS = ["1024-noproj", "2048x512"]
# (scheduler, R, batch): the launchers' R at B = 2 under each order; then R
# = 16 over two tiles, the second ragged (9 rows: two turns of the cell
# phase at 64 units a block, three at 128)
RUNS = [(o, None, 2) for _, o in ORDERS] + [(greedy_order, 16, 25)]
RUN_IDS = [n for n, _ in ORDERS] + ["greedy-16-rows-ragged"]


@pytest.mark.parametrize("order,rows,batch", RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_streamed_forward_matches_plain(units, proj, order, rows, batch):
    gx, seq, keep, wh, pj, peep, _ = make_case(1, units, proj, batch)
    got = fwd_streamed(gx, seq, keep, wh, pj, peep, order, rows=rows)
    ref = cells.dual_recurrence(gx, seq, keep, wh, pj, peep, FORGET_BIAS,
                                states=True)
    for name, g, r in zip(("out", "cfin", "hfin", "c_all", "h_all"), got,
                          ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


def backward_case(units, proj, batch, seed=2):
    gx, seq, keep, wh, pj, peep, rng = make_case(seed, units, proj, batch)
    _, _, _, c_all, h_all = cells.dual_recurrence(
        gx, seq, keep, wh, pj, peep, FORGET_BIAS, states=True)
    out_dim = h_all.shape[2]
    dout = torch.from_numpy(rng.randn(*h_all.shape).astype(np.float32))
    dcfin = torch.from_numpy(rng.randn(gx.shape[1], units)
                             .astype(np.float32))
    dhfin = torch.from_numpy(rng.randn(gx.shape[1], out_dim)
                             .astype(np.float32))
    return (gx, seq, keep, wh, pj, peep, FORGET_BIAS, c_all, h_all, dout,
            dcfin, dhfin)


@pytest.mark.parametrize("order,rows,batch", RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_streamed_backward_matches_plain(units, proj, order, rows, batch):
    args = backward_case(units, proj, batch)
    dgates, _, _, dpeep, _, dh_in = cells.dual_recurrence_backward(
        *args, steps=True)
    got = bwd_streamed(*args[:6], *args[7:], order, rows=rows)
    for name, g, r in zip(("dgates", "dh_in", "dpeep"), got,
                          (dgates, dh_in, dpeep)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_streamed_plans_stream_and_fill_the_ring(units, proj):
    """The plans the emulation runs are the kernels' at these shapes: at B
    = 32 both launchers take R = 16, four clusters in one wave, two to four
    slots, the rest of shared memory holding wh's first rows, and chunks to
    stream every step; with the resident rows capped at half of wh (the
    forced plan's cap) the ring streams the rest."""
    out_dim = proj or units
    for plan in (fwd_plan, bwd_plan):
        rows, clusters, waves = launch_rows(plan, units, out_dim,
                                            proj is not None, 32)
        assert (rows, clusters, waves) == (16, 4, 1)
        pl = plan(units, out_dim, proj is not None, rows)
        assert pl["arow"] == 16
        assert 2 <= pl["slots"] <= MAX_SLOTS
        assert pl["res"] < pl["wsteps"] and pl["nw"] > 0
        half = plan(units, out_dim, proj is not None, rows,
                    pl["wsteps"] // 2)
        assert half["res"] == min(pl["res"], pl["wsteps"] // 2)
        assert half["nw"] >= pl["nw"]


# the streamed widths at B = 32: (H, the projection or None) and the
# launchers' (R, clusters, waves) for K1 and K2, the states in bf16, and
# K2's R with float32 states (h_prev staged as float32 beside the rows);
# H = P = 2048's K2 takes 8 rows: its inbox of 16 rows alone would be 128
# KB
B32 = {(1024, None): ((16, 4, 1), (16, 4, 1), 8),
       (768, 768): ((16, 4, 1), (16, 4, 1), 8),
       (2048, 512): ((16, 4, 1), (16, 4, 1), 16),
       (2048, None): ((16, 4, 1), (8, 8, 2), 6)}


@pytest.mark.parametrize("units,proj", list(B32),
                         ids=["%d-%s" % (u, p or "noproj") for u, p in B32])
def test_streamed_launchers_at_b32(units, proj):
    """At B = 32 every streamed launch runs one wave but K2's at H = P =
    2048 (two of 8 clusters, where the one-row plans ran 2-5), a
    cell-phase thread owning up to four rows; K2 with float32 states takes
    16 rows only where its staged h_prev fits beside them (2048/512)."""
    out_dim = proj or units
    got = tuple(launch_rows(plan, units, out_dim, proj is not None, 32)
                for plan in (fwd_plan, bwd_plan))
    assert got == B32[(units, proj)][:2]
    for plan, (rows, _, _) in zip((fwd_plan, bwd_plan), got):
        us = plan(units, out_dim, proj is not None, rows)["us"]
        assert 1 <= thread_rows(rows, us) <= min(4, cell_rows(rows))
    f32 = launch_rows(bwd_plan, units, out_dim, proj is not None, 32,
                      store=4)[0]
    assert f32 == B32[(units, proj)][2]


@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_inbox_write_before_its_owner_read_is_caught(units, proj):
    """Without the cluster barrier that ends the owners' reads of their
    inboxes and their writes of dq, a block runs ahead into the next step:
    its pass over wh writes its dh partial into an inbox its owner has not
    read yet."""
    args = backward_case(units, proj, 2)
    with pytest.raises(Hazard, match="inbox overwritten|holding"):
        bwd_streamed(*args[:6], *args[7:], greedy_order,
                     inbox_barrier=False)


def test_stamp_phases_refuses_a_buffer_the_kernels_cannot_fill():
    """The stamps' switch (``scripts/layer_stamps.py``) takes only a CUDA
    int64 buffer of the steps and six phases, and refuses any other before
    a CUDA call; each kernel names six phases."""
    for bad in (torch.zeros(7, dtype=torch.int64), torch.zeros(7),
                torch.zeros(6, dtype=torch.int64)):
        for which in ("forward", "backward"):
            with pytest.raises(ValueError, match="stamps"):
                lstm_kernels.stamp_phases(which, bad)
    assert sorted(lstm_kernels.STAMP_PHASES) == ["backward", "forward"]
    assert all(len(p) == 6 for p in lstm_kernels.STAMP_PHASES.values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("units,proj", list(B32),
                         ids=["%d-%s" % (u, p or "noproj") for u, p in B32])
def test_plans_are_the_kernels_on_gpu(cuda, units, proj):
    """fwd_plan and bwd_plan, and the launchers' choice, field by field
    against the kernels' own (``forward_config``, ``backward_config``) at
    B = 32: R, clusters, waves, shared memory a block, and the weight
    bytes held and streamed a step, at the launcher's R and at each R
    they try (a forced launch's plan; refused where the copy says it does
    not fit); so a copy fails wherever the C++ moves."""
    out_dim = proj or units
    has_proj = proj is not None
    for plan, config in ((fwd_plan, lstm_kernels.forward_config),
                         (bwd_plan, lstm_kernels.backward_config)):
        how = config(cuda, 32, units, out_dim, has_proj, torch.bfloat16)
        rows, clusters, waves = launch_rows(plan, units, out_dim, has_proj,
                                            32, resident=how["resident"])
        assert how["streamed"] and how["blocks"] == C
        assert (how["rows"], how["clusters"], how["waves"]) == (
            rows, clusters, waves)
        for r in LAYER_ROWS:
            pl = plan(units, out_dim, has_proj, r)
            if not pl["fits"]:
                with pytest.raises(RuntimeError, match="config"):
                    config(cuda, 32, units, out_dim, has_proj,
                           torch.bfloat16, rows=r)
                continue
            at = config(cuda, 32, units, out_dim, has_proj, torch.bfloat16,
                        rows=r)
            assert (at["rows"], at["clusters"]) == (r, 2 * cdiv(32, r))
            assert (at["smem_bytes"], at["held_bytes"],
                    at["streamed_bytes"]) == (pl["bytes"], pl["held"],
                                              pl["streamed"])
            if r == rows:
                assert at == how


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
