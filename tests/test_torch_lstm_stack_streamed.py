"""K12's and K13's streamed plans and 128-unit blocks
(``csrc/lstm_stack_fwd.cu``, ``csrc/lstm_stack_bwd.cu`` with ``kStream``),
emulated on the CPU.

A bf16 stack whose weight slices fit no resident plan (2048 cells with a
projection of 512, H = P = 1024 without one) runs 16-block clusters, one
per (layer, tile of rows), whose blocks own up to 128 units each, keep the
first rows of their wh slice in shared memory and stream the rest (and
proj) from L2 at every step through ``lstm_cluster.cuh``'s ring of chunks,
as K1's and K2's streamed plans do (``test_torch_lstm_streamed.py``).  The
layers run as the stack kernels' pipeline (``test_torch_lstm_stack_
pipeline.py``): K12's layer l waits, before a chunk of K steps, until the
16 blocks of layer l-1 have counted the chains it reads; K13's layer l
waits, a step ahead, until the blocks of layer l+1 have counted the din it
reads, and counts its own din at the end of every chunk.

Here all the layers' clusters of a row tile run together, each block as
two warps with the kernels' ownership rules, under a scheduler that
interleaves them at every point where a warp could be overtaken and lands
a pending copy at any of them (random orders, and the lowest-numbered warp
as far as it can go).  Every slot carries the chunk it holds and every
read checks it before and after an interleaving point; the hand-off
buffers (h, the cell output, dh, the inboxes) carry the step of each
block's slice; what a layer writes for another becomes readable only when
its block publishes its count.  The chunks are read from the padded
layouts ``lstm_stack_kernels.stack_slices(..., streamed=True)`` gives, at
the kernels' element offsets, and the plans' arithmetic (resident rows,
chunk sizes, slots) is the kernels'.  The results are held to
``stack_forward_reference`` and ``stack_backward_reference`` at rtol =
atol = 1e-5 in float32.
"""

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.models import cells
from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk
from test_torch_lstm_streamed import (ORDERS, SMEM, Hazard, Ring, Sched,
                                      align128, cdiv, greedy_order,
                                      mma_split, read_tagged, release,
                                      ring_layout, round_up, wait_chunk)

TOL = dict(rtol=1e-5, atol=1e-5)
C = 16       # the streamed plans' blocks a cluster
WARPS = 2    # warps a block in the emulation (the kernels run 16)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread: the emulation's many small ops slow
    down when their thread pool shares busy cores (the suite's workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


THREADS = 512  # a block's threads (kThreads)


def thread_rows(rows, us):
    """``lstm_cluster.cuh`` thread_rows: a cell-phase thread's rows (it owns
    unit tid % US of rows tid / US, + THREADS / US, ..)."""
    return cdiv(rows, THREADS // us)


def cell_rows(rows, units=128):
    """``lstm_cluster.cuh`` cell_rows: the most rows a thread owns with R
    rows a cluster, up to ``units`` a block (8 at most)."""
    return min(8, cdiv(rows, THREADS // units))


def k12_plan(units, out_dim, has_proj, rows, cap=-1):
    """``lstm_cluster.cuh`` plan<bf16>(stream): the streamed plan of K12
    with 16 blocks and R = ``rows`` (the products' A operands of 8 rows,
    or of R rounded up to 16-row tiles), and whether it fits."""
    us = round_up(cdiv(units, C), 8)
    ps = round_up(cdiv(out_dim, C), 16) if has_proj else us
    g, own = 4 * us, ps if has_proj else us
    arow = 8 if rows <= 8 else round_up(rows, 16)
    qs, hs = C * ps + 8, C * us + 8
    p = dict(us=us, ps=ps, g=g, lwa=g + 8, wsteps=cdiv(out_dim, 16),
             psteps=cdiv(units, 16) if has_proj else 0, arow=arow,
             per_g=mma_split(g, out_dim)[0], per_p=mma_split(ps, units)[0])
    part = max(arow * g, arow * ps if has_proj else 0)
    off = align128(2 * arow * qs) + (align128(2 * arow * hs) if has_proj
                                     else 0)
    off += (align128(4 * rows * us) + align128(4 * rows * own)
            + align128(2 * rows * max(us, ps)))
    row_in = 2 * (round_up(out_dim, 16) + 8)
    p["srows"] = 32 if 32 * row_in <= 65536 else 16
    off += align128(max(4 * part, p["srows"] * row_in)) + 128
    wrow, prow = 2 * 16 * p["lwa"], 2 * 16 * ps
    p["cw"] = max(1, 24576 // wrow)
    p["cp"] = max(1, 24576 // prow) if has_proj else 0
    slot = align128(max(p["cw"] * wrow, p["cp"] * prow))
    p["slots"], p["res"] = ring_layout(off, wrow, p["wsteps"], slot, cap)
    p["nw"] = cdiv(p["wsteps"] - p["res"], p["cw"])
    p["np"] = cdiv(p["psteps"], p["cp"]) if has_proj else 0
    nbytes = off + p["slots"] * slot + p["res"] * wrow
    p["fits"] = (us <= 128 and thread_rows(rows, us) <= cell_rows(rows)
                 and p["slots"] >= 2 and nbytes <= SMEM)
    return p


def k12_resident_plan(units, out_dim, has_proj, rows, cl=C):
    """``lstm_cluster.cuh`` plan<bf16>, resident, on ``cl`` blocks: the
    slices held in shared memory (wh's rows padded by 16 bytes, proj's
    only on 8 blocks), the partial sums of each k-slice [slices][arow]
    [cols], the input stage in their region (16 rows where 32 do not fit),
    no ring, the carried c in the cell-phase threads' registers where a
    thread has several rows (c_in_regs: 16 blocks only); and whether it
    fits: on 16 blocks several rows a thread up to 64 units a block, on 8
    one row a thread (R·US <= 512) up to 64 units a block."""
    us = round_up(cdiv(units, cl), 8)
    ps = round_up(cdiv(out_dim, cl), 16) if has_proj else us
    g, own = 4 * us, ps if has_proj else us
    arow = 8 if rows <= 8 else round_up(rows, 16)
    qs, hs = cl * ps + 8, cl * us + 8
    per_g, sl_g = mma_split(g, out_dim)
    per_p, sl_p = mma_split(ps, units)
    part = max(sl_g * arow * g, sl_p * arow * ps if has_proj else 0)
    c_regs = cl == C and cell_rows(rows, 64) > 1
    off = (align128(2 * arow * qs) + (align128(2 * arow * hs) if has_proj
                                       else 0)
           + (0 if c_regs else align128(4 * rows * us))
           + align128(4 * rows * own) + align128(2 * rows * max(us, ps)))
    lwd = ps + (8 if cl != C else 0)
    weights = 2 * (round_up(out_dim, 16) * (g + 8)
                   + (round_up(units, 16) * lwd if has_proj else 0))
    row_in = 2 * (round_up(out_dim, 16) + 8)
    srows = 32 if off + align128(max(32 * row_in, 4 * part)) + weights \
        <= SMEM else 16
    nbytes = off + align128(max(4 * part, srows * row_in)) + weights
    p = dict(us=us, ps=ps, g=g, lwa=g + 8, wsteps=cdiv(out_dim, 16),
             psteps=cdiv(units, 16) if has_proj else 0, arow=arow,
             per_g=per_g, per_p=per_p, srows=srows, slots=0,
             res=cdiv(out_dim, 16), nw=0, np=0, bytes=nbytes)
    rows_ok = (thread_rows(rows, us) <= cell_rows(rows, 64) if cl == C
               else rows * us <= THREADS)
    p["fits"] = us <= (128 if cl == C else 64) and rows_ok and nbytes <= SMEM
    return p


def k13_plan(units, out_dim, has_proj, rows, cap=-1, store=2, held=False):
    """``csrc/lstm_stack_bwd.cu`` stack_plan<bf16, S>(stream): the streamed
    plan of K13 with 16 blocks and R = ``rows`` (the states in ``store``
    bytes; without a projection a block's P-slice is its units), and
    whether it fits; with ``held`` the resident plan of 16 blocks (the
    same buffers, every step of wh and all of proj's rows held, no
    ring)."""
    us = round_up(cdiv(units, C), 8)
    u16, g = round_up(us, 16), 4 * us
    ps = round_up(cdiv(out_dim, C), 4) if has_proj else us
    pw, p16 = C * ps, round_up(out_dim, 16)
    arow = 16 if rows > 8 else 8
    p = dict(us=us, u16=u16, g=g, ps=ps, pw=pw, p16=p16, lwh=g + 8,
             lpj=p16 + 8, wsteps=p16 // 16, gsteps=g // 16, arow=arow,
             utiles=u16 // 16 if has_proj else 0)
    part = max(mma_split(u16, p16)[1] * arow * u16 if has_proj else 0,
               7 * (THREADS // us) * us)
    aq = align128(2 * arow * (p16 + 8))
    off = (aq * (2 if has_proj else 1) + align128(2 * arow * (g + 8))
           + align128(4 * rows * ps) + align128(4 * 2 * rows * ps)
           + (0 if store == 2 else align128(store * rows * out_dim))
           + align128(store * 2 * rows * us) + align128(4 * 2 * rows)
           + align128(4 * rows * us) + align128(4 * C * rows * ps)
           + align128(4 * rows * g) + align128(4 * part))
    if held:
        nbytes = (off + align128(2 * p16 * p["lwh"])
                  + (align128(2 * u16 * p["lpj"]) if has_proj else 0))
        p.update(slots=0, res=p["wsteps"], nw=0, np=0, bytes=nbytes)
        p["fits"] = (us <= 128 and rows <= 16
                     and thread_rows(rows, us) <= cell_rows(rows)
                     and nbytes <= SMEM)
        return p
    off += 128
    wrow, urow = 2 * 16 * p["lwh"], 2 * 16 * p["lpj"]
    p["cw"] = max(1, 24576 // wrow)
    p["cu"] = max(1, 24576 // urow) if has_proj else 0
    slot = align128(max(p["cw"] * wrow, p["cu"] * urow))
    p["slots"], p["res"] = ring_layout(off, wrow, p["wsteps"], slot, cap)
    p["nw"] = cdiv(p["wsteps"] - p["res"], p["cw"])
    p["np"] = cdiv(p["utiles"], p["cu"]) if has_proj else 0
    nbytes = off + p["slots"] * slot + p["res"] * wrow
    p["fits"] = (us <= 128 and rows <= 16
                 and thread_rows(rows, us) <= cell_rows(rows)
                 and p["slots"] >= 2 and nbytes <= SMEM)
    return p


def k13_resident_plan(units, out_dim, has_proj, rows, store=2):
    return k13_plan(units, out_dim, has_proj, rows, store=store, held=True)


# the launchers' R of the bf16 plans of 16 blocks, in the order they are
# tried
K12_ROWS, K13_ROWS = (4, 8, 16, 32), (4, 8, 16, 2)


def launch_rows(plan_fn, units, out_dim, has_proj, batch, layers=4,
                resident=7):
    """The launcher's choice on a bf16 plan of 16 blocks (choose_rows): (R,
    row tiles a wave, waves) with the fewest waves, then the smallest R,
    where the card holds ``resident`` sixteen-block clusters at once (7 on
    an H100) and a wave holds resident // layers row tiles."""
    best = None
    k12 = plan_fn in (k12_plan, k12_resident_plan)
    for rows in K12_ROWS if k12 else K13_ROWS:
        if not plan_fn(units, out_dim, has_proj, rows)["fits"]:
            continue
        tiles = cdiv(batch, rows)
        per_wave = min(tiles, resident // layers)
        waves = cdiv(tiles, per_wave)
        if best is None or waves < best[2]:
            best = (rows, per_wave, waves)
    assert best is not None, "no plan"
    return best


def cell_threads(rows, us, nr):
    """The cell phase's rows in turn: for each of a thread's rows i, the
    rows rb0 + i·RS of the threads rb0 < RS = THREADS // US, below nr, as
    (rb0, row) pairs; every row of the tile comes exactly once."""
    rs = THREADS // us
    turns = []
    for i in range(thread_rows(rows, us)):
        turns.append([(rb0, rb0 + i * rs) for rb0 in range(rs)
                      if rb0 + i * rs < nr])
    seen = sorted(r for turn in turns for _, r in turn)
    assert seen == list(range(nr)), "a row owned twice or not at all"
    assert len(turns) <= cell_rows(rows)
    return turns


class Count:
    """A layer's 16 step counters, as a wait sees them: done once every
    block has counted ``want``."""

    def __init__(self):
        self.v = [0] * C

    def done(self, want):
        return min(self.v) >= want


def layer_group(tag, key):
    """The stack's sync groups: a block ((layer, q)), a layer's cluster
    (("layer", l)), or every warp ("cluster")."""
    return key == "cluster" or tag == key or (
        key[0] == "layer" and tag[0] == key[1])


def stream_product(ring, chunk, n_chunks, chunk_rows, a, cols, init, w,
                   block, issue, wres=None, refill_after_barrier=True,
                   per=None):
    """This warp's columns of init + a · w over the streamed depth: the
    resident rows ``wres`` first (with ``per``, the resident plan's: each
    k-slice of ``per`` 16-deep steps summed alone, the slices added in
    order), then ``n_chunks`` chunks of the ring (each waited for, read
    around an interleaving point, released)."""
    acc = init.clone()
    k = 0
    if wres is not None and wres.shape[0]:
        k = wres.shape[0]
        step = k if per is None else 16 * per
        for k0 in range(0, k, step):
            k1 = min(k, k0 + step)
            acc += a[:, k0:k1] @ wres[k0:k1, cols]
    for _ in range(n_chunks):
        nrows = chunk_rows(chunk[0])[1]
        yield wait_chunk(ring, chunk[0])
        ring.read(chunk[0], nrows)
        yield ("run",)
        part = ring.read(chunk[0], nrows)
        k1 = min(a.shape[1], k + nrows)
        acc += a[:, k:k1] @ part[:k1 - k, cols]
        k += nrows
        yield from release(ring, chunk[0], w, block, issue,
                           refill_after_barrier)
        chunk[0] += 1
    return acc


def tile_cols(w, cols):
    """This warp's 16-column tiles of ``cols`` columns (warp w: w, w + 2,
    ..), as column indices."""
    return torch.tensor([c for t in range(w, cols // 16, WARPS)
                         for c in range(16 * t, 16 * t + 16)],
                        dtype=torch.long)


def lag_fwd(steps):
    return min(8, max(2, cdiv(steps, 8)))


def lag_bwd(steps):
    return min(8, max(2, cdiv(steps, 16)))


def k12_streamed(case, order, cap=-1, refill_after_barrier=True, lag=None,
                 count=None, rows=None, held=False):
    """K12 on the streamed plan in plain torch (float32), at the launcher's
    R (or ``rows``): (out, chain, c_all, h_all, cfin, hfin) as
    ``stack_forward_reference`` returns them.  With ``held``, the resident
    plan of 16 blocks: the dense slices all in shared memory, each product
    summed by the resident plan's k-slices, no ring."""
    gx0, mask, wz, proj = case["gx0"], case["mask"], case["wz"], case["proj"]
    bias, peep = case["bias"], case["peep"]
    steps, layers, batch, units, out_dim = sk._dims(gx0, wz)
    has_proj = proj is not None
    plan_fn = k12_resident_plan if held else k12_plan
    rows = rows or launch_rows(plan_fn, units, out_dim, has_proj, batch)[0]
    pl = k12_resident_plan(units, out_dim, has_proj, rows) if held else \
        k12_plan(units, out_dim, has_proj, rows, cap)
    assert pl["fits"]
    us, ps, g, lwa = pl["us"], pl["ps"], pl["g"], pl["lwa"]
    p16, h16 = 16 * pl["wsteps"], round_up(units, 16)
    lag = lag or lag_fwd(steps)
    sl = sk.stack_slices(wz, proj, C, streamed=not held)
    if held:
        assert sl["wh_sl"].shape == (layers, C, p16, 4, us)
        wh_flat = sl["wh_sl"].reshape(layers, C, p16, g)
    else:
        assert sl["wh_sl"].shape == (layers, C, p16, lwa)
        wh_flat = sl["wh_sl"].reshape(-1)
    pj_flat = sl["proj_sl"].reshape(-1) if has_proj else None
    wx_rows = sl["wx_rows"]                   # [L, C, 4, US, P16]
    drop = sk._drop_mask(case["seed"], case["keep_prob"], steps, layers,
                         batch, out_dim, "cpu")
    lb = layers * batch
    chain = torch.zeros(steps, lb, out_dim)
    c_all = torch.zeros(steps, lb, units)
    h_all = torch.zeros(steps, lb, out_dim)
    cfin, hfin = torch.zeros(lb, units), torch.zeros(lb, out_dim)
    per_step = pl["nw"] + pl["np"]
    total = steps * per_step

    def chunk_rows(l, q, n):
        """chunk n of block q's sequence at the kernel's offsets of the
        padded layouts: (first row, rows, the chunk)."""
        i = n % per_step
        if i < pl["nw"]:
            r0 = 16 * (pl["res"] + i * pl["cw"])
            nrows = min(16 * pl["cw"], p16 - r0)
            at = ((l * C + q) * p16 + r0) * lwa
            return r0, nrows, wh_flat[at:at + nrows * lwa].view(nrows, lwa)
        r0 = 16 * (i - pl["nw"]) * pl["cp"]
        nrows = min(16 * pl["cp"], h16 - r0)
        at = ((l * C + q) * h16 + r0) * ps
        return r0, nrows, pj_flat[at:at + nrows * ps].view(nrows, ps)

    class Block:
        def __init__(self):
            self.hq = torch.zeros(pl["arow"], C * ps)
            self.hq_tag = [-1] * C
            self.cell = torch.zeros(pl["arow"], C * us)
            self.cell_tag = [-1] * C
            self.ring = Ring(pl["slots"])
            self.part = torch.zeros(pl["arow"], max(g, ps))
            self.c = self.h = self.gring = None

    def program(sched, blocks, written, visible, counts, b0, l, q, w):
        nr = min(rows, batch - b0)
        me = blocks[l][q]
        br = torch.arange(b0, b0 + nr)
        lr = l * batch + br
        u0, p0 = q * us, q * ps
        nu = max(0, min(us, units - u0))
        np_ = max(0, min(ps, out_dim - p0))
        own0, own = (p0, np_) if has_proj else (u0, nu)
        m_all = mask.view(steps, layers, batch)
        res = l > 0 and case["residual"][l]
        if held:
            wres = wh_flat[l, q]
            pres = sl["proj_sl"][l, q] if has_proj else None
            per_g, per_p = pl["per_g"], pl["per_p"]
        else:
            wres = wh_flat[(l * C + q) * p16 * lwa:][:16 * pl["res"] * lwa]
            wres = wres.view(-1, lwa)
            pres = per_g = per_p = None
        gcols, pcols = tile_cols(w, g), tile_cols(w, ps)
        block, layer = (l, q), ("layer", l)

        def issue(n):
            if n < total:
                sched.issue(me.ring, n, chunk_rows(l, q, n)[2].clone())

        def finish(v, s, cols):
            if drop is not None:
                v = v * drop[s, l, br][:, cols]
            if case["affine"] is not None:
                v = v * case["affine"][0][l, cols] + case["affine"][1][l, cols]
            return v

        def emit(o, s, col0, nc):
            """masking, the chain (residual, dropout, affine), the state
            streams of this block's nc columns from col0; the new h
            slice"""
            m = m_all[s, l, br][:, None]
            hv = m * o + (1.0 - m) * me.h
            me.h = hv
            v = torch.arange(col0, col0 + nc)
            ch = (m * o)[:, :nc]
            if res and s > 0:
                ch = ch + visible[l - 1][s - 1][br][:, v]
            ch = finish(ch, s, v)
            written[l][s][br[:, None], v[None, :]] = ch
            chain[s, lr[:, None], v[None, :]] = ch
            h_all[s, lr[:, None], v[None, :]] = hv[:, :nc]
            return hv

        def share(buf, tags, col0, width, value, s):
            for peer in blocks[l]:
                getattr(peer, buf)[:nr, col0:col0 + width] = value
                getattr(peer, tags)[q] = s

        if w == 0:
            me.c = torch.zeros(nr, us)
            me.c[:, :nu] = case["cinit"][lr][:, u0:u0 + nu]
            me.h = torch.zeros(nr, ps if has_proj else us)
            me.h[:, :own] = case["hinit"][lr][:, own0:own0 + own]
            me.hq[:nr, :out_dim] = case["hinit"][lr]
        yield ("sync", layer)
        if w == 0:
            for n in range(pl["slots"]):
                issue(n)
        chunk = [0]
        for s0 in range(0, steps, lag):
            s1 = min(steps, s0 + lag)
            if l > 0:
                yield ("wait", counts[l - 1], s1 - 1)
                yield ("sync", block)
                if w == 0:
                    # the chunk's input product, from the published chains
                    inp = torch.stack([visible[l - 1][s - 1][br] if s > 0
                                       else torch.zeros(nr, out_dim)
                                       for s in range(s0, s1)])
                    rows_q = wx_rows[l, q].reshape(g, -1)[:, :out_dim]
                    bq = torch.zeros(4, us)
                    bq[:, :nu] = bias[l].view(4, units)[:, u0:u0 + nu]
                    me.gring = inp @ rows_q.t() + bq.reshape(g)
                yield ("sync", block)
            for s in range(s0, s1):
                h_prev = read_tagged(me.hq, me.hq_tag, s - 1 if s else -1,
                                     nr)[:, :out_dim]
                h_pad = torch.zeros(nr, p16)
                h_pad[:, :out_dim] = h_prev
                if l == 0:
                    gxs = torch.zeros(nr, 4, us)
                    gxs[:, :, :nu] = gx0[s, br].view(nr, 4, units)[
                        :, :, u0:u0 + nu]
                    gxs = gxs.reshape(nr, g)
                else:
                    gxs = me.gring[s - s0]
                acc = yield from stream_product(
                    me.ring, chunk, pl["nw"],
                    lambda n: chunk_rows(l, q, n), h_pad, gcols,
                    gxs[:, gcols], w, block, issue, wres,
                    refill_after_barrier, per_g)
                # hq is read through the whole pass
                read_tagged(me.hq, me.hq_tag, s - 1 if s else -1, nr)
                me.part[:nr, gcols] = acc
                yield ("sync", block)
                if not has_proj:
                    yield ("sync", layer)
                if w == 0:
                    # the cell phase: a thread's rows in turn, its unit's
                    # peepholes the same for each
                    pi, pf, po = torch.zeros(3, us)
                    if peep is not None:
                        pi[:nu], pf[:nu], po[:nu] = peep[l, :, u0:u0 + nu]
                    o = torch.zeros(nr, us)
                    for turn in cell_threads(rows, us, nr):
                        rr = torch.tensor([r for _, r in turn])
                        gi, gj, gf, go = me.part[rr, :g].view(
                            len(rr), 4, us).unbind(1)
                        cp = me.c[rr]
                        cn = (torch.sigmoid(gf + pf * cp
                                            + case["forget_bias"]) * cp
                              + torch.sigmoid(gi + pi * cp) * torch.tanh(gj))
                        o[rr] = torch.sigmoid(go + po * cn) * torch.tanh(cn)
                        m = m_all[s, l, br[rr]][:, None]
                        me.c[rr] = m * cn + (1.0 - m) * cp
                    c_all[s, lr, u0:u0 + nu] = me.c[:, :nu]
                    if has_proj:
                        share("cell", "cell_tag", u0, us, o, s)
                    else:
                        hv = emit(o, s, u0, nu)
                        share("hq", "hq_tag", u0, us, hv, s)
                yield ("sync", layer)
                if not has_proj:
                    continue
                cell = read_tagged(me.cell, me.cell_tag, s, nr)[:, :units]
                c_pad = torch.zeros(nr, h16)
                c_pad[:, :units] = cell
                acc = yield from stream_product(
                    me.ring, chunk, pl["np"],
                    lambda n: chunk_rows(l, q, n), c_pad, pcols,
                    torch.zeros(nr, len(pcols)), w, block, issue, pres,
                    refill_after_barrier, per_p)
                read_tagged(me.cell, me.cell_tag, s, nr)
                me.part[:nr, pcols] = acc
                yield ("sync", block)
                if w == 0:
                    hv = emit(me.part[:nr, :ps], s, p0, np_)
                    share("hq", "hq_tag", p0, ps, hv, s)
                yield ("sync", layer)
            if l + 1 < layers:
                # publish: the chunk's chains of this block's columns
                yield ("sync", block)
                if w == 0:
                    cols = torch.arange(own0, own0 + own)
                    for s in range(s0, s1):
                        visible[l][s][br[:, None], cols[None, :]] = \
                            written[l][s][br[:, None], cols[None, :]]
                    counts[l].v[q] = s1
        if w == 0:
            cfin[lr, u0:u0 + nu] = me.c[:, :nu]
            hfin[lr, own0:own0 + own] = me.h[:, :own]

    out = torch.zeros(steps, batch, out_dim)
    for b0 in range(0, batch, rows):
        sched = Sched(order, layer_group)
        blocks = [[Block() for _ in range(C)] for _ in range(layers)]
        written = [torch.zeros(steps, batch, out_dim) for _ in range(layers)]
        visible = [torch.zeros(steps, batch, out_dim) for _ in range(layers)]
        counts = [(count or Count)() for _ in range(layers)]
        sched.run([((l, q), program(sched, blocks, written, visible, counts,
                                    b0, l, q, w))
                   for l in range(layers) for q in range(C)
                   for w in range(WARPS)])
        out[:, b0:b0 + rows] = written[-1][:, b0:b0 + rows]
    return out, chain, c_all, h_all, cfin, hfin


def k13_streamed(case, fwd, dout, dcfin, dhfin, order, cap=-1,
                 refill_after_barrier=True, lag=None, rows=None,
                 inbox_barrier=True, held=False):
    """K13 on the streamed plan in plain torch (float32), at the launcher's
    R (or ``rows``): (dgates, dbias, dpeep, dcinit, dhinit, dc_in, dh_in,
    din) as ``stack_backward_reference`` gives them.  A block keeps the
    carry dh and dchain of its own P-slice only: the pass over wh writes
    each 16-column tile of its dh partial straight into the owners'
    inboxes, and each owner, after the cluster barrier, adds the 16
    partials in block order, updates its slice and writes the next step's
    dout_p of it into every block (dq: the A operand of dout_blk).  Without
    ``inbox_barrier`` the cluster barrier that ends an owner's reads of its
    inboxes is left out.  With ``held``, the resident plan of 16 blocks:
    the same kernel with the dense slices all in shared memory, dout_blk
    over all of proj's rows at once, no ring."""
    gx0, mask, wz, proj = case["gx0"], case["mask"], case["wz"], case["proj"]
    bias, peep = case["bias"], case["peep"]
    _, chain, c_all, h_all, _, _ = fwd
    steps, layers, batch, units, out_dim = sk._dims(gx0, wz)
    has_proj = proj is not None
    plan_fn = k13_resident_plan if held else k13_plan
    rows = rows or launch_rows(plan_fn, units, out_dim, has_proj, batch)[0]
    pl = k13_plan(units, out_dim, has_proj, rows, cap, held=held)
    assert pl["fits"]
    us, u16, g, ps, p16 = (pl[k] for k in ("us", "u16", "g", "ps", "p16"))
    lwh, lpj = pl["lwh"], pl["lpj"]
    rs = THREADS // us
    lag = lag or lag_bwd(steps)
    sl = sk.stack_slices(wz, proj, C, backward=True, streamed=not held)
    if held:
        assert sl["wh_sl"].shape == (layers, C, p16, 4, us)
        wh_held = sl["wh_sl"].reshape(layers, C, p16, g)
        if has_proj:
            assert sl["proj_rows"].shape == (layers, C, u16, p16)
    else:
        assert sl["wh_sl"].shape == (layers, C, p16, lwh)
        wh_flat = sl["wh_sl"].reshape(-1)
        if has_proj:
            assert sl["proj_rows"].shape == (layers, C, u16, lpj)
            pj_flat = sl["proj_rows"].reshape(-1)
    drop = sk._drop_mask(case["seed"], case["keep_prob"], steps, layers,
                         batch, out_dim, "cpu")
    lb, h4 = layers * batch, 4 * units
    # the gate inputs of layers l >= 1 before the recurrence (gxl), from
    # the stored chains
    in_prev = sk._inputs_before(chain, layers)          # [S, L, B, P]
    gxl = in_prev @ wz[:, :out_dim]                      # [S, L, B, 4H]
    dgates = torch.zeros(steps, lb, h4)
    dc_in, dh_in = torch.zeros(steps, lb, units), torch.zeros(steps, lb,
                                                             out_dim)
    din = torch.zeros(layers, steps, batch, out_dim)
    dcinit, dhinit = torch.zeros(lb, units), torch.zeros(lb, out_dim)
    sums = torch.zeros(layers, 7, units)
    per_step = pl["np"] + pl["nw"]
    total = pl["nw"] + steps * per_step

    def chunk_rows(l, q, n):
        i = pl["np"] + n if n < pl["nw"] else (n - pl["nw"]) % per_step
        if i < pl["np"]:
            r0 = 16 * i * pl["cu"]
            nrows = min(16 * pl["cu"], u16 - r0)
            at = ((l * C + q) * u16 + r0) * lpj
            return r0, nrows, pj_flat[at:at + nrows * lpj].view(nrows, lpj)
        r0 = 16 * (pl["res"] + (i - pl["np"]) * pl["cw"])
        nrows = min(16 * pl["cw"], p16 - r0)
        at = ((l * C + q) * p16 + r0) * lwh
        return r0, nrows, wh_flat[at:at + nrows * lwh].view(nrows, lwh)

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
            self.sums = torch.zeros(rs, 7, us)  # a thread's rows' sums

    def program(sched, blocks, written, visible, counts, b0, l, q, w):
        nr = min(rows, batch - b0)
        me = blocks[l][q]
        br = torch.arange(b0, b0 + nr)
        lr = l * batch + br
        u0, p0 = q * us, q * ps
        nu = max(0, min(us, units - u0))
        npq = max(0, min(ps, out_dim - p0))
        own = torch.arange(p0, p0 + npq)
        last = l == layers - 1
        res = l > 0 and case["residual"][l]
        m_all = mask.view(steps, layers, batch)
        if held:
            wres = wh_held[l, q]
        else:
            wres = wh_flat[(l * C + q) * p16 * lwh:][:16 * pl["res"] * lwh]
            wres = wres.view(-1, lwh)
        gcols = tile_cols(w, g)
        block, layer = (l, q), ("layer", l)
        bq = torch.zeros(4, us)
        bq[:, :nu] = bias[l].view(4, units)[:, u0:u0 + nu]
        pi, pf, po = torch.zeros(3, us)
        if peep is not None:
            pi[:nu], pf[:nu], po[:nu] = peep[l, :, u0:u0 + nu]

        def issue(n):
            if n < total:
                sched.issue(me.ring, n, chunk_rows(l, q, n)[2].clone())

        def fetch(tt):
            """What step tt reads that no carry feeds, once the layer above
            has counted its din at tt + 1 (the kernel's cp.async a step
            ahead): dchain of the owned P-slice, h_prev, c_prev, the mask
            (the gate inputs are read as the pass over wh starts)."""
            if not last and tt + 1 < steps:
                yield ("wait", counts[l + 1], steps - 1 - tt)
            if last:
                dch = dout[tt, br][:, own]
            elif tt + 1 < steps:
                dch = visible[l + 1][tt + 1][br][:, own]
            else:
                dch = torch.zeros(nr, npq)
            if drop is not None:
                dch = dch * drop[tt, l, br][:, own]
            hp = torch.zeros(nr, p16)
            cp = torch.zeros(nr, us)
            if tt > 0:
                hp[:, :out_dim] = h_all[tt - 1, lr]
                cp[:, :nu] = c_all[tt - 1, lr][:, u0:u0 + nu]
            else:
                hp[:, :out_dim] = case["hinit"][lr]
                cp[:, :nu] = case["cinit"][lr][:, u0:u0 + nu]
            return dict(t=tt, dch=dch, hp=hp, cp=cp,
                        m=m_all[tt, l, br][:, None])

        def gate_inputs(tt):
            gxt = torch.zeros(nr, 4, us)
            src = gx0[tt, br] if l == 0 else gxl[tt, l, br]
            gxt[:, :, :nu] = src.view(nr, 4, units)[:, :, u0:u0 + nu]
            return gxt.reshape(nr, g) + bq.reshape(g)

        def to_inboxes(c0, value, t):
            """dh partial columns c0 .. c0 + 7 (half a 16-column tile) of
            this step into the inbox[q] of each owner of them"""
            for owner in range(c0 // ps, (c0 + 7) // ps + 1):
                lo, hi = max(c0, owner * ps), min(c0 + 8, (owner + 1) * ps)
                peer = blocks[l][owner]
                tags = peer.inbox_tag[q]
                for c in range(lo - owner * ps, hi - owner * ps):
                    if tags[c] not in (-1, peer.inbox_read[q]):
                        raise Hazard("block %d's inbox overwritten before "
                                     "its owner read it" % owner)
                    tags[c] = t
                peer.inbox[q][:, lo - owner * ps:hi - owner * ps] = \
                    value[:, lo - c0:hi - c0]

        def wh_pass(chunk, dh_t, st):
            """4: with dh_t, this step's dh partial from me.gq (by rows p,
            the 8-column half h of tile j by warp 1 - (2·j + h) % 2) into
            the owners' inboxes; with ``st`` (the step before's staged
            loads) the gate sums, this warp's columns, into me.gsum, which
            holds their init from the pass's start."""
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
                r0, nrows, _ = chunk_rows(l, q, chunk[0])
                yield wait_chunk(me.ring, chunk[0])
                me.ring.read(chunk[0], nrows)
                yield ("run",)
                rows_at(me.ring.read(chunk[0], nrows), r0, nrows)
                yield from release(me.ring, chunk[0], w, block, issue,
                                   refill_after_barrier)
                chunk[0] += 1
            if acc is not None:
                me.gsum[:, gcols] += acc
            yield ("sync", block)

        def share_dq(st, v):
            """dout_p of the staged step over the owned slice, from the
            carry's slice v, into every block's dq"""
            for peer in blocks[l]:
                peer.dq[:, p0:p0 + npq] = st["m"] * (st["dch"] + v)
                peer.dq_tag[q] = st["t"]

        if w == 0:
            me.dh = torch.zeros(nr, ps)
            me.dh[:, :npq] = dhfin[lr][:, own]
            me.dc = torch.zeros(nr, us)
            me.dc[:, :nu] = dcfin[lr][:, u0:u0 + nu]
        yield ("sync", layer)
        if w == 0:
            for n in range(pl["slots"]):
                issue(n)
        chunk = [0]
        staged = yield from fetch(steps - 1)
        yield ("sync", block)
        if w == 0 and has_proj:
            share_dq(staged, me.dh[:, :npq])
        yield ("sync", layer)
        yield from wh_pass(chunk, None, staged)
        for t in range(steps - 1, -1, -1):
            cur = staged
            m = cur["m"]
            done = steps - t
            chunk_end = l > 0 and (done % lag == 0 or t == 0)
            if t > 0:
                staged = yield from fetch(t - 1)
            dch = cur["dch"]
            if w == 0:
                # 1. the stashes and din's residual part of the owned slice
                dh_in[t, lr[:, None], own[None, :]] = me.dh[:, :npq]
                if l > 0:
                    written[l][t][br[:, None], own[None, :]] = (
                        dch if res else 0.0)
            yield ("sync", block)
            # 2. dout_blk over proj's chunks of rows (held: all at once),
            # this warp's tiles
            if held and has_proj:
                read_tagged(me.dq, me.dq_tag, t, nr)
                yield ("run",)
                dq = read_tagged(me.dq, me.dq_tag, t, nr)
                rows_q = sl["proj_rows"][l, q]
                for j in range(w, pl["utiles"], WARPS):
                    me.part_d[:, 16 * j:16 * j + 16] = (
                        dq @ rows_q[16 * j:16 * j + 16].t())
                yield ("sync", block)
            for _ in range(pl["np"]):
                r0, nrows, _ = chunk_rows(l, q, chunk[0])
                yield wait_chunk(me.ring, chunk[0])
                me.ring.read(chunk[0], nrows)
                read_tagged(me.dq, me.dq_tag, t, nr)
                yield ("run",)
                rows_c = me.ring.read(chunk[0], nrows)
                dq = read_tagged(me.dq, me.dq_tag, t, nr)
                for j in range(w, nrows // 16, WARPS):
                    me.part_d[:, r0 + 16 * j:r0 + 16 * j + 16] = (
                        dq @ rows_c[16 * j:16 * j + 16, :p16].t())
                yield from release(me.ring, chunk[0], w, block, issue,
                                   refill_after_barrier)
                chunk[0] += 1
            # 3. the cell backward (warp 0), a thread's rows in turn
            if w == 0:
                dgq = torch.zeros(nr, 4, us)
                for turn in cell_threads(rows, us, nr):
                    rr = torch.tensor([r for _, r in turn])
                    c0 = cur["cp"][rr]
                    mr = m[rr]
                    gi, gj, gf, go = me.gsum[rr].view(len(rr), 4, us).unbind(1)
                    si, tj = torch.sigmoid(gi + pi * c0), torch.tanh(gj)
                    sf = torch.sigmoid(gf + pf * c0 + case["forget_bias"])
                    cn = sf * c0 + si * tj
                    so, tc = torch.sigmoid(go + po * cn), torch.tanh(cn)
                    if has_proj:
                        db = me.part_d[rr, :us]
                    else:
                        # PS = US: the units' own columns
                        db = torch.zeros(len(rr), us)
                        db[:, :nu] = (mr * (dch[rr] + me.dh[rr, :npq]))[:, :nu]
                    dcv = me.dc[rr]
                    dc_in[t, lr[rr], u0:u0 + nu] = dcv[:, :nu]
                    d_o = db * tc * so * (1 - so)
                    dcn = db * so * (1 - tc * tc) + mr * dcv + d_o * po
                    d_f = dcn * c0 * sf * (1 - sf)
                    d_i = dcn * tj * si * (1 - si)
                    d_j = dcn * si * (1 - tj * tj)
                    me.dc[rr] = dcn * sf + (1 - mr) * dcv + d_f * pf + d_i * pi
                    dg = torch.stack([d_i, d_j, d_f, d_o], 1)   # [n, 4, US]
                    dg[:, :, nu:] = 0.0
                    for k in range(4):
                        at = k * units + u0
                        dgates[t, lr[rr], at:at + nu] = dg[:, k, :nu]
                    dgq[rr] = dg
                    # each thread's column sums, its rows in order
                    thr = torch.tensor([rb0 for rb0, _ in turn])
                    me.sums[thr, :4] += dg
                    me.sums[thr, 4] += d_i * c0
                    me.sums[thr, 5] += d_f * c0
                    me.sums[thr, 6] += d_o * cn
                me.gq = dgq.reshape(nr, g)
            yield ("sync", block)
            # 3b, 4: the step before's staged loads, the pass over wh
            yield from wh_pass(chunk, t, staged if t > 0 else None)
            yield ("sync", layer)
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
                me.dh[:, :npq] = (1 - m) * me.dh[:, :npq] + s
                if has_proj and t > 0:
                    share_dq(staged, me.dh[:, :npq])
            if inbox_barrier:
                yield ("sync", layer)
            # 6. a chunk's din, counted for the layer below
            if chunk_end:
                cnt = done - (done - 1) // lag * lag
                if w == 0:
                    wx = wz[l, :out_dim]                     # [P, 4H]
                    for s_ in range(t, t + cnt):
                        dgl = dgates[s_, lr]
                        written[l][s_][br[:, None], own[None, :]] += (
                            dgl @ wx[p0:p0 + npq].t())
                        visible[l][s_][br[:, None], own[None, :]] = \
                            written[l][s_][br[:, None], own[None, :]]
                yield ("sync", block)
                if w == 0:
                    counts[l].v[q] = done
        if w == 0:
            dcinit[lr, u0:u0 + nu] = me.dc[:, :nu]
            dhinit[lr[:, None], own[None, :]] = me.dh[:, :npq]
            # the row tile's column sums: the threads' in row order
            tot = torch.zeros(7, us)
            for rb0 in range(min(rs, nr)):
                tot = tot + me.sums[rb0]
            sums[l, :, u0:u0 + nu] += tot[:, :nu]

    for b0 in range(0, batch, rows):
        sched = Sched(order, layer_group)
        nr = min(rows, batch - b0)
        blocks = [[Block(nr) for _ in range(C)] for _ in range(layers)]
        written = [torch.zeros(steps, batch, out_dim) for _ in range(layers)]
        visible = [torch.zeros(steps, batch, out_dim) for _ in range(layers)]
        counts = [Count() for _ in range(layers)]
        sched.run([((l, q), program(sched, blocks, written, visible, counts,
                                    b0, l, q, w))
                   for l in range(layers) for q in range(C)
                   for w in range(WARPS)])
        for l in range(1, layers):
            din[l, :, b0:b0 + nr] = written[l][:, b0:b0 + nr]
    dbias = sums[:, :4].reshape(layers, h4)
    dpeep = sums[:, 4:] if peep is not None else None
    return dgates, dbias, dpeep, dcinit, dhinit, dc_in, dh_in, din


def make_case(seed, units, proj, batch=2, time_steps=3, layers=2, keep=0.9,
              affine=False):
    """A stack's K12 arguments from a numpy seed (the lstm family with a
    projection: peepholes, layer 1 residual; the cudnnlstm family without:
    neither), float32, ragged lengths, carried initial states."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    dim = 12
    params, d = [], dim
    for _ in range(layers):
        params.append(cells.init_lstm_cell(gen, d, units, proj,
                                           proj is not None))
        d = proj or units
    for p in params:
        p["bias"] = torch.from_numpy(
            (0.1 * rng.randn(4 * units)).astype(np.float32))
    x = torch.from_numpy(rng.randn(batch, time_steps, dim).astype(np.float32))
    lengths = np.array([time_steps, max(1, time_steps - 1)] * batch)[:batch]
    seq = torch.from_numpy(lengths.astype(np.int32))
    wz, bias, pw, peep = sk.stack_weights(params, torch.float32)
    gx = x @ params[0]["wx"] + params[0]["bias"]
    gx0 = torch.nn.functional.pad(gx.transpose(0, 1),
                                  (0, 0, 0, 0, 0, layers - 1)).contiguous()
    out_dim, lb = proj or units, layers * batch
    aff = None
    if affine:
        aff = (torch.from_numpy((0.5 + rng.rand(layers, out_dim)).astype(
            np.float32)), torch.from_numpy((0.2 * rng.randn(
                layers, out_dim)).astype(np.float32)))
    return dict(
        gx0=gx0, mask=sk.stack_mask(seq, time_steps, layers, "cpu"), wz=wz,
        bias=bias, proj=pw, peep=peep,
        cinit=torch.from_numpy((0.1 * rng.randn(lb, units)).astype(
            np.float32)),
        hinit=torch.from_numpy((0.1 * rng.randn(lb, out_dim)).astype(
            np.float32)),
        residual=(False,) + (proj is not None,) * (layers - 1),
        forget_bias=1.0, keep_prob=keep if proj is not None else 1.0,
        seed=torch.tensor([-1234567], dtype=torch.int32), affine=aff)


# Sak, Senior and Beaufays' LSTMP (2048 cells, projection 512: 128 units a
# block); the cudnnlstm family at H = P = 1024 (64 a block)
SHAPES = [(2048, 512), (1024, None)]
SHAPE_IDS = ["2048x512", "1024-noproj"]


def close(got, want, names):
    for name, g, r in zip(names, got, want):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), r.float().numpy(),
                                   err_msg=name, **TOL)


# (scheduler, R, batch): the launchers' R at B = 2 under each order; then R
# with two rows for some cell-phase threads (8 at 128 units a block, 16 at
# 64) over a ragged tile (B below R)
RUNS = [(o, None, 2) for _, o in ORDERS] + [(greedy_order, "two", None)]
RUN_IDS = [n for n, _ in ORDERS] + ["greedy-two-rows-ragged"]
TWO_ROWS = {(2048, 512): (8, 5), (1024, None): (16, 9)}


def run_shape(units, proj, rows, batch):
    """(R, batch) of a RUNS entry at a shape"""
    if rows == "two":
        rows, batch = TWO_ROWS[(units, proj)]
        assert thread_rows(rows, round_up(cdiv(units, C), 8)) == 2
        assert batch % rows
    return rows, batch


@pytest.mark.parametrize("order,rows,batch", RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_stack_streamed_forward_matches_plain(units, proj, order, rows,
                                              batch):
    rows, batch = run_shape(units, proj, rows, batch)
    case = make_case(1, units, proj, batch=batch, affine=proj is None)
    got = k12_streamed(case, order, lag=2, rows=rows)
    ref = sk.stack_forward_reference(**case)
    close(got, ref, ("out", "chain", "c_all", "h_all", "cfin", "hfin"))


def backward_case(units, proj, batch, seed=2):
    case = make_case(seed, units, proj, batch=batch)
    fwd = sk.stack_forward_reference(**case)
    rng = np.random.RandomState(7)
    out, _, _, _, cfin, hfin = fwd
    dout = torch.from_numpy((0.1 * rng.randn(*out.shape)).astype(np.float32))
    dcfin = torch.from_numpy(rng.randn(*cfin.shape).astype(np.float32))
    dhfin = torch.from_numpy(rng.randn(*hfin.shape).astype(np.float32))
    return case, fwd, dout, dcfin, dhfin


@pytest.mark.parametrize("order,rows,batch", RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_stack_streamed_backward_matches_plain(units, proj, order, rows,
                                               batch):
    rows, batch = run_shape(units, proj, rows, batch)
    case, fwd, dout, dcfin, dhfin = backward_case(units, proj, batch)
    _, chain, c_all, h_all, _, _ = fwd
    ref = sk.stack_backward_reference(
        **{k: v for k, v in case.items() if k != "affine"}, chain=chain,
        c_all=c_all, h_all=h_all, dout=dout, dcfin=dcfin, dhfin=dhfin,
        steps_out=True)
    got = k13_streamed(case, fwd, dout, dcfin, dhfin, order, lag=2,
                       rows=rows)
    dgates, _, dbias, _, dpeep, dcinit, dhinit, dc_in, dh_in, din = ref
    close(got, (dgates, dbias, dpeep, dcinit, dhinit, dc_in, dh_in, din),
          ("dgates", "dbias", "dpeep", "dcinit", "dhinit", "dc_in", "dh_in",
           "din"))


# wh's bytes a block holds at R = 4 (K12's, K13's), as stack_config
# reports them on an H100
HELD = {(2048, 512): (49152, 98304), (1024, None): (106496, 98304),
        (2048, None): (49152, 49152)}


@pytest.mark.parametrize("units,proj", SHAPES + [(2048, None)],
                         ids=SHAPE_IDS + ["2048-noproj"])
def test_stack_streamed_plans_stream_and_fill_the_ring(units, proj):
    """The plans the emulation runs are the kernels': a streaming chunk (B
    = 1) launches R = 4 forward and backward; two to four slots, wh's first
    rows in the rest of shared memory, chunks to stream every step; K12's
    input stage is 16 rows where 32 would pass 64 KB; capped at half of
    wh's steps (the forced plan) the ring streams the rest."""
    out_dim, has_proj = proj or units, proj is not None
    for plan in (k12_plan, k13_plan):
        assert launch_rows(plan, units, out_dim, has_proj, 1) == (4, 1, 1)
    assert k12_plan(units, out_dim, has_proj, 4)["srows"] == (
        16 if out_dim >= 1024 else 32)
    for plan in (k12_plan, k13_plan):
        pl = plan(units, out_dim, has_proj, 4)
        assert 2 <= pl["slots"] <= 4
        assert pl["res"] < pl["wsteps"] and pl["nw"] > 0
        assert pl["res"] * 16 * pl["g"] * 2 == HELD[(units, proj)][
            plan is k13_plan]
        half = plan(units, out_dim, has_proj, 4, pl["wsteps"] // 2)
        assert half["res"] == min(pl["res"], pl["wsteps"] // 2)
        assert half["nw"] >= pl["nw"]


@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_stack_streamed_b32_launches_at_most_two_tiles(units, proj):
    """At B = 32 the launchers take R = 16 or 32 (a cell-phase thread owns
    several rows; the products' A operands one or two whole 16-row tiles),
    so with 7 sixteen-block clusters resident a 4-layer stack runs at most
    two row tiles, one a wave, where R = 4 ran eight; each plan keeps at
    least two ring slots, and the rows a thread stay within cell_rows.
    Neither resident plan of 16 blocks holds these slices."""
    out_dim, has_proj = proj or units, proj is not None
    assert not k12_resident_plan(units, out_dim, has_proj, 4)["fits"]
    assert not k13_resident_plan(units, out_dim, has_proj, 2)["fits"]
    us = round_up(cdiv(units, C), 8)
    for plan in (k12_plan, k13_plan):
        rows, per_wave, waves = launch_rows(plan, units, out_dim, has_proj,
                                            32)
        pl = plan(units, out_dim, has_proj, rows)
        assert rows >= 16 and per_wave == 1 and cdiv(32, rows) == waves <= 2
        assert pl["slots"] >= 2 and pl["arow"] == round_up(rows, 16)
        assert 2 <= thread_rows(rows, us) <= cell_rows(rows)
        assert launch_rows(plan, units, out_dim, has_proj, 32,
                           resident=4)[2] == waves
    assert launch_rows(k12_plan, units, out_dim, has_proj, 32)[0] == (
        16 if has_proj else 32)
    assert launch_rows(k13_plan, units, out_dim, has_proj, 32)[0] == 16


@pytest.mark.parametrize("units,proj", SHAPES, ids=SHAPE_IDS)
def test_stack_padded_slices_read_back_at_the_kernel_offsets(units, proj):
    """128 (or 64) units a block: row r of layer l's block q's wh slice
    lies at element ((l·C + q)·P16 + r)·LWA of the streamed layout,
    gate-major, 8 zeros after its 4·US columns; K13's proj rows at
    ((l·C + q)·U16 + u)·LPJ, padded likewise; K12's proj slices and wx
    rows as the resident plans'."""
    case = make_case(4, units, proj, batch=1, time_steps=1)
    wz, pj = case["wz"], case["proj"]
    layers, out_dim = wz.shape[0], wz.shape[1] // 2
    us = round_up(cdiv(units, C), 8)
    lwa, p16 = 4 * us + 8, round_up(out_dim, 16)
    fwd = sk.stack_slices(wz, pj, C, streamed=True)
    res = sk.stack_slices(wz, pj, C)
    flat = fwd["wh_sl"].reshape(-1)
    gates = wz[:, out_dim:].view(layers, out_dim, 4, units)
    for l in range(layers):
        for q in (0, 7, C - 1):
            for r in (0, out_dim // 2, out_dim - 1, p16 - 1):
                row = flat[((l * C + q) * p16 + r) * lwa:][:lwa]
                assert not row[4 * us:].any()
                for k in range(4):
                    u = torch.arange(q * us, q * us + us)
                    want = torch.zeros(us)
                    ok = (u < units) & (r < out_dim)
                    if r < out_dim:
                        want[ok] = gates[l, r, k, u[ok]]
                    assert torch.equal(row[k * us:(k + 1) * us], want)
    assert torch.equal(fwd["wx_rows"], res["wx_rows"])
    assert torch.equal(fwd["wh_sl"].view(layers, C, p16, lwa)[..., :4 * us],
                       res["wh_sl"].reshape(layers, C, p16, 4 * us))
    bwd = sk.stack_slices(wz, pj, C, backward=True, streamed=True)
    assert torch.equal(bwd["wh_sl"], fwd["wh_sl"])
    if pj is None:
        assert fwd["proj_sl"] is None and bwd["proj_rows"] is None
        return
    assert torch.equal(fwd["proj_sl"], res["proj_sl"])
    u16, lpj = round_up(us, 16), p16 + 8
    rows = bwd["proj_rows"].reshape(-1)
    for l in range(layers):
        for q in (0, C - 1):
            for j in (0, us - 1, u16 - 1):
                row = rows[((l * C + q) * u16 + j) * lpj:][:lpj]
                u = q * us + j
                assert not row[out_dim:].any()
                if j < us and u < units:
                    assert torch.equal(row[:out_dim], pj[l, u])
                else:
                    assert not row.any()


def test_stack_refill_before_the_block_barrier_is_caught():
    """Without the block barrier between a chunk's last read and its
    refill, warp 0 refills the slot while warp 1 still reads it: the
    emulation sees the slot in flight (K12 and K13)."""
    case = make_case(3, 1024, None, batch=1, time_steps=2)
    with pytest.raises(Hazard, match="in flight"):
        k12_streamed(case, greedy_order, refill_after_barrier=False)
    fwd = sk.stack_forward_reference(**case)
    zeros = torch.zeros(case["cinit"].shape), torch.zeros(
        case["hinit"].shape)
    with pytest.raises(Hazard, match="in flight"):
        k13_streamed(case, fwd, torch.ones(fwd[0].shape), *zeros,
                     greedy_order, refill_after_barrier=False)


@pytest.mark.parametrize("units,proj,rows,batch,caught", [
    (1024, None, 16, 9, "inbox overwritten"),
    (2048, 512, 8, 5, "read step")], ids=SHAPE_IDS[::-1])
def test_stack_inbox_write_before_its_owner_read_is_caught(units, proj, rows,
                                                           batch, caught):
    """Without the cluster barrier that ends the owners' reads of their
    inboxes and their writes of dq, a block runs ahead into the next step:
    its pass over wh writes its dh partial into an inbox its owner has not
    read yet, and (with a projection, first) its dout_blk reads dq slices
    their owners have not written yet.  The emulation sees it (K13 with
    two rows for some cell-phase threads, a ragged tile)."""
    case, fwd, dout, dcfin, dhfin = backward_case(units, proj, batch, seed=6)
    # the highest-numbered block first, copies landed as soon as issued
    with pytest.raises(Hazard, match=caught):
        k13_streamed(case, fwd, dout, dcfin, dhfin, lambda c: c[-1],
                     rows=rows, inbox_barrier=False)


def test_stack_a_wait_on_too_few_steps_is_caught():
    """A layer that waits for one step fewer than its chunk reads runs its
    input product from chains not yet published: the streamed forward no
    longer equals the plain version."""
    case = make_case(5, 1024, None, time_steps=4)
    ref = sk.stack_forward_reference(**case)

    class Short(Count):
        def done(self, want):
            return min(self.v) >= want - 1

    # the upper layer first, copies landed as soon as they are issued
    got = k12_streamed(case, lambda cands: cands[-1], lag=2, count=Short)
    assert not torch.allclose(got[1], ref[1], **TOL)
    got = k12_streamed(case, lambda cands: cands[-1], lag=2)
    close(got, ref, ("out", "chain", "c_all", "h_all", "cfin", "hfin"))
