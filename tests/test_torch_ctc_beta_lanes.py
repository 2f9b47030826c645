"""K11's lane layout (``csrc/ctc_dp.cu`` ``ctc_beta_kernel``), emulated on
the CPU.

The kernel mirrors K10's: one block per lattice row and a warp for every 32
positions (up to 16 warps), lane l of warp w holding positions 32·w·P + l +
32·j (j < P) in registers, walked down in time from t = T - 1.  A step's
neighbours s + 1 and s + 2 come by one shuffle each from the lanes after,
and for lanes 30 and 31 from lanes 0 and 1 of the register after, with the
registers updated from the first up so that every shuffle sees the old
row; the two positions after a warp's range come from the warp after
through shared memory (two buffers, taken in turn by the updates), the
last warp reading NEG_INF; lp(t) comes down a ring of 8 steps, time_mask
and is_last as two ballot words per 32 steps, each loaded a word ahead
walking down; a reset step (is_last) takes final & valid ? lp : NEG_INF and
no neighbour.  Here that data movement is emulated lane by lane (an
overwritten register reads NaN until the step ends, so a shuffle that saw a
new value would show), and the log-sum-exp is the plain version's own, on
the same [N, S] layout, so the result is held **bit-equal** to
``ctc_kernels.beta_reference``, on widths that end inside, at and past a
register's 32 lanes, with resets several times a row, at and across the
32-step words, and valid, skip_from and time_mask patterns that cross lane,
warp and word boundaries; once with the kernel's warps a row and once with
a single warp a row (every boundary then a register boundary).
"""

import numpy as np
import pytest
import torch

from lstm_ctc_tpu_torch.ops import ctc_kernels
from test_torch_ctc_alpha_lanes import LANES, RING, WIDTHS, row_warps

NEG = ctc_kernels.NEG_INF


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread: the emulation's thousands of small ops
    slow down many times when their thread pool shares busy cores (the
    suite's workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def lattice_inputs(width, slots=3, steps=72, seed=0):
    """Arbitrary beta inputs: log-probabilities, a time mask with gaps
    across 32-step words, resets (is_last) several times a row, at word
    edges (steps 31, 32, 63, 64) and inside words, and random valid,
    skip_from and final bits."""
    rng = np.random.RandomState(seed + 7 * width)
    lp = np.log(rng.rand(steps, slots, width).astype(np.float32) + 1e-3)
    time_mask = rng.rand(steps, slots) < 0.85
    time_mask[:, 0] = np.arange(steps) < steps - 3        # a plain prefix
    is_last = np.zeros((steps, slots), bool)
    is_last[steps - 4, 0] = True                           # the row's end
    is_last[[31, 64, 68], 1] = True                        # a packed row
    is_last[[12, 32, 63], 2] = True
    time_mask[[12, 31, 32, 63, 64, 68], 1:] = True         # live resets
    valid = rng.rand(slots, width) < 0.9
    skip_from = rng.rand(slots, width) < 0.5
    skip_from[:, max(width - 2, 0):] = False
    final_mask = rng.rand(slots, width) < 0.3
    final_mask[:, width - 1] = True
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(lp), t(time_mask), t(is_last), t(valid), t(skip_from),
            t(final_mask))


def lanes_beta(lp_ext, time_mask, is_last, valid, skip_from, final_mask,
               warps=None, ascending=True):
    """beta' at every step [T, N, S], by the kernel's data movement:
    ``warps`` warps a row (the kernel's choice if None), warp w holding
    positions w·32·P + l + 32·j.  ``ascending=False`` updates the registers
    from the last down instead (the wrong order, for the test that shows
    it would be seen)."""
    steps, slots, width = lp_ext.shape
    warps = warps or row_warps(width)
    per = -(-width // (LANES * warps))
    lane = torch.arange(LANES)
    rows = torch.arange(slots)
    pos = (torch.arange(warps)[:, None, None] * LANES * per
           + lane[None, :, None] + LANES * torch.arange(per)[None, None, :])
    inside = pos < width                          # [W, 32, P]

    def to_regs(row, fill):                       # [N, S] -> [N, W, 32, P]
        regs = torch.full((slots, warps, LANES, per), fill, dtype=row.dtype)
        regs[:, inside] = row[:, pos[inside]]
        return regs

    def to_row(regs):                             # [N, W, 32, P] -> [N, S]
        row = torch.empty(slots, width, dtype=regs.dtype)
        row[:, pos[inside]] = regs[:, inside]
        return row

    b = torch.full((slots, warps, LANES, per), NEG)
    ok = to_regs(valid, False)
    skip = to_regs(skip_from, False)
    fin = to_regs(final_mask & valid, False)
    out = torch.empty(steps, slots, width)

    ring = [None] * RING
    ring_step = [-1] * RING

    def fetch(t):
        if t >= 0:
            ring[t % RING] = to_regs(lp_ext[t], 0.0)
            ring_step[t % RING] = t

    for i in range(RING - 1):
        fetch(steps - 1 - i)

    def word(mask, t0):                           # lane i: step t0 + i
        bits = torch.zeros(slots, dtype=torch.int64)
        for i in range(LANES):
            if 0 <= t0 + i < steps:
                bits |= mask[t0 + i].long() << i
        return bits

    top = (steps - 1) & ~31
    live, live_next = word(time_mask, top), word(time_mask, top - 32)
    reset, reset_next = word(is_last, top), word(is_last, top - 32)
    buffers = torch.full((2, slots, warps, 2), NEG)
    turn = torch.zeros(slots, dtype=torch.int64)
    order = range(per) if ascending else range(per - 1, -1, -1)
    for t in range(steps - 1, -1, -1):
        if t % 32 == 31 and t != steps - 1:
            live, live_next = live_next, word(time_mask, t - 63)
            reset, reset_next = reset_next, word(is_last, t - 63)
        assert ring_step[t % RING] == t
        lpt = ring[t % RING]
        is_live = ((live >> (t % 32)) & 1).bool()
        is_reset = is_live & ((reset >> (t % 32)) & 1).bool()
        update = is_live & ~is_reset
        # each updating row's warps write their first register's lanes 0, 1
        # (old values) into this update's buffer; after the row's barrier,
        # lanes 0 and 1 of warp w read warp w + 1's (the last warp NEG_INF)
        buffers[turn[update], rows[update]] = b[update][:, :, :2, 0]
        edge = torch.full((slots, warps, LANES), NEG)
        edge[:, :-1, :2] = buffers[turn, rows][:, 1:]
        turn = turn ^ update.long()
        work = b.clone()
        b1 = torch.empty_like(b)
        b2 = torch.empty_like(b)
        for j in order:
            nxt = work[..., j + 1] if j + 1 < per else edge
            # each lane supplies what its reader needs: lane 0 (for lane 31)
            # and lanes 0, 1 (for lanes 30, 31) the register after
            b1[..., j] = torch.where(lane == 0, nxt, work[..., j])[
                ..., (lane + 1) % LANES]
            b2[..., j] = torch.where(lane < 2, nxt, work[..., j])[
                ..., (lane + 2) % LANES]
            work[..., j] = float("nan")           # register j is rewritten
        b2 = torch.where(skip, b2, torch.full_like(b2, NEG))
        # the plain version's arithmetic, on its own [N, S] layout
        b_row, lp_row = to_row(b), to_row(lpt)
        neg_row = torch.full_like(b_row, NEG)
        moved = ctc_kernels._log3sum(b_row, to_row(b1), to_row(b2))
        new = to_regs(torch.where(to_row(ok), moved + lp_row, neg_row), NEG)
        init = torch.where(fin, lpt, torch.full_like(lpt, NEG))
        b = torch.where(update[:, None, None, None], new,
                        torch.where(is_reset[:, None, None, None], init, b))
        fetch(t - (RING - 1))
        out[t] = to_row(b)
    return out


@pytest.mark.parametrize("warps", [1, None], ids=["one_warp", "kernel"])
@pytest.mark.parametrize("width", WIDTHS)
def test_lane_layout_is_bit_equal_to_plain(width, warps):
    args = lattice_inputs(width)
    got = lanes_beta(*args, warps=warps)
    want = ctc_kernels.beta_reference(*args)
    assert torch.equal(got, want)
    assert (got > NEG * 0.5).any()


def test_inputs_reset_across_words():
    """Rows 1 and 2 reset three times each, at both edges of a 32-step word
    and inside one, every reset on a live step."""
    _, time_mask, is_last, *_ = lattice_inputs(33)
    for row in (1, 2):
        steps = torch.nonzero(is_last[:, row])[:, 0]
        assert len(steps) == 3 and bool(time_mask[steps, row].all())
        assert len(set((steps // 32).tolist())) >= 2


def test_a_descending_update_would_be_seen():
    """Updating the registers from the last down hands lanes 30 and 31 the
    new value of positions s + 1 and s + 2: the emulation's NaN shows it."""
    args = lattice_inputs(64)
    got = lanes_beta(*args, warps=1, ascending=False)
    assert torch.isnan(got).any()
    assert torch.equal(lanes_beta(*args, warps=1),
                       ctc_kernels.beta_reference(*args))
