"""K12's and K13's resident plans of 16 blocks in bf16
(``csrc/lstm_stack_fwd.cu``, ``csrc/lstm_stack_bwd.cu``), several rows a
cell-phase thread, on the CPU.

Only 7 sixteen-block clusters are resident at once on an H100, so a 4-layer
stack runs one row tile a wave, and each wave pays the whole sequential
chain again.  The resident plans of 16 blocks therefore take as many rows
a cluster as shared memory holds, as the streamed plans do
(``test_torch_lstm_stack_streamed.py``): a cell-phase thread owns unit tid
% US of rows tid / US, + 512 / US, .., and the products' A operands are one
or two whole 16-row tiles.  K12 keeps its resident products (each k-slice
of a tile summed alone, the slices added in order by the reader); K13 runs
the streamed plan's kernel with every weight held and no ring: a block
keeps its own P-slice of the carry dh and of dchain, writes its dh
partials into the owners' inboxes during the pass over wh, and the owners
all-gather the next step's dout_p.

Here the streamed file's block-by-block, warp-by-warp emulation runs the
resident plans (``held``) under its interleaved schedules at R = 16 and 32
(K12) and 16 (K13), with rows for some cell-phase threads twice and ragged
tiles, held to ``stack_forward_reference`` and ``stack_backward_reference``
at rtol = atol = 1e-5 in float32; a block that writes its dh partial into
an inbox before its owner has read it is caught; and a mirror of the plans'
shared-memory arithmetic gives the launchers' R and waves at B = 32.
"""

import pytest

from lstm_ctc_tpu_torch.models import cells  # noqa: F401 (before the ops)
from lstm_ctc_tpu_torch.ops import lstm_stack_kernels as sk
from test_torch_lstm_stack_streamed import (
    C, ORDERS, SMEM, THREADS, Hazard, backward_case, cdiv, close,
    k12_resident_plan, k12_streamed, k13_resident_plan, k13_streamed,
    launch_rows, make_case, round_up, thread_rows)

# two of the file's schedules: a random one and the lowest-numbered warp as
# far as it can go
RUN_ORDERS = [ORDERS[0], ORDERS[-1]]

# (H, P or None, R, B): Kaldi's LSTMP at R = 16 (64 units a block: rows 8 ..
# a cell-phase thread's second), the cudnnlstm family at H = P = 512 at R =
# 32 (32 units a block: rows 16 .. the second); ragged tiles
K12_RUNS = [(1024, 256, 16, 9), (512, None, 32, 20)]
# K13 at R = 16 (its most): 64 units a block with a projection of 128
# (rows 8 .. a thread's second), the cudnnlstm family at 512, a full tile
K13_RUNS = [(1024, 128, 16, 9), (512, None, 16, 16)]


def run_id(run):
    units, proj, rows, batch = run
    return "%dx%s-R%d-B%d" % (units, proj or "noproj", rows, batch)


@pytest.mark.parametrize("name,order", RUN_ORDERS,
                         ids=[n for n, _ in RUN_ORDERS])
@pytest.mark.parametrize("run", K12_RUNS, ids=[run_id(r) for r in K12_RUNS])
def test_stack_resident_forward_matches_plain(run, name, order):
    units, proj, rows, batch = run
    us = round_up(cdiv(units, C), 8)
    assert thread_rows(rows, us) == 2 and batch > THREADS // us
    case = make_case(11, units, proj, batch=batch, affine=proj is None)
    got = k12_streamed(case, order, lag=2, rows=rows, held=True)
    ref = sk.stack_forward_reference(**case)
    close(got, ref, ("out", "chain", "c_all", "h_all", "cfin", "hfin"))


@pytest.mark.parametrize("name,order", RUN_ORDERS,
                         ids=[n for n, _ in RUN_ORDERS])
@pytest.mark.parametrize("run", K13_RUNS, ids=[run_id(r) for r in K13_RUNS])
def test_stack_resident_backward_matches_plain(run, name, order):
    units, proj, rows, batch = run
    case, fwd, dout, dcfin, dhfin = backward_case(units, proj, batch,
                                                  seed=12)
    _, chain, c_all, h_all, _, _ = fwd
    ref = sk.stack_backward_reference(
        **{k: v for k, v in case.items() if k != "affine"}, chain=chain,
        c_all=c_all, h_all=h_all, dout=dout, dcfin=dcfin, dhfin=dhfin,
        steps_out=True)
    got = k13_streamed(case, fwd, dout, dcfin, dhfin, order, lag=2,
                       rows=rows, held=True)
    dgates, _, dbias, _, dpeep, dcinit, dhinit, dc_in, dh_in, din = ref
    close(got, (dgates, dbias, dpeep, dcinit, dhinit, dc_in, dh_in, din),
          ("dgates", "dbias", "dpeep", "dcinit", "dhinit", "dc_in", "dh_in",
           "din"))


@pytest.mark.parametrize("run,caught", [
    (K13_RUNS[1][:3] + (9,), "inbox overwritten"),
    (K13_RUNS[0], "read step")], ids=["512-noproj", "1024x128"])
def test_stack_resident_inbox_write_before_its_owner_read_is_caught(run,
                                                                    caught):
    """Without the cluster barrier that ends the owners' reads of their
    inboxes (and, with a projection, their writes of dq), a block runs
    ahead into the next step: its pass over the held wh writes its dh
    partial into an inbox its owner has not read yet, or its dout_blk
    reads dq slices their owners have not written yet."""
    units, proj, rows, batch = run
    case, fwd, dout, dcfin, dhfin = backward_case(units, proj, batch,
                                                  seed=13)
    with pytest.raises(Hazard, match=caught):
        k13_streamed(case, fwd, dout, dcfin, dhfin, lambda c: c[-1],
                     rows=rows, inbox_barrier=False, held=True)


# the widths of the resident plans of 16 blocks (phases 11, 12 and 22 of
# chip_smoke.py): Kaldi's LSTMP, H = P = 384-512 with a projection, the
# cudnnlstm family at 512; (H, P or None, K12's R, K13's R) at B = 32
WIDE = [(1024, 256, 16, 8), (512, 512, 16, 8), (448, 448, 16, 8),
        (384, 384, 16, 16), (512, None, 32, 16)]


@pytest.mark.parametrize("units,proj,k12_rows,k13_rows", WIDE,
                         ids=["%dx%s" % (u, p or "noproj")
                              for u, p, _, _ in WIDE])
def test_stack_resident_b32_waves(units, proj, k12_rows, k13_rows):
    """At B = 32 (4 layers, bf16 states) the 16-block K12 runs at most 2
    waves (one row a cell-phase thread ran 4 at 1024/256, 3 at H = P =
    384-512) and K13 at most 4 (one row a thread ran 8 at 1024/256, 16 at
    512/512), within a block's 232,448 bytes.  With float32 states K13
    still takes 4 rows."""
    out_dim, has_proj = proj or units, proj is not None
    rows, per_wave, waves = launch_rows(k12_resident_plan, units, out_dim,
                                        has_proj, 32)
    assert (rows, per_wave) == (k12_rows, 1) and waves <= 2
    assert k12_resident_plan(units, out_dim, has_proj, rows)["bytes"] <= SMEM
    rows, per_wave, waves = launch_rows(k13_resident_plan, units, out_dim,
                                        has_proj, 32)
    assert (rows, per_wave) == (k13_rows, 1) and waves <= 4
    assert k13_resident_plan(units, out_dim, has_proj, rows)["bytes"] <= SMEM
    assert k13_resident_plan(units, out_dim, has_proj, 4, store=4)["fits"]
    # a streaming chunk (B = 1) keeps R = 4 on both
    for plan in (k12_resident_plan, k13_resident_plan):
        assert launch_rows(plan, units, out_dim, has_proj, 1) == (4, 1, 1)


@pytest.mark.parametrize("units,proj", [(320, 320), (320, None)],
                         ids=["lstm", "cudnnlstm"])
def test_stack_eight_block_rows_unchanged(units, proj):
    """The 8-block plans keep one row a cell-phase thread, the carried c in
    shared memory and R of {4, 6, 8, 12}: at the families' flagship width
    all four fit, so the launcher takes R = 12 in one wave as before; R =
    16 would be two rows a thread, which 8 blocks do not take.  (On the
    card, ``test_torch_lstm_stack.py``'s ``test_k12_k13_wide_on_16_blocks``
    reads the launcher's own R there: K12 12 in one wave, K13 6 in two.)"""
    out_dim, has_proj = proj or units, proj is not None
    assert all(k12_resident_plan(units, out_dim, has_proj, rows, 8)["fits"]
               for rows in (4, 6, 8, 12))
    assert not k12_resident_plan(units, out_dim, has_proj, 16, 8)["fits"]
