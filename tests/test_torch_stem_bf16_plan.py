"""The bf16 stem dW kernel's decomposition, emulated on the CPU.

``csrc/stem_dw_bf16.cu`` cuts dW into work items of ``nr`` output rows of
one (b, od) (``ops/stemconv.py`` ``bf16_plan``). Each output row takes
``bpr`` boxes of 64 positions in K (its columns past OW zero), 4 boxes an
item, each box one accumulator chain (4 k16 steps). x comes as 5 plane runs
from their 16-byte chunks; g as one tensor-map box of 8 channels (r, r + 8,
.., r + 56) for each r, in rows of 32 elements from the row holding channel
r's run start, or in rows of 8 where a box of 32-element rows would pass
that map's last row; the staged runs are rewritten into the boxes (zeros
past each row and past the item's rows), and the A loads read x at offsets
fixed by the K layout (zeroed past the row). These tests walk the same
items, boxes, chains and slot offsets in numpy at small ragged shapes and
hold the result in float64 to the plain dW, with every (position, tap)
covered exactly once. The kernel itself is held against the plain version
on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from neuroimagedisttraining_tpu_torch.ops import stemconv as PSC

TAPS, CO, KS = 125, 64, 5
#: g's two tensor maps in the kernel: elements a row
GEA, GEB = 32, 8


def _taps():
    """(kd, kh, kw) of the kernel's 128 tap rows (125..127 read tap 0's)."""
    t = np.arange(128)
    t = np.where(t < TAPS, t, 0)
    return t // 25, (t // 5) % 5, t % 5


def _staged_run(gf, start, nk, odhw, rows_a, rows_b, nr, ow, i):
    """Channel r + 8 i's run of nk positions as the kernel stages it: the
    map (rows of 32, or of 8 near g's end) that box r is read by, the rows
    from the one holding the run start of channel r, zeros past the map."""
    gra = (GEA - 1 + nr * ow + GEA - 1) // GEA
    grb = (GEB - 1 + nr * ow + GEB - 1) // GEB
    if start // GEA + gra <= rows_a:
        ge, gr, rows = GEA, gra, rows_a
    else:
        ge, gr, rows = GEB, grb, rows_b
    row = start // ge
    assert row < 2 ** 31
    staged = np.zeros(ge * gr)
    for t in range(gr):
        if row + t < rows:  # rows past the map read as zeros
            at = (row + t) * ge + i * 8 * odhw
            staged[ge * t:ge * t + ge] = gf[at:at + ge]
    o = start - row * ge
    # every position of the run is inside the map's rows
    assert row * ge + o + nk <= rows * ge and o + nk <= ge * gr
    return staged[o:o + nk]


def emulate(x: np.ndarray, g: np.ndarray):
    """dW [125, 64] of x [B, D, H, W] and g [B, 64, OD, OH, OW] (NCDHW) the
    way the kernel computes it, in float64; and how often each (position,
    tap) was multiplied."""
    B, D, H, W = x.shape
    plan = PSC.bf16_plan(B, D, H, W)
    OD, OH, OW, NR, BPR = plan.od, plan.oh, plan.ow, plan.nr, plan.bpr
    assert g.shape == (B, CO, OD, OH, OW) and NR * BPR <= 4
    xf, gf = x.reshape(-1), g.reshape(-1)
    box, xpl = PSC.BF16_BOX, PSC.BF16_XPL
    odhw = OD * OH * OW
    rows_a = max((B * CO - 56) * odhw // GEA, 1)
    rows_b = (B * CO - 56) * odhw // GEB
    kd, kh, kw = _taps()
    dw = np.zeros((128, CO))
    cover = np.zeros((B, OD, OH, OW, 128), dtype=np.int64)
    nhb = -(-OH // NR)
    assert plan.items == B * OD * nhb
    # K: 4 boxes of 64; box j is output row j // BPR, columns 64 (j % BPR)..
    kk = np.arange(4 * box)
    rr, cc = (kk // box) // BPR, box * ((kk // box) % BPR) + kk % box
    for it in range(plan.items):
        hb, r = it % nhb, it // nhb
        od, b = r % OD, r // OD
        oh0 = hb * NR
        nrows = min(NR, OH - oh0)
        valid = (rr < nrows) & (cc < OW)
        # x: plane kd's run from the 16-byte chunk holding its first element
        x0 = ((b * D + 2 * od) * H + 2 * oh0) * W
        xn = (2 * nrows + 3) * W
        slots = np.full((KS, xpl), np.nan)
        filled = np.zeros(KS, dtype=np.int64)
        al = np.zeros(KS, dtype=np.int64)
        for p in range(KS):
            start = x0 + p * H * W
            q = start & ~7
            n = ((start - q) + xn + 7) & ~7
            assert n <= xpl
            inside = min(n, xf.size - q)
            slots[p, :inside] = xf[q:q + inside]
            filled[p], al[p] = inside, start - q
        # g: each channel's run of nrows OW positions, rewritten into the
        # boxes (zeros past each output row and past the item's rows)
        g0 = (b * CO * OD + od) * OH * OW + oh0 * OW
        nk = nrows * OW
        bmat = np.zeros((4 * box, CO))
        for c in range(CO):
            run = _staged_run(gf, g0 + (c % 8) * odhw, nk, odhw, rows_a,
                              rows_b, NR, OW, c // 8)
            bmat[valid, c] = run[rr[valid] * OW + cc[valid]]
        # the A loads: fixed offsets of the K layout, zeros where masked
        col = (al[kd] + kh * W + kw)[:, None] + (2 * rr * W + 2 * cc)[None]
        assert col.max() < PSC.bf16_x_reach(NR, BPR, W) <= xpl
        # every value a kept position reads was copied; the rest is masked
        assert (col[:, valid] < filled[kd][:, None]).all()
        a = np.where(valid[None, :], slots[kd[:, None], np.minimum(col, xpl - 1)], 0.0)
        # the operands are the convolution's own values (numpy puts the
        # indexed positions first)
        ro, co = oh0 + rr[valid], cc[valid]
        np.testing.assert_array_equal(bmat[valid], g[b, :, od, ro, co])
        for t in range(128):
            np.testing.assert_array_equal(
                a[t, valid],
                x[b, 2 * od + kd[t], 2 * ro + kh[t], 2 * co + kw[t]])
        for j in range(4):  # one chain a box: 4 k16 steps
            chain = slice(j * box, (j + 1) * box)
            dw += a[:, chain] @ bmat[chain]
        cover[b, od, ro, co] += 1
    return dw[:TAPS], cover


@pytest.mark.parametrize("B,D,H,W", [
    (3, 7, 109, 13),    # OW 5: nr 4, OH 53 = 13 x 4 + 1
    (1, 7, 15, 121),    # OW 59 (the flagship's rows): nr 4, OH 6 = 4 + 2
    (3, 5, 13, 141),    # OW 69: 2 boxes a row, nr 2, OH 5 = 2 x 2 + 1
    (2, 21, 25, 23),    # 54 items: fewer than the persistent grid
    (1, 7, 23, 67),     # OW 32: the last run ends at g's end, read by the
    (1, 7, 13, 129),    # map of 8-element rows; OW 63: one short of a box
])
def test_bf16_plan_covers_and_sums_to_plain(B, D, H, W):
    """Items, flattened K, boxes, chains, padded taps and the zeroed tail:
    every (position, tap) exactly once, and the float64 sum of the emulated
    products equal to the plain dW (integral x and g: every sum is exact in
    float64). The last two shapes have an odd x, whose last elements the
    producer copies by hand."""
    rng = np.random.default_rng(B * 1000 + W)
    x = rng.integers(0, 256, (B, D, H, W)).astype(np.float64)
    plan = PSC.bf16_plan(B, D, H, W)
    g = rng.integers(-3, 4, (B, CO, plan.od, plan.oh, plan.ow)
                     ).astype(np.float64)
    dw, cover = emulate(x, g)
    assert (cover[..., :TAPS] == 1).all()
    plain = PSC.stem_dw_plain(
        torch.from_numpy(x[..., None]),
        torch.from_numpy(g).permute(0, 2, 3, 4, 1)).reshape(TAPS, CO)
    np.testing.assert_array_equal(dw, plain.numpy())


def test_bf16_plan_at_the_flagship_shape():
    """121x145x121 at batch 16: 4 rows an item, one box of 64 positions a
    row (59 of them kept), 16 x 59 x 18 items."""
    plan = PSC.bf16_plan(16, 121, 145, 121)
    assert (plan.nr, plan.bpr, plan.od, plan.oh, plan.ow) == (4, 1, 59, 71,
                                                              59)
    assert plan.items == 16 * 59 * 18
    assert (2 * plan.nr + 3) * 121 + 7 <= PSC.BF16_XPL
    assert PSC.bf16_x_reach(4, 1, 121) <= PSC.BF16_XPL


@pytest.mark.parametrize("shape,match", [
    ((1, 13, 13, 1001), "do not fit one work item"),   # OW 499 > 256
    ((1, 13, 13, 500), "do not fit one work item"),    # 5 x rows of 500
    ((1100, 121, 145, 121), "tensor map"),             # g of 1.7e10
    ((1, 4, 13, 13), "smaller than"),
])
def test_bf16_plan_refuses(shape, match):
    """What the kernel does not take is refused before a launch: rows too
    wide for one item or one x plane slot, a g past the tensor map's
    signed 32-bit row coordinate, an x smaller than the kernel."""
    with pytest.raises(ValueError, match=match):
        PSC.bf16_plan(*shape)
