"""Port's mask path (K4's plain version and its host tables) against the
JAX package's ``upsample_argmax_planar``, which off the TPU is the exact
chained resize + argmax (upsample_argmax_kernel.py:340-346).

Both sides interpolate in float32 with different rounding, so a pixel may
flip between two classes whose interpolated logits are within ~1e-6; the
stated bound is a mismatch share of at most 1e-4 (at these seeds it is 0).

K4's launch plan (pure Python) is held here too: its tiles cover the frame
exactly once with every read inside the staged window and the run's span,
and a numpy walk of the kernel's index math and arithmetic gives the same
class map under every tile (exactly: the per-pixel order does not depend
on the tile) and agrees with the plain version within the same share."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.pallas.upsample_argmax_kernel import (
    _compose_matrix, upsample_argmax_planar)
from multiyolov5_tpu_torch.ops.kernels import upsample_argmax, upsample_argmax_plain
from multiyolov5_tpu_torch.ops.kernels.upsample_argmax import (
    MAX_TAPS, SMEM_BUDGET, TILES, band_tables, dense_weights, plan, smem_bytes, tiles,
    windows)

MAX_MISMATCH = 1e-4


@pytest.mark.parametrize("b,c,h,w,out_hw", [(1, 19, 16, 32, (256, 512)),
                                            (2, 19, 8, 16, (100, 150)),
                                            (1, 2, 16, 32, (256, 512))])
def test_upsample_argmax_plain_matches_jax(b, c, h, w, out_hw):
    rng = np.random.RandomState(c + h + out_hw[1])
    x = rng.randn(b, c, h, w).astype(np.float32)
    via = (h * 8, w * 8)
    want = np.asarray(upsample_argmax_planar(jnp.asarray(x), out_hw, via_hw=via))
    got = upsample_argmax(torch.from_numpy(x), out_hw, via_hw=via)   # CPU: plain
    np.testing.assert_array_equal(
        got.numpy(), upsample_argmax_plain(torch.from_numpy(x), out_hw, via).numpy())
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert (got.numpy() != want).mean() <= MAX_MISMATCH


@pytest.mark.parametrize("n_in,n_out,via", [(64, 1024, 512), (128, 2048, 1024),
                                            (16, 100, 128), (8, 40, 64)])
def test_band_tables_compose_the_jax_matrix(n_in, n_out, via):
    """K4 reads each composed interpolation row as a band (first column,
    weights); expanded back it is the JAX package's float64 matrix."""
    lo, wts = band_tables(n_in, n_out, via)
    dense = np.zeros((n_out, n_in))
    for r in range(n_out):
        dense[r, lo[r]:lo[r] + wts.shape[1]] = wts[r]
    assert wts.shape[1] <= 8 and lo.min() >= 0 and lo.max() + wts.shape[1] <= n_in
    np.testing.assert_allclose(dense, _compose_matrix(n_in, n_out, via, True),
                               rtol=0, atol=1e-6)


# K4's launch plan.  Geometries (h, w, out_hw, via_hw): bs1 serving's,
# the bs8 server's, ragged frames, and bands of 1, 3 and 8 taps (identity
# rows; a downsample through a 2-wide via gives 8).
K4_GEOMS = [(64, 128, (1024, 2048), (512, 1024)), (128, 128, (1024, 2048), (1024, 1024)),
            (8, 16, (100, 150), (64, 128)), (16, 32, (257, 333), (128, 256)),
            (8, 16, (8, 150), (8, 128)), (8, 16, (3, 100), (2, 128)),
            (16, 16, (20, 37), (10, 128)), (5, 7, (41, 29), (40, 56))]


def _fma(a, b, c):
    """float32 fmaf, emulated: the float64 product of two float32 values is
    exact, and the sum is rounded (twice, which can differ from one rounding
    only in the last bit, in rare cases: the plans share this emulation)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _k4_walk(x, out_hw, via_hw, p):
    """csrc/upsample_argmax.cu's index math and arithmetic order in numpy,
    under the plan ``p``: each tile stages its window (zero past the image),
    forms the row pass over the window's columns, and each run of columns
    its dense column weights over ``span``.  Asserts that every read stays
    inside the staged window and the run's span; returns the class map and
    how many times each pixel was written."""
    bsz, c, h, w = x.shape
    H0, W0 = out_hw
    hlo, hwt = band_tables(h, H0, via_hw[0])
    wlo, wwt = band_tables(w, W0, via_hw[1])
    th, tw = hwt.shape[1], wwt.shape[1]
    dense = dense_weights(wlo, wwt, p.run, p.span)
    out = np.zeros((bsz, H0, W0), np.int64)
    writes = np.zeros((bsz, H0, W0), np.int64)
    for oh0, kr in tiles(H0, p.tr):
        r0 = hlo[oh0]
        for ow0, kc in tiles(W0, p.tc):
            c0 = wlo[ow0]
            xs = np.zeros((bsz, c, p.wr, p.wx), np.float32)
            rr, cc = min(p.wr, h - r0), min(p.wx, w - c0)
            xs[:, :, :rr, :cc] = x[:, :, r0:r0 + rr, c0:c0 + cc]
            lo_r = hlo[oh0:oh0 + kr] - r0
            assert lo_r.min() >= 0 and lo_r.max() + th <= p.wr
            t = np.zeros((bsz, c, kr, p.wx), np.float32)
            for a in range(th):
                t = _fma(hwt[oh0:oh0 + kr, a][None, None, :, None], xs[:, :, lo_r + a], t)
            ow = np.arange(ow0, ow0 + kc)
            base = wlo[ow0 + (ow - ow0) // p.run * p.run] - c0
            d = wlo[ow] - c0 - base
            assert d.min() >= 0 and (d + tw).max() <= p.span and (base + p.span).max() <= p.wx
            # the thread of column j reads [j % run][q][j // run] of the table
            wd = dense[(ow % p.run)[:, None], np.arange(p.span)[None], (ow // p.run)[:, None]]
            v = np.zeros((bsz, c, kr, kc), np.float32)
            for q in range(p.span):
                v = _fma(wd[:, q], t[..., base + q], v)
            out[:, oh0:oh0 + kr, ow0:ow0 + kc] = v.argmax(1)
            writes[:, oh0:oh0 + kr, ow0:ow0 + kc] += 1
    return out, writes


@pytest.mark.parametrize("h,w,out_hw,via_hw", K4_GEOMS)
def test_k4_plan_covers_the_frame_once(h, w, out_hw, via_hw):
    """Every tile of ``TILES`` that takes the geometry: its tiles cover the
    frame exactly once (ragged edges included), every tile's taps lie in
    its staged window and every run's in its span, the shared memory is
    the kernel's layout, and the class chunk fits the budget."""
    hlo, hwt = band_tables(h, out_hw[0], via_hw[0])
    wlo, wwt = band_tables(w, out_hw[1], via_hw[1])
    assert max(hwt.shape[1], wwt.shape[1]) <= MAX_TAPS
    taken = 0
    for tile in TILES:
        try:
            p = plan(1, 19, h, w, out_hw, via_hw, tile=tile)
        except ValueError:
            continue
        taken += 1
        assert (p.tr, p.tc, p.run) == tile and p.threads == min(256, p.tr * p.tc // p.run)
        assert p.tr % (p.threads // (p.tc // p.run)) == 0
        assert p.smem == smem_bytes(p.tr, hwt.shape[1], p.cb, p.wr, p.wx)
        assert p.cb == 19 or p.smem <= SMEM_BUDGET
        assert p.wr == windows(hlo, hwt.shape[1], p.tr)[0]
        rows = np.zeros(out_hw[0], int)
        cols = np.zeros(out_hw[1], int)
        for i, k in tiles(out_hw[0], p.tr):
            rows[i:i + k] += 1
            assert hlo[i + k - 1] + hwt.shape[1] - hlo[i] <= p.wr
        for i, k in tiles(out_hw[1], p.tc):
            cols[i:i + k] += 1
            for j in range(i, i + k, p.run):
                e = min(j + p.run, i + k) - 1
                assert wlo[e] + wwt.shape[1] - wlo[j] <= p.span
                assert wlo[j] - wlo[i] + p.span <= p.wx
        assert (rows == 1).all() and (cols == 1).all()
        assert p.ctas == len(tiles(out_hw[0], p.tr)) * len(tiles(out_hw[1], p.tc))
    assert taken >= 1 and plan(1, 19, h, w, out_hw, via_hw) is not None


@pytest.mark.parametrize("c", [1, 19, 256])
def test_k4_plan_chunks_classes(c):
    """All classes in one chunk where they fit the budget, chunks otherwise;
    no class count raises."""
    p = plan(1, c, 64, 128, (1024, 2048), (512, 1024))
    assert 1 <= p.cb <= c and (p.cb == c or p.smem <= SMEM_BUDGET)


@pytest.mark.parametrize("h,w,out_hw,via_hw", K4_GEOMS[2:])
def test_k4_walk_matches_plain_under_every_plan(h, w, out_hw, via_hw):
    """The kernel's arithmetic (numpy walk) gives one class map under every
    plan, bit for bit, covers each pixel once, and agrees with the plain
    version within the stated mismatch share (float32 rounding in another
    order: separable rows then columns against two chained resizes)."""
    rng = np.random.RandomState(h * w)
    x = rng.randn(2, 5, h, w).astype(np.float32)
    want = upsample_argmax_plain(torch.from_numpy(x), out_hw, via_hw).numpy()
    maps = []
    for tile in TILES:
        try:
            p = plan(2, 5, h, w, out_hw, via_hw, tile=tile)
        except ValueError:
            continue
        got, writes = _k4_walk(x, out_hw, via_hw, p)
        assert (writes == 1).all()
        maps.append(got)
        assert (got != want).mean() <= MAX_MISMATCH
    assert maps and all(np.array_equal(m, maps[0]) for m in maps)


@pytest.mark.parametrize("n_in,n_out,via,run,span", [(128, 2048, 1024, 16, 4),
                                                    (16, 150, 128, 8, 4), (8, 3, 2, 1, 8),
                                                    (32, 333, 256, 4, 8)])
def test_k4_dense_weights_hold_each_band(n_in, n_out, via, run, span):
    """The dense column table holds each output column's band at its offset
    from its run's first tap, zeros elsewhere (and past the last column)."""
    lo, wts = band_tables(n_in, n_out, via)
    dense = dense_weights(lo, wts, run, span)
    runs = -(-n_out // run)
    assert dense.shape == (run, span, runs) and dense.dtype == np.float32
    for j in range(runs * run):
        row = dense[j % run, :, j // run]
        if j >= n_out:
            assert not row.any()
            continue
        d = lo[j] - lo[j // run * run]
        want = np.zeros(span, np.float32)
        want[d:d + wts.shape[1]] = wts[j]
        np.testing.assert_array_equal(row, want)
