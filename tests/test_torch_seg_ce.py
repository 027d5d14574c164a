"""K6's plain version, and the ``seg_ce`` wrapper's CPU path, against the JAX
package's ``seg_ce_up8`` (interpret mode on the CPU) and against its
reference ``cross_entropy_seg . resize_bilinear``: value and dz.

The cases mirror tests/test_seg_ce_kernel.py.  The port takes planar
(B, C, h, w) logits, the JAX function NHWC; the same seeded numbers go to
both.  Bounds, float32: the loss within 5e-5 relative and dz within 2e-4
relative + 1e-7 absolute, the bounds tests/test_seg_ce_kernel.py holds
the kernel to (summation order; torch interpolates with float32 weights,
the JAX package with float64-built matrices rounded to float32).  bf16
logits: the JAX kernel rounds its column-interpolated plane to bf16 (its
MXU input) where the port computes in float32, so the loss is held within
2e-2 relative and dz within 0.1 relative + 2e-4, as there.
All labels ignored: exactly 0 and a zero gradient, not NaN.

The kernels' launch plan (``plan``, pure Python): its tiles cover every
dz element and every label pixel as the kernels need, its shared-memory
counts match counts made by hand, and it raises on what the kernels do not
take.  A float64 numpy walk over the plan's tiles mirrors both kernels
(the forward's logsumexp a pixel, the backward's row walk with its parked
rows, then the column contraction, each dz element written once): its dz
equals ``seg_ce_plain``'s float64 autograd gradient within 1e-12 of its
scale, and the JAX kernel's within the float32 bounds above."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.pallas.seg_ce_kernel import seg_ce_up8
from multiyolov5_tpu.ops.resize import resize_bilinear
from multiyolov5_tpu.train.losses import cross_entropy_seg
from multiyolov5_tpu_torch.ops.kernels import seg_ce, seg_ce_plain
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

K6 = importlib.import_module("multiyolov5_tpu_torch.ops.kernels.seg_ce")


def _data(seed, b=2, h=8, w=16, c=7, k=8, ignore_frac=0.2):
    rng = np.random.RandomState(seed)
    z = rng.randn(b, h, w, c).astype(np.float32)          # NHWC, the JAX layout
    y = rng.randint(0, c, (b, k * h, k * w))
    y = np.where(rng.rand(*y.shape) < ignore_frac, -1, y).astype(np.int32)
    wv = rng.rand(c).astype(np.float32) + 0.5
    return z, y, wv


def _jax(fn, z, y, wv, scale, dtype):
    zj = jnp.asarray(z, dtype)
    yj = jnp.asarray(y)
    wj = None if wv is None else jnp.asarray(wv)
    val, grad = jax.value_and_grad(lambda zz: scale * fn(zz, yj, wj))(zj)
    return float(val) / scale, np.asarray(grad, np.float32).transpose(0, 3, 1, 2)


def _ref(zz, y, w):
    return cross_entropy_seg(resize_bilinear(zz, y.shape[1:]), y, w)


def _kernel(zz, y, w):
    return seg_ce_up8(zz, y, weight=w)


def _port(fn, z, y, wv, scale, dtype):
    zt = torch.from_numpy(z.transpose(0, 3, 1, 2).copy()).to(dtype).requires_grad_(True)
    loss = fn(zt, torch.from_numpy(y).long(), None if wv is None else torch.from_numpy(wv))
    (scale * loss).backward()
    assert loss.dtype == torch.float32 and zt.grad.dtype == dtype
    return loss.item(), zt.grad.float().numpy()


CASES = {
    "unweighted": dict(seed=1, weighted=False, scale=1.0),
    "weighted_scaled": dict(seed=2, weighted=True, scale=3.5, c=5),
    "nondivisible_6x12": dict(seed=3, weighted=False, scale=1.0, b=1, h=6, w=12, c=4),
}


@pytest.mark.parametrize("fn", [seg_ce_plain, seg_ce], ids=["plain", "wrapper"])
@pytest.mark.parametrize("case", list(CASES))
def test_seg_ce_matches_jax_float32(fn, case):
    kw = dict(CASES[case])
    seed, weighted, scale = kw.pop("seed"), kw.pop("weighted"), kw.pop("scale")
    z, y, wv = _data(seed, **kw)
    wv = wv if weighted else None
    got, dz = _port(fn, z, y, wv, scale, torch.float32)
    for ref in (_ref, _kernel):
        want, dz_want = _jax(ref, z, y, wv, scale, jnp.float32)
        np.testing.assert_allclose(got, want, rtol=5e-5)
        np.testing.assert_allclose(dz, dz_want, rtol=2e-4, atol=1e-7)


def test_seg_ce_matches_jax_bf16():
    z, y, _ = _data(4, b=1)
    got, dz = _port(seg_ce, z, y, None, 1.0, torch.bfloat16)
    want, dz_want = _jax(_kernel, z, y, None, 1.0, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    np.testing.assert_allclose(dz, dz_want, rtol=0.1, atol=2e-4)


@pytest.mark.parametrize("fn", [seg_ce_plain, seg_ce], ids=["plain", "wrapper"])
def test_seg_ce_all_ignored_is_zero(fn):
    z, y, wv = _data(5, b=1, h=4, w=8, c=3)
    y[:] = -1
    got, dz = _port(fn, z, y, wv, 1.0, torch.float32)
    assert got == 0.0 and not np.any(dz)
    want, _ = _jax(_kernel, z, y, wv, 1.0, jnp.float32)
    assert want == 0.0


# (B, C, h, w, H, W): the train step's, the card tests' (x8), and resizes
# at other ratios, with sizes that are no multiple of any tile
PLAN_SHAPES = [(8, 19, 64, 128, 512, 1024), (1, 4, 6, 12, 48, 96), (2, 5, 8, 16, 64, 128),
               (1, 3, 6, 17, 50, 136), (2, 19, 17, 6, 136, 50)]


def _touching(lo, i0, n):
    """Label indices whose taps (lo, lo + 1) touch inputs [i0, i0 + n)."""
    return np.flatnonzero((lo + 1 >= i0) & (lo <= i0 + n - 1))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plan_tiles_cover_dz_and_labels(shape):
    bsz, c, h, w, H, W = shape
    for dtype in (torch.float32, torch.bfloat16):
        p = K6.plan(bsz, c, h, w, H, W, dtype)
        for n_in, n_out, t, tf in ((h, H, p.bwd.ti, p.fwd.ti), (w, W, p.bwd.tj, p.fwd.tj)):
            lo = K6.tap_tables(n_in, n_out)[0]
            # backward: every dz index in exactly one tile; every label index
            # whose taps touch the tile in its range, and no other
            seen = np.zeros(n_in, int)
            for i0, n, start, end in K6.tile_ranges(n_in, n_out, t, backward=True):
                seen[i0:i0 + n] += 1
                np.testing.assert_array_equal(np.arange(start, end), _touching(lo, i0, n))
                # the staged z rows hold every tap the range reads
                assert max(i0 - 1, 0) <= lo[start:end].min() if end > start else True
                assert lo[start:end].max() + 1 <= min(i0 + n, n_in - 1)
            assert (seen == 1).all()
            # forward: every cell and every label index in exactly one tile
            cells, labels = np.zeros(n_in - 1, int), np.zeros(n_out, int)
            for i0, n, start, end in K6.tile_ranges(n_in, n_out, tf, backward=False):
                cells[i0:i0 + n] += 1
                labels[start:end] += 1
                assert ((lo[start:end] >= i0) & (lo[start:end] < i0 + n)).all()
            assert (cells == 1).all() and (labels == 1).all()
        for q, backward in ((p.fwd, False), (p.bwd, True)):
            rows = K6.tile_ranges(h, H, q.ti, backward)
            cols = K6.tile_ranges(w, W, q.tj, backward)
            assert q.cols == max(e - s for _, _, s, e in cols)
            assert q.ctas == bsz * len(rows) * len(cols)
            assert q.threads == min(-(-q.groups * q.cols // 32) * 32, K6.MAX_THREADS)
            assert q.cb * q.groups >= c and q.smem <= K6.SMEM_LIMIT
            assert q.smem == K6.smem_bytes(backward, q.cb * q.groups, q.ti, q.tj, q.cols)
        assert p.fwd.groups == 1 and p.fwd.cb in K6.FWD_CLASSES
        assert p.bwd.cb in K6.BWD_CLASSES


def test_plan_smem_bytes_by_hand():
    p = K6.plan(8, 19, 64, 128, 512, 1024, torch.bfloat16)
    # forward 4 x 32 cells, the 19 classes padded to 20: 20 weights, a
    # 5 x 33 x 20 z tile; 258 label columns over 160 threads
    assert (p.fwd.ti, p.fwd.tj, p.fwd.cb, p.fwd.cols, p.fwd.threads) == (4, 32, 20, 258, 160)
    assert p.fwd.smem == 4 * (20 + 5 * 33 * 20) == 13280
    # backward 8 x 8, 2 groups of 10 classes: 20 weights, 2 x 73 column
    # weights, a 10 x 10 x 20 z tile, 8 rows x 73 label columns x 20 partials
    assert (p.bwd.ti, p.bwd.tj, p.bwd.cb, p.bwd.groups, p.bwd.cols) == (8, 8, 10, 2, 73)
    assert p.bwd.smem == 4 * (20 + 2 * 73 + 10 * 10 * 20 + 8 * 73 * 20) == 55384
    assert p.bwd.threads == 160 and (p.fwd.ctas, p.bwd.ctas) == (8 * 16 * 4, 8 * 8 * 16)
    assert K6.smem_bytes(False, 8, 4, 8, 40) == 4 * (8 + 5 * 9 * 8)
    assert K6.smem_bytes(True, 4, 2, 3, 11) == 4 * (4 + 2 * 11 + 4 * 5 * 4 + 2 * 11 * 4)


@pytest.mark.parametrize("args", [
    (1, 4, 1, 12, 48, 96), (1, 4, 6, 1, 48, 96), (1, 4, 6, 12, 1, 96), (1, 4, 6, 12, 48, 1),
    (0, 4, 6, 12, 48, 96), (1, 0, 6, 12, 48, 96), (1, 33, 6, 12, 48, 96)])
def test_plan_raises_on_what_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        K6.plan(*args, torch.float32)


def test_plan_raises_on_dtype_and_tiles_that_do_not_fit():
    with pytest.raises(ValueError):
        K6.plan(1, 4, 6, 12, 48, 96, torch.float16)
    with pytest.raises(ValueError):          # 64 x 64 x 19 partials: past shared memory
        K6.plan(8, 19, 64, 128, 512, 1024, torch.float32, bwd=(64, 64, 1))
    with pytest.raises(ValueError):          # a 129 x 129 x 19 z tile: past shared memory
        K6.plan(8, 19, 64, 128, 512, 1024, torch.float32, fwd=(128, 128))
    with pytest.raises(ValueError):
        K6.tap_tables(1, 8)


def _walk(z, y, wv, scale, p, ignore=-1):
    """Both kernels' arithmetic in float64 over the plan's tiles: (loss, dz
    (B, C, h, w)).  Forward: a pixel's logsumexp from its 2x2 taps, columns
    first.  Backward: per tile, each label column walks its label rows,
    takes each pixel's one-hot term into the partials U at once and adds
    an input row's softmax terms when the walk leaves it; then each dz
    element sums its label columns.  Every pixel and dz element is written
    once."""
    bsz, c, h, w = z.shape
    H, W = y.shape[1:]
    hlo, hwt, _, _ = K6.tap_tables(h, H, np.float64)
    wlo, wwt, wfirst, wcount = K6.tap_tables(w, W, np.float64)
    zn = z.transpose(0, 2, 3, 1)
    valid = (y != ignore) & (y >= 0) & (y < c)
    yc = np.clip(y, 0, c - 1)
    wy = np.where(valid, wv[yc], 0.0)
    onehot = np.eye(c)[yc]

    def colmix(r, X):                                 # (B, len(X), C) at input row r
        return (wwt[X, 0, None] * zn[:, r, wlo[X]] + wwt[X, 1, None] * zn[:, r, wlo[X] + 1])

    def logits(Y, X):                                 # (B, C) -> (B, len(X), C) at row Y
        return hwt[Y, 0] * colmix(hlo[Y], X) + hwt[Y, 1] * colmix(hlo[Y] + 1, X)

    lse = np.full((bsz, H, W), np.nan)
    num = den = 0.0
    for _, _, ys, ye in K6.tile_ranges(h, H, p.fwd.ti, backward=False):
        for _, _, xs, xe in K6.tile_ranges(w, W, p.fwd.tj, backward=False):
            X = np.arange(xs, xe)
            for Y in range(ys, ye):
                assert np.isnan(lse[:, Y, X]).all()
                v = logits(Y, X)
                m = v.max(-1)
                lse[:, Y, X] = m + np.log(np.exp(v - m[..., None]).sum(-1))
                py = np.take_along_axis(v, yc[:, Y, X, None], -1)[..., 0]
                num += (wy[:, Y, X] * (lse[:, Y, X] - py)).sum()
                den += wy[:, Y, X].sum()
    assert not np.isnan(lse).any()
    gsc = scale / max(den, 1.0)
    dz = np.full((bsz, h, w, c), np.nan)
    for i0, ni, ys, ye in K6.tile_ranges(h, H, p.bwd.ti, backward=True):
        for j0, nj, xs, xe in K6.tile_ranges(w, W, p.bwd.tj, backward=True):
            assert xe - xs <= p.bwd.cols
            X = np.arange(xs, xe)
            U = np.zeros((bsz, ni, len(X), c))
            acc0, acc1 = np.zeros((bsz, len(X), c)), np.zeros((bsz, len(X), c))

            def park(row, acc):
                if i0 <= row < i0 + ni:
                    U[:, row - i0] += acc

            bi = np.arange(bsz)[:, None]
            xi = np.arange(len(X))[None, :]

            cur = hlo[ys] if ye > ys else 0
            for Y in range(ys, ye):
                while cur < hlo[Y]:
                    park(cur, acc0)
                    acc0, acc1 = acc1, np.zeros_like(acc1)
                    cur += 1
                pr = np.exp(logits(Y, X) - lse[:, Y, X, None])
                ws = wy[:, Y, X] * gsc
                acc0 = acc0 + hwt[Y, 0] * ws[..., None] * pr
                acc1 = acc1 + hwt[Y, 1] * ws[..., None] * pr
                for row, a in ((cur, hwt[Y, 0]), (cur + 1, hwt[Y, 1])):
                    if i0 <= row < i0 + ni:
                        U[bi, row - i0, xi, yc[:, Y, X]] -= a * ws
            if ye > ys:
                park(cur, acc0)
                park(cur + 1, acc1)
            for j in range(j0, j0 + nj):
                Xj = np.arange(wfirst[j], wfirst[j] + wcount[j])
                wx = np.where(wlo[Xj] == j, wwt[Xj, 0], wwt[Xj, 1])
                assert np.isnan(dz[:, i0:i0 + ni, j]).all()
                dz[:, i0:i0 + ni, j] = np.einsum("x,bixc->bic", wx, U[:, :, Xj - xs])
    assert not np.isnan(dz).any()
    return num / max(den, 1.0), dz.transpose(0, 3, 1, 2)


WALK_CASES = {
    "x8_weighted": dict(seed=6, b=2, h=8, w=16, c=5, k=8, weighted=True, scale=3.5, tiles=None),
    "x8_small_tiles": dict(seed=7, b=1, h=6, w=12, c=4, k=8, weighted=False, scale=1.0,
                           tiles=((4, 8), (4, 4, 1))),
    "ratio_6_to_50_and_17_to_136": dict(seed=8, b=1, h=6, w=17, c=3, k=None, weighted=True,
                                        scale=2.0, tiles=((4, 8), (4, 8, 2))),
    "c19_two_groups_90pct_ignored": dict(seed=9, b=1, h=6, w=12, c=19, k=8, weighted=True,
                                         scale=1.0, tiles=None, ignore_frac=0.9),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_separable_walk_matches_plain_float64_and_jax(case):
    kw = dict(WALK_CASES[case])
    seed, weighted, scale, tiles, k = (kw.pop(n) for n in ("seed", "weighted", "scale",
                                                            "tiles", "k"))
    if k is None:                                     # 6 -> 50 rows, 17 -> 136 columns
        z, y, wv = _data(seed, k=8, **kw)
        y = np.random.RandomState(seed).randint(-1, kw["c"], (kw["b"], 50, 136)).astype(np.int32)
    else:
        z, y, wv = _data(seed, k=k, **kw)
    wv = wv if weighted else np.ones(kw["c"], np.float32)
    bsz, h, w, c = z.shape
    H, W = y.shape[1:]
    fwd, bwd = tiles if tiles else (None, None)
    p = K6.plan(bsz, c, h, w, H, W, torch.float32, fwd=fwd, bwd=bwd)
    z64 = z.transpose(0, 3, 1, 2).astype(np.float64)
    loss, dz = _walk(z64, y, wv.astype(np.float64), scale, p)
    zt = torch.from_numpy(z64.copy()).requires_grad_(True)
    ref = seg_ce_plain(zt, torch.from_numpy(y).long(), torch.from_numpy(wv.astype(np.float64)))
    (scale * ref).backward()
    want = zt.grad.numpy()
    assert ref.dtype == torch.float64
    assert abs(loss - ref.item()) <= 1e-12 * abs(ref.item())
    assert np.abs(dz - want).max() <= 1e-12 * np.abs(want).max()
    # seg_ce_up8 takes integer ratios; other resizes go to its reference
    fn = _kernel if H % h == 0 and W % w == 0 else _ref
    jval, jdz = _jax(fn, z, y, wv if weighted else None, scale, jnp.float32)
    np.testing.assert_allclose(loss, jval, rtol=5e-5)
    np.testing.assert_allclose(dz, jdz, rtol=2e-4, atol=1e-7)
