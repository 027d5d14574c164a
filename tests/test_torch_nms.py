"""Port's NMS against the JAX package.

* K3's plain version keeps exactly the boxes that the TPU fixpoint kernel
  ``nms_fixpoint_pallas`` keeps (interpret mode on the CPU): both test
  IoU > t in the same division-free float32 form, so no tolerance.
* The port's ``nms_planar`` gives the JAX ``nms_planar``'s detections on the
  same decoded candidates, ties in the top-k included (scores drawn from a
  few levels, so many candidates tie; both resolve lower index first).
  The JAX CPU path tests IoU with a division, which can differ only for a
  pair within an ulp of the threshold; none occurs at these seeds, so the
  comparison is exact up to float32 box arithmetic (1e-5 relative).
* K3's packed output (plain version) equals the JAX ``_pack_keep`` of the
  TPU kernel's keep mask, and a numpy walk of the kernel's build partition
  and sweep equals the plain versions at any CTA count: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.ops.nms import nms_planar as jax_nms_planar
from multiyolov5_tpu.ops.pallas.nms_fixpoint_kernel import nms_fixpoint_pallas
from multiyolov5_tpu_torch.ops.kernels import nms, nms_packed, nms_packed_plain, nms_plain
from multiyolov5_tpu_torch.ops.kernels.nms import Plan, plan, smem_bytes, suppression, word_pairs
from multiyolov5_tpu_torch.ops.nms import nms_planar
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)


def _clustered_boxes(rng, n, n_valid, img=160):
    """Boxes crowded into a small image, so that most pairs overlap and the
    suppression chains run deep."""
    xy = rng.rand(n, 2) * img
    wh = rng.rand(n, 2) * 60 + 4
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    scores = np.sort(rng.rand(n).astype(np.float32))[::-1] + 1e-4
    scores[n_valid:] = 0.0
    return boxes, scores.copy()


@pytest.mark.parametrize("n,n_valid,iou", [(128, 128, 0.45), (256, 200, 0.45),
                                           (256, 256, 0.6)])
def test_nms_plain_equals_fixpoint_kernel(n, n_valid, iou):
    boxes, scores = _clustered_boxes(np.random.RandomState(n + n_valid), n, n_valid)
    want = np.asarray(nms_fixpoint_pallas(jnp.asarray(boxes), jnp.asarray(scores), iou))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    got = nms(tb, ts, iou).numpy()        # CPU: plain
    np.testing.assert_array_equal(got, nms_plain(tb, ts, iou).numpy())
    assert 0 < got.sum() < n_valid        # the test exercises suppression
    np.testing.assert_array_equal(got, want)


def _planar_candidates(rng, b, nc, na, grids, img=256):
    """Per-scale JAX-layout (no, na, B, HW) decoded candidates."""
    no = nc + 5
    zs = []
    for hw in grids:
        z = np.empty((no, na, b, hw), np.float32)
        z[0:2] = rng.rand(2, na, b, hw) * img
        z[2:4] = rng.rand(2, na, b, hw) * 80 + 4
        z[4] = rng.choice([0.1, 0.3, 0.5, 0.7, 0.9], size=(na, b, hw))
        z[5:] = rng.choice([0.2, 0.4, 0.6, 0.8], size=(nc, na, b, hw))
        zs.append(z)
    return zs


@pytest.mark.parametrize("conf,agnostic,max_nms", [(0.25, False, 1024),
                                                   (0.05, True, 1024),
                                                   (0.25, False, 128)])
def test_nms_planar_matches_jax(conf, agnostic, max_nms):
    rng = np.random.RandomState(3)
    b = 2
    zs = _planar_candidates(rng, b, nc=10, na=3, grids=(128, 32, 8))
    want_det, want_valid = jax_nms_planar([jnp.asarray(z) for z in zs],
                                          conf_thres=conf, iou_thres=0.45,
                                          agnostic=agnostic, max_nms=max_nms,
                                          max_det=300)
    z = np.concatenate([zi.transpose(2, 0, 1, 3).reshape(b, zi.shape[0], -1)
                        for zi in zs], 2)
    got_det, got_valid = nms_planar(torch.from_numpy(z), conf, 0.45, agnostic,
                                    max_nms=max_nms, max_det=300)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_valid.sum() > 10
    np.testing.assert_allclose(got_det.numpy(), np.asarray(want_det),
                               rtol=1e-5, atol=1e-5)


def test_nms_planar_bs8_is_one_k5_launch(monkeypatch):
    """bs8 serving: 8 lists of 1024 candidates go to one K5 call (its plain
    version here) and give the JAX package's detections."""
    import multiyolov5_tpu_torch.ops.nms as nms_mod
    rng = np.random.RandomState(8)
    b = 8
    zs = _planar_candidates(rng, b, nc=10, na=3, grids=(320, 80, 20))
    want_det, want_valid = jax_nms_planar([jnp.asarray(z) for z in zs], conf_thres=0.25,
                                          iou_thres=0.45, max_nms=1024, max_det=300)
    z = np.concatenate([zi.transpose(2, 0, 1, 3).reshape(b, zi.shape[0], -1)
                        for zi in zs], 2)
    calls = []
    real = nms_mod.nms_greedy
    monkeypatch.setattr(nms_mod, "nms_greedy",
                        lambda boxes, *a: calls.append(tuple(boxes.shape)) or real(boxes, *a))
    got_det, got_valid = nms_planar(torch.from_numpy(z), 0.25, 0.45, max_nms=1024, max_det=300)
    assert calls == [(8, 1024, 4)]
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert got_valid.sum(1).min() > 10
    np.testing.assert_allclose(got_det.numpy(), np.asarray(want_det), rtol=1e-5, atol=1e-5)


def _chain_boxes(n, n_valid=None):
    """The deepest suppression chain: unit boxes a quarter apart, so each
    overlaps the next (IoU 0.6) and not the one after (0.33); greedy keeps
    every other row.  Coordinates are exact in float32."""
    x = np.arange(n, dtype=np.float32) * 0.25
    boxes = np.stack([x, np.zeros_like(x), x + 1, np.ones_like(x)], 1)
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    scores[n if n_valid is None else n_valid:] = 0.0
    return boxes, scores


def _k3_sets():
    """(name, boxes, scores, iou): the clustered sets above, the chain and
    an all-invalid list."""
    sets = []
    for n, n_valid, iou in [(128, 128, 0.45), (256, 200, 0.45), (256, 256, 0.6)]:
        boxes, scores = _clustered_boxes(np.random.RandomState(n + n_valid), n, n_valid)
        sets.append((f"clustered{n}_{n_valid}", boxes, scores, iou))
    sets.append(("chain", *_chain_boxes(256), 0.45))
    boxes, _ = _clustered_boxes(np.random.RandomState(5), 128, 128)
    sets.append(("all_invalid", boxes, np.zeros(128, np.float32), 0.45))
    return sets


@pytest.mark.parametrize("name,boxes,scores,iou", _k3_sets(), ids=[s[0] for s in _k3_sets()])
@pytest.mark.parametrize("max_det", [7, 128])
def test_nms_packed_plain_equals_jax_pack_keep(name, boxes, scores, iou, max_det):
    """K3's packed output (plain version here) equals the JAX package's
    ``_pack_keep(nms_fixpoint_pallas(...))`` in interpret mode: exact."""
    from multiyolov5_tpu.ops.nms import _pack_keep
    keep = nms_fixpoint_pallas(jnp.asarray(boxes), jnp.asarray(scores), iou)
    want_idx, want_valid = _pack_keep(keep, max_det)
    got_idx, got_valid = nms_packed(torch.from_numpy(boxes), torch.from_numpy(scores), iou,
                                    max_det)
    assert got_idx.dtype == torch.int64 and got_valid.dtype == torch.bool
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    if name == "all_invalid":
        assert (got_idx.numpy() == -1).all() and not got_valid.any()


def _k3_walk(boxes, scores, iou, ctas, max_det):
    """csrc/nms.cu in numpy: the build's items over ``ctas`` CTAs (each word
    w of row j written once, for j < 32 (w + 1)), then the sweep, a lane a
    word: the candidates no candidate of the word suppresses kept at once,
    the others walked in order, and only the kept rows that suppress a row
    of a later word ORed into it; then the pack from the keep words' prefix
    counts."""
    n = boxes.shape[0]
    nw = -(-n // 32)
    sup = suppression(torch.from_numpy(boxes), iou).numpy()
    pad = np.zeros((n, 32 * nw), bool)
    pad[:, :n] = sup
    words = (pad.reshape(n, nw, 32) * (1 << np.arange(32, dtype=np.uint64))).sum(2)
    mask = np.full((nw, n), -1, np.int64)          # [w][j]; -1: never written
    pairs = word_pairs(n)
    for rank in range(ctas):
        for p in range(rank, len(pairs), ctas):
            for w in pairs[p]:
                for j in range(min(32 * (w + 1), n)):
                    assert mask[w, j] == -1, "an item built twice"
                    mask[w, j] = words[j, w]
    valid = np.zeros(32 * nw, bool)
    valid[:n] = scores > 0
    valid_w = [int((valid[32 * w:32 * w + 32] * (1 << np.arange(32))).sum()) for w in range(nw)]
    anyrow = [0] * nw                    # rows that suppress a row of a later word
    for j in range(n):
        if any(mask[w, j] for w in range((j >> 5) + 1, nw)):
            anyrow[j >> 5] |= 1 << (j & 31)
    removed, keep_w = [0] * nw, [0] * nw
    for W in range(nw):
        cand = valid_w[W] & ~removed[W] & 0xffffffff
        if not cand:
            continue
        d = [int(mask[W, 32 * W + b]) if 32 * W + b < n else 0 for b in range(32)]
        assert all(v >= 0 for v in d), "the sweep read a word no item wrote"
        sup0 = 0
        for b in range(32):
            if (cand >> b) & 1:
                sup0 |= d[b]
        a_set = cand & sup0              # suppressed by a candidate of the word
        kept = cand & ~a_set
        sup = 0
        for b in range(32):
            if (kept >> b) & 1:
                sup |= d[b]
        for i in range(32):
            if (a_set >> i) & 1 and not (sup >> i) & 1:
                kept |= 1 << i
                sup |= d[i]
        keep_w[W] = kept
        for i in range(32):
            if (kept & anyrow[W]) >> i & 1:
                for w in range(W + 1, nw):
                    assert mask[w, 32 * W + i] >= 0, "the sweep read a word no item wrote"
                    removed[w] |= int(mask[w, 32 * W + i])
    keep = np.array([(keep_w[t >> 5] >> (t & 31)) & 1 for t in range(n)], bool)
    off = np.concatenate([[0], np.cumsum([bin(k).count("1") for k in keep_w])])
    idx = np.full(max_det, -1, np.int64)
    for t in np.flatnonzero(keep):
        pos = off[t >> 5] + bin(keep_w[t >> 5] & ((1 << (t & 31)) - 1)).count("1")
        if pos < max_det:
            idx[pos] = t
    return keep, idx, np.arange(max_det) < off[-1]


@pytest.mark.parametrize("n", [1, 31, 33, 100, 1024])
@pytest.mark.parametrize("ctas", [1, 3, 16])
def test_k3_walk_equals_plain(n, ctas):
    """The kernel's build partition covers the mask's triangle once at any
    CTA count, its sweep reads only words the build wrote, and its keep
    mask and packed output equal the plain versions: exact."""
    rng = np.random.RandomState(n + ctas)
    boxes, scores = _clustered_boxes(rng, n, n - n // 5)
    for b, s, iou in [(boxes, scores, 0.45), (*_chain_boxes(n), 0.45),
                      (boxes, np.zeros_like(scores), 0.45)]:
        tb, ts = torch.from_numpy(b), torch.from_numpy(s)
        keep, idx, valid = _k3_walk(b, s, iou, min(ctas, len(word_pairs(n))), 300)
        np.testing.assert_array_equal(keep, nms_plain(tb, ts, iou).numpy())
        want_idx, want_valid = nms_packed_plain(tb, ts, iou, 300)
        np.testing.assert_array_equal(idx, want_idx.numpy())
        np.testing.assert_array_equal(valid, want_valid.numpy())


def test_k3_plan():
    """One CTA a pair of mask words at most; the shared memory is the
    kernel's layout (boxes and areas, the [32][n + 1] mask words)."""
    assert plan(1024) == Plan(16, 20 * 1024 + 4 * 32 * 1025) == Plan(16, smem_bytes(1024))
    assert plan(1).ctas == 1 and plan(33).ctas == 1 and plan(65).ctas == 2
    assert plan(1024, ctas=8).ctas == 8
    for bad in ((1025, None), (1024, 17), (1024, 0)):
        with pytest.raises(ValueError):
            plan(*bad)
