"""Port's folded stem (K1's plain version) against the JAX package.

The same seeded uint8 frame and stem weights go through
``multiyolov5_tpu_torch.ops.kernels.stem_plain`` and through the JAX u8 Pallas
kernel (interpret mode on the CPU) and the XLA ``stem_apply``.  float32 on
both sides; the /255 fold into conv1's weights and the conv summation order
differ, so outputs agree to 1e-4 absolute (|y| is O(1)).  K1's float mode
(B1c): the same on a seeded float32 frame in [0, 1], off the k/255 lattice,
with w1 unscaled, against ``stem_apply_pallas`` (interpret mode) and
``stem_apply`` on its space-to-depth, to 1e-4 absolute.  A bfloat16 output
rounds as the TPU kernels do in bf16 (bf16 operands, a bf16 y1): against
``stem_apply_pallas_u8(out_dtype=bfloat16)`` and ``stem_apply_pallas`` on
a bf16 space-to-depth, to one bf16 ulp (see ``_assert_bf16_close``).
Frames of 1 and 4 channels (16 and 64 conv1 inputs) in every mode against
the same JAX functions under the same bounds, and the packed weights of
both forms at those widths by their index formulas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multiyolov5_tpu.engine import space_to_depth_host
from multiyolov5_tpu.ops import stem as jax_stem
from multiyolov5_tpu.ops.pallas.stem_kernel import (pack_stem96_host,
                                                    stem_apply_pallas,
                                                    stem_apply_pallas_u8,
                                                    stem_pack_geometry)
from multiyolov5_tpu_torch.ops import stem as torch_stem
from multiyolov5_tpu_torch.ops.kernels import stem, stem_plain
from multiyolov5_tpu_torch.ops.kernels.stem import (CHUNK, _packed, pack_weights,
                                                    pack_weights_tf32, space_to_depth4,
                                                    tf32_split)
from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4


def _weights(rng, c2, c2b, c1=3):
    w0 = rng.randn(3, 3, 4 * c1, c2).astype(np.float32) * 0.2
    b0 = rng.randn(c2).astype(np.float32) * 0.1
    w1 = rng.randn(3, 3, c2, c2b).astype(np.float32) * 0.2
    b1 = rng.randn(c2b).astype(np.float32) * 0.1
    return w0, b0, w1, b1


# (b, h, w, c2, c2b): a narrow stem, and the s-width stem (c_mid 128, c_out 64)
@pytest.mark.parametrize("b,h,w,c2,c2b", [(2, 32, 64, 16, 24), (1, 64, 96, 32, 64)])
def test_stem_plain_matches_jax(b, h, w, c2, c2b):
    rng = np.random.RandomState(10 + h)
    w0, b0, w1, b1 = _weights(rng, c2, c2b)
    fw = jax_stem.fold_stem_weights(w0, b0, w1, b1)
    fw_port = torch_stem.fold_stem_weights(w0, b0, w1, b1)
    for a, p in zip(fw, fw_port):
        np.testing.assert_array_equal(a, p)
    frame = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)

    x48 = space_to_depth_host(space_to_depth_host(frame))
    np.testing.assert_array_equal(
        space_to_depth4(torch.from_numpy(frame)).permute(0, 2, 3, 1).numpy(), x48)

    hq, wq = h // 4, w // 4
    cp, _ = stem_pack_geometry(hq, wq)
    want_kernel = np.asarray(stem_apply_pallas_u8(
        jnp.asarray(pack_stem96_host(x48, cp)), *fw, cols=wq,
        out_dtype=jnp.float32))
    want_xla = np.asarray(jax_stem.stem_apply(
        jnp.asarray(x48, jnp.float32) / 255.0, *fw))

    w1p, b1p, w2p, b2p = (torch.from_numpy(a) for a in fw)
    w1p = w1p * np.float32(1.0 / 255.0)
    got = stem(torch.from_numpy(frame), w1p, b1p, w2p, b2p)   # CPU: plain
    got_plain = stem_plain(torch.from_numpy(frame), w1p, b1p, w2p, b2p)
    assert got.shape == (b, hq, wq, c2b)
    np.testing.assert_array_equal(got.numpy(), got_plain.numpy())
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=ATOL)


# the same two stems, on float frames: K1's float mode
@pytest.mark.parametrize("b,h,w,c2,c2b", [(2, 32, 64, 16, 24), (1, 64, 96, 32, 64)])
def test_stem_float_mode_matches_jax(b, h, w, c2, c2b):
    rng = np.random.RandomState(20 + h)
    fw = jax_stem.fold_stem_weights(*_weights(rng, c2, c2b))
    frame = rng.rand(b, h, w, 3).astype(np.float32)
    x48 = space_to_depth_host(space_to_depth_host(frame))
    want_kernel = np.asarray(stem_apply_pallas(jnp.asarray(x48), *fw))
    want_xla = np.asarray(jax_stem.stem_apply(jnp.asarray(x48), *fw))

    w1p, b1p, w2p, b2p = (torch.from_numpy(a) for a in fw)
    got = stem(torch.from_numpy(frame), w1p, b1p, w2p, b2p)     # CPU: plain
    got_plain = stem_plain(torch.from_numpy(frame), w1p, b1p, w2p, b2p)
    assert got.shape == (b, h // 4, w // 4, c2b)
    np.testing.assert_array_equal(got.numpy(), got_plain.numpy())
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=ATOL)


# bf16 output: the same two stems, against the TPU kernel's bf16 rounding
@pytest.mark.parametrize("b,h,w,c2,c2b", [(2, 32, 64, 16, 24), (1, 64, 96, 32, 64)])
def test_stem_plain_bf16_matches_jax(b, h, w, c2, c2b):
    rng = np.random.RandomState(30 + h)
    fw = jax_stem.fold_stem_weights(*_weights(rng, c2, c2b))
    w1p, b1p, w2p, b2p = (torch.from_numpy(a) for a in fw)
    hq, wq = h // 4, w // 4

    # uint8 frame: the /255 folded into w1 before its bf16 rounding, as
    # stem_apply_pallas_u8 folds it (stem_kernel.py:178-181)
    frame = (rng.rand(b, h, w, 3) * 255).astype(np.uint8)
    x48 = space_to_depth_host(space_to_depth_host(frame))
    cp, _ = stem_pack_geometry(hq, wq)
    want = np.asarray(stem_apply_pallas_u8(
        jnp.asarray(pack_stem96_host(x48, cp)), *fw, cols=wq,
        out_dtype=jnp.bfloat16).astype(jnp.float32))
    got = stem(torch.from_numpy(frame), w1p * np.float32(1.0 / 255.0), b1p, w2p, b2p,
               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (b, hq, wq, c2b)
    _assert_bf16_close(got.float().numpy(), want)

    # float frame on its bf16 space-to-depth: stem_apply_pallas in bf16
    frame = rng.rand(b, h, w, 3).astype(np.float32)
    x48 = space_to_depth_host(space_to_depth_host(frame))
    want = np.asarray(stem_apply_pallas(jnp.asarray(x48, jnp.bfloat16), *fw)
                      .astype(jnp.float32))
    got = stem(torch.from_numpy(frame), w1p, b1p, w2p, b2p, out_dtype=torch.bfloat16)
    _assert_bf16_close(got.float().numpy(), want)


# frames of other channel counts: uint8 and float, float32 and bf16 outputs
@pytest.mark.parametrize("ch", [1, 4])
def test_stem_channels_match_jax(ch):
    b, h, w, c2, c2b = 2, 32, 64, 16, 24
    rng = np.random.RandomState(40 + ch)
    w0, b0, w1, b1 = _weights(rng, c2, c2b, ch)
    fw = jax_stem.fold_stem_weights(w0, b0, w1, b1)
    for a, p in zip(fw, torch_stem.fold_stem_weights(w0, b0, w1, b1)):
        np.testing.assert_array_equal(a, p)
    w1p, b1p, w2p, b2p = (torch.from_numpy(a) for a in fw)
    assert w1p.shape == (3, 3, 16 * ch, c2 * 4)
    hq, wq = h // 4, w // 4
    cp, _ = stem_pack_geometry(hq, wq)

    frame = (rng.rand(b, h, w, ch) * 255).astype(np.uint8)
    x16 = space_to_depth_host(space_to_depth_host(frame))
    np.testing.assert_array_equal(
        space_to_depth4(torch.from_numpy(frame)).permute(0, 2, 3, 1).numpy(), x16)
    packed = jnp.asarray(pack_stem96_host(x16, cp))
    w1u = w1p * np.float32(1.0 / 255.0)
    got = stem(torch.from_numpy(frame), w1u, b1p, w2p, b2p)     # CPU: plain
    assert got.shape == (b, hq, wq, c2b)
    np.testing.assert_allclose(got.numpy(), np.asarray(stem_apply_pallas_u8(
        packed, *fw, cols=wq, out_dtype=jnp.float32)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_stem.stem_apply(
        jnp.asarray(x16, jnp.float32) / 255.0, *fw)), rtol=0, atol=ATOL)
    got = stem(torch.from_numpy(frame), w1u, b1p, w2p, b2p, out_dtype=torch.bfloat16)
    _assert_bf16_close(got.float().numpy(), np.asarray(stem_apply_pallas_u8(
        packed, *fw, cols=wq, out_dtype=jnp.bfloat16).astype(jnp.float32)))

    frame = rng.rand(b, h, w, ch).astype(np.float32)
    x16 = space_to_depth_host(space_to_depth_host(frame))
    got = stem(torch.from_numpy(frame), w1p, b1p, w2p, b2p)
    np.testing.assert_allclose(got.numpy(), np.asarray(stem_apply_pallas(
        jnp.asarray(x16), *fw)), rtol=0, atol=ATOL)
    got = stem(torch.from_numpy(frame), w1p, b1p, w2p, b2p, out_dtype=torch.bfloat16)
    _assert_bf16_close(got.float().numpy(), np.asarray(stem_apply_pallas(
        jnp.asarray(x16, jnp.bfloat16), *fw).astype(jnp.float32)))


def _assert_bf16_close(got, want):
    """Both sides multiply the same bf16 operands exactly and sum in float32
    in different orders, so a y1 or output value near a rounding boundary
    can land on the neighbouring bf16.  Measured: equal in 3 of the 4 cases,
    at most 2.4e-4 of the values differing, by at most 0.035 of a bf16 ulp
    of the output's scale.  Bound: one bf16 ulp (2^-8) of the scale and
    1e-3 of the values.  Rounding only the output (float32 operands and y1,
    the port's earlier bf16 mode) puts 52-60% of the values off, by up to
    1.3 ulps."""
    scale = max(np.abs(want).max(), 1.0)
    diff = np.abs(got - want)
    assert diff.max() <= 2.0 ** -8 * scale
    assert (diff > 0).mean() <= 1e-3


def _rna_tf32_reference(w):
    """w rounded to 11 significant bits (to a multiple of 2^-136 below
    float32's normal range, as tf32's subnormals), ties away from zero, in
    float64 arithmetic (independent of the bit trick)."""
    w = w.astype(np.float64)
    _, e = np.frexp(w)
    q = 2.0 ** np.maximum(e - 11, -136)
    return (np.sign(w) * np.floor(np.abs(w) / q + 0.5) * q).astype(np.float32)


def test_tf32_split():
    rng = np.random.RandomState(5)
    w = np.concatenate([rng.randn(4096) * 10.0 ** rng.uniform(-6, 3, 4096),
                        [1.0, -1.0, 3e-38, -7e4]]).astype(np.float32)
    ties = (rng.randint(0x30000000, 0x50000000, 64) & ~0x1FFF | 0x1000).astype(np.int32)
    w = np.concatenate([w, ties.view(np.float32), -ties.view(np.float32)])
    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(w)))
    assert not (hi.view(np.int32) & 0x1FFF).any()
    assert not (lo.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _rna_tf32_reference(w))
    np.testing.assert_array_equal(lo, _rna_tf32_reference(w - hi))
    # where lo stays in float32's normal range (weights are far from 2^-104)
    err = np.abs(w.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    normal = np.abs(w) >= 2.0 ** -104
    assert normal.sum() == len(w) - 1 and (err <= 2.0 ** -21 * np.abs(w))[normal].all()


def _unpack(p, fields, k_of, n_of, shape):
    """Scatter packed weights back to ``shape`` by a docstring's index
    formula: ``fields`` names p's axes, ``k_of`` and ``n_of`` map the index
    arrays to the row and column of the (part, ..., k, n) target."""
    idx = dict(zip(fields, np.indices(p.shape)))
    lead = tuple(idx[f].ravel() for f in shape[1])
    out = np.full(shape[0], np.nan, np.float32)
    count = np.zeros(shape[0], np.int64)
    at = lead + (k_of(idx).ravel(), n_of(idx).ravel())
    out[at] = p.float().numpy().ravel()
    np.add.at(count, at, 1)
    assert (count == 1).all()          # each weight (and pad) packed exactly once
    return out


@pytest.mark.parametrize("form", ["bf16", "tf32"])
@pytest.mark.parametrize("c_mid,c_out", [(32, 16), (128, 64), (320, 160)])
def test_pack_weights_round_trip(form, c_mid, c_out):
    _pack_round_trip(form, c_mid, c_out, 3)


# conv1's K at frames of 1 and 4 channels: 144 and 576 rows
@pytest.mark.parametrize("form", ["bf16", "tf32"])
@pytest.mark.parametrize("ch", [1, 4])
def test_pack_weights_round_trip_channels(form, ch):
    _pack_round_trip(form, 128, 64, ch)


def _pack_round_trip(form, c_mid, c_out, c_in):
    rng = np.random.RandomState(c_mid + c_out)
    k = 144 * c_in
    w1 = rng.randn(3, 3, 16 * c_in, c_mid).astype(np.float32)
    w2 = rng.randn(2, 2, c_mid, c_out).astype(np.float32)
    cm_p, co_p, ch = -(-c_mid // CHUNK) * CHUNK, -(-c_out // 32) * 32, CHUNK
    m1 = np.zeros((k, cm_p), np.float32)
    m1[:, :c_mid] = w1.reshape(k, c_mid)
    m2 = np.zeros((4, cm_p, co_p), np.float32)
    m2[:, :c_mid, :c_out] = w2.reshape(4, c_mid, c_out)
    packer = pack_weights if form == "bf16" else pack_weights_tf32
    p1, p2 = packer(torch.from_numpy(w1), torch.from_numpy(w2))
    if form == "bf16":
        assert p1.dtype == p2.dtype == torch.bfloat16
        got1 = _unpack(p1, ["c", "k", "n16", "g", "t", "nt", "h", "e"],
                       lambda i: 16 * i["k"] + 8 * i["h"] + 2 * i["t"] + i["e"],
                       lambda i: ch * i["c"] + 16 * i["n16"] + 8 * i["nt"] + i["g"],
                       (m1.shape, ()))
        got2 = _unpack(p2, ["c", "tap", "k", "n16", "g", "t", "nt", "h", "e"],
                       lambda i: ch * i["c"] + 16 * i["k"] + 8 * i["h"] + 2 * i["t"] + i["e"],
                       lambda i: 16 * i["n16"] + 8 * i["nt"] + i["g"],
                       (m2.shape, ("tap",)))
        want1, want2 = (torch.from_numpy(m).to(torch.bfloat16).float().numpy()
                        for m in (m1, m2))
        np.testing.assert_array_equal(got1, want1)
        np.testing.assert_array_equal(got2, want2)
        return
    assert p1.dtype == p2.dtype == torch.float32
    got1 = _unpack(p1, ["c", "k", "n16", "part", "g", "t", "nt", "h"],
                   lambda i: 8 * i["k"] + 4 * i["h"] + i["t"],
                   lambda i: ch * i["c"] + 16 * i["n16"] + 8 * i["nt"] + i["g"],
                   ((2, *m1.shape), ("part",)))
    got2 = _unpack(p2, ["c", "tap", "k", "n16", "part", "g", "t", "nt", "h"],
                   lambda i: ch * i["c"] + 8 * i["k"] + 4 * i["h"] + i["t"],
                   lambda i: 16 * i["n16"] + 8 * i["nt"] + i["g"],
                   ((2, *m2.shape), ("part", "tap")))
    for got, m in ((got1, m1), (got2, m2)):
        hi = _rna_tf32_reference(m)
        np.testing.assert_array_equal(got[0], hi)
        np.testing.assert_array_equal(got[1], _rna_tf32_reference(m - hi))


def test_packed_cache_keeps_each_form():
    """The packed copies of both forms live side by side on w1: alternating
    output types neither repacks nor hands one form the other's copy; an
    in-place update of w2 repacks."""
    g = torch.Generator().manual_seed(3)
    w1, w2 = torch.randn(3, 3, 48, 64, generator=g), torch.randn(2, 2, 64, 32, generator=g)
    f32, bf16 = _packed(w1, w2, torch.float32), _packed(w1, w2, torch.bfloat16)
    assert f32[0].dtype == torch.float32 and bf16[0].dtype == torch.bfloat16
    for _ in range(2):
        assert _packed(w1, w2, torch.float32) is f32
        assert _packed(w1, w2, torch.bfloat16) is bf16
    w2.mul_(2)
    again = _packed(w1, w2, torch.float32)
    assert again is not f32
    torch.testing.assert_close(again[1], pack_weights_tf32(w1, w2)[1], rtol=0, atol=0)
    assert _packed(w1, w2, torch.bfloat16) is not bf16
