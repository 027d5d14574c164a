"""MPO (a JPEG whose first frame is the image) through the port's JPEG
codec and ``data/images.py``, against cv2 (OpenCV 5.0) and PIL (Pillow
12.1), on the CPU: two- and three-frame files written by Pillow's MPO
writer and by tests/_torch_image_writers.py, the first frame's EXIF
orientation 1-8, frames of other sizes after it.  ``imread`` equals
``cv2.imread`` (orientation applied), ``read_rgb`` / ``read_samples``
equal ``Image.open(p).convert("RGB")`` / ``np.array(Image.open(p))`` (the
first frame, not turned), ``size`` ``.size`` and ``exif_size`` the JAX
``exif_size``: 0 differing values.  ``imwrite`` of ``.mpo`` raises as
``cv2.imwrite`` does (it has no MPO writer); a gray JPEG's samples are
(H, W), as PIL's mode ``L`` gives them; a WebP file under any suffix reads as cv2 and PIL read it.
"""

import io

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_image_writers as W
from multiyolov5_tpu.data.detection import exif_size as jax_exif_size
from multiyolov5_tpu_torch.data import images, jpeg


def _frame(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 2 + yy, yy * 3, (xx + yy) // 2], -1)
    return ((base + rng.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


@pytest.mark.parametrize("writer", ["pil", "port"])
def test_mpo_reads_its_first_frame(tmp_path, writer):
    rng = np.random.RandomState(1)
    for o in range(0, 9):
        first, rest = _frame(rng, 40, 64), [_frame(rng, 24, 30), _frame(rng, 64, 40)]
        path = str(tmp_path / f"m{o}.mpo")
        if writer == "pil":
            exif = Image.Exif()
            if o:
                exif[274] = o
            Image.fromarray(first).save(path, format="MPO", save_all=True,
                                        append_images=[Image.fromarray(f) for f in rest],
                                        exif=exif.tobytes(), quality=90)
        else:
            data = jpeg.encode(first, 90)
            if o:
                body = b"Exif\x00\x00" + W.exif_tiff(o, ">")
                data = data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big") + body + \
                    data[2:]
            with open(path, "wb") as fh:
                fh.write(W.mpo([data] + [jpeg.encode(f, 75) for f in rest]))
        with Image.open(path) as im:
            assert im.format == "MPO" and im.n_frames == 3
            want_rgb, want_samples, want_size = np.asarray(im.convert("RGB")), np.array(im), \
                im.size
        want = cv2.imread(path)
        assert want.shape[:2] == ((64, 40) if o in (5, 6, 7, 8) else (40, 64))
        assert (images.imread(path) != want).sum() == 0, o
        assert (images.read_rgb(path) != want_rgb).sum() == 0, o
        got = images.read_samples(path)
        assert got.shape == want_samples.shape and (got != want_samples).sum() == 0, o
        assert images.size(path) == want_size
        verified = Image.open(path)
        verified.verify()
        assert images.exif_size(path) == jax_exif_size(verified) == \
            jax_exif_size(Image.open(path)), o


def test_mpo_write_raises_as_cv2(tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(cv2.error, match="could not find a writer"):
        cv2.imwrite(str(tmp_path / "a.mpo"), img)
    with pytest.raises(ValueError, match="could not find a writer"):
        images.imwrite(str(tmp_path / "a.mpo"), img)
    for name in ("a._masktiff", "noext"):           # the JAX app's names for a .tiff source
        with pytest.raises(cv2.error):
            cv2.imwrite(str(tmp_path / name), img)
        with pytest.raises(ValueError, match="could not find a writer"):
            images.imwrite(str(tmp_path / name), img)
    assert cv2.imwrite(str(tmp_path / "c.dib"), img) and images.imwrite(str(tmp_path / "p.dib"),
                                                                        img)
    assert (tmp_path / "c.dib").read_bytes() == (tmp_path / "p.dib").read_bytes()


def test_gray_jpeg_samples_and_webp(tmp_path):
    rng = np.random.RandomState(2)
    path = str(tmp_path / "g.jpg")
    cv2.imwrite(path, _frame(rng, 30, 50)[..., 1])
    want = np.array(Image.open(path))
    assert Image.open(path).mode == "L"
    got = images.read_samples(path)
    assert got.shape == want.shape == (30, 50) and (got != want).sum() == 0
    buf = io.BytesIO()
    Image.fromarray(_frame(rng, 8, 8)).save(buf, "WEBP")
    webp = tmp_path / "x.png"                          # a WebP under any suffix
    webp.write_bytes(buf.getvalue())
    assert (images.imread(str(webp)) != cv2.imread(str(webp))).sum() == 0
    assert (images.read_rgb(str(webp)) != np.asarray(Image.open(webp).convert("RGB"))).sum() == 0
