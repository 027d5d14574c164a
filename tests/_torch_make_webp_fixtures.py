"""Writes chip_smoke.py [20]'s WebP fixtures and the digests of their decodes.

The card's machine has neither cv2 nor Pillow for certain, so [20] holds
the port's decodes there to SHA-256s taken here of cv2's ``imread`` and
Pillow's ``convert("RGB")`` and ``np.array`` arrays.  The files are
libwebp's (``WebPEncode`` through ``_torch_webp_files``), seeded:

* ``lossy_2048x1024.webp``: a 2048x1024 frame, 4 segments, 8 partitions,
  the normal loop filter;
* ``simple_640x360.webp``: the simple loop filter, sharpness 6, 2 segments;
* ``alpha_640x360.webp``: VP8 + a VP8L-coded, filtered ALPH plane whose
  levels were reduced (the pre-processing flag);
* ``exif6_400x300.webp``: VP8X with EXIF orientation 6 (cv2 turns it);
* ``anim_320x240.webp``: an animation whose first frame sits at an offset.

Run from the repository's root: ``python tests/_torch_make_webp_fixtures.py``
(writes ``tests/webp_fixtures/``; tests/test_torch_image_callers.py holds
the digests to both libraries).
"""

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "webp_fixtures")


def photo(rng, h, w):
    """A smooth seeded picture with a little noise (a lossy codec's input)."""
    y, x = np.mgrid[:h, :w].astype(np.float32)
    base = np.stack([128 + 90 * np.sin(x / (37.0 + 9 * c) + c) * np.cos(y / (23.0 + 5 * c) - c)
                     for c in range(3)], -1)
    base[(x.astype(int) // 128 + y.astype(int) // 96) % 5 == 0] *= 0.5
    return np.clip(base + rng.normal(0, 3, base.shape), 0, 255).astype(np.uint8)


def fixtures() -> dict:
    sys.path.insert(0, HERE)
    import _torch_webp_files as wf
    rng = np.random.default_rng(2025)
    big = photo(rng, 1024, 2048)
    mid = photo(rng, 360, 640)
    yy, xx = np.mgrid[:360, :640]
    alpha = np.clip(np.hypot(yy - 180, xx - 320) * 1.2, 0, 255).astype(np.uint8)
    small = photo(rng, 240, 320)
    return {
        "lossy_2048x1024.webp": wf.encode(big, quality=80, segments=4, partitions=3,
                                          filter_type=1, filter_sharpness=2, method=4),
        "simple_640x360.webp": wf.encode(mid, quality=50, segments=2, partitions=1,
                                         filter_type=0, filter_strength=60,
                                         filter_sharpness=6),
        "alpha_640x360.webp": wf.encode(np.concatenate([mid[::-1], alpha[..., None]], -1),
                                        quality=70, alpha_compression=1, alpha_filtering=2,
                                        alpha_quality=80),
        "exif6_400x300.webp": wf.with_exif(wf.encode(photo(rng, 300, 400), quality=85), 6),
        "anim_320x240.webp": wf.animation(
            [(wf.encode(small[:120, :160], quality=75), 64, 40),
             (wf.encode(small, quality=60), 0, 0)], (320, 240), alpha=False),
    }


def digests(path: str) -> dict:
    import cv2
    from PIL import Image
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    with Image.open(path) as im:
        samples = np.array(im)
    return {"cv2": sha(cv2.imread(path)), "rgb": sha(rgb), "samples": sha(samples)}


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    out = {}
    for name, data in fixtures().items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as fh:
            fh.write(data)
        out[name] = digests(path)
        print(name, len(data))
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
