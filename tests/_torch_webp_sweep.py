"""A seeded sweep of WebP files through the port's decoders against cv2's and
Pillow's (the larger run behind tests/test_torch_webp.py's cases).

Each round makes, with ``_torch_webp_files`` (libwebp through ctypes), a
lossy file at one of its settings and a random quality, the same with an
ALPH plane, a lossless file, and every third round a VP8X file with an EXIF
orientation 0-9 (with and without the ``Exif\\0\\0`` prefix) or an animation
of 1-3 frames at random offsets, blend, dispose and background; sides of
1-69 px, every tenth round 100-259.  Each file's ``imread``, ``read_rgb``,
``read_samples`` and ``size`` are held to cv2's and Pillow's at 0
differing values; files that differ are written under ``--out``.

Run from the repository's root:
``python tests/_torch_webp_sweep.py --rounds 1000 --seed 11 --out /tmp/webp_sweep``
"""

import argparse
import os
import sys

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import _torch_webp_files as wf  # noqa: E402
from multiyolov5_tpu_torch.data import webp  # noqa: E402


def differs(path: str) -> list:
    """The reads of ``path`` that differ from the libraries'."""
    out = []
    want = cv2.imread(path)
    with Image.open(path) as im:
        rgb, size = np.asarray(im.convert("RGB")), im.size
    with Image.open(path) as im:
        samples = np.array(im)
    try:
        for name, got, ref in (("imread", webp.imread(path), want),
                               ("read_rgb", webp.read_rgb(path), rgb),
                               ("read_samples", webp.read_samples(path), samples)):
            if ref is None or got.shape != ref.shape or (got != ref).any():
                out.append(name)
        if webp.size(path) != size:
            out.append("size")
    except ValueError as e:
        out.append(f"raised {e}")
    return out


def files(rng, i: int):
    """Round ``i``'s (kind, bytes)."""
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    if i % 10 == 0:
        h, w = int(rng.integers(100, 260)), int(rng.integers(100, 260))
    kind = int(rng.integers(0, 4))
    s = dict(wf.lossy_settings()[int(rng.integers(16))], quality=float(rng.integers(0, 101)))
    yield "lossy", wf.encode(wf.picture(rng, h, w, kind), **s)
    s.update(wf.alpha_settings()[int(rng.integers(12))])
    yield "alpha", wf.encode(wf.picture(rng, h, w, kind, alpha=True), **s)
    ll = dict(wf.lossless_settings()[int(rng.integers(8))], quality=float(rng.integers(0, 101)))
    yield "lossless", wf.encode(wf.picture(rng, h, w, kind, alpha=bool(i % 2)), **ll)
    if i % 3 == 0:
        base = wf.encode(wf.picture(rng, h, w, kind, alpha=bool(i % 2)), quality=50,
                         lossless=i % 2)
        yield "exif", wf.with_exif(base, int(rng.integers(0, 10)), prefix=i % 4 == 0)
    if i % 3 == 1:
        cw, ch = w + 2 * int(rng.integers(0, 20)), h + 2 * int(rng.integers(0, 20))
        frames = []
        for _ in range(int(rng.integers(1, 4))):
            fw, fh = int(rng.integers(1, cw + 1)), int(rng.integers(1, ch + 1))
            x = 2 * int(rng.integers(0, (cw - fw) // 2 + 1))
            y = 2 * int(rng.integers(0, (ch - fh) // 2 + 1))
            frames.append((wf.encode(wf.picture(rng, fh, fw, kind, alpha=bool(rng.integers(2))),
                                     quality=float(rng.integers(0, 100)),
                                     lossless=int(rng.integers(2))), x, y))
        n = len(frames)
        yield "anim", wf.animation(frames, (cw, ch), background=int(rng.integers(0, 2 ** 32)),
                                   blend=[bool(rng.integers(2)) for _ in range(n)],
                                   dispose=[bool(rng.integers(2)) for _ in range(n)],
                                   alpha=bool(rng.integers(2)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="webp_sweep")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    path = os.path.join(args.out, "f.webp")
    counts = {}
    for i in range(args.rounds):
        for kind, data in files(rng, i):
            with open(path, "wb") as fh:
                fh.write(data)
            bad = differs(path)
            n, nbad = counts.get(kind, (0, 0))
            counts[kind] = (n + 1, nbad + bool(bad))
            if bad:
                os.replace(path, os.path.join(args.out, f"{args.seed}_{i}_{kind}.webp"))
                print(i, kind, bad, flush=True)
    print({k: {"files": n, "differing": b} for k, (n, b) in counts.items()})


if __name__ == "__main__":
    main()
