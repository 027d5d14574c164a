"""``utils/metrics.seg_confusion_device`` on the card.

Marked ``cuda``: the test decides inside itself whether a card is present
and skips otherwise.  Run on a machine with an H100 by ``pytest -m cuda
tests/test_torch_metrics_cuda.py`` (no JAX is imported).  Seeded NCHW
logits at 19 classes and labels with -1: the card's integer counts equal
the host ``SegMetric`` histograms of the same argmax, with no bound, at a
small shape and at a full 1024 x 2048 frame (bs2).
"""

import numpy as np
import pytest
import torch

from multiyolov5_tpu_torch.utils.metrics import SegMetric, seg_confusion_device

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("shape", [(2, 19, 24, 40), (2, 19, 1024, 2048)], ids=["small", "full"])
def test_seg_confusion_device_on_card_equals_segmetric(shape):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.RandomState(0)
    b, c, h, w = shape
    logits = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    target = torch.from_numpy(rng.randint(-1, c, (b, h, w))).cuda()
    inter, union = seg_confusion_device(logits, target, c)
    assert inter.device.type == "cuda" and inter.dtype == torch.int64
    m = SegMetric(c)
    m.update(logits.argmax(1).cpu().numpy(), target.cpu().numpy())
    assert np.array_equal(inter.cpu().numpy(), m.total_inter)
    assert np.array_equal(union.cpu().numpy(), m.total_union)
