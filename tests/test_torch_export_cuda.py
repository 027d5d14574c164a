"""The export CLI (multiyolov5_tpu_torch/cli/export.py) on the card.

Marked ``cuda``: the test decides inside itself whether a card is present
and skips otherwise.  Run on a machine with an H100 by ``pytest -m cuda
tests/test_torch_export_cuda.py`` (no JAX is imported).  pspv5s narrowed to
width 0.125 (seeded weights, seed 0) is exported at 128x256 in both
formats, with and without ``--raw``, traced on the card; each artifact is
loaded back on the card and must give the live plain build's outputs on
a seeded frame to 1e-6 of their scale (TF32 off: the same cuDNN graph).
"""

import argparse

import numpy as np
import pytest
import torch

from multiyolov5_tpu_torch.cli import export as port_export
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.models import zoo

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("raw", [False, True], ids=["decoded", "raw"])
def test_export_roundtrip_on_card(tmp_path, raw):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    cfg = zoo.get("yolov5s_city_seg")
    cfg["width_multiple"] = 0.125
    made = port_export.export(argparse.Namespace(
        weights="", cfg=cfg, img_size=[128, 256], batch_size=1,
        include=["torchscript", "export"], raw=raw, output=str(tmp_path), device=""))
    eng = Engine(cfg=cfg, device="cuda", half=False)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 128, 256).astype(np.float32)).cuda()
    with torch.no_grad():
        live = port_export.ExportModel(port_export.plain_model(eng), raw=raw)(x)
        for path in made:
            net = (torch.jit.load(path) if path.endswith(".torchscript.pt")
                   else torch.export.load(path).module())
            got = net(x)
            assert len(got) == len(live) == (4 if raw else 2)
            for g, want in zip(got, live):
                assert g.is_cuda and g.shape == want.shape
                assert (g - want).abs().max().item() <= 1e-6 * max(want.abs().max().item(), 1.0)
