"""Hand-written Hopper kernels (sm_90a) of the serving, eval and train paths, the
sibling of ``multiyolov5_tpu/ops/pallas``.

Each module holds a kernel's wrapper and its plain PyTorch version
(``*_plain``).  A wrapper runs the plain version for a CPU tensor and
launches its kernel for a CUDA tensor; any other device raises.  Every
wrapper counts its launches in a plain integer attribute, ``launches``.
"""

from .c3 import c3, c3_plain
from .conv3x3 import conv3x3, conv3x3_plain
from .nms import nms, nms_packed, nms_packed_plain, nms_plain
from .nms_greedy import nms_greedy, nms_greedy_plain
from .seg_ce import seg_ce, seg_ce_backward, seg_ce_forward, seg_ce_plain
from .stem import stem, stem_float, stem_plain
from .upsample_argmax import upsample_argmax, upsample_argmax_plain

KERNELS = {"stem": stem, "stem_float": stem_float, "conv3x3": conv3x3, "nms": nms,
           "upsample_argmax": upsample_argmax, "nms_greedy": nms_greedy,
           "seg_ce": seg_ce_forward, "seg_ce_bwd": seg_ce_backward,
           "c3": c3}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
