"""One-time converter: reference ``.pt`` checkpoint -> native ``.npz``
(counterpart of ``multiyolov5_tpu/tools/convert_pt.py``).

Published reference checkpoints (pspv5s.pt / pspv5m.pt) pickle whole
``nn.Module``s, so loading them needs the reference's code importable
(utils/checkpoint.load_pt).  This converts once; the ``.npz`` it writes
(the JAX package's format: ``params``, ``state``, ``spec_yaml``,
``epoch``, ``best_fitness``) loads in the port's ``Engine`` and the CLIs,
and in the JAX package's, without the reference:

    python -m multiyolov5_tpu_torch.tools.convert_pt pspv5s.pt pspv5s.npz \\
        [--ref /path/to/multiyolov5]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from ..models.config import load_spec
from ..utils.checkpoint import load_pt, save_npz, to_jax_params


def convert(pt_path: str, out_path: str, ref: Optional[str] = None) -> str:
    cfg, sd, meta = load_pt(pt_path, ref=ref)
    params, state = to_jax_params(sd)
    save_npz(out_path, {
        "params": params,
        "state": state,
        "spec_yaml": json.dumps(cfg) if cfg else None,
        "epoch": meta.get("epoch"),
        "best_fitness": meta.get("best_fitness"),
    })
    if cfg:
        spec = load_spec(cfg)
        print(f"converted {pt_path} -> {out_path} "
              f"({len(params)} params, nc={spec.nc}, n_segcls={spec.n_segcls})")
    else:
        print(f"converted {pt_path} -> {out_path} ({len(params)} params; "
              f"no embedded config: pass --cfg at load time)")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("pt_path")
    ap.add_argument("out_path")
    ap.add_argument("--ref", help="reference repo checkout (for unpickling)")
    a = ap.parse_args(argv)
    return convert(a.pt_path, a.out_path, a.ref)


if __name__ == "__main__":
    main()
