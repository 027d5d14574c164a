"""Checkpoints (counterpart of ``multiyolov5_tpu/utils/checkpoint.py``).

The JAX package keeps flat ``params``/``state`` dicts of numpy arrays whose
keys already are the torch ``state_dict`` names; only conv weights differ,
HWIO there and OIHW here.  Its native ``.npz`` format (a JSON skeleton plus
one array per leaf) is read and written here without JAX, so the JAX
package loads what the port's training writes and the other way round.

Reference ``.pt`` checkpoints (reference train.py:482-489: ``{'model',
'ema', 'epoch', ...}``, the published pspv5s/pspv5m weights) load through
:func:`load_pt`.  A bare ``state_dict`` or a dict of ``state_dict``s loads
with ``torch.load(weights_only=True)``; a pickled whole ``nn.Module`` needs
the reference's ``models``/``utils`` packages importable (a reference
checkout: ``MULTIYOLOV5_REF``, ``./reference`` or ``./multiyolov5``), or a
one-time ``tools/convert_pt.py`` to ``.npz`` where one is.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import pickle
import sys
import types
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def from_jax_params(params: Dict[str, Any], state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-layout ``(params, state)`` -> a torch ``state_dict``.

    4-D ``.weight`` arrays go HWIO -> OIHW, as ``to_torch_state_dict``
    (multiyolov5_tpu/utils/checkpoint.py:54-62) does; everything else is
    copied.  Values become float32 CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in {**params, **state}.items():
        arr = np.asarray(v, np.float32)
        if arr.ndim == 4 and k.endswith(".weight"):
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[k] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


# state_dict entries that the JAX package keeps in ``state``, not ``params``
# (multiyolov5_tpu/utils/checkpoint.py:28-30)
_STATE_SUFFIXES = (".running_mean", ".running_var", ".anchors", ".anchor_grid")


def to_jax_params(sd: Dict[str, torch.Tensor]) -> Tuple[Dict[str, np.ndarray],
                                                        Dict[str, np.ndarray]]:
    """A torch ``state_dict`` -> JAX-layout ``(params, state)`` numpy dicts,
    the inverse of :func:`from_jax_params`: 4-D ``.weight`` arrays go OIHW
    -> HWIO (``from_torch_state_dict``,
    multiyolov5_tpu/utils/checkpoint.py:33-51); BN running statistics and
    the Detect anchor buffers go to ``state``; ``num_batches_tracked`` is
    dropped."""
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.endswith(".num_batches_tracked"):
            continue
        arr = v.detach().cpu().numpy()
        if arr.ndim == 4 and k.endswith(".weight"):
            arr = np.transpose(arr, (2, 3, 1, 0))
        (state if k.endswith(_STATE_SUFFIXES) else params)[k] = np.ascontiguousarray(arr)
    return params, state


def intersect_load(sd: Dict[str, Any], new: Dict[str, Any]) -> Tuple[Dict[str, Any], int]:
    """Copy the entries of ``new`` whose name and shape match an entry of
    ``sd`` over it; keep the rest (multiyolov5_tpu/utils/checkpoint.py:129,
    reference utils/torch_utils.py:140-142 ``intersect_dicts``).  Returns
    (the merged dict, the number copied)."""
    out = dict(sd)
    n = 0
    for k, v in new.items():
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = v
            n += 1
    return out, n


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> Any:
    """Flatten nested dicts/lists/tuples of arrays into string keys; returns
    the JSON skeleton of the structure (the JAX package's format)."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}/{k}", out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__seq__": kind,
                "items": [_flatten(v, f"{prefix}/{i}", out) for i, v in enumerate(tree)]}
    if tree is None:
        return {"__none__": True}
    if isinstance(tree, (int, float, str, bool)):
        return {"__scalar__": tree}
    out[prefix] = np.asarray(tree)
    return {"__leaf__": prefix}


def save_npz(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` (numpy arrays and scalars in dicts, lists and tuples)
    as a native ``.npz`` checkpoint that the JAX package's ``load_npz``
    reads."""
    arrays: Dict[str, np.ndarray] = {}
    skel = _flatten(tree, "", arrays)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, __skeleton__=np.frombuffer(json.dumps(skel).encode(), dtype=np.uint8),
                 **arrays)


def _unflatten(skel: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(skel, dict):
        if "__leaf__" in skel:
            return np.asarray(arrays[skel["__leaf__"]])
        if "__none__" in skel:
            return None
        if "__scalar__" in skel:
            return skel["__scalar__"]
        if "__seq__" in skel:
            items = [_unflatten(s, arrays) for s in skel["items"]]
            return items if skel["__seq__"] == "list" else tuple(items)
        return {k: _unflatten(v, arrays) for k, v in skel.items()}
    raise ValueError(f"bad skeleton node: {skel!r}")


def load_npz(path: str) -> Dict[str, Any]:
    """Read a native ``.npz`` checkpoint written by the JAX package's
    ``save_npz`` into its nested dict."""
    with np.load(path, allow_pickle=False) as z:
        skel = json.loads(bytes(z["__skeleton__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__skeleton__"}
    return _unflatten(skel, arrays)


# reference checkouts, where a pickled whole module's classes are looked up
# (multiyolov5_tpu/utils/checkpoint.py:65-100), and the imports of the
# reference's modules that unpickling does not need
_REF_DIRS = ("./reference", "./multiyolov5")
_REF_STUBS = ("onnx", "onnx.external_data_helper", "torchvision", "torchvision.ops",
              "seaborn", "wandb")


@contextlib.contextmanager
def _reference_importable(ref: str):
    """``ref`` on ``sys.path`` and empty stand-ins for the reference's
    heavy imports that are not installed, for the duration."""
    tops = {n.split(".")[0] for n in _REF_STUBS}
    missing = {t for t in tops if t not in sys.modules and importlib.util.find_spec(t) is None}
    added = {n: types.ModuleType(n) for n in _REF_STUBS if n.split(".")[0] in missing}
    sys.modules.update(added)
    if "torchvision.ops" in added:
        added["torchvision"].ops = added["torchvision.ops"]
    sys.path.insert(0, ref)
    try:
        yield
    finally:
        sys.path.remove(ref)
        for name in added:
            sys.modules.pop(name, None)


def _torch_load_reference(path: str, ref: Optional[str] = None):
    """``torch.load`` of a reference checkpoint on the CPU.

    ``weights_only=True`` first: tensors, dicts and numbers, which is all a
    ``state_dict`` checkpoint holds.  A pickle of whole modules (or numpy
    arrays) needs ``weights_only=False``; where the reference's classes do
    not import, a reference checkout (``ref``, ``MULTIYOLOV5_REF``,
    ``./reference``, ``./multiyolov5``) goes on ``sys.path`` and the load is
    tried once more.  Unpickling runs the file's code, so that fallback
    warns, naming the file: load only checkpoints you trust."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        pass
    warnings.warn(f"{path} is not a weights-only checkpoint: loading it with "
                  "weights_only=False runs the code it pickles; load only files you "
                  "trust, or convert it once with multiyolov5_tpu_torch/tools/convert_pt.py",
                  stacklevel=3)
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        candidates = (ref, os.environ.get("MULTIYOLOV5_REF")) + _REF_DIRS
        found = next((c for c in candidates if c and os.path.isdir(c)), None)
        if found is None:
            raise ModuleNotFoundError(
                f"{e}. {path} pickles the reference's modules: set MULTIYOLOV5_REF to a "
                "reference checkout, or convert it once with "
                "multiyolov5_tpu_torch/tools/convert_pt.py") from e
        with _reference_importable(found):
            return torch.load(path, map_location="cpu", weights_only=False)


def load_pt(path: str, prefer_ema: bool = True, ref: Optional[str] = None
            ) -> Tuple[Optional[Any], Dict[str, torch.Tensor], Dict[str, Any]]:
    """A reference ``.pt`` checkpoint -> ``(spec config or None, state_dict,
    meta)`` (multiyolov5_tpu/utils/checkpoint.py:103-126, reference
    ``attempt_load``).

    Takes a bare ``state_dict``, a pickled module, or a dict with ``model``
    and/or ``ema``, each a ``state_dict`` or a pickled module; ``ema`` wins
    unless ``prefer_ema`` is false.  ``meta`` holds the dict's ``epoch``,
    ``best_fitness`` and ``training_results`` and, from a module, its
    ``yaml`` (the config returned first).  Tensors become float32 on the
    CPU; ``num_batches_tracked`` is dropped.  The checkpoint's Detect
    ``anchors`` and ``anchor_grid`` are kept, so an autoanchored model
    decodes with its own anchors."""
    ckpt = _torch_load_reference(path, ref)
    meta: Dict[str, Any] = {}
    if isinstance(ckpt, dict) and ("model" in ckpt or "ema" in ckpt):
        meta = {k: ckpt[k] for k in ("epoch", "best_fitness", "training_results") if k in ckpt}
        obj = ckpt["ema"] if prefer_ema and ckpt.get("ema") is not None else ckpt["model"]
        for src in (obj, ckpt.get("model")):
            if hasattr(src, "yaml"):       # the reference Model keeps its config dict
                meta["yaml"] = src.yaml
                break
    else:
        obj = ckpt
        if hasattr(obj, "yaml"):
            meta["yaml"] = obj.yaml
    sd = obj.float().state_dict() if hasattr(obj, "state_dict") else obj
    sd = {k: (v.float() if v.is_floating_point() else v).cpu() for k, v in sd.items()
          if not k.endswith(".num_batches_tracked")}
    return meta.get("yaml"), sd, meta


def load_checkpoint(path: str) -> Tuple[Optional[Any], Dict[str, torch.Tensor]]:
    """``(spec config or None, state_dict)`` from a reference ``.pt``
    (:func:`load_pt`) or a native ``.npz``.

    In a ``.npz``, EMA weights win when present, and then pair with the EMA
    BN statistics (multiyolov5_tpu/engine.py:221-232): folding EMA
    gamma/beta against the raw running moments would skew the folded
    weights."""
    if str(path).endswith(".pt"):
        cfg, sd, _ = load_pt(path)
        return cfg, sd
    tree = load_npz(path)
    ema = tree.get("ema_params")
    params = ema or tree["params"]
    state = (tree.get("ema_state") or tree["state"]) if ema else tree["state"]
    spec_yaml = tree.get("spec_yaml")
    cfg = json.loads(spec_yaml) if isinstance(spec_yaml, str) else spec_yaml
    return cfg, from_jax_params(params, state)


def save_sharded(path: str, tree: Dict[str, Any]) -> None:
    """The port's counterpart of the JAX package's ``save_orbax``: a nested
    dict of tensors (and plain Python values) to a directory, through
    ``torch.distributed.checkpoint``.  With a process group every rank
    calls it with the same replicated tree and the files are written once;
    without one, the one process writes them.  Orbax's checkpoints cannot
    cross into the port (the card's machine has no orbax); the npz format
    (:func:`save_npz`) is the one both packages read."""
    import torch.distributed.checkpoint as dcp

    dcp.save(tree, checkpoint_id=os.path.abspath(path))


def load_sharded(path: str) -> Dict[str, Any]:
    """The tree :func:`save_sharded` wrote, on any world size (every rank
    calls it; each gets the whole tree), its tensors on the CPU.  The
    tree's shape comes from the checkpoint's metadata."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    path = os.path.abspath(path)
    md = dcp.FileSystemReader(path).read_metadata()
    tree: Dict[str, Any] = {}
    for key, item in md.state_dict_metadata.items():
        *parents, leaf = md.planner_data[key]
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = (torch.empty(item.size, dtype=item.properties.dtype)
                      if isinstance(item, TensorStorageMetadata) else None)
    dcp.load(tree, checkpoint_id=path)
    return tree


def strip_optimizer(path: str, out_path: Optional[str] = None) -> None:
    """Finalize a training checkpoint for inference (reference
    utils/general.py:512-525; multiyolov5_tpu/utils/checkpoint.py:212-227):
    the EMA weights become the weights, the optimizer state goes."""
    ckpt = load_npz(path)
    final = {
        "params": ckpt.get("ema_params") or ckpt["params"],
        "state": ckpt.get("ema_state") or ckpt["state"],
        "spec_yaml": ckpt.get("spec_yaml"),
        "updates": ckpt.get("updates", ckpt.get("step")),
        "epoch": ckpt.get("epoch"),
        "best_fitness": ckpt.get("best_fitness"),
    }
    save_npz(out_path or path, final)
