"""The Weights & Biases artifact workflow (counterpart of
``multiyolov5_tpu/utils/loggers.py``; reference
utils/wandb_logging/wandb_utils.py:1-306).

``WandbLogger`` is the JAX one over the port's ``DetectionDataset`` and
checkpoints: dataset artifacts with ground-truth tables (``data/images``
and ``data/labels`` files, a ``Classes`` set, one box dict a label in
pixels), the ``*_wandb.yaml`` twin of the dataset file with
``wandb-artifact://`` splits (written as JSON, which is YAML: both
``data/hyps.read_yaml`` and PyYAML read it), artifact downloads and path
swaps when training starts, the default ``bbox_interval`` (epochs // 10,
at least 1), per-epoch box panels joined on the val table, model
artifacts (the port's ``last.npz``, the JAX checkpoint format, so an
artifact logged by either CLI resumes in the other) and the
``wandb-artifact://`` resume, which refuses a finished run.

One repair: after ``--upload-dataset`` the JAX logger skips the download
of the artifacts it just made (the reference downloads them) but leaves
their ``wandb-artifact://`` names in the dataset the CLI then loads, which
no loader can open.  The port's gives the training the local splits the
artifacts were made from.

wandb is imported when a logger is made, never when this module is: where
it does not import, every logger is disabled and each call is a no-op, as
the JAX guard does.  A stand-in module in ``sys.modules["wandb"]`` takes
its place.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..data.hyps import read_yaml

WANDB_ARTIFACT_PREFIX = "wandb-artifact://"


def wandb_module():
    """The wandb module, or None where it does not import."""
    try:
        import wandb
    except ImportError:
        return None
    return wandb


def remove_prefix(s: str, prefix: str = WANDB_ARTIFACT_PREFIX) -> str:
    """reference wandb_utils.py:23-24."""
    return s[len(prefix):]


def check_wandb_config_file(data_config_file: str) -> str:
    """Prefer the ``*_wandb.yaml`` twin if one exists (wandb_utils.py:27-31)."""
    twin = "_wandb.".join(data_config_file.rsplit(".", 1))
    return twin if Path(twin).is_file() else data_config_file


def get_run_info(run_path: str):
    """Split ``wandb-artifact://entity/project/run_id`` (wandb_utils.py:34-39)."""
    p = Path(remove_prefix(run_path))
    return p.stem, p.parent.stem, "run_" + p.stem + "_model"


def check_wandb_resume(opt) -> Optional[bool]:
    """True iff ``--resume wandb-artifact://...`` (wandb_utils.py:42-53)."""
    if isinstance(opt.resume, str) and opt.resume.startswith(WANDB_ARTIFACT_PREFIX):
        return True
    return None


class WandbLogger:
    """reference utils/wandb_logging/wandb_utils.py:80-306, npz-checkpoint
    flavored.  ``job_type`` is "Training" or "Dataset Creation"."""

    def __init__(self, opt=None, name: Optional[str] = None, run_id: Optional[str] = None,
                 data_dict: Optional[Dict[str, Any]] = None, job_type: str = "Training"):
        off = opt is not None and getattr(opt, "no_wandb", False)
        self.wandb = None if off else wandb_module()
        self.run = None
        self.job_type = job_type
        self.data_dict = data_dict
        self.log_dict: Dict[str, Any] = {}
        self.current_epoch = 0
        self.bbox_interval = getattr(opt, "bbox_interval", -1) if opt else -1
        self.log_imgs = 16
        self.val_table = self.result_table = self.result_artifact = None
        self.val_artifact = self.train_artifact = None
        self.val_table_map: Dict[str, int] = {}
        self.uploaded: Dict[str, str] = {}      # split -> the local path it was made from
        if self.wandb is None:
            return
        try:
            resume = getattr(opt, "resume", False) if opt else False
            if isinstance(resume, str) and resume.startswith(WANDB_ARTIFACT_PREFIX):
                # resume-from-artifact keeps the original run id and project
                # (wandb_utils.py:86-93)
                run_id, project, model_art = get_run_info(resume)
                self.run = self.wandb.init(id=run_id, project=project, resume="allow")
                opt.resume = WANDB_ARTIFACT_PREFIX + model_art
            else:
                project = ("multiyolov5_tpu" if opt is None or opt.project in ("runs/train", "")
                           else Path(opt.project).stem)
                self.run = self.wandb.init(
                    config=vars(opt) if opt else None, resume="allow",
                    project=project, name=name, id=run_id, job_type=job_type)
        except Exception as e:  # noqa: BLE001 (W&B is optional: training goes on without it)
            print(f"W&B: off ({type(e).__name__}: {e})")
            self.wandb = self.run = None
            return
        if self.run is None:
            self.wandb = None
            return
        if job_type == "Training":
            if opt is not None and not getattr(opt, "resume", False):
                if getattr(opt, "upload_dataset", False):
                    self.data_dict = self.check_and_upload_dataset(opt)
                try:
                    self.run.config.update({"opt": vars(opt), "data_dict": self.data_dict},
                                           allow_val_change=True)
                except Exception as e:  # noqa: BLE001 (as the JAX logger: the run goes on)
                    print(f"W&B: the run's config was not updated ({type(e).__name__})")
            if opt is not None:
                self.data_dict = self.setup_training(opt, self.data_dict)
        elif job_type == "Dataset Creation" and opt is not None and getattr(opt, "data", None):
            self.data_dict = self.check_and_upload_dataset(opt)

    @property
    def enabled(self) -> bool:
        return self.run is not None

    # --- dataset artifacts (wandb_utils.py:115-124, 193-261) ---

    def check_and_upload_dataset(self, opt) -> Dict[str, Any]:
        cfg = self.log_dataset_artifact(
            opt.data, getattr(opt, "single_cls", False),
            Path(getattr(opt, "project", "runs/train")).stem or "multiyolov5_tpu")
        return read_yaml(cfg)

    def log_dataset_artifact(self, data_file: str, single_cls: bool, project: str,
                             overwrite_config: bool = False) -> str:
        from ..data.detection import DetectionDataset
        data = read_yaml(data_file)
        names = {0: "item"} if single_cls else dict(enumerate(data["names"]))
        self.train_artifact = (
            self.create_dataset_table(DetectionDataset(data["train"]), names, name="train")
            if data.get("train") else None)
        self.val_artifact = (
            self.create_dataset_table(DetectionDataset(data["val"]), names, name="val")
            if data.get("val") else None)
        for split in ("train", "val"):
            if data.get(split):
                self.uploaded[split] = data[split]
                data[split] = WANDB_ARTIFACT_PREFIX + str(Path(project) / split)
        path = data_file if overwrite_config else "_wandb.".join(data_file.rsplit(".", 1))
        data.pop("download", None)
        with open(path, "w") as fh:         # JSON is YAML
            json.dump(data, fh, indent=1, sort_keys=True)
        if self.job_type == "Training":     # links lineage without re-upload
            if self.val_artifact is not None:
                self.run.use_artifact(self.val_artifact)
                self.val_artifact.wait()
                self.val_table = self.val_artifact.get("val")
                self.map_val_table_path()
            if self.train_artifact is not None:
                self.run.use_artifact(self.train_artifact)
        else:
            for art in (self.train_artifact, self.val_artifact):
                if art is not None:
                    self.run.log_artifact(art)
        return path

    def create_dataset_table(self, dataset, class_to_id: Dict[int, str], name: str = "dataset"):
        """Image and label files plus a ground-truth box table
        (wandb_utils.py:228-261).  Labels are (cls, xywh normalised)."""
        artifact = self.wandb.Artifact(name=name, type="dataset")
        for img_file, lb_file in zip(dataset.img_files, dataset.label_files):
            artifact.add_file(img_file, name="data/images/" + Path(img_file).name)
            if Path(lb_file).exists():
                artifact.add_file(str(lb_file), name="data/labels/" + Path(lb_file).name)
        table = self.wandb.Table(columns=["id", "train_image", "Classes", "name"])
        class_set = self.wandb.Classes([{"id": k, "name": v} for k, v in class_to_id.items()])
        for si, (img_file, labels) in enumerate(zip(dataset.img_files, dataset.labels)):
            h, w = dataset.shapes[si][::-1] if hasattr(dataset, "shapes") else (1, 1)
            box_data, img_classes = [], {}
            for row in np.asarray(labels).reshape(-1, 5):
                cls = int(row[0])
                cx, cy, bw, bh = row[1:] * np.array([w, h, w, h])
                box_data.append({
                    "position": {"minX": float(cx - bw / 2), "minY": float(cy - bh / 2),
                                 "maxX": float(cx + bw / 2), "maxY": float(cy + bh / 2)},
                    "class_id": cls, "box_caption": class_to_id[cls],
                    "scores": {"acc": 1}, "domain": "pixel"})
                img_classes[cls] = class_to_id[cls]
            boxes = {"ground_truth": {"box_data": box_data, "class_labels": class_to_id}}
            table.add_data(si, self.wandb.Image(img_file, classes=class_set, boxes=boxes),
                           json.dumps(img_classes), Path(img_file).name)
        artifact.add(table, name)
        return artifact

    def map_val_table_path(self) -> None:
        """File name -> row id for the eval join (wandb_utils.py:222-226)."""
        self.val_table_map = {row[3]: row[0] for row in self.val_table.data}

    def download_dataset_artifact(self, path, alias: str = "latest"):
        """wandb_utils.py:159-165."""
        if isinstance(path, str) and path.startswith(WANDB_ARTIFACT_PREFIX):
            art = self.run.use_artifact(remove_prefix(path) + ":" + alias)
            return art.download(), art
        return None, None

    # --- training session (wandb_utils.py:126-157) ---

    def setup_training(self, opt, data_dict):
        data_dict = dict(data_dict or {})
        resume = getattr(opt, "resume", False)
        if isinstance(resume, str) and resume.startswith(WANDB_ARTIFACT_PREFIX):
            modeldir, _ = self.download_model_artifact(opt)
            if modeldir:
                opt.weights = str(Path(modeldir) / "last.npz")
                cfg = self.run.config
                for k in ("epochs", "bbox_interval"):
                    if hasattr(cfg, k):
                        setattr(opt, k, getattr(cfg, k))
                data_dict = dict(getattr(cfg, "data_dict", data_dict))
        if self.val_artifact is None:  # not already uploaded this run
            alias = getattr(opt, "artifact_alias", "latest")
            tdir, self.train_artifact = self.download_dataset_artifact(
                data_dict.get("train"), alias)
            vdir, self.val_artifact = self.download_dataset_artifact(
                data_dict.get("val"), alias)
            if tdir is not None:
                data_dict["train"] = str(Path(tdir) / "data/images")
            if vdir is not None:
                data_dict["val"] = str(Path(vdir) / "data/images")
                self.val_table = self.val_artifact.get("val")
                self.map_val_table_path()
        else:       # uploaded by this run: train on the files the artifacts hold
            for split, local in self.uploaded.items():
                if str(data_dict.get(split, "")).startswith(WANDB_ARTIFACT_PREFIX):
                    data_dict[split] = local
        if self.val_artifact is not None:
            self.result_artifact = self.wandb.Artifact("run_" + self.run.id + "_progress",
                                                       "evaluation")
            self.result_table = self.wandb.Table(["epoch", "id", "prediction", "avg_confidence"])
        if self.bbox_interval == -1:
            epochs = getattr(opt, "epochs", 0)
            self.bbox_interval = (epochs // 10) if epochs > 10 else 1
            if opt is not None:
                opt.bbox_interval = self.bbox_interval
        return data_dict

    def download_model_artifact(self, opt):
        """wandb_utils.py:167-177: the model artifact's directory, refusing
        a run that trained all its epochs."""
        resume = getattr(opt, "resume", "")
        if isinstance(resume, str) and resume.startswith(WANDB_ARTIFACT_PREFIX):
            art = self.run.use_artifact(remove_prefix(resume) + ":latest")
            if art is None:
                raise AssertionError("W&B model artifact doesn't exist")
            trained = art.metadata.get("epochs_trained", 0)
            total = art.metadata.get("total_epochs", trained + 1)
            if trained >= total:
                raise AssertionError(f"training to {total} epochs is finished, "
                                     "nothing to resume")
            return art.download(), art
        return None, None

    # --- per-epoch logging (wandb_utils.py:179-191, 263-306) ---

    def log_model(self, path: str, opt=None, epoch: int = 0, fitness: float = 0.0,
                  best: bool = False) -> None:
        if self.run is None:
            return
        art = self.wandb.Artifact(
            f"run_{self.run.id}_model", type="model",
            metadata={"original_url": str(path), "epochs_trained": epoch + 1,
                      "total_epochs": getattr(opt, "epochs", epoch + 1),
                      "fitness_score": fitness})
        art.add_file(str(path), name="last.npz")
        aliases = ["latest", "epoch " + str(self.current_epoch)]
        if best:
            aliases.append("best")
        self.run.log_artifact(art, aliases=aliases)

    def log_training_progress(self, predn: np.ndarray, path: str,
                              names: Dict[int, str]) -> None:
        """One val image's predictions into the epoch's table.  ``predn``
        rows are (xyxy, conf, cls) in original-image pixels; boxes below
        conf 0.25 are left out (wandb_utils.py:263-283)."""
        if not (self.val_table and self.result_table):
            return
        class_set = self.wandb.Classes([{"id": k, "name": v} for k, v in names.items()])
        box_data, total_conf = [], 0.0
        for *xyxy, conf, cls in np.asarray(predn).reshape(-1, 6).tolist():
            if conf < 0.25:
                continue
            box_data.append({
                "position": {"minX": xyxy[0], "minY": xyxy[1], "maxX": xyxy[2],
                             "maxY": xyxy[3]},
                "class_id": int(cls), "box_caption": f"{names[int(cls)]} {conf:.3f}",
                "scores": {"class_score": conf}, "domain": "pixel"})
            total_conf += conf
        boxes = {"predictions": {"box_data": box_data, "class_labels": names}}
        rid = self.val_table_map.get(Path(path).name)
        if rid is None:
            return
        self.result_table.add_data(
            self.current_epoch, rid,
            self.wandb.Image(self.val_table.data[rid][1], boxes=boxes, classes=class_set),
            total_conf / max(1, len(box_data)))

    def log(self, d: Dict[str, Any], step: Optional[int] = None) -> None:
        if self.run is not None:
            self.log_dict.update(d)

    def end_epoch(self, best_result: bool = False) -> None:
        """Flush the scalars and publish the joined eval table
        (wandb_utils.py:290-300)."""
        if self.run is None:
            return
        self.wandb.log(self.log_dict)
        self.log_dict = {}
        if self.result_artifact is not None:
            joined = self.wandb.JoinedTable(self.val_table, self.result_table, "id")
            self.result_artifact.add(joined, "result")
            aliases = ["latest", "epoch " + str(self.current_epoch)]
            if best_result:
                aliases.append("best")
            self.run.log_artifact(self.result_artifact, aliases=aliases)
            self.result_table = self.wandb.Table(["epoch", "id", "prediction", "avg_confidence"])
            self.result_artifact = self.wandb.Artifact("run_" + self.run.id + "_progress",
                                                       "evaluation")

    def finish(self) -> None:
        if self.run is not None:
            if self.log_dict:
                self.wandb.log(self.log_dict)
            self.run.finish()

    finish_run = finish
