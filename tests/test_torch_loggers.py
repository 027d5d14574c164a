"""The port's W&B workflow (multiyolov5_tpu_torch/utils/loggers.py and its
wiring in cli/train.py and evaluation.py) against the JAX one, with the
recording stand-in for wandb of tests/test_loggers.py
(tests/_torch_fake_wandb.py).

* Every scenario of tests/test_loggers.py, as cases of one test, runs
  through both loggers, each holding what the JAX test holds; the calls
  that reach the stand-in (in order: init, artifacts with their names,
  types, metadata, files and aliases, tables with their columns and rows,
  use_artifact, log, finish) are then equal, with each scenario's
  temporary directory read as one root.
* Both training CLIs run two epochs on tests/test_torch_train_cli.py's
  TINY tree (detection only, batch 8, 64 px, float32) with
  ``--upload-dataset --bbox-interval 1 --save-period 1``, from the same
  weights and with the train step replaced by one that leaves the state
  as it is, so that both evaluate the same weights each epoch: the W&B
  calls are the same sequence, with the numbers in the tables and the
  scalars within 1e-3 (boxes in pixels of 64-96 px frames; scores,
  metrics; float32 in both, as tests/test_torch_eval.py's 1e-4 on the
  metrics and tests/test_torch_engine.py's 1e-3 px on the boxes).  The
  JAX logger's ``setup_training`` is given back the local splits after
  ``--upload-dataset`` (it leaves ``wandb-artifact://`` names in the
  dataset its CLI loads, which raises FileNotFoundError), as the port's
  logger does (utils/loggers.py's one repair).
* A model artifact logged by either CLI (the first epoch's, with
  ``--save-period 1``) resumes in the other through ``--resume
  wandb-artifact://``: the run trains on from epoch 1.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from multiyolov5_tpu.utils import loggers as JL
from multiyolov5_tpu_torch.cli import train as cli
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.models.config import load_spec
from multiyolov5_tpu_torch.models.model import seeded_state_dict
from multiyolov5_tpu_torch.utils import loggers as PL
from multiyolov5_tpu_torch.utils.checkpoint import save_npz, to_jax_params

from _torch_fake_wandb import FakeArtifact, FakeRun, FakeTable, FakeWandb, assert_close, plain
from test_torch_train_cli import tree  # noqa: F401 (the TINY tree fixture)

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)

# table and scalar numbers, JAX CLI against the port's (see the docstring)
CLI_ATOL = 1e-3


def _opt(**kw):
    d = dict(resume=False, project="runs/train", epochs=20, data="", single_cls=False,
             upload_dataset=False, bbox_interval=-1, artifact_alias="latest", no_wandb=False,
             weights="")
    d.update(kw)
    return argparse.Namespace(**d)


def _make_dataset(root: Path, n=2):
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    for i in range(n):
        img = np.zeros((24, 32, 3), np.uint8)
        img[..., 2] = i * 40                      # BGR: red i * 40, as the JAX test's
        png.imwrite(str(root / "images" / f"im{i}.png"), img)
        (root / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.25 0.5\n")
    yml = root / "data.yaml"
    yml.write_text(yaml.safe_dump({
        "train": str(root / "images"), "val": str(root / "images"),
        "nc": 2, "names": ["car", "person"]}))
    return yml


# ----------------------------------------------------------- the scenarios
# each takes the logger module and its own temporary root, with the
# stand-in installed, and holds what tests/test_loggers.py holds

def disabled_without_wandb(L, root):
    lg = L.WandbLogger(_opt(), "exp")
    assert not lg.enabled
    lg.log({"x": 1.0})
    lg.end_epoch()
    lg.log_model("/nonexistent", _opt(), 0, 0.0)
    lg.log_training_progress(np.zeros((0, 6)), "a.png", {0: "car"})
    lg.finish()


def no_wandb_flag(L, root):
    lg = L.WandbLogger(_opt(no_wandb=True), "exp")
    assert not lg.enabled


def log_and_end_epoch(L, root):
    lg = L.WandbLogger(_opt(), "exp")
    assert lg.enabled
    lg.log({"metrics/mAP_0.5": 0.5})
    lg.log({"train/box_loss": 0.1})
    assert lg.wandb.logged == []              # buffered until end_epoch
    lg.end_epoch()
    assert lg.wandb.logged == [{"metrics/mAP_0.5": 0.5, "train/box_loss": 0.1}]
    assert lg.log_dict == {} and lg.bbox_interval == 2


def log_model_artifact(L, root):
    ck = root / "last.npz"
    ck.write_bytes(b"x")
    lg = L.WandbLogger(_opt(), "exp")
    lg.current_epoch = 3
    lg.log_model(str(ck), _opt(epochs=9), epoch=3, fitness=0.7, best=True)
    (art, aliases), = lg.run.artifacts
    assert art.type == "model" and art.metadata["epochs_trained"] == 4
    assert art.metadata["total_epochs"] == 9
    assert "best" in aliases and "latest" in aliases
    assert art.files == [(str(ck), "last.npz")]


def log_dataset_artifact(L, root):
    yml = _make_dataset(root)
    lg = L.WandbLogger(_opt(), "exp", job_type="Dataset Creation")
    cfg = lg.log_dataset_artifact(str(yml), False, "proj")
    assert cfg.endswith("data_wandb.yaml")
    new = yaml.safe_load(open(cfg))
    assert new["train"] == L.WANDB_ARTIFACT_PREFIX + "proj/train"
    assert new["val"] == L.WANDB_ARTIFACT_PREFIX + "proj/val"
    assert len(lg.run.artifacts) == 2
    art = lg.train_artifact
    names = {n for _, n in art.files}
    assert "data/images/im0.png" in names and "data/labels/im0.txt" in names
    table = art.objects["train"]
    assert len(table.data) == 2
    _, img, classes_json, fname = table.data[0]
    box = img[2]["ground_truth"]["box_data"][0]["position"]
    assert box["minX"] == pytest.approx(12) and box["maxX"] == pytest.approx(20)
    assert json.loads(classes_json) == {"0": "car"}
    assert fname == "im0.png"


def upload_dataset_training_links_val_table(L, root):
    yml = _make_dataset(root)
    data = yaml.safe_load(open(yml))
    lg = L.WandbLogger(_opt(data=str(yml), upload_dataset=True), "exp", data_dict=data)
    assert lg.enabled and lg.val_table is not None
    assert lg.val_table_map == {"im0.png": 0, "im1.png": 1}
    assert lg.train_artifact in lg.run.used
    assert lg.result_table is not None and lg.result_artifact is not None


def log_training_progress_and_epoch_table(L, root):
    yml = _make_dataset(root)
    data = yaml.safe_load(open(yml))
    lg = L.WandbLogger(_opt(data=str(yml), upload_dataset=True), "exp", data_dict=data)
    pred = np.array([[1.0, 2.0, 11.0, 12.0, 0.9, 1],
                     [0.0, 0.0, 5.0, 5.0, 0.1, 0]])     # low conf dropped
    lg.current_epoch = 4
    lg.log_training_progress(pred, str(root / "images" / "im1.png"), {0: "car", 1: "person"})
    row, = lg.result_table.data
    assert row[0] == 4 and row[1] == 1 and row[3] == pytest.approx(0.9)
    boxes = row[2][2]["predictions"]["box_data"]
    assert len(boxes) == 1 and boxes[0]["class_id"] == 1
    lg.log({"m": 1.0})
    lg.end_epoch(best_result=True)
    art, aliases = lg.run.artifacts[-1]
    assert art.type == "evaluation" and "best" in aliases
    assert art.objects["result"][0] == "joined"
    assert lg.result_table.data == []


def check_wandb_resume(L, root):
    assert L.check_wandb_resume(_opt(resume=L.WANDB_ARTIFACT_PREFIX + "p/r1")) is True
    assert L.check_wandb_resume(_opt(resume=True)) is None
    assert L.check_wandb_resume(_opt(resume="runs/train/exp/weights/last.npz")) is None


def get_run_info(L, root):
    assert L.get_run_info(L.WANDB_ARTIFACT_PREFIX + "myproj/abc9") == (
        "abc9", "myproj", "run_abc9_model")


def resume_from_artifact(L, root):
    modeldir = root / "dl"
    modeldir.mkdir()
    (modeldir / "last.npz").write_bytes(b"x")
    art = FakeArtifact("run_abc9_model", "model", {"epochs_trained": 3, "total_epochs": 20})
    art._dir = str(modeldir)
    FakeWandb.registry["run_abc9_model"] = art
    opt = _opt(resume=L.WANDB_ARTIFACT_PREFIX + "myproj/abc9", epochs=20)
    lg = L.WandbLogger(opt, "exp", data_dict={})
    assert lg.enabled and lg.run.id == "abc9"
    assert opt.weights == str(modeldir / "last.npz")


def resume_finished_run_refuses(L, root):
    art = FakeArtifact("run_abc9_model", "model", {"epochs_trained": 20, "total_epochs": 20})
    art._dir = str(root)
    FakeWandb.registry["myproj/run_abc9_model"] = art
    opt = _opt(resume=L.WANDB_ARTIFACT_PREFIX + "myproj/abc9", epochs=20)
    lg = L.WandbLogger.__new__(L.WandbLogger)
    lg.run = FakeRun(id="abc9")
    lg.run.use_artifact = lambda a: FakeWandb.registry[a.split(":")[0]]
    opt.resume = L.WANDB_ARTIFACT_PREFIX + "myproj/run_abc9_model"
    with pytest.raises(AssertionError, match="nothing to resume"):
        lg.download_model_artifact(opt)


def download_dataset_artifact_swaps_paths(L, root):
    ddir = root / "valdl"
    (ddir / "data" / "images").mkdir(parents=True)
    art = FakeArtifact("proj/val", "dataset")
    art._dir = str(ddir)
    t = FakeTable(["id", "train_image", "Classes", "name"])
    t.add_data(0, ("img", "x", None), "{}", "im0.png")
    art.objects["val"] = t
    FakeWandb.registry["proj/val"] = art
    lg = L.WandbLogger(_opt(), "exp", data_dict={"val": L.WANDB_ARTIFACT_PREFIX + "proj/val"})
    assert lg.data_dict["val"] == str(ddir / "data" / "images")
    assert lg.val_table_map == {"im0.png": 0}


def evaluate_detection_accepts_logger_kw(L, root):
    import importlib
    import inspect
    ev = importlib.import_module(L.__name__.rsplit(".", 2)[0] + ".evaluation")
    assert "wandb_logger" in inspect.signature(ev.evaluate_detection).parameters


SCENARIOS = [disabled_without_wandb, no_wandb_flag, log_and_end_epoch, log_model_artifact,
             log_dataset_artifact, upload_dataset_training_links_val_table,
             log_training_progress_and_epoch_table, check_wandb_resume, get_run_info,
             resume_from_artifact, resume_finished_run_refuses,
             download_dataset_artifact_swaps_paths, evaluate_detection_accepts_logger_kw]


def _install(monkeypatch, L, fw):
    """The stand-in (or None: wandb absent) where logger module ``L`` finds wandb."""
    if L is JL:
        monkeypatch.setattr(JL, "wandb", fw)
    else:
        monkeypatch.setitem(sys.modules, "wandb", fw)


def _calls(fw, root):
    """Everything the stand-in recorded, as plain data."""
    run = None if fw is None or fw.run is None else {
        "id": fw.run.id, "kw": plain({k: v for k, v in fw.run.kw.items() if k != "config"},
                                     [root]),
        "config": plain(fw.run.kw.get("config"), [root]), "finished": fw.run.finished,
        "used": plain(fw.run.used, [root]), "artifacts": plain(fw.run.artifacts, [root])}
    return {"events": plain(FakeWandb.events, [root]),
            "logged": None if fw is None else plain(fw.logged, [root]), "run": run}


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[f.__name__ for f in SCENARIOS])
def test_logger_scenarios_match_jax(scenario, tmp_path, monkeypatch):
    logs = []
    for L in (JL, PL):
        root = tmp_path / L.__name__.split(".")[0]
        root.mkdir()
        fw = None if scenario is disabled_without_wandb else FakeWandb()
        FakeWandb.registry, FakeWandb.events = {}, []
        _install(monkeypatch, L, fw)
        scenario(L, root)
        logs.append(_calls(fw, root))
    assert logs[0] == logs[1]


def test_port_logger_imports_wandb_only_when_made(monkeypatch):
    """The port's module holds no wandb; a logger made after the stand-in
    is installed takes it, and one made without wandb is off."""
    assert not hasattr(PL, "wandb")
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert not PL.WandbLogger(_opt(), "exp").enabled and PL.wandb_module() is None
    fw = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fw)
    assert PL.WandbLogger(_opt(), "exp").wandb is fw


# -------------------------------------------------------------- the CLIs

def _still_step(zeros):
    """A stand-in for a CLI's ``make_train_step``: a step that leaves the
    state as it is and reports zero losses."""
    def make(*a, **kw):
        return lambda ts, *args, **kwargs: (ts, zeros())
    return make


def _jax_zeros():
    import jax.numpy as jnp
    return {"det_items": jnp.zeros(4, jnp.float32), "seg_loss": jnp.float32(0)}


def _port_zeros():
    return {"det_items": torch.zeros(4), "seg_loss": torch.tensor(0.0)}


@pytest.fixture(scope="module")
def weights(tree, tmp_path_factory):  # noqa: F811 (the fixture imported above)
    spec = load_spec(json.loads(Path(tree["SegMaskPSP"]).read_text()))
    p, s = to_jax_params(seeded_state_dict(spec, 0))
    path = tmp_path_factory.mktemp("w") / "w.npz"
    save_npz(str(path), {"params": p, "state": s})
    return str(path)


def _cli_argv(tree, weights, project, *extra):  # noqa: F811
    return ["--data", str(tree["det"]), "--cfg", str(tree["SegMaskPSP"]), "--weights", weights,
            "--batch-size", "8", "--img-size", "64", "64", "--workers", "2", "--no-tb",
            "--noautoanchor", "--fp32", "--project", str(project), "--name", "exp", *extra]


def _jax_local_splits(monkeypatch):
    """The JAX logger's setup_training, with the splits it uploaded in this
    run pointing at their local files again (the port's repair)."""
    real = JL.WandbLogger.setup_training

    def setup_training(self, opt, data_dict):
        out = real(self, opt, data_dict)
        if getattr(opt, "upload_dataset", False) and not opt.resume:
            local = yaml.safe_load(open(opt.data))
            for split in ("train", "val"):
                if str(out.get(split, "")).startswith(JL.WANDB_ARTIFACT_PREFIX):
                    out[split] = local[split]
        return out
    monkeypatch.setattr(JL.WandbLogger, "setup_training", setup_training)


def _run_cli(which, argv, monkeypatch, keep):
    """One CLI's run under a fresh stand-in: (run dir, the stand-in, its events)."""
    from multiyolov5_tpu.cli import train as jax_cli
    fw = FakeWandb(keep=str(keep))
    if which == "jax":
        _install(monkeypatch, JL, fw)
        _jax_local_splits(monkeypatch)
        monkeypatch.setattr(jax_cli, "make_train_step", _still_step(_jax_zeros))
        run, _ = jax_cli.main(argv)
    else:
        _install(monkeypatch, PL, fw)
        monkeypatch.setattr(cli, "make_train_step", _still_step(_port_zeros))
        run, _ = cli.main(argv + ["--device", "cpu"])
    return run, fw, list(FakeWandb.events)


@pytest.fixture(scope="module")
def cli_runs(tree, weights, tmp_path_factory):  # noqa: F811
    """Each CLI's two-epoch run with the stand-in: {which: (run dir, root,
    plain calls, the first model artifact)}."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for which in ("jax", "port"):
            root = tmp_path_factory.mktemp(which)
            run, fw, events = _run_cli(which, _cli_argv(
                tree, weights, root / "runs", "--epochs", "2", "--upload-dataset",
                "--bbox-interval", "1", "--save-period", "1"), mp, root / "kept")
            models = [a for a, _ in fw.run.artifacts if a.type == "model"]
            out[which] = (run, root, {"events": plain(events, [run, root]),
                                      "logged": plain(fw.logged, [run, root])}, models[0])
            mp.undo()
    finally:
        mp.undo()
    return out


def test_cli_wandb_calls_match_jax(cli_runs):
    (jrun, _, want, _), (prun, _, got, _) = cli_runs["jax"], cli_runs["port"]
    kinds = [e[0] for e in got["events"]]
    # two epochs: the dataset artifacts, 2 x (8 + 8) panels, 2 joined
    # tables and 2 model artifacts (latest, epoch N, best where fitness rose)
    assert kinds.count("log_artifact") == 4 and kinds.count("finish") == 1
    models = [e for e in got["events"] if e[0] == "log_artifact" and e[1]["type"] == "model"]
    assert [m[2][:2] for m in models] == [["latest", "epoch 0"], ["latest", "epoch 1"]]
    assert [e[0] for e in want["events"]] == kinds
    assert_close(got, want, CLI_ATOL)


def test_cli_wandb_panels_are_the_evaluated_boxes(cli_runs):
    """Each val image's panel holds the boxes of conf >= 0.25 among those
    evaluate_detection kept, in original pixels."""
    _, _, got, _ = cli_runs["port"]
    rows = [e[1] for e in got["events"] if e[0] == "add_data" and len(e[1]) == 4
            and isinstance(e[1][0], int) and isinstance(e[1][2], list)]
    assert len(rows) == 2 * 16
    for epoch, rid, (kind, _, boxes), avg in rows:
        data = boxes["predictions"]["box_data"]
        assert kind == "img" and all(b["scores"]["class_score"] >= 0.25 for b in data)
        if data:
            assert abs(avg - np.mean([b["scores"]["class_score"] for b in data])) < 1e-9


@pytest.mark.parametrize("logged_by,resumed_by", [("jax", "port"), ("port", "jax")])
def test_cli_model_artifact_resumes_in_the_other(cli_runs, tree, weights, tmp_path,  # noqa: F811
                                                 monkeypatch, logged_by, resumed_by):
    _, _, _, art = cli_runs[logged_by]
    assert art.metadata["epochs_trained"] == 1 and art.metadata["total_epochs"] == 2
    FakeWandb.registry["run_fake123_model"] = art
    argv = _cli_argv(tree, weights, tmp_path / "runs", "--epochs", "2", "--resume",
                     "wandb-artifact://runs/fake123")
    argv.pop(argv.index("--weights") + 1)
    argv.remove("--weights")
    registry = dict(FakeWandb.registry)
    from multiyolov5_tpu.cli import train as jax_cli
    fw = FakeWandb(keep=str(tmp_path / "kept"))
    FakeWandb.registry = registry
    _install(monkeypatch, JL if resumed_by == "jax" else PL, fw)
    if resumed_by == "jax":
        monkeypatch.setattr(jax_cli, "make_train_step", _still_step(_jax_zeros))
        run, _ = jax_cli.main(argv)
    else:
        monkeypatch.setattr(cli, "make_train_step", _still_step(_port_zeros))
        run, _ = cli.main(argv + ["--device", "cpu"])
    assert fw.run.id == "fake123" and fw.run.kw["project"] == "runs"
    rows = (Path(run) / "results.txt").read_text().split("\n")
    assert [r.split()[0] for r in rows if r] == ["1"]        # on from the artifact's epoch
    assert any(e[0] == "use_artifact" and e[1] == "run_fake123_model:latest"
               for e in FakeWandb.events)
