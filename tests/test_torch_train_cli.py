"""The port's training CLI (multiyolov5_tpu_torch/cli/train.py) and
tools/resume.py on the CPU (``--device cpu``), at the TINY spec of
tests/test_torch_train_step.py (a PSP seg head) on seeded 64-96 px PNG
trees: a detection split of 16 frames and a custom-layout seg split of 4
train and 2 val frames, the dataset file in JSON.

* detection-only and joint runs: ``results.txt`` rows of the JAX CLI's
  format (the epoch and 11 finite numbers), ``hyp.yaml`` / ``opt.yaml``
  that parse as JSON, ``last.npz`` / ``best.npz`` stripped at the end and
  served by ``Engine``;
* ``--quad --multi-scale --image-weights --rect --adam --remat`` and
  ``--seg-loss ohem`` on the BiSe head;
* ``--evolve`` over two generations (the second mutates the first's hyps);
* an interrupted run: ``tools/resume.py --dry-run`` names it and skips a
  finished one; ``--resume`` continues at the next epoch from the
  optimizer buffers, EMA and update count the file held, bitwise;
* the checkpoints cross both ways: the JAX ``load_npz`` and the JAX CLI's
  ``--resume`` read the port's ``last.npz``, and the port's ``--resume``
  continues the JAX CLI's interrupted run;
* ``--num-processes 2`` and ``--model-parallel 2`` (two spawned ranks,
  gloo): rank 0 writes the one run directory; ``--rect`` under
  ``--model-parallel 2`` trains on batch heights that split unevenly;
* the W&B options that once raised (``--upload-dataset``,
  ``--bbox-interval``, ``--save-period``) run with wandb absent, the
  logger off and one line saying so, and the run's plots are written
  (``labels.jpg``, ``train_batch*.jpg``, ``results.png``);
  tests/test_torch_loggers.py runs them with a stand-in wandb.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multiyolov5_tpu_torch.cli import train as cli
from multiyolov5_tpu_torch.data import png
from multiyolov5_tpu_torch.engine import Engine
from multiyolov5_tpu_torch.tools import resume as resume_tool
from multiyolov5_tpu_torch.utils.checkpoint import from_jax_params, load_npz

import _torch_parallel_worker as W
from test_torch_train_step import HEAD_ROWS, TINY

from test_torch_profiling import one_torch_thread  # noqa: F401 (autouse)


def _frame(rng, h, w):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.RandomState(0)
    img_dir, lbl_dir = root / "images" / "train", root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i in range(16):
        h, w = ((64, 96), (96, 64), (80, 80), (64, 64))[i % 4]
        png.imwrite(str(img_dir / f"im{i:02d}.png"), _frame(rng, h, w))
        n = rng.randint(1, 4)
        rows = np.concatenate([rng.randint(0, 3, (n, 1)), rng.rand(n, 2) * 0.5 + 0.25,
                               rng.rand(n, 2) * 0.3 + 0.15], 1)
        (lbl_dir / f"im{i:02d}.txt").write_text(
            "".join("%d %.5f %.5f %.5f %.5f\n" % tuple(r) for r in rows))
    seg = root / "seg"
    for split, n in (("train", 4), ("val", 2)):
        (seg / "segimages" / split).mkdir(parents=True)
        (seg / "seglabels" / split).mkdir(parents=True)
        for i in range(n):
            png.imwrite(str(seg / "segimages" / split / f"s{i}.png"), _frame(rng, 64, 96))
            m = rng.randint(0, 4, (64, 96)).astype(np.uint8)
            m[:4] = 255
            png.imwrite(str(seg / "seglabels" / split / f"s{i}.png"), m)
    files = {}
    for name, extra in (("det", {}), ("joint", {"segtrain": str(seg), "segval": str(seg)})):
        files[name] = root / f"{name}.json"
        files[name].write_text(json.dumps({"train": str(img_dir), "val": str(img_dir),
                                           "nc": 3, "names": ["a", "b", "c"], **extra}))
    for head in ("SegMaskPSP", "SegMaskBiSe"):
        sp = json.loads(json.dumps(TINY))
        sp["head"][-2] = HEAD_ROWS[head]
        files[head] = root / f"{head}.json"
        files[head].write_text(json.dumps(sp))
    return files


def _argv(tree, tmp_path, data="joint", head="SegMaskPSP", epochs=1, *extra):
    return ["--data", str(tree[data]), "--cfg", str(tree[head]), "--epochs", str(epochs),
            "--batch-size", "4", "--img-size", "64", "64", "--base-size", "64",
            "--seg-data-kind", "custom", "--seg-eval-interval", "1", "--workers", "2",
            "--device", "cpu", "--fp32", "--no-tb", "--project", str(tmp_path / "runs"),
            "--log-interval", "1", *extra]


def _rows(run):
    rows = [r.split() for r in (Path(run) / "results.txt").read_text().strip().splitlines()]
    assert all(len(r) == 12 for r in rows)          # the epoch and 11 numbers
    assert np.isfinite(np.array(rows, float)).all()
    return rows


def _stripped(path):
    tree = load_npz(str(path))
    assert tree.get("opt") is None and tree["epoch"] is not None
    return tree


@pytest.mark.parametrize("data", ["det", "joint"])
def test_cli_runs_detection_only_and_joint(tree, tmp_path, data):
    run, best = cli.main(_argv(tree, tmp_path, data, "SegMaskPSP", 2))
    rows = _rows(run)
    assert [r[0] for r in rows] == ["0", "1"]
    seg_loss = [float(r[5]) for r in rows]
    assert (min(seg_loss) > 0) == (data == "joint")
    for f in ("hyp.yaml", "opt.yaml"):
        json.loads((Path(run) / f).read_text())
    weights = Path(run) / "weights"
    _stripped(weights / "last.npz")
    if (weights / "best.npz").exists():
        _stripped(weights / "best.npz")
    eng = Engine(str(weights / "last.npz"), device="cpu", half=False)
    dets, masks = eng((np.random.RandomState(1).rand(64, 64, 3) * 255).astype(np.uint8),
                      (64, 64), conf=0.001)
    assert masks[0].shape == (64, 64)


def test_cli_options(tree, tmp_path):
    run, _ = cli.main(_argv(tree, tmp_path, "joint", "SegMaskPSP", 1, "--quad", "--multi-scale",
                            "--image-weights", "--rect", "--adam", "--remat"))
    assert len(_rows(run)) == 1
    opt = json.loads((Path(run) / "opt.yaml").read_text())
    assert opt["quad"] and opt["adam"] and opt["remat"] and opt["image_weights"]
    run, _ = cli.main(_argv(tree, tmp_path, "joint", "SegMaskBiSe", 1, "--seg-loss", "ohem",
                            "--noautoanchor"))
    assert float(_rows(run)[0][5]) > 0


def test_cli_evolve(tree, tmp_path):
    cli.main(_argv(tree, tmp_path, "det", "SegMaskPSP", 1, "--evolve",
                   "--evolve-generations", "2", "--noautoanchor"))
    x = np.loadtxt(tmp_path / "runs" / "evolve.txt", ndmin=2)
    assert x.shape[0] == 2
    best = json.loads((tmp_path / "runs" / "hyp_evolved.yaml").read_text())
    assert set(best) <= set(cli.EVOLVE_META) and "lr0" in best
    assert not np.array_equal(x[0, 5:], x[1, 5:])     # the second generation mutated


class _Interrupt:
    """Wraps a CLI module's make_train_step: its step raises
    KeyboardInterrupt on call ``at`` (counting from 1)."""

    def __init__(self, module, at):
        self.module, self.at, self.calls = module, at, 0
        self.real = module.make_train_step

    def __call__(self, *a, **kw):
        step = self.real(*a, **kw)

        def wrapped(*args, **kwargs):
            self.calls += 1
            if self.calls == self.at:
                raise KeyboardInterrupt
            return step(*args, **kwargs)
        return wrapped


def test_cli_resume_and_resume_tool(tree, tmp_path, monkeypatch):
    """Run B stops at epoch 1's first step; the tool names it and skips
    the finished run A; --resume continues B at epoch 1 from the state the
    file held."""
    done, _ = cli.main(_argv(tree, tmp_path, "joint", "SegMaskPSP", 1, "--name", "a"))
    nb = 16 // 4
    monkeypatch.setattr(cli, "make_train_step", _Interrupt(cli, nb + 1))
    with pytest.raises(KeyboardInterrupt):
        cli.main(_argv(tree, tmp_path, "joint", "SegMaskPSP", 2, "--name", "b"))
    monkeypatch.undo()
    last = tmp_path / "runs" / "b" / "weights" / "last.npz"
    held = load_npz(str(last))
    assert held["epoch"] == 0 and held["opt"] is not None
    cmds = resume_tool.main(["--dir", str(tmp_path / "runs"), "--dry-run"])
    assert [c[c.index("--weights") + 1] for c in cmds] == [str(last)]
    assert resume_tool.unfinished(str(last))
    assert not resume_tool.unfinished(str(Path(done) / "weights" / "last.npz"))

    restored = _spy_restore(monkeypatch)
    run, _ = cli.main(["--resume", str(last), "--device", "cpu"])
    mom, ema, updates = restored[0]
    want = from_jax_params(held["opt"], {})
    assert set(mom) == set(want) and all(torch.equal(mom[k], want[k]) for k in mom)
    want = from_jax_params(held["ema_params"], held["ema_state"])
    assert set(ema) == set(want) and all(torch.equal(ema[k], want[k]) for k in ema)
    assert updates == int(held["updates"]) > 0
    assert [r[0] for r in _rows(run)] == ["0", "1"]
    _stripped(last)


def _spy_restore(monkeypatch):
    """Record copies of the momentum buffers, the EMA and the update count
    as cli._restore leaves them."""
    restored = []
    real = cli._restore

    def spy(ts, t, device):
        real(ts, t, device)
        restored.append(({k: v.clone() for k, v in ts.opt["momentum"].items()},
                         {k: v.clone() for k, v in ts.ema.items()}, ts.updates))
    monkeypatch.setattr(cli, "_restore", spy)
    return restored


def test_checkpoints_cross_both_ways(tree, tmp_path, monkeypatch):
    """The JAX CLI resumes the port's interrupted run, and the port resumes
    the JAX CLI's (detection-only, the JAX CLI's 8-device batch rounding
    on the CPU)."""
    from multiyolov5_tpu.cli import train as jax_cli
    from multiyolov5_tpu.utils.checkpoint import load_npz as jax_load_npz

    base = ["--data", str(tree["det"]), "--cfg", str(tree["SegMaskPSP"]), "--batch-size", "8",
            "--img-size", "64", "64", "--workers", "2", "--no-tb", "--noautoanchor",
            "--noval", "--fp32"]
    monkeypatch.setattr(cli, "make_train_step", _Interrupt(cli, 16 // 8 + 1))
    with pytest.raises(KeyboardInterrupt):
        cli.main(base + ["--epochs", "2", "--device", "cpu", "--project",
                         str(tmp_path / "port"), "--name", "p"])
    monkeypatch.undo()
    port_last = tmp_path / "port" / "p" / "weights" / "last.npz"
    jt = jax_load_npz(str(port_last))
    assert jt["epoch"] == 0 and jt["opt"] is not None and int(jt["updates"]) > 0
    run, _ = jax_cli.main(["--resume", str(port_last)])
    rows = (Path(run) / "results.txt").read_text().strip().splitlines()
    assert [r.split()[0] for r in rows] == ["0", "1"]       # epoch 1 appended

    monkeypatch.setattr(jax_cli, "make_train_step", _Interrupt(jax_cli, 16 // 8 + 1))
    with pytest.raises(KeyboardInterrupt):
        jax_cli.main(base + ["--epochs", "2", "--project", str(tmp_path / "jax"), "--name", "j"])
    monkeypatch.undo()
    jax_last = tmp_path / "jax" / "j" / "weights" / "last.npz"
    held = load_npz(str(jax_last))
    restored = _spy_restore(monkeypatch)
    run, _ = cli.main(["--resume", str(jax_last), "--device", "cpu"])
    mom, ema, updates = restored[0]
    want = from_jax_params(held["opt"], {})
    assert set(mom) == set(want) and all(torch.equal(mom[k], want[k]) for k in mom)
    want = from_jax_params(held["ema_params"], held["ema_state"])
    assert all(torch.equal(ema[k], want[k]) for k in ema)
    assert updates == int(held["updates"]) > 0
    assert [r[0] for r in _rows(run)] == ["0", "1"]         # epoch 1 appended


def test_cli_raises_what_it_does_not_have(tree, tmp_path, monkeypatch, capsys):
    """The W&B options once raised; without wandb they now run with the
    logger off (one printed line), and the run writes its plots."""
    import sys
    monkeypatch.setitem(sys.modules, "wandb", None)        # wandb does not import
    run, _ = cli.main(_argv(tree, tmp_path, "det", "SegMaskPSP", 1, "--upload-dataset",
                            "--bbox-interval", "5", "--save-period", "1"))
    assert "W&B: off (wandb does not import)" in capsys.readouterr().out
    assert len(_rows(run)) == 1
    for f in ("labels.jpg", "train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg",
              "results.png"):
        assert (Path(run) / f).is_file(), f


@pytest.mark.parametrize("extra", [[], ["--model-parallel", "2"]], ids=["dp2", "dp1_sp2"])
def test_cli_multi_process(tree, tmp_path, extra):
    """``--num-processes 2`` (gloo on the CPU, a ``file://`` rendezvous), as
    the JAX CLI's test_train_cli_model_parallel: the global batch of 4 over
    two ranks, or with ``--model-parallel 2`` the image H axis over them;
    rank 0 alone writes the run, whose checkpoint serves and which
    ``--resume`` continues as two ranks."""
    argv = _argv(tree, tmp_path, "joint", "SegMaskPSP", 1,
                 "--coordinator", f"file://{tmp_path}/store", *extra)
    res = W.launch_cli(2, argv, tmp_path)
    run = res[0][0]
    assert res[1][0] == run and len(list((tmp_path / "runs").iterdir())) == 1
    rows = _rows(run)
    assert [r[0] for r in rows] == ["0"] and float(rows[0][5]) > 0     # seg loss
    json.loads((Path(run) / "hyp.yaml").read_text())
    assert json.loads((Path(run) / "opt.yaml").read_text())["num_processes"] == 2
    last = Path(run) / "weights" / "last.npz"
    _stripped(last)
    eng = Engine(str(last), device="cpu", half=False)
    _, masks = eng((np.random.RandomState(1).rand(64, 64, 3) * 255).astype(np.uint8),
                   (64, 64), conf=0.001)
    assert masks[0].shape == (64, 64)
    # --resume as two ranks: the finished run fine-tunes one epoch more
    res = W.launch_cli(2, ["--resume", str(last), "--device", "cpu",
                           "--coordinator", f"file://{tmp_path}/store2"], tmp_path)
    assert res[0][0] == res[1][0] == run
    assert [r[0] for r in _rows(run)] == ["0", "1"]


def test_cli_rect_under_model_parallel(tree, tmp_path):
    """``--rect`` under ``--model-parallel 2`` at 96: the rect batches of the
    taller frames are 96 rows high, 3 units of the stride, which the two
    ranks split 64 + 32 (mesh.split_rows); the epoch trains and its losses
    are finite."""
    from multiyolov5_tpu_torch.data.detection import DetectionDataset

    ds = DetectionDataset(str(json.loads(tree["det"].read_text())["train"]), img_size=96,
                          batch_size=4, augment=True, rect=True, stride=32)
    assert 96 in {int(h) for h, _ in ds.batch_shapes}
    argv = _argv(tree, tmp_path, "joint", "SegMaskPSP", 1, "--coordinator",
                 f"file://{tmp_path}/store", "--model-parallel", "2", "--rect")
    argv[argv.index("--img-size") + 1:argv.index("--img-size") + 3] = ["96", "96"]
    res = W.launch_cli(2, argv, tmp_path)
    assert res[0][0] == res[1][0]
    rows = _rows(res[0][0])
    assert [r[0] for r in rows] == ["0"] and float(rows[0][5]) > 0


def test_cli_model_parallel_must_divide_the_world(tree, tmp_path):
    """As the JAX CLI's :147-149: one process cannot hold a model axis of 2."""
    with pytest.raises(SystemExit, match="does not divide"):
        cli.main(_argv(tree, tmp_path, "det", "SegMaskPSP", 1, "--model-parallel", "2"))
