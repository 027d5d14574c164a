"""A recording stand-in for the ``wandb`` module: the one of
tests/test_loggers.py, copied, plus an ordered log of every call that
reaches it (``FakeWandb.events``) and, with ``FakeWandb.keep`` set to a
directory, a copy of each file an artifact adds (so a model artifact's
``download()`` gives the checkpoint as it was when it was logged).

The JAX logger takes it as ``multiyolov5_tpu.utils.loggers.wandb``; the
port's imports it from ``sys.modules["wandb"]``.  ``plain`` turns what it
recorded into plain data to compare.
"""

import argparse
import os
import shutil

import numpy as np


class FakeArtifact:
    def __init__(self, name=None, type=None, metadata=None):
        self.name, self.type = name, type
        self.metadata = metadata or {}
        self.files, self.objects, self._dir = [], {}, None
        FakeWandb.events.append(("Artifact", name, type, dict(self.metadata)))
        if FakeWandb.keep is not None:
            FakeWandb.kept += 1
            self._dir = os.path.join(FakeWandb.keep, str(FakeWandb.kept))

    def add_file(self, path, name=None):
        self.files.append((str(path), name))
        FakeWandb.events.append(("add_file", self.name, str(path), name))
        if self._dir is not None and FakeWandb.keep is not None:
            os.makedirs(os.path.join(self._dir, os.path.dirname(name or "")), exist_ok=True)
            shutil.copyfile(path, os.path.join(self._dir, name or os.path.basename(path)))

    def add(self, obj, name):
        self.objects[name] = obj
        FakeWandb.events.append(("add", self.name, name))

    def wait(self):
        return self

    def get(self, name):
        return self.objects.get(name)

    def download(self):
        return self._dir


class FakeTable:
    def __init__(self, columns=None):
        self.columns = list(columns) if columns else []
        self.data = []
        FakeWandb.events.append(("Table", list(self.columns)))

    def add_data(self, *row):
        self.data.append(list(row))
        FakeWandb.events.append(("add_data", list(row)))


class FakeRun:
    def __init__(self, **kw):
        self.id = kw.get("id") or "fake123"
        self.kw = kw
        self.config = argparse.Namespace()
        self.logged, self.artifacts, self.used = [], [], []
        self.finished = False

    def log(self, d, step=None):
        self.logged.append(dict(d))

    def log_artifact(self, art, aliases=None):
        self.artifacts.append((art, aliases or []))
        FakeWandb.events.append(("log_artifact", art, list(aliases or [])))

    def use_artifact(self, art):
        self.used.append(art)
        return art if not isinstance(art, str) else FakeWandb.registry.get(
            art.split(":")[0])

    def finish(self):
        self.finished = True
        FakeWandb.events.append(("finish",))


class FakeWandb:
    """Module stand-in; ``registry`` maps artifact name -> FakeArtifact for
    use_artifact-by-name lookups."""
    registry = {}
    events = []
    keep = None
    kept = 0
    Artifact, Table = FakeArtifact, FakeTable

    def __init__(self, keep=None):
        self.run = None
        self.logged = []
        FakeWandb.registry, FakeWandb.events = {}, []
        FakeWandb.keep, FakeWandb.kept = keep, 0

    def init(self, **kw):
        self.run = FakeRun(**kw)
        FakeWandb.events.append(("init", {k: v for k, v in kw.items() if k != "config"}))
        # route by-name use_artifact through the class registry
        run = self.run

        def use_artifact(art):
            run.used.append(art)
            FakeWandb.events.append(("use_artifact", art))
            if isinstance(art, str):
                got = FakeWandb.registry.get(art.split(":")[0])
                assert got is not None, f"no fake artifact {art}"
                return got
            return art
        run.use_artifact = use_artifact
        return self.run

    def log(self, d, step=None):
        self.logged.append(dict(d))
        FakeWandb.events.append(("log", dict(d)))

    @staticmethod
    def Image(src, classes=None, boxes=None):
        return ("img", src, boxes)

    @staticmethod
    def Classes(items):
        return ("classes", tuple(i["id"] for i in items))

    @staticmethod
    def JoinedTable(a, b, key):
        return ("joined", a, b, key)


def plain(obj, roots=()):
    """``obj`` as plain data: artifacts and tables as dicts, tuples as
    lists, numpy scalars as Python numbers, each of ``roots`` at the start
    of a string replaced by "<root>"."""
    if isinstance(obj, FakeArtifact):
        return {"artifact": obj.name, "type": obj.type, "metadata": plain(obj.metadata, roots),
                "files": plain(obj.files, roots), "objects": plain(obj.objects, roots)}
    if isinstance(obj, FakeTable):
        return {"columns": obj.columns, "data": plain(obj.data, roots)}
    if isinstance(obj, dict):
        return {str(k): plain(v, roots) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v, roots) for v in obj]
    if isinstance(obj, np.generic):
        return plain(obj.item(), roots)
    if isinstance(obj, str):
        for r in roots:
            if obj.startswith(str(r)):
                return "<root>" + obj[len(str(r)):]
    return obj


def assert_close(a, b, atol: float, path: str = "") -> None:
    """``a`` and ``b`` (plain data) equal but for floats within ``atol``
    (relative 1e-5 on top)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), b)
        for k in a:
            assert_close(a[k], b[k], atol, f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close(x, y, atol, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, str):
        assert abs(a - b) <= atol + 1e-5 * abs(b), (path, a, b)
    else:
        assert a == b, (path, a, b)
