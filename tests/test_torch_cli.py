"""The port's command line against heracles_tpu's, on the CPU.

The config factories and converters of ``tests/test_cli.py`` on the port
(its objects, with their device); one run of ``maps`` -> ``alms`` ->
``spectra`` -> ``mixmats`` through both CLIs on a tiny FITS catalogue
(``--device cpu`` for the port), plus ``alms`` -> ``spectra`` of a
pixel-free config, every output compared; ``python -m
heracles_tpu_torch``; the progress modules without their optional
packages.

Tolerance: both pipelines run in float64 on the same catalogue, with sums
in another order, 1e-10 of each output's largest value.
"""

import io
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import heracles_tpu.cli as jcli
import heracles_tpu_torch.cli as cli
from heracles_tpu_torch import twopoint
from heracles_tpu_torch.cli import (
    ConfigParser,
    bins_from_config,
    fields_from_config,
    getdict,
    getfilter,
    getlist,
    mapper_from_config,
    spectra_from_config,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_config(text):
    config = ConfigParser()
    config.read_file(io.StringIO(text))
    return config


def test_converters():
    assert getlist("a\nb\n\nc") == ["a", "b", "c"]
    assert getdict("x = 1\ny = 2") == {"x": "1", "y": "2"}
    with pytest.raises(ValueError):
        getdict("novalue")
    filt = getfilter("POS, ..., 0\nSHE_E")
    assert filt == [("POS", ..., 0), ("SHE_E",)]


def test_mapper_from_config():
    from heracles_tpu_torch.mappers import DiscreteMapper, HealpixMapper

    config = make_config(
        "[a]\nnside = 8\nlmax = 10\n"
        "[b]\nmapper = discrete\nlmax = 20\nepsilon = 1e-9\nmethod = exact\n"
        "[c]\nmapper = none\n"
    )
    m = mapper_from_config(config, "a", device="cpu")
    assert isinstance(m, HealpixMapper)
    assert m.nside == 8 and m.lmax == 10 and m.device == torch.device("cpu")
    assert mapper_from_config(config, "a").device == torch.device("cuda")
    d = mapper_from_config(config, "b", device="cpu")
    assert isinstance(d, DiscreteMapper)
    assert d.lmax == 20 and d.device == torch.device("cpu")
    assert d._epsilon == 1e-9 and d._method == "exact"
    assert mapper_from_config(config, "c") is None


def test_mapper_from_config_accuracy_knobs():
    config = make_config(
        "[a]\nnside = 8\nlmax = 10\ndd = true\niterations = 3\n"
        "[b]\nnside = 8\n"
    )
    m = mapper_from_config(config, "a")
    assert m._dd is True and m._iterations == 3
    m = mapper_from_config(config, "b")
    assert m._dd is None and m._iterations == 0
    config = make_config("[c]\nnside = 8\ndd = comp\n")
    assert mapper_from_config(config, "c")._dd == "comp"


def test_device_maps_from_config():
    """Maps stay on the device: true is accepted, false raises."""
    config = make_config("[a]\nnside = 8\ndevice_maps = true\n"
                         "[b]\nnside = 8\ndevice_maps = false\n")
    assert mapper_from_config(config, "a").nside == 8
    with pytest.raises(ValueError, match="device_maps=False"):
        mapper_from_config(config, "b")


def test_fields_from_config():
    from heracles_tpu_torch.fields import Positions, Shears, Visibility

    config = make_config(
        "[defaults]\nnside = 8\n"
        "[fields:POS]\ntype = positions\ncolumns = RA\n\tDEC\nmask = VIS\n"
        "[fields:SHE]\ntype = shears\n"
        "columns = RA\n\tDEC\n\tG1\n\t-G2\n\tWEIGHT\nmask = WHT\n"
        "[fields:VIS]\ntype = visibility\n"
    )
    fields = fields_from_config(config, device="cpu")
    assert isinstance(fields["POS"], Positions)
    assert fields["POS"].mask == "VIS"
    assert fields["POS"].columns == ("RA", "DEC", None)
    assert isinstance(fields["SHE"], Shears)
    assert fields["SHE"].columns == ("RA", "DEC", "G1", "-G2", "WEIGHT")
    assert isinstance(fields["VIS"], Visibility)
    assert {f.mapper.device for f in fields.values()} == {torch.device("cpu")}


def test_bins_from_config():
    config = make_config("[s]\nbins = 4 log\nlmin = 2\nlmax = 100\n")
    edges, w = bins_from_config(config, "s")
    assert w is None
    assert len(edges) == 5
    assert edges[0] == 2 and edges[-1] == 101
    config = make_config("[s]\nbins = 3 linear 2l+1\nlmax = 30\n")
    edges, w = bins_from_config(config, "s")
    assert w == "2l+1"
    np.testing.assert_allclose(np.diff(edges), np.diff(edges)[0])
    config = make_config("[s]\nlmax = 10\n")
    assert bins_from_config(config, "s") == (None, None)
    with pytest.raises(ValueError):
        bins_from_config(make_config("[s]\nbins = 1 log\nlmax = 9\n"), "s")
    with pytest.raises(ValueError):
        bins_from_config(make_config("[s]\nbins = 4 bad\nlmax = 9\n"), "s")


def test_spectra_from_config():
    config = make_config(
        "[spectra:full]\nlmax = 20\nl2max = 30\nl3max = 40\ndebias = false\n"
        "include = POS, ..., 0\n"
    )
    [(label, info)] = spectra_from_config(config)
    assert label == "full"
    assert info["lmax"] == 20 and info["l2max"] == 30 and info["l3max"] == 40
    assert info["debias"] is False
    assert info["include"] == [("POS", ..., 0)]
    assert spectra_from_config(make_config("[x]\na = 1\n")) == [(None, {})]


def test_defaults_section_applies():
    config = make_config(
        "[defaults]\nnside = 16\n[fields:POS]\ntype = positions\n"
        "columns = RA\n\tDEC\n"
    )
    fields = fields_from_config(config)
    assert fields["POS"].mapper.nside == 16


def _write_inputs(tmp_path):
    from heracles_tpu_torch import healpix
    from heracles_tpu_torch.fits import FitsFile
    from heracles_tpu_torch.io import write_maps

    rng = np.random.default_rng(0)
    n = 3000
    cat = str(tmp_path / "catalog.fits")
    FitsFile(cat, mode="rw", clobber=True).write_table(
        {
            "RA": rng.uniform(0, 360, n),
            "DEC": np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
            "W": rng.uniform(0.5, 1.5, n),
            "G1": rng.normal(0, 0.1, n),
            "G2": rng.normal(0, 0.1, n),
            "ZBIN": rng.integers(0, 2, n).astype(np.int32),
        },
        extname="CATALOG",
    )
    vmap = str(tmp_path / "vmap.fits")
    write_maps(vmap, {("VMAP", 0): np.ones(healpix.nside2npix(8))})
    # HEALPix fields through all four stages, with pixel windows
    cfg = str(tmp_path / "heracles.cfg")
    with open(cfg, "w") as fp:
        fp.write(
            "[defaults]\nnside = 8\nlmax = 12\n"
            "[fields:POS]\ntype = positions\ncolumns = RA\n\tDEC\nmask = VIS\n"
            "[fields:SHE]\ntype = shears\n"
            "columns = RA\n\tDEC\n\tG1\n\t-G2\n\tW\nmask = WHT\n"
            "[fields:VIS]\ntype = visibility\n"
            "[fields:WHT]\ntype = weights\ncolumns = RA\n\tDEC\n\tW\n"
            f"[catalogs:cat]\nsource = {cat}\nvisibility = {vmap}\n"
            "selections = 0 = ZBIN == 0\n\t1 = ZBIN == 1\n"
            "[spectra:full]\nlmax = 12\nl2max = 12\nl3max = 12\n"
            "bins = 3 log\nlmin = 2\n"
        )
    # pixel-free fields: alms straight from the catalogue
    cfgd = str(tmp_path / "discrete.cfg")
    with open(cfgd, "w") as fp:
        fp.write(
            "[defaults]\nmapper = discrete\nlmax = 12\n"
            "[fields:DSHE]\ntype = shears\n"
            "columns = RA\n\tDEC\n\tG1\n\t-G2\n\tW\n"
            "[fields:DWHT]\ntype = weights\ncolumns = RA\n\tDEC\n\tW\n"
            f"[catalogs:cat]\nsource = {cat}\n"
            "selections = 0 = ZBIN == 0\n\t1 = ZBIN == 1\n"
        )
    return cfg, cfgd


def _run(pkg_cli, tmp_path, tag, cfg, cfgd, **kw):
    from heracles_tpu_torch.io import read, read_alms, read_maps

    def path(name):
        return str(tmp_path / f"{tag}_{name}.fits")

    logger = logging.getLogger(f"test_torch_cli.{tag}")
    common = dict(logger=logger, progress=False, **kw)
    pkg_cli.maps(path("maps"), files=[cfg], **common)
    pkg_cli.alms(path("alms"), files=[cfg], maps=[path("maps")], **common)
    pkg_cli.spectra(path("cls"), files=[cfg], alms=[path("alms")], **common)
    pkg_cli.mixmats(path("mms"), files=[cfg], alms=[path("alms")], **common)
    pkg_cli.alms(path("dalms"), files=[cfgd], **common)
    pkg_cli.spectra(path("dcls"), files=[cfgd], alms=[path("dalms")], **common)
    return {
        "maps": read_maps(path("maps")), "alms": read_alms(path("alms")),
        "cls": read(path("cls")), "mms": read(path("mms")),
        "dalms": read_alms(path("dalms")), "dcls": read(path("dcls")),
    }


def test_cli_pipeline_matches_reference(tmp_path, monkeypatch):
    """All four stages of both CLIs on one catalogue give the same files."""
    monkeypatch.setenv("HERACLES_TPU_CACHE", str(tmp_path))
    cfg, cfgd = _write_inputs(tmp_path)
    want = _run(jcli, tmp_path, "ref", cfg, cfgd)
    # the spectra of alms read from files run on the stage's device: the
    # cls, the mixmats' mask spectra and the discrete cls
    devices = []
    real = twopoint.angular_power_spectra

    def spy(*args, **kw):
        devices.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(twopoint, "angular_power_spectra", spy)
    got = _run(cli, tmp_path, "port", cfg, cfgd, device="cpu")
    assert devices == ["cpu"] * 3
    counts = {"maps": 8, "alms": 8, "cls": 36, "mms": 10, "dalms": 4,
              "dcls": 10}
    for what, n in counts.items():
        assert set(got[what]) == set(want[what]) and len(got[what]) == n, what
        for key, w in want[what].items():
            g, w = np.asarray(got[what][key]), np.asarray(w)
            assert g.shape == w.shape, (what, key)
            scale = np.abs(w).max()
            assert np.max(np.abs(g - w)) <= 1e-10 * scale, (what, key)
    assert got["alms"]["SHE", 0].shape[0] == 2
    assert got["cls"]["POS", "POS", 0, 0].shape == (3,)
    assert got["mms"]["SHE", "SHE", 0, 0].shape == (3, 3, 13)
    assert got["dalms"]["DSHE", 1].dtype.metadata["geometry"] == "discrete"


def test_main_runs_a_stage(tmp_path, monkeypatch, capsys):
    """``main`` parses the arguments, ``--device`` included."""
    monkeypatch.setenv("HERACLES_TPU_CACHE", str(tmp_path))
    _, cfgd = _write_inputs(tmp_path)
    out = str(tmp_path / "alms.fits")
    assert cli.main(["alms", "-c", cfgd, "--no-progress", "--device", "cpu",
                     out]) == 0
    from heracles_tpu_torch.io import read_alms

    assert len(read_alms(out)) == 4
    # a stage that fails reports it and returns 1
    assert cli.main(["alms", "-c", str(tmp_path / "missing.cfg"),
                     "--device", "cpu", out]) == 1
    assert cli.main([]) == 1


def _python(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("module,package", [("rich_progress", "rich"),
                                            ("notebook", "ipywidgets")])
def test_progress_modules_without_their_package(module, package):
    """Without the optional package the import fails with the explainer's
    note; with a stand-in the progress protocol runs."""
    code = (
        f"import sys\nsys.modules[{package!r}] = None\n"
        "try:\n"
        f"    import heracles_tpu_torch.{module}\n"
        "except ModuleNotFoundError as exc:\n"
        "    assert 'missing external dependency' in ' '.join(exc.__notes__)\n"
        "else:\n"
        "    raise AssertionError('imported without its package')\n"
        "import heracles_tpu_torch.cli as cli\n"
        "assert cli._progress_obj(False) is None\n"
    )
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr


def test_progress_modules_with_stand_ins():
    code = """
import sys, types

class Box:
    def __init__(self, *a, **k):
        self.tasks, self.started, self.stopped, self.children = {}, 0, 0, ()
    def add_task(self, label, total=None):
        self.tasks[len(self.tasks)] = dict(label=label, total=total)
        return len(self.tasks) - 1
    def update(self, task_id, **k):
        self.tasks[task_id].update(k)
    def start(self):
        self.started += 1
    def stop(self):
        self.stopped += 1

class Bar:
    def __init__(self, value=0, min=0, max=1, description=""):
        self.value, self.max, self.description = value, max, description

rich = types.ModuleType("rich")
rich.progress = types.ModuleType("rich.progress")
for name in ("TextColumn", "BarColumn", "TaskProgressColumn",
             "TimeElapsedColumn"):
    setattr(rich.progress, name, lambda *a, **k: None)
rich.progress.Progress = Box
widgets = types.ModuleType("ipywidgets")
widgets.VBox, widgets.IntProgress = Box, Bar
ipy = types.ModuleType("IPython")
ipy.display = types.ModuleType("IPython.display")
ipy.display.display = lambda obj: None
sys.modules.update({"rich": rich, "rich.progress": rich.progress,
                    "ipywidgets": widgets, "IPython": ipy,
                    "IPython.display": ipy.display})

from heracles_tpu_torch.progress import Progress
from heracles_tpu_torch.rich_progress import RichProgress
from heracles_tpu_torch.notebook import NotebookProgress

with RichProgress("top") as top:
    assert isinstance(top, Progress)
    with top.task("child") as child:
        child.update(3, 10)
    assert top.box.tasks[1] == dict(label="  child", total=10, completed=3,
                                    visible=False)
assert top.box.started == top.box.stopped == 1
with NotebookProgress("nb") as nb:
    with nb.task("child") as child:
        child.update(2, 5)
        assert (child._bar.value, child._bar.max) == (2, 5)
    assert nb.container.children == (nb._bar,)
assert nb.container.children == ()
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr


def test_python_m_help():
    proc = subprocess.run([sys.executable, "-m", "heracles_tpu_torch", "--help"],
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "heracles-tpu-torch" in proc.stdout
    for command in ("maps", "alms", "spectra", "mixmats"):
        assert command in proc.stdout
