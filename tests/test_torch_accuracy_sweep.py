"""``tools/torch_accuracy_sweep.py`` at a toy size on the CPU.

The tool's CPU path (the plain versions, no times): its JSON lines and
file, the records of the four modes, its band and C(l) helpers against
``tools/accuracy_sweep.py``'s, and that it loads no JAX.
"""

import importlib.util
import json
import subprocess
import sys

import numpy as np

TOOL = "tools/torch_accuracy_sweep.py"
MODES = ("f32", "comp", "dd", "f64")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_sweep_writes_every_mode(tmp_path, monkeypatch, capsys):
    sweep = _load("torch_accuracy_sweep_under_test", TOOL)
    out = tmp_path / "sweep.json"
    out.write_text(json.dumps({"kept": {"nside": 1}}))
    monkeypatch.setattr(sys, "argv", [TOOL, "--nside", "8", "--lmax", "12",
                                      "--device", "cpu", "--out", str(out)])
    sweep.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["spin"] for r in lines] == [0, 2]
    saved = json.loads(out.read_text())
    assert sorted(saved) == ["kept", "n8_l12_s0", "n8_l12_s2"]
    for rec in lines:
        assert rec["device"] == "cpu" and rec["card"] is None
        for direction in ("analysis", "synthesis"):
            assert tuple(rec[direction]) == MODES
            for row in rec[direction].values():
                assert row["kernel_ms"] is None and row["transform_ms"] is None
                assert 0 < row["alm_rms_rel"] <= row["alm_max_rel"] < 1e-1
                assert list(row["cl_band_max_rel"]) == ["2-2", "3-4", "5-5",
                                                        "6-8", "9-12"]
        # the float64 synthesis is the truth map itself; float32 is not
        syn = rec["synthesis"]
        assert syn["f64"]["map_max_rel"] == 0.0
        assert 0 < syn["dd"]["map_max_rel"] < syn["f32"]["map_max_rel"] < 1e-5


def test_helpers_match_the_reference_tool():
    port = _load("torch_accuracy_sweep_helpers", TOOL)
    ref = _load("accuracy_sweep_reference", "tools/accuracy_sweep.py")
    rng = np.random.default_rng(2)
    rel = rng.uniform(size=(2, 301))
    assert port.band_max(rel, 300) == ref._band_max(rel, 300)
    alm = port.make_alms(20, 0, seed=4)
    ls, ms = np.nonzero(np.ones((21, 21)))
    keep = ms <= ls
    from heracles_tpu.ops import sht as jsht

    packed = np.asarray(jsht.pack_alm(alm, 20, 20))
    np.testing.assert_allclose(port.cl_of(alm), ref._cl_of(packed, 20),
                               rtol=1e-14)
    assert not alm[ls[~keep], ms[~keep]].any()


def test_sweep_imports_no_jax():
    code = ("import runpy, sys; sys.argv = ['x', '--nside', '4', '--lmax', "
            "'6', '--spin', '0', '--device', 'cpu']; "
            f"runpy.run_path({TOOL!r}, run_name='__main__'); "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert 'heracles_tpu' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["nside"] == 4
