"""The cell at toy size (nside 32) on the CPU against the plain
reference, through the harness's whole run."""

import pytest

import bench_toy


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("toy"))
    cache = bench_toy.make(dst)
    with pytest.MonkeyPatch.context() as mp:
        bench_toy.environ(mp, dst, cache)
        yield dst


@pytest.fixture(scope="module")
def toy64(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("toy64"))
    cache = bench_toy.make(dst, dtype="float64")
    with pytest.MonkeyPatch.context() as mp:
        bench_toy.environ(mp, dst, cache)
        yield dst


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct(toy, trace):
    res = bench_toy.run(toy, "spin0_n4096_l3000", trace=trace)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1
    if trace:
        assert "spectra_ms" in res["metrics"]
        # a CPU trace has no device events: no device metric is read
        assert "idle_pct.maps" not in res["metrics"]
        assert "busy_s" not in res["device"]
    else:
        assert {"maps_per_s", "step_p90_ms", "setup_s"} == set(res["metrics"])


def test_float64_program_meets_the_reference(toy64):
    """In float64 the program and the reference agree to rounding: each
    compared number is below 1e-11, far under any limit."""
    res = bench_toy.run(toy64, "spin0_n4096_l3000")
    for name, check in res["checks"].items():
        assert check["value"] < 1e-11, (name, check)
