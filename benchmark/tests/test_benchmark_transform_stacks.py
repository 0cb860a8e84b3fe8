"""The reader of the program's count of transform calls
(``transforms_per_map``): a number on a toy ``--trace 1`` run on the CPU,
where the step's 10 maps stack as 8 and 2, and None for a program without
the counter, whether it lacks the tracing module or only the counter."""

import sys
import types

import pytest

import bench_toy
from hbench import runner


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("toy"))
    cache = bench_toy.make(dst)
    with pytest.MonkeyPatch.context() as mp:
        bench_toy.environ(mp, dst, cache)
        yield bench_toy.run(dst, "spin0_n4096_l3000", trace=True)


def test_transforms_per_map_on_a_traced_run(traced):
    got = traced["metrics"]["transforms_per_map"]
    assert got["unit"] == "count"
    # two calls (a stack of 8 and one of 2) a step of 10 maps
    assert got["value"] == pytest.approx(0.2)


@pytest.mark.parametrize("tracing", [None, types.SimpleNamespace()],
                         ids=["no module", "no counter"])
def test_transforms_per_map_without_the_counter(tracing, monkeypatch):
    if tracing is None:
        monkeypatch.delitem(sys.modules, "heracles_tpu_torch.tracing",
                            raising=False)
    else:
        monkeypatch.setitem(sys.modules, "heracles_tpu_torch.tracing",
                            tracing)
    run = types.SimpleNamespace(traffic={"fenced_steps": 4}, traced_steps=3,
                                sht_maps={0: 10})
    assert runner.load_reader("transforms_per_map")(run) is None
