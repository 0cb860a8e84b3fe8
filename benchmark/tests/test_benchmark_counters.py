"""The readers of the program's counters (``hbench.counters``): numbers on
a toy ``--trace 1`` run on the CPU (no host wait or copy there, the ring
FFTs' tables built every step), None for a program without them."""

import sys

import pytest

import bench_toy
from hbench import runner

COUNTERS = ("host_syncs_per_map", "host_copies_per_map",
            "table_builds_per_map")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("toy"))
    cache = bench_toy.make(dst)
    with pytest.MonkeyPatch.context() as mp:
        bench_toy.environ(mp, dst, cache)
        yield bench_toy.run(dst, "spin0_n4096_l3000", trace=True)


def test_readers_return_numbers_on_a_traced_run(traced):
    values = {m: traced["metrics"][m]["value"] for m in COUNTERS}
    assert values["host_syncs_per_map"] == 0.0
    assert values["host_copies_per_map"] == 0.0
    # the ring FFTs' phases, chirps and rows, the fold and the pack index
    # of each transform (the toy's maps are stacked, so fewer than a map)
    assert values["table_builds_per_map"] > 0
    for m in COUNTERS:
        assert traced["metrics"][m]["unit"] == "count"


@pytest.mark.parametrize("name", COUNTERS)
def test_readers_without_the_program_counters(name, monkeypatch):
    import types

    monkeypatch.delitem(sys.modules, "heracles_tpu_torch.tracing",
                        raising=False)
    run = types.SimpleNamespace(traffic={"fenced_steps": 4}, traced_steps=3,
                                sht_maps={0: 10})
    assert runner.load_reader(name)(run) is None
