"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have, and so does the control (the plain
reference with its ring sums in TF32) in the program's place.  Toy
size, on the CPU: the harness's look for a card is skipped, the rest of
a run is driven as the command drives it."""

import json
import os

import pytest

import bench_toy
import heracles_tpu_torch as th


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("toy"))
    cache = bench_toy.make(dst)
    with pytest.MonkeyPatch.context() as mp:
        bench_toy.environ(mp, dst, cache)
        yield dst


def altered_alms(orig):
    def transform(fields, data, **kw):
        out = orig(fields, data, **kw)
        out[next(iter(out))].array.mul_(1.01)
        return out
    return transform


def half_the_maps(orig):
    def transform(fields, data, **kw):
        keys = list(data)
        half = keys[: max(1, len(keys) // 2)]
        res = orig(fields, {k: data[k] for k in half}, **kw)
        out = th.TocDict()
        for i, k in enumerate(keys):
            out[k] = res[half[i % len(half)]]
        return out
    return transform


def previous_step(orig):
    last = []

    def transform(fields, data, **kw):
        out = orig(fields, data, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return transform


FAULTS = [
    ("spin0_n4096_l3000", "transform", altered_alms),
    ("spin0_n4096_l3000", "transform", half_the_maps),
    ("spin0_n4096_l3000", "transform", previous_step),
]


@pytest.mark.parametrize("cell,name,fault", FAULTS,
                         ids=[f[2].__name__ for f in FAULTS])
def test_fault_is_not_correct(toy, monkeypatch, cell, name, fault):
    monkeypatch.setattr(th, name, fault(getattr(th, name)))
    res = bench_toy.run(toy, cell, seconds=0.5)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", ["spin0_n4096_l3000"])
def test_control_is_not_correct(toy, cell):
    """The control at toy size reads above the cell's limits (those of the
    benchmark as committed) in at least one compared number."""
    import importlib

    import torch

    from hbench import runner

    spec = runner.load_spec(toy)
    _, config, traffic = runner.cell_files(spec, cell,
                                           os.path.join(toy, "benchmark"), toy)
    with open(os.path.join(bench_toy.HERE, "workloads", f"{cell}.json")) as f:
        limits = json.load(f)["limits"]
    entry = importlib.import_module(f"entries.{traffic['entry']}")
    ctx = runner.make_context(config, traffic, 99, torch.device("cpu"),
                              os.path.join(toy, "build"))
    c = entry.Cell(ctx)
    c.setup()
    kept = [c.step(k, ctx.no_spans) for k in range(traffic["kept_steps"])]
    c.release()
    program = c.check(kept)
    control = c.check(kept, "tf32")
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control
