"""The harness finds what a later change adds as files and entries alone:
a configuration, a cell (traffic file) and a per-layer metric, in a
temporary copy of the benchmark, run in a process of its own."""

import json
import os
import subprocess
import sys

import bench_toy

SCRIPT = """
import json, os, sys, time
dst = sys.argv[1]
sys.path[:0] = [os.path.join(dst, "benchmark"), sys.argv[2]]
import torch
from hbench import runner
spec = runner.load_spec(dst)
res = runner.run_cell(spec, "spin0_two_maps", 2**33 + 5, 0.5, False,
                      torch.device("cpu"), time.time(),
                      bench=os.path.join(dst, "benchmark"), root=dst,
                      build_dir=os.path.join(dst, "build"))
print(json.dumps(res))
"""


def test_new_cell_config_and_metric_are_found(tmp_path):
    dst = str(tmp_path)
    cache = bench_toy.make(dst)
    bench = os.path.join(dst, "benchmark")
    # a new configuration: two maps
    with open(os.path.join(bench, "configs", "clustering_n4096_l3000.json")) as f:
        cfg = json.load(f)
    cfg.update(name="two_maps", bins=2)
    with open(os.path.join(bench, "configs", "two_maps.json"), "w") as f:
        json.dump(cfg, f)
    # a new cell of it, with its own traffic file
    with open(os.path.join(bench, "workloads", "spin0_n4096_l3000.json")) as f:
        traffic = json.load(f)
    traffic.update(traffic="two_map_stream", kept_steps=1)
    with open(os.path.join(bench, "workloads", "spin0_two_maps.json"), "w") as f:
        json.dump(traffic, f)
    # a new end-to-end metric, read by a new file
    with open(os.path.join(bench, "metrics", "maps_total.py"), "w") as f:
        f.write("def read(run):\n    return float(sum(run.units))\n")
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "two_maps", "source": "test",
                            "file": "benchmark/configs/two_maps.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "spin0_two_maps", "config": "two_maps",
                              "traffic": "two_map_stream", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "maps_total", "unit": "maps",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["spin0_two_maps"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, dst, bench_toy.ROOT], capture_output=True,
        text=True, timeout=600, env={**os.environ, "HERACLES_TPU_CACHE": cache})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    total = res["metrics"]["maps_total"]["value"]
    assert total == 2 * res["attempted"]
    assert "maps_per_s" not in res["metrics"]  # listed for another cell


def test_benchmark_json_names_files_that_exist():
    with open(os.path.join(bench_toy.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    bench = bench_toy.HERE
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(bench_toy.ROOT, c["file"]))
    for w in spec["workloads"]:
        with open(os.path.join(bench, "workloads", f"{w['name']}.json")) as f:
            traffic = json.load(f)
        assert traffic["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(bench, "entries",
                                           f"{traffic['entry']}.py"))
        assert os.path.exists(os.path.join(bench, "reference",
                                           f"{traffic['entry']}.py"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics", f"{m['name']}.py"))
