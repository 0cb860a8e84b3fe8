"""The port's device-trace tools on the CPU: ``tools/torch_trace_capture.py``
(the Chrome-trace summariser, the stage labels, the ops) and
``tools/torch_profile_map2alm.py`` (the map2alm stages).

The summariser is held to hand-built traces whose busy time, gaps and
labels are known exactly (the sums differ from the hand values by float
rounding only: ``rel=1e-12``).  A capture must leave every result bit for
bit unchanged, each op must enter the program's spans the tool lists for
it, and every span of the program must be entered by an op or by a test
here.  The profiler's stages
are held to ``sht.map2alm`` bit for bit and, in float64, to the JAX
package's ``map2alm`` and the JAX tool's C(l) at ``atol = 1e-10 * scale``
(tests/test_torch_ops.py's bar).  No card here: the tools' ``main()``
must refuse to run.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heracles_tpu.ops import sht as jsht
from heracles_tpu_torch import parallel, twopoint
from heracles_tpu_torch.ops import sht

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ttc = _load("torch_trace_capture")
tpm = _load("torch_profile_map2alm")

REP = ttc.REP_LABEL
B1F = ("void (anonymous namespace)::analysis_kernel<float, false, false>("
       "float const*, float const*, float const*, float const*, double "
       "const*, double const*, float2*, int, int, int, int)")
B2D = ("void (anonymous namespace)::pair_analysis_kernel<double, false>("
       "double const*, double const*, int, int)")
MUL = ("void at::native::vectorized_elementwise_kernel<4, at::native::"
       "BinaryFunctor<float, float, float, at::native::MulFunctor<float> >, "
       "std::array<char*, 3ul> >(int, at::native::BinaryFunctor<float, float, "
       "float, at::native::MulFunctor<float> >, std::array<char*, 3ul>)")
MUL_LABEL = MUL[len("void "):MUL.index(">(int") + 1]


def _x(cat, name, ts, dur, corr=None, tid=1, **args):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": float(ts), "dur": float(dur), "args": dict(args)}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _device(cat, name, ts, dur, corr, stream=7):
    e = _x(cat, name, ts, dur, corr, stream=stream)
    e["pid"], e["tid"] = 0, stream
    return e


def _trace(two_reps=False, lead=0.0):
    """One rep [1000, 2000] us: a memcpy (starting as its call starts), two
    kernels on two streams that overlap, a third kernel, a memset; gaps of
    20 (start), 10, 150, 550 and 38 (end) us.  ``two_reps``: a second rep
    [3000, 3500] with one kernel [3100, 3200].  ``lead``: the device
    clock that many us ahead of the host's."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "py"}},
        _x("user_annotation", REP, 1000, 1000),
        _x("user_annotation", "sht.map2alm", 1005, 895),
        _x("user_annotation", "sht_kernels.analysis_spin0_folded", 1030, 30),
        _x("cpu_op", "aten::copy_", 1010, 15),
        _x("cpu_op", "aten::mul", 1300, 20),
        _x("cuda_runtime", "cudaMemcpyAsync", 1020, 3, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 1040, 3, 11),
        _x("cuda_driver", "cuLaunchKernel", 1045, 3, 12),
        _x("cuda_runtime", "cudaLaunchKernel", 1305, 5, 13),
        _x("cuda_runtime", "cudaMemsetAsync", 1950, 5, 14),
        _x("cuda_runtime", "cudaLaunchKernel", 2450, 5, 15),
        _device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1020, 20, 10),
        _device("kernel", B1F, 1050, 100, 11),
        _device("kernel", B2D, 1100, 150, 12, stream=8),
        _device("gpu_user_annotation", "sht.map2alm", 1050, 200, None),
        _device("kernel", MUL, 1400, 10, 13),
        _device("gpu_memset", "Memset (Device)", 1960, 2, 14),
        # after the window: not counted
        _device("kernel", B1F, 2500, 100, 15),
    ]
    if two_reps:
        ev += [
            _x("user_annotation", REP, 3000, 500),
            _x("cuda_runtime", "cudaLaunchKernel", 3050, 5, 16),
            _device("kernel", B1F, 3100, 100, 16),
        ]
    for e in ev:
        if e.get("pid") == 0:
            e["ts"] -= lead
    return {"traceEvents": ev}


def _flat(gaps):
    return {(lab, k): v for lab, g in gaps.items() for k, v in g.items()}


B1_LABEL = "B1 analysis_kernel<float, false, false>"
B2_LABEL = "B2 pair_analysis_kernel<double, false>"
MEMCPY = "Memcpy HtoD (Pageable -> Device)"


def test_summarise_one_rep():
    s = ttc.summarise(_trace())
    approx = pytest.approx
    assert s["reps"] == 1
    assert s["window_ms"] == approx(1.0, rel=1e-12)
    # union: [1020, 1040] + [1050, 1250] + [1400, 1410] + [1960, 1962]
    assert s["busy_ms"] == approx(0.232, rel=1e-12)
    assert s["idle_ms"] == approx(0.768, rel=1e-12)
    assert s["idle_share"] == approx(0.768, rel=1e-12)
    assert s["busy_ms"] + s["idle_ms"] == approx(s["window_ms"], rel=1e-12)
    assert s["device_ms"] == approx({B2_LABEL: 0.15, B1_LABEL: 0.1,
                                     MEMCPY: 0.02, MUL_LABEL: 0.01,
                                     "Memset (Device)": 0.002}, rel=1e-12)
    assert s["launches"] == {B1_LABEL: 1, B2_LABEL: 1, MEMCPY: 1,
                             MUL_LABEL: 1, "Memset (Device)": 1}
    assert s["device_ms_by_label"] == approx({
        "sht_kernels.analysis_spin0_folded": 0.25, "sht.map2alm": 0.03,
        REP: 0.002}, rel=1e-12)
    # gaps longer than 20 us: 150 (K3, launched inside aten::mul), 550 (the
    # memset, launched in the rep alone), 38 to the window's end
    assert _flat(s["gaps"]) == approx(_flat({
        f"{REP} | -": {"n": 1, "ms": 0.55},
        "sht.map2alm | aten::mul": {"n": 1, "ms": 0.15},
        ttc.FINAL_SYNC: {"n": 1, "ms": 0.038}}), rel=1e-12)
    assert [lab for _, lab in s["longest_gaps"]] == [
        f"{REP} | -", "sht.map2alm | aten::mul", ttc.FINAL_SYNC]
    # the memcpy starts as its call starts: no clock correction
    assert s["launch_skew_us"] == 0.0 and s["clock_shift_us"] == 0.0
    assert s["device_ms_by_stage_op"] == approx({
        "sht_kernels.analysis_spin0_folded | -": 0.25,
        "sht.map2alm | aten::copy_": 0.02, "sht.map2alm | aten::mul": 0.01,
        f"{REP} | -": 0.002}, rel=1e-12)
    # what the host was inside while the card waited: the idle spans cut
    # at the annotations' edges (rep 5 + 60 + 38 us, map2alm 15 + 150 + 490,
    # the kernel entry point 10)
    assert s["idle_ms_by_host_label"] == approx({
        "sht.map2alm": 0.655, REP: 0.103,
        "sht_kernels.analysis_spin0_folded": 0.01}, rel=1e-12)
    assert ttc.launches_by_table(s) == {"B1": 1, "B2": 1}
    assert ttc.device_ms_by_table(s) == approx({"B1": 0.1, "B2": 0.15},
                                               rel=1e-12)


@pytest.mark.parametrize("min_gap_us, labels", [
    (5.0, {"sht.map2alm | aten::copy_": 0.02,
           "sht_kernels.analysis_spin0_folded | -": 0.01}),
    (20.0, {}),
])
def test_summarise_short_gaps(min_gap_us, labels):
    """The gap before the memcpy (20 us, queued inside aten::copy_) and the
    one before K1 (10 us) count only above ``min_gap_us``; the idle time
    holds them either way."""
    s = ttc.summarise(_trace(), min_gap_us=min_gap_us)
    short = {k: v["ms"] for k, v in s["gaps"].items()
             if k.endswith("aten::copy_") or k.startswith("sht_kernels.")}
    assert short == pytest.approx(labels, rel=1e-12)
    assert s["idle_ms"] == pytest.approx(0.768, rel=1e-12)


def test_summarise_two_reps():
    s = ttc.summarise(_trace(two_reps=True))
    assert s["reps"] == 2
    assert s["window_ms"] == pytest.approx(0.75, rel=1e-12)
    assert s["busy_ms"] == pytest.approx(0.166, rel=1e-12)
    assert s["idle_share"] == pytest.approx(1 - 0.332 / 1.5, rel=1e-12)
    assert s["launches"][B1_LABEL] == 1.0
    assert s["device_ms"][B1_LABEL] == pytest.approx(0.1, rel=1e-12)
    assert [r["busy_ms"] for r in s["per_rep"]] == pytest.approx(
        [0.232, 0.1], rel=1e-12)
    assert [r["window_ms"] for r in s["per_rep"]] == pytest.approx(
        [1.0, 0.5], rel=1e-12)
    assert s["per_rep"][1]["device_ms_by_label"] == pytest.approx(
        {REP: 0.1}, rel=1e-12)
    assert s["idle_ms_by_host_label"][REP] == pytest.approx(
        (0.103 + 0.4) / 2, rel=1e-12)
    assert sum(s["idle_ms_by_host_label"].values()) == pytest.approx(
        s["idle_ms"], rel=1e-12)
    # the second rep: 100 us before its kernel, 300 us after it
    assert s["gaps"][f"{REP} | -"] == pytest.approx(
        {"n": 1.0, "ms": 0.325}, rel=1e-12)
    assert s["gaps"][ttc.FINAL_SYNC] == pytest.approx(
        {"n": 1.0, "ms": 0.169}, rel=1e-12)


@pytest.mark.parametrize("lead", [0.5, 50.0, 900.0])
def test_summarise_moves_a_leading_device_clock(lead):
    """Device events recorded ahead of the calls that queued them: the
    summary moves the device clock back and is the unskewed trace's."""
    want = ttc.summarise(_trace(two_reps=True))
    got = ttc.summarise(_trace(two_reps=True, lead=lead))
    assert got["launch_skew_us"] == pytest.approx(-lead, rel=1e-12)
    assert got["clock_shift_us"] == pytest.approx(lead, rel=1e-12)
    for key in ("window_ms", "busy_ms", "idle_ms", "idle_share"):
        assert got[key] == pytest.approx(want[key], rel=1e-9)
    assert got["idle_ms_by_host_label"] == pytest.approx(
        want["idle_ms_by_host_label"], rel=1e-9)
    assert got["launches"] == want["launches"]
    assert _flat(got["gaps"]) == pytest.approx(_flat(want["gaps"]), rel=1e-9)


def test_summarise_unlaunched_event():
    """A device event whose correlation id has no host call is charged to
    "(no launch found)", as is the gap it ends."""
    trace = _trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e.get("args", {}).get("correlation") != 13
                            or e["cat"] != "cuda_runtime"]
    s = ttc.summarise(trace)
    assert s["device_ms_by_label"][ttc.NO_LAUNCH] == pytest.approx(0.01)
    assert s["gaps"][ttc.NO_LAUNCH] == pytest.approx({"n": 1, "ms": 0.15})


@pytest.mark.parametrize("trace, match", [
    ({"traceEvents": [_x("user_annotation", REP, 0, 10),
                      _x("cpu_op", "aten::mul", 1, 2)]}, "no device events"),
    ({"traceEvents": [_device("kernel", B1F, 0, 10, 1)]}, "annotation"),
])
def test_summarise_refuses(trace, match):
    with pytest.raises(ValueError, match=match):
        ttc.summarise(trace)


@pytest.mark.parametrize("name, label", [
    (B1F, B1_LABEL),
    (B1F.replace("<float, false, false>", "<float, true, false>"),
     "B1 analysis_kernel<float, true, false>"),
    (B1F.replace("<float, false, false>", "<double, false, false>"),
     "B1 analysis_kernel<double, false, false>"),
    (B2D, B2_LABEL),
    ("void (anonymous namespace)::pair_analysis_kernel<float, true>(float "
     "const*)", "B2 pair_analysis_kernel<float, true>"),
    ("void (anonymous namespace)::analysis_group_kernel<float, false, 8>("
     "float const*)", "B1 analysis_group_kernel<float, false, 8>"),
    ("void (anonymous namespace)::pair_group_kernel<double, false, 4>("
     "double const*)", "B2 pair_group_kernel<double, false, 4>"),
    ("void (anonymous namespace)::synth_group_kernel<float, true, 8>("
     "float const*)", "B3 synth_group_kernel<float, true, 8>"),
    ("void (anonymous namespace)::synth_pair_group_kernel<double, false, "
     "2>(double const*)", "B4 synth_pair_group_kernel<double, false, 2>"),
    ("void (anonymous namespace)::synthesis_kernel<float, false, false>("
     "float2 const*, float*)", "B3 synthesis_kernel<float, false, false>"),
    ("void (anonymous namespace)::pair_synthesis_kernel<double, false, "
     "false>(double2 const*)", "B4 pair_synthesis_kernel<double, false, false>"),
    ("void (anonymous namespace)::pair_synthesis_kernel<float, true, false>("
     "float2 const*)", "B4 pair_synthesis_kernel<float, true, false>"),
    ("void (anonymous namespace)::gram_kernel<true>(double const*, double "
     "const*, double const*, double*, int, int, int)",
     "B5 gram_kernel<true>"),
    ("void (anonymous namespace)::probe_kernel<double, 1, 4>(double const*)",
     "B6 probe_kernel<double, 1, 4>"),
    ("(anonymous namespace)::bin_kernel(double const*, double const*, "
     "double const*, long, int)", "S1 bin_kernel"),
    ("(anonymous namespace)::scan_kernel(int const*, int, int*, int*, int*)",
     "S1 scan_kernel"),
    ("(anonymous namespace)::order_kernel(int2 const*, int const*, long, "
     "long, int*)", "S1 order_kernel"),
    ("void (anonymous namespace)::spread_kernel<6, 1>((anonymous namespace)"
     "::SpreadArgs)", "S1 spread_kernel<6, 1>"),
    (MUL, MUL_LABEL),
    ("sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16",
     "sm90_xmma_gemm_f64f64_f64f64_f64_nn_n_tilesize64x64x16"),
])
def test_kernel_label(name, label):
    assert ttc.kernel_label(name) == label
    tag = label.split(" ")[0]
    assert ttc.table_tag(label) == (tag if tag[0] in "BS" and tag[1:].isdigit()
                                    else None)


def _captured(tmp_path, fn, name="op"):
    """The Chrome trace of one rep of ``fn`` captured by the tool on the
    CPU."""
    path = tmp_path / f"{name}.json"
    ttc.capture(fn, 1, "cpu", path)
    return ttc.load_trace(path)


def test_cpu_trace_has_no_device_events(tmp_path):
    """A real torch.profiler trace of the spin-0 op on the CPU."""
    fn = ttc.build_op("spin0", 8, 12, "cpu")
    fn()
    path = tmp_path / "spin0.json"
    ttc.capture(fn, 2, "cpu", path)
    trace = ttc.load_trace(path)
    assert ttc.dead(ttc.spans_in(trace), ttc.OP_LABELS["spin0"]) == []
    reps = [e for e in trace["traceEvents"] if e.get("name") == REP]
    assert len(reps) == 2
    with pytest.raises(ValueError, match="no device events"):
        ttc.summarise(trace)


def _rng_map(nside, spin, dtype=np.float64, seed=1):
    npix = 12 * nside * nside
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(
        size=(npix,) if spin == 0 else (2, npix)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spans_leave_results_unchanged(dtype, tmp_path):
    """The same calls outside and inside the tool's capture: equal results,
    bit for bit, and the capture's trace holds the calls' spans."""
    import heracles_tpu_torch as th

    nside, lmax = 8, 12
    m0, m2 = _rng_map(nside, 0, dtype), _rng_map(nside, 2, dtype)
    tdtype = {np.float64: torch.float64, np.float32: torch.float32}[dtype]
    mapper = th.HealpixMapper(nside, lmax, dtype=tdtype, device="cpu",
                              iterations=2)

    def run():
        return [sht.map2alm(m0, lmax), sht.map2alm(m2, lmax, spin=2),
                sht.map2alm(m0, lmax, iterations=2),
                sht.alm2map(sht.map2alm(m2, lmax, spin=2), nside, lmax,
                            spin=2),
                mapper.transform(m0, spin=0).array,
                mapper.transform(m2, spin=2).array]

    want = run()
    got = []
    spans = ttc.spans_in(_captured(tmp_path, lambda: got.extend(run())))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # two in map2alm(iterations=2), one direct, two in each mapper transform
    assert spans["sht.alm2map"] == 2 + 1 + 2 * 2
    assert spans["mappers.HealpixMapper.transform"] == 2


def _program_spans():
    """Every span name written in the program's source (``tracing.span`` /
    ``tracing.spanned`` with a literal name)."""
    names = set()
    pkg = os.path.join(REPO, "heracles_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names |= set(re.findall(
                        r'tracing\.span(?:ned)?\(\s*"([\w.]+)"', fh.read()))
    return names


def _spans(trace):
    """(name, start, end) of each span of the trace, in start order."""
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in trace["traceEvents"] if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def test_spans_nest_across_an_exception(tmp_path, monkeypatch):
    """A call that raises inside three nested spans: each span is closed
    in the trace, inside its parent, and the next call's spans are not
    inside them."""
    import heracles_tpu_torch as th
    from heracles_tpu_torch.ops import sht_kernels

    mapper = th.HealpixMapper(8, 12, device="cpu")
    m = _rng_map(8, 0)

    def boom(*args, **kwargs):
        raise RuntimeError("inside the kernel's span")

    def fn():
        with monkeypatch.context() as mp:
            mp.setattr(sht_kernels, "_run", boom)
            with pytest.raises(RuntimeError, match="kernel's span"):
                mapper.transform(m)
        mapper.transform(m)

    spans = _spans(_captured(tmp_path, fn))
    names = ("mappers.HealpixMapper.transform", "sht.map2alm",
             "sht_kernels.analysis_spin0_folded")
    # (start, end) of each call's span of each name, the failed call first
    calls = {n: [(a, b) for name, a, b in spans if name == n] for n in names}
    assert all(len(v) == 2 for v in calls.values()), calls
    failed, done = zip(*(calls[n] for n in names))
    for outer, inner in zip(failed, failed[1:]):
        assert outer[0] <= inner[0] <= inner[1] <= outer[1]
    # every span of the next call starts after the failed call's ended
    assert min(a for a, _ in done) >= failed[0][1]


OP_KW = {"pipeline": dict(rows=2000), "dices": dict(regions=3)}


@pytest.mark.parametrize("op", ttc.OPS)
def test_op_enters_its_spans(op, tmp_path):
    lmax = 8 if op == "dices" else 12
    fn = ttc.build_op(op, 8, lmax, "cpu", **OP_KW.get(op, {}))
    fn()
    out = []
    spans = ttc.spans_in(_captured(tmp_path, lambda: out.append(fn()), op))
    assert np.isfinite(out[0])
    assert ttc.dead(spans, ttc.OP_LABELS[op]) == []


def test_spans_off_the_ops_are_entered(tmp_path):
    """The spans no op runs: the inversion's pinv, the sharded analysis,
    the two mixing-matrix entry points and the pixel-window cache lookup
    (an nside above 32); with the ops' spans they are every span of the
    program."""
    rng = np.random.default_rng(2)
    cl = np.abs(rng.normal(size=9))
    mesh = parallel.make_mesh(2, m_axis=2, devices=["cpu"] * 2)
    maps = _rng_map(8, 0)[None]

    def fn():
        mm = twopoint.mixmat(cl, l1max=8, l2max=8, l3max=8, device="cpu")
        twopoint.mixmat_eb(cl, l1max=8, l2max=8, l3max=8, device="cpu")
        twopoint._pinv_batch(mm[None], 1e-5, "cpu")
        parallel.map2alm_sharded(mesh, maps, 12)
        sht.pixel_window(64, 8)

    off = ["twopoint.pinv", "parallel.map2alm_sharded", "twopoint.mixmat",
           "twopoint.mixmat_eb", "pixwin.find_cached"]
    assert ttc.dead(ttc.spans_in(_captured(tmp_path, fn)), off) == []
    every = set().union(*map(set, ttc.OP_LABELS.values()), off)
    assert every == _program_spans()


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_profile_stages_compose_to_map2alm(spin, dtype):
    nside, lmax = 8, 14
    maps = _rng_map(nside, spin, dtype, seed=3 + spin)
    ring, fold, kernel, cl = tpm.stages(maps, lmax, spin)
    alm = kernel(fold(ring(maps)))
    want = sht.map2alm(maps, lmax, spin=spin, packed=False)
    assert alm.dtype == want.dtype and torch.equal(alm, want)
    assert torch.equal(cl(alm), cl(want))
    if dtype != np.float64:
        return
    # against the JAX package's map2alm and the JAX tool's C(l)
    ja = np.asarray(jsht.map2alm(jnp.asarray(maps.numpy()), lmax, spin=spin,
                                 packed=False))
    np.testing.assert_allclose(alm.numpy(), ja, rtol=0,
                               atol=1e-10 * np.abs(ja).max())
    eps = np.where(np.arange(lmax + 1) == 0, 1.0, 2.0)
    jcl = (np.abs(ja) ** 2 * eps).sum(-1) / (2 * np.arange(lmax + 1) + 1)
    np.testing.assert_allclose(cl(alm).numpy(), jcl, rtol=0,
                               atol=1e-10 * np.abs(jcl).max())


def test_profile_keys_match_the_jax_tool():
    with open(os.path.join(TOOLS, "profile_map2alm.py")) as f:
        src = f.read()
    keys = set(re.findall(r'out\["(\w+)"\]', src))
    keys |= set(re.search(r"out\.update\(([^)]*)\)", src).group(1)
                .replace(" ", "").replace("=", ",").split(",")[::2])
    maps = _rng_map(8, 2)
    out = tpm.profile(maps, 12, 2, lambda fn: float(bool(fn() is not None)))
    out.update(nside=8, lmax=12, spin=2)
    assert set(out) == keys == {"ring_analysis_ms", "fold_weight_ms",
                                "kernel_ms", "cl_ms", "full_ms", "nside",
                                "lmax", "spin"}


@pytest.mark.parametrize("main, argv", [
    (ttc.main, ["--op", "spin0", "--nside", "8", "--lmax", "12"]),
    (tpm.main, ["--nside", "8", "--lmax", "12"]),
])
def test_main_refuses_without_a_card(main, argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ttc, "RECORDS", str(tmp_path / "records.json"))
    with pytest.raises(SystemExit) as exc:
        main(argv + (["--outdir", str(tmp_path)] if main is ttc.main else []))
    assert exc.value.code not in (0, None)
    assert not os.listdir(tmp_path)


def test_tools_load_no_jax():
    code = (
        "import sys, json; sys.path.insert(0, 'tools');"
        "import torch_trace_capture as t, torch_profile_map2alm as p;"
        "fn = t.build_op('spin0', 8, 12, 'cpu'); fn();"
        "fn = t.build_op('mesh', 8, 12, 'cpu'); fn();"
        "fn = t.build_op('dices', 8, 8, 'cpu', regions=3); fn();"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'heracles_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
