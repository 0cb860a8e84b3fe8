"""The port's spans and counters (``heracles_tpu_torch.tracing``).

On the CPU: spans reach a ``torch.profiler`` trace only while it records,
nested as called and closed on an exception; the transform and the
spectra give the same bits with the profiler on and off; one reset zeroes
every counter of the registry; the CPU ``map2alm`` counts its tables and
no host wait or copy.  On the card (``-m cuda``; skips here): the host
waits counted equal the synchronisations torch's sync-debug mode reports,
and the copies counted equal the trace's host-card memcpy events.  The
file imports no JAX, so on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py
"""

import json
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import heracles_tpu_torch as th
from heracles_tpu_torch import tracing
from heracles_tpu_torch.ops import gram, ringfft, sht, sht_kernels, wigner


def _spans(prof, tmp_path):
    """(name, start, end) of the trace's spans, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def test_span_is_a_shared_no_op_without_a_profiler():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a") as s:
        assert s is tracing.span("c")

    @tracing.spanned("test.f")
    def f(x, *, y):
        """f's docstring."""
        return x + y

    assert f(1, y=2) == 3 and f.__doc__ == "f's docstring."


def test_spans_are_in_the_trace_only_while_it_records(tmp_path):
    @tracing.spanned("test.inner")
    def inner():
        with tracing.span("test.innermost"):
            pass

    def outer():
        with tracing.span("test.outer"):
            inner()

    outer()  # before: not recorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outer()
    outer()  # after: not recorded
    spans = [s for s in _spans(prof, tmp_path) if s[0].startswith("test.")]
    assert [s[0] for s in spans] == ["test.outer", "test.inner",
                                     "test.innermost"]
    for (_, a0, a1), (_, b0, b1) in zip(spans, spans[1:]):
        assert a0 <= b0 <= b1 <= a1


def test_spans_close_on_an_exception(tmp_path):
    @tracing.spanned("test.raises")
    def raises():
        with tracing.span("test.inside"):
            raise KeyError("x")

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with tracing.span("test.outer"):
                raises()
        with tracing.span("test.after"):
            pass
    spans = {s[0]: s[1:] for s in _spans(prof, tmp_path)
             if s[0].startswith("test.")}
    assert set(spans) == {"test.outer", "test.raises", "test.inside",
                          "test.after"}
    (o0, o1), (r0, r1), (i0, i1) = (spans[n] for n in (
        "test.outer", "test.raises", "test.inside"))
    assert o0 <= r0 <= i0 <= i1 <= r1 <= o1
    assert spans["test.after"][0] >= o1


def _maps(nside, spin, dtype, seed=5):
    rng = np.random.default_rng(seed)
    shape = (2, 12 * nside**2) if spin == 0 else (2, 2, 12 * nside**2)
    return torch.as_tensor(rng.normal(size=shape)).to(dtype)


@pytest.mark.parametrize("spin", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_results_equal_with_the_profiler_on_and_off(spin, dtype):
    nside, lmax = 8, 12
    mapper = th.HealpixMapper(nside, lmax, dtype=dtype, device="cpu",
                              iterations=1)
    maps = _maps(nside, spin, dtype)

    def run():
        alm = mapper.transform(maps, spin=spin, metadata={"spin": spin})
        cls = th.angular_power_spectra({("F", i): alm[i] for i in range(2)})
        back = sht.alm2map(alm.array, nside, lmax, spin=spin)
        return [alm.array, back, *(c.array for c in cls.values())]

    off = run()
    with profile(activities=[ProfilerActivity.CPU]):
        on = run()
    for a, b in zip(on, off, strict=True):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_reset_zeroes_every_counter():
    # the modules' counters are the registry's, under their old names
    assert sht_kernels.LAUNCHES is tracing.counter("sht_kernels.LAUNCHES")
    assert wigner.PLAIN_RUNS is tracing.counter("wigner.PLAIN_RUNS")
    assert gram.LAUNCHES is tracing.counter("gram.LAUNCHES")
    names = set(tracing.counts())
    assert {"host_syncs", "host_copies", "table_builds",
            "sht_kernels.LAUNCHES_BY_NB", "gram.PLAIN_RUNS"} <= names
    for name in names:
        tracing.counter(name)["test"] += 1
    sht_kernels.LAUNCHES["analysis_spin0_folded"] += 2
    # any module's reset_counts zeroes them all
    gram.reset_counts()
    assert tracing.counts() == {name: {} for name in names}
    tracing.TABLE_BUILDS["test"] += 1
    tracing.reset()
    assert not tracing.TABLE_BUILDS and not sht_kernels.LAUNCHES


@pytest.mark.parametrize("spin", [0, 2])
def test_cpu_map2alm_counts_tables_and_no_host_traffic(spin):
    nside, lmax = 8, 12
    maps = _maps(nside, spin, torch.float64)[0]
    sht.map2alm(maps, lmax, spin=spin)  # the cached host tables built
    tracing.reset()
    sht.map2alm(maps, lmax, spin=spin)
    plan = ringfft.ring_plan(nside, lmax + 1)
    caps = sum(not b["belt"] for b in plan)
    assert dict(tracing.TABLE_BUILDS) == {
        "ringfft.weights": 1, "ringfft.phase": len(plan),
        "ringfft.cap_rows": caps,
        # complex input (spin 2) runs both directions of each cap bucket
        "ringfft.chirp": caps * (2 if spin else 1),
        "sht.geometry": 1, "sht.fold_sign": 1, "sht.pack_index": 1}
    assert not tracing.HOST_SYNCS and not tracing.HOST_COPIES


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda")


def _memcpys(prof, tmp_path):
    """The host-card memcpy events of the trace: {"h2d": n, "d2h": n}."""
    path = tmp_path / "card.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("ph") == "X"
             and e.get("cat") == "gpu_memcpy"]
    return {"h2d": sum(n.startswith("Memcpy HtoD") for n in names),
            "d2h": sum(n.startswith("Memcpy DtoH") for n in names)}


def _increase(before, name):
    after = tracing.counts()[name]
    return {k: v - before[name].get(k, 0) for k, v in after.items()
            if v != before[name].get(k, 0)}


@pytest.mark.cuda
def test_counts_match_the_cards_record(card, tmp_path):
    """One transform of 2 maps at nside 256 and their spectra, warmed up,
    then once under the sync-debug mode and the profiler."""
    nside = 256
    mapper = th.HealpixMapper(nside, dtype=torch.float32, device=card)
    maps = _maps(nside, 0, torch.float32).to(card)

    def run():
        alm = mapper.transform(maps, metadata={"spin": 0})
        return th.angular_power_spectra({("P", i): alm[i] for i in range(2)})

    run()
    torch.cuda.synchronize()
    before = tracing.counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    syncs = _increase(before, "host_syncs")
    copies = _increase(before, "host_copies")
    warned = [str(w.message) for w in caught
              if "synchronizing CUDA operation" in str(w.message)]
    assert sum(syncs.values()) == len(warned), (syncs, warned)
    counted = {d: sum(v for (_, k), v in copies.items() if k == d)
               for d in ("h2d", "d2h")}
    assert counted == _memcpys(prof, tmp_path), copies
    assert syncs and counted["h2d"] and counted["d2h"]
