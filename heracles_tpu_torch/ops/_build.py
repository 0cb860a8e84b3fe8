"""Build and load the Hopper kernels of :mod:`heracles_tpu_torch.ops`.

The CUDA sources in ``heracles_tpu_torch/csrc/`` are compiled at first
use with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source, all started
together, and linked into one shared library with a plain C interface,
which is loaded with :mod:`ctypes`.  The library lands in
``build/heracles_tpu_torch/`` beside the package (named after a hash of
the sources and the headers they include, so an edited file is
rebuilt).  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .. import tracing

__all__ = ["KernelLibrary", "build", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name
                for name in ("sht_analysis.cu", "sht_analysis_pair.cu",
                             "sht_synthesis.cu", "sht_synthesis_pair.cu",
                             "gram.cu", "fma_peak.cu", "spread.cu",
                             "ringfft.cu"))
HEADERS = tuple(_PKG / "csrc" / name
                for name in ("sht_paths.cuh", "tc_contract.cuh",
                             "warp_reduce.cuh", "wigner_recurrence.cuh"))
BUILD_DIR = _PKG.parent / "build" / "heracles_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# every extern "C" function of SOURCES: name -> (restype, argtypes); the
# launchers return cudaGetLastError() as an int; the SHT launchers take
# the group size nb after m0 (the diagnostic paths launchers too: the pair
# analysis' counts its groups, the others their nb = 1 kernel)
_SIGNATURES = {
    "heracles_analysis_spin0_f32": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "heracles_analysis_spin0_f64": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "heracles_analysis_spin0_paths_f32": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    "heracles_analysis_spin0_comp_f32": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    "heracles_analysis_spin0_comp_paths_f32": (_I, [_P] * 9 + [_I] * 6 + [_P]),
    "heracles_analysis_spin0_blocks_per_sm": (_I, [_I, _I, _P]),
    "heracles_cuda_error_string": (ctypes.c_char_p, [_I]),
    "heracles_analysis_pair_f32": (_I, [_P] * 10 + [_I] * 7 + [_P]),
    "heracles_analysis_pair_f64": (_I, [_P] * 10 + [_I] * 7 + [_P]),
    "heracles_analysis_pair_comp_f32": (_I, [_P] * 11 + [_I] * 7 + [_P]),
    "heracles_analysis_pair_paths_f32": (_I, [_P] * 11 + [_I] * 7 + [_P]),
    "heracles_analysis_pair_comp_paths_f32": (_I, [_P] * 12 + [_I] * 7
                                              + [_P]),
    "heracles_analysis_pair_blocks_per_sm": (_I, [_I, _I, _P]),
    "heracles_synthesis_spin0_f32": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "heracles_synthesis_spin0_f64": (_I, [_P] * 7 + [_I] * 6 + [_P]),
    "heracles_synthesis_spin0_paths_f32": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    "heracles_synthesis_spin0_comp_f32": (_I, [_P] * 8 + [_I] * 6 + [_P]),
    "heracles_synthesis_spin0_comp_paths_f32": (_I, [_P] * 9 + [_I] * 6
                                                + [_P]),
    "heracles_synthesis_spin0_blocks_per_sm": (_I, [_I, _I, _P]),
    "heracles_synthesis_pair_f32": (_I, [_P] * 10 + [_I] * 7 + [_P]),
    "heracles_synthesis_pair_f64": (_I, [_P] * 10 + [_I] * 7 + [_P]),
    "heracles_synthesis_pair_paths_f32": (_I, [_P] * 11 + [_I] * 7 + [_P]),
    "heracles_synthesis_pair_comp_f32": (_I, [_P] * 11 + [_I] * 7 + [_P]),
    "heracles_synthesis_pair_comp_paths_f32": (_I, [_P] * 12 + [_I] * 7
                                               + [_P]),
    "heracles_synthesis_pair_blocks_per_sm": (_I, [_I, _I, _P]),
    "heracles_gram_f64": (_I, [_P] * 4 + [_I] * 3 + [_P]),
    "heracles_fma_peak_f32": (_I, [_P] * 3 + [_I] * 4 + [_P]),
    "heracles_fma_peak_f64": (_I, [_P] * 3 + [_I] * 4 + [_P]),
    "heracles_spread_es": (_I, [_P] * 4 + [_L, _I, _I, _L, _L, _I, _D]
                           + [_P] * 8 + [_I] * 4 + [_P]),
    "heracles_ring_rows_f32": (_I, [_P, _L] + [_P] * 3 + [_I] * 8 + [_P]),
    "heracles_ring_rows_f64": (_I, [_P, _L] + [_P] * 3 + [_I] * 8 + [_P]),
    "heracles_ring_spectrum_f32": (_I, [_P] * 2 + [_I] * 5 + [_P]),
    "heracles_ring_spectrum_f64": (_I, [_P] * 2 + [_I] * 5 + [_P]),
    "heracles_ring_orders_f32": (_I, [_P, _L, _I, _I, _P, _P] + [_I] * 9
                                 + [_P] * 4),
    "heracles_ring_orders_f64": (_I, [_P, _L, _I, _I, _P, _P] + [_I] * 9
                                 + [_P] * 4),
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """A loaded kernel library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    seconds: float  # build time (0.0 when an existing build was loaded)
    log: str  # nvcc's output, including ptxas' register and spill counts

    def check(self, err):
        """Raise if a launcher returned a CUDA error code."""
        if err != 0:
            msg = self.lib.heracles_cuda_error_string(err).decode()
            raise RuntimeError(f"CUDA kernel launch failed: {msg} ({err})")

    def blocks_per_sm(self, kernel, is_double, comp=False, nb=1):
        """Resident blocks per SM of ``analysis_spin0``, ``analysis_pair``,
        ``synthesis_spin0`` or ``synthesis_pair`` (none's shared memory
        grows with lmax); ``comp``: the compensated float32 instantiation;
        ``nb``: the group of maps."""
        n = ctypes.c_int(0)
        fn = getattr(self.lib, f"heracles_{kernel}_blocks_per_sm")
        variant = 2 if comp else int(is_double)
        self.check(fn(variant, nb, ctypes.addressof(n)))
        return n.value


def find_nvcc():
    """Path of ``nvcc`` on PATH or under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file() and os.access(cand, os.X_OK):
                return str(cand)
    return None


def _source_hash():
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library_path():
    return BUILD_DIR / f"libheracles_{_source_hash()}.so"


def _run(cmd):
    """Run one compiler command to its end; raises with its output."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{log}"
        )
    return log


def build(nvcc=None):
    """Compile the kernel library; returns (path, seconds, compiler log).

    Each source is compiled by its own ``nvcc``, all at once, and the
    objects are linked into one shared library.  Raises RuntimeError when
    ``nvcc`` is missing or a step fails, with the compiler's output in the
    message.
    """
    nvcc = nvcc or find_nvcc()
    if nvcc is None or not os.access(nvcc, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
            "/usr/local/cuda/bin): the CUDA kernels of heracles_tpu_torch "
            "need the CUDA toolkit"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _library_path()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in SOURCES]
    tmp = out.with_suffix(f".{tag}")
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(
                _run,
                [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(SOURCES, objs)],
            ))
        logs.append(_run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                          *map(str, objs)]))
        os.replace(tmp, out)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return out, time.perf_counter() - t0, "".join(logs)


@functools.lru_cache(maxsize=1)
def load_library():
    """Build (if needed) and load the kernel library, once per process."""
    path = _library_path()
    seconds, log = 0.0, ""
    if not path.exists():
        tracing.built("_build.library")
        path, seconds, log = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib, path, seconds, log)
