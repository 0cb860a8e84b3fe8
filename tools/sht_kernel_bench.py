"""Time the four SHT kernels of one checkout of the port on the card.

    python3 tools/sht_kernel_bench.py [--root DIR] [--label NAME]
                                      [--nside 4096] [--lmax 3000]
                                      [--double | --comp]

Builds the kernels of the ``heracles_tpu_torch`` package under ``--root``
(default: this checkout), runs the spin-0 and spin-pair analysis and
synthesis in float32 (float64 with ``--double``, the compensated float32
instantiations with ``--comp``) on seeded random inputs at one map's
shapes (2 nside northern rings, lmax + 1 orders), and prints, on lines
that start with ``--label``:

* ptxas' registers and spills of the SHT kernels;
* per kernel the times of three launches after a warm-up (ms, CUDA
  events) and a digest of its outputs;
* where the package has them, the path counts of the spin-0 analysis and
  of the syntheses and the resident blocks per SM.

Two checkouts given the same seed get the same inputs, so equal digests
mean that two versions of a kernel agree bit for bit.  To compare two
versions on one card, unpack the other one (``git archive``) into an
ignored directory and run parent, change, change, parent in one command.
Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--label", default="bench")
    parser.add_argument("--nside", type=int, default=4096)
    parser.add_argument("--lmax", type=int, default=3000)
    parser.add_argument("--seed", type=int, default=5)
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--double", action="store_true")
    mode.add_argument("--comp", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, args.root)

    import torch

    from heracles_tpu_torch.ops import _build, sht, sht_kernels

    # the comp instantiations' keywords (packages without them take none)
    kw = dict(dd="comp", x_lo=sht._x_lo(args.nside, "comp", "cuda")) \
        if args.comp else {}

    if not torch.cuda.is_available():
        raise SystemExit("sht_kernel_bench: torch sees no CUDA device")
    dev = torch.device("cuda")
    label, lmax = args.label, args.lmax

    kl = _build.load_library()
    print(label, f"build {kl.seconds:.1f} s", flush=True)
    keep = False
    for line in kl.log.splitlines():
        if "Compiling entry function" in line:
            keep = "analysis_kernel" in line or "synthesis_kernel" in line
        if keep and ("Compiling" in line or "Used" in line or "spill" in line):
            print(label, line.strip()[:200])

    x, lch, lsh = sht._geometry(args.nside, dev)
    nhalf, nm = x.shape[0], lmax + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    real = torch.float64 if args.double else torch.float32

    def rnd(shape):
        re, im = (torch.randn(shape, generator=gen, device=dev, dtype=real)
                  for _ in range(2))
        return torch.complex(re, im)

    F = [rnd((nhalf, nm)) for _ in range(4)]
    A = [rnd((nm, nm)) for _ in range(2)]

    def timed(fn, n=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            times.append(round(start.elapsed_time(stop), 2))
        return out, times

    def digest(out):
        out = out if isinstance(out, (tuple, list)) else (out,)
        raw = b"".join(t.cpu().numpy().tobytes() for t in out)
        return hashlib.sha256(raw).hexdigest()[:12]

    kernels = {
        "analysis_spin0_folded": lambda: sht_kernels.analysis_spin0_folded(
            F[0], F[1], x, lch, lsh, lmax, **kw),
        "analysis_pair_folded": lambda: sht_kernels.analysis_pair_folded(
            *F, x, lch, lsh, lmax, 2, **kw),
        "synthesis_spin0_folded": lambda: sht_kernels.synthesis_spin0_folded(
            A[0], x, lch, lsh, lmax, **kw),
        "synthesis_pair_folded": lambda: sht_kernels.synthesis_pair_folded(
            *A, x, lch, lsh, lmax, 2, **kw),
    }
    result = {}
    for name, fn in kernels.items():
        out, times = timed(fn)
        result[name] = {"ms": times, "digest": digest(out)}
        del out
    print(label, json.dumps(result), flush=True)

    if hasattr(sht_kernels, "path_counts") and not args.double:
        # the spin-0 synthesis has paths only in later versions of the package
        synth0 = "heracles_synthesis_spin0_paths_f32" in _build._SIGNATURES
        print(label, "paths analysis_spin0_folded", sht_kernels.path_counts(
            "analysis_spin0_folded", F[0], F[1], x, lch, lsh, lmax, **kw))
        if synth0:
            print(label, "paths synthesis_spin0_folded", sht_kernels.path_counts(
                "synthesis_spin0_folded", A[0], x, lch, lsh, lmax, **kw))
        print(label, "paths synthesis_pair_folded", sht_kernels.path_counts(
            "synthesis_pair_folded", *A, x, lch, lsh, lmax, 2, **kw))
        for kernel in ("analysis_spin0", "analysis_pair",
                       *(("synthesis_spin0",) if synth0 else ()),
                       "synthesis_pair"):
            blocks = [kl.blocks_per_sm(kernel, False),
                      kl.blocks_per_sm(kernel, True)]
            if args.comp:
                blocks.append(kl.blocks_per_sm(kernel, False, comp=True))
            print(label, kernel, "blocks per SM (f32, f64[, comp]):", *blocks)


if __name__ == "__main__":
    main()
