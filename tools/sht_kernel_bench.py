"""Time the four SHT kernels of one checkout of the port on the card.

    python3 tools/sht_kernel_bench.py [--root DIR] [--label NAME]
                                      [--nside 4096] [--lmax 3000]
                                      [--double | --comp] [--batch B]
                                      [--nb 1,2,4,8] [--sass]

Builds the kernels of the ``heracles_tpu_torch`` package under ``--root``
(default: this checkout), runs the spin-0 and spin-pair analysis and
synthesis in float32 (float64 with ``--double``, the compensated float32
instantiations with ``--comp``) on seeded random inputs at one map's
shapes (2 nside northern rings, lmax + 1 orders; a stack of ``--batch``
maps, e.g. the DICES batch of 8), and prints, on lines that start with
``--label``:

* ptxas' registers and spills of the SHT kernels (of a fresh build);
  with ``--sass`` the HMMA, DMMA and SHFL instructions of each grouped
  analysis instantiation in the SASS (``chip_smoke.group_sass``, which
  disassembles the whole library: about a minute);
* per kernel the times of three launches after a warm-up (ms, CUDA
  events) and a digest of its outputs; with ``--nb`` each kernel once
  for each listed group of maps that it has and that divides the batch
  (``name/nb{n}``; a kernel without groups in the package runs once as
  ``name``, on its package's own choice, and a package without any
  groups takes no ``--nb``);
* where the package has them, the path counts of the spin-0 analysis, of
  the pair analysis' groups of maps (at each listed ``nb`` it has) and of
  the syntheses, and the resident blocks per SM.

Two checkouts given the same seed get the same inputs, so equal digests
mean that two versions of a kernel agree bit for bit.  To compare two
versions on one card, unpack the other one (``git archive``) into an
ignored directory and run parent, change, change, parent in one command.
Needs a CUDA card and nvcc; imports no JAX.
"""

import argparse
import hashlib
import importlib.util
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
    parser.add_argument("--batch", type=int, default=None,
                        help="maps in the stack (default: one map, no "
                             "batch axis)")
    parser.add_argument("--nb", default=None,
                        help="comma-separated groups of maps of the kernels")
    parser.add_argument("--sass", action="store_true",
                        help="count the grouped analyses' HMMA, DMMA and "
                             "SHFL instructions")
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
            keep = any(k in line for k in ("analysis_kernel",
                                           "synthesis_kernel", "group_kernel"))
        if keep and ("Compiling" in line or "Used" in line or "spill" in line):
            print(label, line.strip()[:200])

    if args.sass:
        # the grouped analyses' tensor-core and shuffle instructions, read
        # by this checkout's chip_smoke.py from the library just built
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        for (kernel, prec, nb), ops in smoke.group_sass(kl.path).items():
            print(label, f"sass group/{kernel}/{prec}/nb{nb}",
                  {op: ops[op] for op in ("HMMA", "DMMA", "SHFL")})

    x, lch, lsh = sht._geometry(args.nside, dev)
    nhalf, nm = x.shape[0], lmax + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    real = torch.float64 if args.double else torch.float32

    def rnd(shape):
        re, im = (torch.randn(shape, generator=gen, device=dev, dtype=real)
                  for _ in range(2))
        return torch.complex(re, im)

    batch = () if args.batch is None else (args.batch,)
    F = [rnd(batch + (nhalf, nm)) for _ in range(4)]
    A = [rnd(batch + (nm, nm)) for _ in range(2)]

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

    def spin0(**more):
        return lambda: sht_kernels.analysis_spin0_folded(
            F[0], F[1], x, lch, lsh, lmax, **kw, **more)

    def pair(**more):
        return lambda: sht_kernels.analysis_pair_folded(
            *F, x, lch, lsh, lmax, 2, **kw, **more)

    def synth0(**more):
        return lambda: sht_kernels.synthesis_spin0_folded(
            A[0], x, lch, lsh, lmax, **kw, **more)

    def synth2(**more):
        return lambda: sht_kernels.synthesis_pair_folded(
            *A, x, lch, lsh, lmax, 2, **kw, **more)

    makers = {"analysis_spin0_folded": spin0, "analysis_pair_folded": pair,
              "synthesis_spin0_folded": synth0,
              "synthesis_pair_folded": synth2}
    kernels = {name: make() for name, make in makers.items()}
    if args.nb:
        from heracles_tpu_torch.ops import wigner

        B = args.batch or 1
        for name, make in makers.items():
            if name not in wigner.GROUP_SIZES:
                continue
            del kernels[name]
            for nb in map(int, args.nb.split(",")):
                if nb in wigner.GROUP_SIZES[name] and B % nb == 0:
                    kernels[f"{name}/nb{nb}"] = make(nb=nb)
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
        if args.nb and "heracles_analysis_pair_paths_f32" in _build._SIGNATURES:
            for nb in map(int, args.nb.split(",")):
                if nb > 1 and nb in wigner.GROUP_SIZES["analysis_pair_folded"] \
                        and (args.batch or 1) % nb == 0:
                    print(label, f"paths analysis_pair_folded/nb{nb}",
                          sht_kernels.path_counts(
                              "analysis_pair_folded", *F, x, lch, lsh, lmax,
                              2, nb=nb, **kw))
        if args.nb:
            for kernel in ("analysis_spin0", "analysis_pair",
                           "synthesis_spin0", "synthesis_pair"):
                sizes = wigner.GROUP_SIZES.get(f"{kernel}_folded")
                if sizes is None:
                    continue
                print(label, kernel, "blocks per SM by nb (f32, f64, comp):",
                      {nb: [kl.blocks_per_sm(kernel, d, comp=c, nb=nb)
                            for d, c in ((False, False), (True, False),
                                         (False, True))] for nb in sizes})
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
