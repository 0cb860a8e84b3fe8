"""Does a process's first CPU power scan agree with its second?

Runs ``--procs`` fresh Python processes.  Each runs one CPU FFT, then the
power scan of the nside-32 / lmax-48 polarised pixel window
(``heracles_tpu_torch.ops.pixwin._rep_powers``) twice on the CPU, and
prints the largest difference between the two scans; the parent counts
the processes whose scans differ.  ``--torch-sqrt`` builds the recurrence
tables with torch's CPU square root (MKL's vector library), as the port
did before it took them from numpy.

    python3 tools/pixwin_first_call.py --procs 100 [--torch-sqrt]
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _torch_tables(ms, ns, j0, lmax, dtype, device):
    import numpy as np
    import torch

    def lane(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)[None, :]

    L = torch.arange(lmax + 2, dtype=torch.float64, device=device)[:, None]
    m2, n2, mn = lane(ms * ms), lane(ns * ns), lane(ms * ns)

    def a_of(ell):
        v = (ell * ell - m2) * (ell * ell - n2)
        return torch.sqrt(torch.clamp(v, min=0.0)) / torch.clamp(ell, min=1.0)

    inv = torch.where(L > lane(j0), 1.0 / a_of(L), 0.0)
    A1 = (2.0 * L - 1.0) * inv
    A0 = -(2.0 * L - 1.0) * mn / (torch.clamp(L - 1.0, min=1.0) * L) * inv
    B = a_of(L - 1.0) * inv
    return A1.to(dtype), A0.to(dtype), B.to(dtype)


def child(torch_sqrt):
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from heracles_tpu_torch.ops import pixwin, wigner

    if torch_sqrt:
        wigner._coeff_tables = _torch_tables
    torch.fft.fft(torch.randn(64, 8192, dtype=torch.complex128))
    pix, _ = pixwin._pixel_classes(32, 1)
    th, ph, rings = pixwin._children_angles_rings(32, pix, 16)
    first, second = (pixwin._rep_powers(th, ph, 48, True, rings=rings,
                                        device="cpu") for _ in range(2))
    print(float(np.abs(first - second).max()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=100)
    ap.add_argument("--torch-sqrt", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.torch_sqrt)
    cmd = [sys.executable, __file__, "--child"]
    cmd += ["--torch-sqrt"] if args.torch_sqrt else []
    diffs = [float(subprocess.run(cmd, capture_output=True, text=True,
                                  check=True).stdout.split()[-1])
             for _ in range(args.procs)]
    off = [d for d in diffs if d > 0]
    print(json.dumps({"tables": "torch.sqrt" if args.torch_sqrt else "numpy",
                      "procs": len(diffs), "first_scan_off": len(off),
                      "max_diff": max(diffs)}))


if __name__ == "__main__":
    main()
