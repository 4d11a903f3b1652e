#!/usr/bin/env python3
"""Quick-look analysis of hipace_tpu openPMD output.

A stand-in for the reference's openPMD-viewer based tools/analysis.py
(ref tools/analysis.py): prints field
statistics and on-axis lineouts, and (with --plot) writes a png.

Usage:
    python tools/analysis.py diags/hdf5 --iteration 1 --field Ez
    python tools/analysis.py diags/hdf5 --iteration 1 --beam beam --plot out.png
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np


def _open(prefix: str, it: int):
    import h5py
    path = os.path.join(prefix, f"openpmd_{it:06d}.h5")
    if not os.path.exists(path):
        cands = sorted(glob.glob(os.path.join(prefix, "openpmd_*.h5")))
        raise SystemExit(f"{path} not found; available: "
                         f"{[os.path.basename(c) for c in cands]}")
    return h5py.File(path, "r")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prefix", help="diagnostics directory (hipace.file_prefix)")
    ap.add_argument("--iteration", "-i", type=int, default=0)
    ap.add_argument("--field", "-f", default=None,
                    help="field name, e.g. Ez (default: list available)")
    ap.add_argument("--beam", "-b", default=None, help="beam species name")
    ap.add_argument("--plot", default=None, help="write a png to this path")
    args = ap.parse_args(argv)

    with _open(args.prefix, args.iteration) as f:
        base = f[f"data/{args.iteration}"]
        print(f"iteration {args.iteration}: time={base.attrs['time']:.6g} "
              f"dt={base.attrs['dt']:.6g}")
        if "fields" in base:
            names = []
            base["fields"].visit(
                lambda n: names.append(n)
                if isinstance(base[f"fields/{n}"], type(base)) is False
                else None)
            names = [n for n in names
                     if hasattr(base[f"fields/{n}"], "shape")]
            if args.field is None:
                print("fields:", ", ".join(names))
            else:
                arr = np.array(base[f"fields/{args.field}"])
                print(f"{args.field}: shape {arr.shape} "
                      f"min {arr.min():.6g} max {arr.max():.6g} "
                      f"rms {np.sqrt((arr**2).mean()):.6g}")
                if arr.ndim == 3:
                    axis = arr[:, arr.shape[1] // 2, arr.shape[2] // 2]
                elif arr.ndim == 2:
                    axis = arr[:, arr.shape[1] // 2]
                else:
                    axis = arr
                print("on-axis lineout (head..tail):")
                step = max(1, len(axis) // 16)
                for i in range(len(axis) - 1, -1, -step):
                    print(f"  z[{i:4d}] = {axis[i]:+.6g}")
                if args.plot:
                    import matplotlib
                    matplotlib.use("Agg")
                    import matplotlib.pyplot as plt
                    fig, ax = plt.subplots(1, 2, figsize=(10, 4))
                    if arr.ndim == 3:
                        ax[0].imshow(arr[:, arr.shape[1] // 2, :],
                                     aspect="auto", origin="lower")
                        ax[0].set_title(f"{args.field} (xz)")
                    ax[1].plot(axis)
                    ax[1].set_title("on-axis")
                    fig.savefig(args.plot, dpi=120)
                    print("wrote", args.plot)
        if args.beam is not None:
            gp = base[f"particles/{args.beam}"]
            z = np.array(gp["position/z"])
            uz = np.array(gp["momentum/z"])
            w = np.array(gp["weighting"])
            print(f"beam '{args.beam}': n={z.size} "
                  f"<z>={np.average(z, weights=w):.6g} "
                  f"<uz>={np.average(uz, weights=w):.6g} "
                  f"sigma_uz={np.sqrt(np.average((uz-np.average(uz, weights=w))**2, weights=w)):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
