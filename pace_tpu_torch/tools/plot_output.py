"""Quick-look plots of the driver's diagnostics.

Port of ``pace_tpu.tools.plot_output`` (reference role: the driver
examples' ``plot_output.py`` / ``plot_cube.py``): each 2-D (or z-selected)
variable of an HDF5 (through ``h5py``, where it is installed) or zarr
diagnostics store, at the last output time, as a 2x3 panel of the cube's
faces, written next to the store as ``<var>.png``. Usage::

    python -m pace_tpu_torch.tools.plot_output <output_dir> [var ...]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _load(output_dir: str):
    h5 = os.path.join(output_dir, "diagnostics.h5")
    if os.path.exists(h5):
        import h5py

        with h5py.File(h5) as f:
            return {k: np.asarray(f[k]) for k in f.keys()}
    from ..utils import zarr_v2

    out = {}
    for name in sorted(os.listdir(output_dir)):
        adir = os.path.join(output_dir, name)
        if os.path.isdir(adir) and os.path.exists(os.path.join(adir, ".zarray")):
            out[name] = zarr_v2.read_array(adir)
    return out


def plot_cube_panel(arr2d_tiles, title, path):
    """``(6, ny, nx)`` -> a 2x3 panel png at ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(12, 7))
    vmin, vmax = np.nanmin(arr2d_tiles), np.nanmax(arr2d_tiles)
    for t in range(6):
        ax = axes[t // 3][t % 3]
        im = ax.pcolormesh(arr2d_tiles[t], vmin=vmin, vmax=vmax)
        ax.set_title(f"tile {t + 1}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.colorbar(im, ax=axes, shrink=0.8)
    fig.suptitle(title)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        raise SystemExit(2)
    output_dir = argv[0]
    names = argv[1:]
    data = _load(output_dir)
    if not names:
        names = [k for k, v in data.items()
                 if v.ndim in (3, 4) and v.shape[-3] == 6 or (v.ndim == 4 and v.shape[1] == 6)]
    written = []
    for name in names:
        arr = data[name]
        if arr.ndim == 4:  # (time, 6, ny, nx)
            arr = arr[-1]
        elif arr.ndim == 3 and arr.shape[0] != 6:
            arr = arr[-1]
        if arr.ndim != 3 or arr.shape[0] != 6:
            print(f"skip {name}: shape {data[name].shape}")
            continue
        path = os.path.join(output_dir, f"{name}.png")
        plot_cube_panel(arr, name, path)
        print(f"wrote {path}")
        written.append(path)
    return written


if __name__ == "__main__":
    main()
