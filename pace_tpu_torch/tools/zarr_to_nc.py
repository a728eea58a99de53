"""Convert a zarr-v2 diagnostics store to classic NetCDF-3.

Port of ``pace_tpu.tools.zarr_to_nc`` (reference role: the driver examples'
``zarr_to_nc.py``), over the port's own ``zarr_v2`` and ``netcdf3``: the
same file, byte for byte. Usage::

    python -m pace_tpu_torch.tools.zarr_to_nc output.zarr diagnostics.nc
"""

from __future__ import annotations

import os
import sys

from ..utils import netcdf3, zarr_v2


def convert(zarr_path: str, nc_path: str) -> None:
    """Each array of the store as a variable of its own dimensions
    ``{name}_d{axis}``."""
    dims = {}
    variables = {}
    for name in sorted(os.listdir(zarr_path)):
        adir = os.path.join(zarr_path, name)
        if not os.path.isdir(adir) or not os.path.exists(os.path.join(adir, ".zarray")):
            continue
        arr = zarr_v2.read_array(adir)
        dnames = []
        for ax, sz in enumerate(arr.shape):
            dn = f"{name}_d{ax}"
            dims[dn] = int(sz)
            dnames.append(dn)
        variables[name] = netcdf3.Variable(tuple(dnames), arr)
    netcdf3.write(nc_path, netcdf3.NetCDF3File(dims=dims, variables=variables, attrs={}))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__)
        raise SystemExit(2)
    convert(argv[0], argv[1])
    print(f"wrote {argv[1]}")


if __name__ == "__main__":
    main()
