"""The port's tools (pace_tpu_torch/tools/): ``zarr_to_nc`` byte for byte
against ``pace_tpu``'s, ``plot_output`` under matplotlib's Agg backend on
an HDF5 and a zarr store of the port's driver, and ``profile_step`` on the
CPU at C12."""

import os

import numpy as np
import pytest
import torch

from pace_tpu.tools import zarr_to_nc as jzarr_to_nc
from pace_tpu_torch.tools import plot_output, profile_step, zarr_to_nc
from pace_tpu_torch.utils import netcdf3, zarr_v2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(path):
    rng = np.random.default_rng(9)
    z = zarr_v2.ZarrGroup(str(path))
    for it in range(3):
        z.append_time("ps", it, 1e5 + rng.standard_normal((6, 12, 12)))
        z.append_time("ua", it, rng.standard_normal((6, 4, 12, 12)))
        z.append_time("time", it, np.asarray(225.0 * it))
    z.write_constant("lat", rng.standard_normal((6, 12, 12)))
    return path


def test_zarr_to_nc_is_pace_tpus_byte_for_byte(tmp_path):
    store = _store(tmp_path / "out.zarr")
    zarr_to_nc.convert(str(store), str(tmp_path / "t.nc"))
    jzarr_to_nc.convert(str(store), str(tmp_path / "j.nc"))
    assert (tmp_path / "t.nc").read_bytes() == (tmp_path / "j.nc").read_bytes()
    f = netcdf3.read(str(tmp_path / "t.nc"))
    assert sorted(f.variables) == ["lat", "ps", "time", "ua"]
    np.testing.assert_array_equal(np.asarray(f.variables["ua"].data),
                                  zarr_v2.read_array(str(store / "ua")))
    zarr_to_nc.main([str(store), str(tmp_path / "cli.nc")])
    assert (tmp_path / "cli.nc").read_bytes() == (tmp_path / "t.nc").read_bytes()
    with pytest.raises(SystemExit):
        zarr_to_nc.main([str(store)])


@pytest.mark.parametrize("fmt", ["hdf5", "zarr"])
def test_plot_output_under_agg(tmp_path, fmt):
    """A C12 driver run's diagnostics, each cube variable plotted at the last
    output as a 2x3 panel of faces."""
    from pace_tpu_torch.driver.config import DriverConfig
    from pace_tpu_torch.driver.driver import Driver

    out = tmp_path / "out"
    d = Driver(DriverConfig.from_dict(dict(
        nx_tile=12, nz=4, dt_atmos=225.0, seconds=225, precision=64,
        dycore_config={"k_split": 1, "n_split": 1, "hydrostatic": True},
        diagnostics_config={"path": str(out), "names": ["ps", "ua"], "output_format": fmt},
        performance_config={"collect_performance": False},
    )), device="cpu")
    d.step_all()
    d.cleanup()
    written = plot_output.main([str(out)])
    assert sorted(os.path.basename(p) for p in written) == ["lat.png", "lon.png", "ps.png"]
    for p in written:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert plot_output.main([str(out), "ua"]) == []  # (time, 6, K, Y, X): skipped
    with pytest.raises(SystemExit):
        plot_output.main([])


def test_profile_step_on_the_cpu(capsys):
    assert profile_step.main(["--n-tile", "12", "--npz", "4", "--device", "cpu", "--top", "5",
                              "--k-split", "1", "--n-split", "1", "--hydrostatic"]) == 0
    out = capsys.readouterr().out
    assert "1 step(s) at C12 npz=4 on cpu" in out
    assert "no device events (the CPU)" in out and "--- by operator" in out
    assert "HaloExchange" in out
