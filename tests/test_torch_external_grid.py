"""External (FRE-NCtools supergrid) grids: ``tests/main/test_external_grid.py``
against the port, and the port against pace_tpu's ``from_external``.

The six tile files are written by ``chip_smoke.write_fre_supergrid`` (the
port's gnomonic supergrid in degrees). Loaded back through
``MetricTerms.from_external`` they give the generated grid's metric terms
within rtol 1e-6 (positions round-trip through degrees), and every array of
the port's external metric terms is within 1e-12 of its scale of
``pace_tpu``'s from the same files, for layouts (1, 1) and (2, 2).
"""

import numpy as np
import pytest

import chip_smoke
from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu_torch.driver.grid import GeneratedGridConfig, GridConfig
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms

FIELDS = ("lon", "lat", "lon_agrid", "lat_agrid", "xyz_corner", "xyz_center", "xyz_u", "xyz_v",
          "dx", "dy", "dxa", "dya", "dxc", "dyc", "area", "area_c", "cos_sg", "sin_sg", "cosa",
          "sina", "cosa_u", "sina_u", "cosa_v", "sina_v", "cosa_s", "rsin2", "ec1", "ec2",
          "ew1", "ew2", "es1", "es2", "elon_u", "elat_u", "elon_v", "elat_v", "elon_a",
          "elat_a", "f0", "fC", "ak", "bk")


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    return chip_smoke.write_fre_supergrid(
        str(tmp_path_factory.mktemp("fre") / "grid.tile{tile}.nc"), 12)


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
def test_external_matches_generated(tiles, layout):
    spec = GridSpec(n_tile=12, npz=4, layout=layout)
    gen = MetricTerms.generate(spec)
    ext = MetricTerms.from_external(tiles, spec)
    for name in ("area", "dx", "dy", "dxc", "dyc", "lat_agrid", "lon_agrid"):
        a = np.asarray(getattr(gen, name))
        b = np.asarray(getattr(ext, name))
        assert np.allclose(a, b, rtol=1e-6, atol=1e-6), name


@pytest.mark.parametrize("layout", [(1, 1), (2, 2)])
def test_external_matches_pace_tpu(tiles, layout):
    got = MetricTerms.from_external(tiles, GridSpec(n_tile=12, npz=4, layout=layout))
    want = JMetricTerms.from_external(tiles, JGridSpec(n_tile=12, npz=4, layout=layout))
    for name in FIELDS:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * float(np.abs(w).max()),
                                   err_msg=name)


def test_external_shape_mismatch_raises(tmp_path):
    pattern = chip_smoke.write_fre_supergrid(str(tmp_path / "grid.tile{tile}.nc"), 6)
    spec = GridSpec(n_tile=12, npz=4, layout=(1, 1))
    with pytest.raises(ValueError, match="supergrid shape"):
        MetricTerms.from_external(pattern, spec)


def test_driver_grid_config_external(tiles, tmp_path):
    gen = MetricTerms.generate(GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    eta = str(tmp_path / "eta4.nc")
    chip_smoke.write_eta_file(eta, gen.ak, gen.bk)
    cfg = GridConfig(type="external",
                     config=GeneratedGridConfig(tile_paths=tiles, eta_file=eta))
    mt = cfg.get_metric_terms(12, 4, (1, 1))
    assert np.isfinite(np.asarray(mt.area)).all()
    assert np.array_equal(mt.ak, gen.ak) and np.array_equal(mt.bk, gen.bk)
    # a list of the six paths works as the format string does
    mt2 = MetricTerms.from_external([tiles.format(tile=t) for t in range(1, 7)],
                                    GridSpec(n_tile=12, npz=4, layout=(1, 1)))
    assert np.array_equal(mt2.area, mt.area)
