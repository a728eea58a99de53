"""``Quantity``, ``zeros``, ``SubtileGridSizer`` and ``QuantityFactory``:
``tests/main/test_quantity.py`` and ``tests/main/test_quantity_factory.py``
against the port (on the CPU; the port's containers hold torch tensors and
have no pytree registration, so the JAX-only cases become the functional
updates they stand for), with ``pace_tpu``'s sizer and metadata as the
oracle.
"""

import numpy as np
import pytest
import torch

import pace_tpu_torch
from pace_tpu import quantity as jquantity
from pace_tpu_torch import constants
from pace_tpu_torch.quantity import (
    Quantity, QuantityFactory, QuantityMetadata, SubtileGridSizer, zeros,
)


def cpu_zeros(*a, **k):
    return zeros(*a, device="cpu", **k)


def test_package_exports():
    assert pace_tpu_torch.Quantity is Quantity and pace_tpu_torch.zeros is zeros
    assert pace_tpu_torch.QuantityMetadata is QuantityMetadata


def test_quantity_view_and_data():
    data = torch.arange(100.0).reshape(10, 10)
    q = Quantity(data, dims=("y", "x"), units="m", origin=(3, 3), extent=(4, 4))
    assert q.view.shape == (4, 4)
    assert float(q.view[0, 0]) == float(data[3, 3])
    assert q.data.shape == (10, 10)
    assert q.metadata.dim_lengths == {"y": 4, "x": 4}
    assert q.np is torch and q.dtype == torch.float32 and q.shape == (10, 10)


def test_quantity_metadata_is_pace_tpu_s():
    q = cpu_zeros(("tile", "z", "y", "x_interface"), "Pa",
                  sizes={"tile": 6, "x": 12, "y": 12, "z": 8})
    j = jquantity.zeros(("tile", "z", "y", "x_interface"), "Pa",
                        sizes={"tile": 6, "x": 12, "y": 12, "z": 8})
    assert (q.dims, q.units, q.origin, q.extent, q.shape) == (
        j.dims, j.units, j.origin, j.extent, tuple(j.shape))
    assert q.metadata.dim_lengths == j.metadata.dim_lengths


def test_functional_update_keeps_metadata():
    q = cpu_zeros(("y", "x"), "m", sizes={"x": 4, "y": 4})
    out = q.with_data(q.data + 1.0)
    assert isinstance(out, Quantity)
    assert float(out.data[0, 0]) == 1.0 and float(q.data[0, 0]) == 0.0
    assert (out.units, out.origin, out.extent) == (q.units, q.origin, q.extent)
    with pytest.raises(ValueError):
        q.with_data(torch.zeros(3, 3))


def test_zeros_shapes_interface_and_halo():
    q = cpu_zeros(("tile", "z_interface", "y", "x_interface"), "Pa",
                  sizes={"tile": 6, "x": 12, "y": 12, "z": 79})
    h = constants.N_HALO_DEFAULT
    assert q.data.shape == (6, 80, 12 + 2 * h, 13 + 2 * h)
    assert q.origin == (0, 0, h, h)
    assert q.extent == (6, 80, 12, 13)
    assert cpu_zeros(("x",), "m", sizes={"x": 2}, dtype=torch.float64).dtype == torch.float64


def test_with_view():
    q = cpu_zeros(("y", "x"), "m", sizes={"x": 2, "y": 2})
    q2 = q.with_view(torch.ones((2, 2)))
    assert float(q2.data.sum()) == 4.0
    # the halo untouched, the old tensor not written
    assert float(q2.data[0, 0]) == 0.0 and float(q.data.sum()) == 0.0


def test_transpose():
    q = cpu_zeros(("z", "y", "x"), "m", sizes={"x": 4, "y": 5, "z": 3})
    qt = q.transpose(("x", "y", "z"))
    assert qt.dims == ("x", "y", "z")
    assert qt.extent == (4, 5, 3)
    assert qt.origin == (3, 3, 0) and qt.shape == (10, 11, 3)


def test_mismatched_dims_raises():
    with pytest.raises(ValueError):
        Quantity(torch.zeros((3, 3)), dims=("x",), units="m")
    with pytest.raises(ValueError):
        Quantity(torch.zeros((3, 3)), dims=("y", "x"), units="m", origin=(0,))


def test_quantity_to_numpy():
    q = cpu_zeros(("y", "x"), "m", sizes={"x": 2, "y": 2})
    assert isinstance(q.to_numpy(), np.ndarray)
    assert "units='m'" in repr(q)


def test_zeros_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zeros(("x",), "m", sizes={"x": 2})


def test_sizer_shapes():
    s = SubtileGridSizer.from_tile_params(24, 24, 8, layout=(2, 2))
    j = jquantity.SubtileGridSizer.from_tile_params(24, 24, 8, layout=(2, 2))
    assert (s.nx, s.ny, s.nz) == (12, 12, 8)
    for dims in (("tile", "z", "y", "x"), ("z_interface", "y", "x_interface")):
        assert s.get_shape(dims) == j.get_shape(dims)
        assert s.get_origin(dims) == j.get_origin(dims)
        assert s.get_extent(dims) == j.get_extent(dims)
    assert s.get_shape(("tile", "z", "y", "x")) == (6, 8, 18, 18)
    assert s.get_shape(("z_interface", "y", "x_interface")) == (9, 18, 19)


def test_sizer_rejects_indivisible_layout():
    with pytest.raises(ValueError):
        SubtileGridSizer.from_tile_params(24, 24, 8, layout=(5, 1))


def test_factory_alloc_and_view():
    f = QuantityFactory.from_backend(SubtileGridSizer.from_tile_params(12, 12, 4), device="cpu")
    q = f.zeros(("z", "y", "x_interface"), "m/s")
    assert q.shape == (4, 18, 19)
    assert q.view[:].shape == (4, 12, 13)
    assert q.units == "m/s"
    one = f.ones(("y", "x"), "1")
    assert float(one.data.sum()) == 18 * 18
    assert float(f.empty(("y", "x"), "1", dtype=torch.float64).data.abs().sum()) == 0.0


def test_factory_from_array_shape_check():
    f = QuantityFactory.from_backend(SubtileGridSizer.from_tile_params(12, 12, 4), device="cpu")
    good = f.from_array(np.zeros((18, 18)), ("y", "x"), "m")
    assert good.extent == (12, 12) and isinstance(good.data, torch.Tensor)
    with pytest.raises(ValueError):
        f.from_array(np.zeros((12, 12)), ("y", "x"), "m")
