"""The port's halo exchange against pace_tpu's.

The port's plain exchange (strip updates) must reproduce pace_tpu's slab
exchange exactly: its XLA assembly on the CPU and its Pallas kernel in
interpret mode, for the staggers and kinds the transport slice uses. The
index maps the CUDA gather kernel reads are checked here too, by applying
them with plain tensor indexing (the kernel itself runs only on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.parallel.halo_pallas import exchange_pallas, exchange_pallas_multi
from pace_tpu_torch.grid.generation import GridSpec, MetricTerms
from pace_tpu_torch.parallel import halo_kernel

#: the slice runs the six tiles unsplit, one shard each
LAYOUTS = [(1, 1)]


@pytest.fixture(scope="module", params=LAYOUTS, ids=lambda l: f"layout{l[0]}x{l[1]}")
def halos(request):
    jhalo = JMetricTerms.generate(JGridSpec(n_tile=12, npz=3, layout=request.param)).halo
    thalo = MetricTerms.generate(GridSpec(n_tile=12, npz=3, layout=request.param)).halo
    return jhalo, thalo


def _field(halo, seed, lead=(3,), extra_y=0, extra_x=0):
    h = halo.n_halo
    rng = np.random.default_rng(seed)
    shape = (halo.n_shards,) + lead + (halo.nsy + 2 * h + extra_y, halo.nsx + 2 * h + extra_x)
    return rng.standard_normal(shape)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _emulate_kernel(inputs, plan):
    """Apply the CUDA kernel's index maps with tensor indexing: out[s, k, p]
    = ±in[input][src shard, k, off]."""
    names = sorted(inputs)
    arrays = {n: halo_kernel._lift(_t(inputs[n])) for n in names}
    planes = {n: tuple(a.shape[-2:]) for n, a in arrays.items()}
    S, K = arrays[names[0]].shape[:2]
    outs = {}
    for name, src, shape in plan.outputs:
        off, meta = halo_kernel.index_map(plan, name, planes, S)
        # the kernel reads the maps as flat C-ordered arrays
        assert off.flags.c_contiguous and meta.flags.c_contiguous
        Yo, Xo = off.shape[-2:]
        off = torch.from_numpy(off.astype(np.int64)).reshape(S, -1)
        meta = torch.from_numpy(meta.astype(np.int64)).reshape(S, -1)
        out = torch.empty((S, K, Yo * Xo), dtype=torch.float64)
        for i, n in enumerate(names):
            flat = arrays[n].reshape(S, K, -1)
            sel = ((meta >> 1) & 1) == i
            ss = (meta >> 2)[sel]
            s_idx = torch.nonzero(sel)[:, 0]
            vals = flat[ss, :, off[sel]]  # (npts, K)
            vals = torch.where((meta[sel] & 1).bool()[:, None], -vals, vals)
            out.permute(0, 2, 1)[s_idx, torch.nonzero(sel)[:, 1]] = vals
        outs[name] = out.reshape(S, K, Yo, Xo)
    return outs


@pytest.mark.parametrize("fold", ["x", "y"])
@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=["3d", "4d", "5d"])
def test_update_scalar_exact(halos, fold, lead):
    jhalo, thalo = halos
    q = _field(jhalo, 1, lead)
    ref = np.asarray(jhalo.update_scalar(jnp.asarray(q), fold=fold))
    got = thalo.update_scalar(_t(q), fold=fold).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["cgrid", "dgrid"])
@pytest.mark.parametrize("fold", ["x", "y"])
def test_update_vector_exact(halos, kind, fold):
    jhalo, thalo = halos
    cg = kind == "cgrid"
    u = _field(jhalo, 2, extra_y=0 if cg else 1, extra_x=1 if cg else 0)
    v = _field(jhalo, 3, extra_y=1 if cg else 0, extra_x=0 if cg else 1)
    ru, rv = jhalo.update_vector(jnp.asarray(u), jnp.asarray(v), kind=kind, fold=fold)
    gu, gv = thalo.update_vector(_t(u), _t(v), kind=kind, fold=fold)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["4d", "5d"])
def test_fold_patch_exact(halos, lead):
    """x-fold + corner pack vs pace_tpu's XLA path and its Pallas kernel."""
    jhalo, thalo = halos
    q = _field(jhalo, 4, lead)
    rx, rp = jhalo.update_scalar_fold_patch(jnp.asarray(q))
    gx, gp = thalo.update_scalar_fold_patch(_t(q))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(rp))
    js = jhalo._slabs
    h = jhalo.n_halo
    out = exchange_pallas_multi(
        {"q": jnp.asarray(q)},
        [("qx", "q"), ("qp", None, (2 * h, 2 * h))],
        [("qx", op) for op in js._scalar_ops_for("center", "x")]
        + [("qp", op) for op in js._patch_ops("center", "y")],
        ("torch-port-fold-patch", jhalo.nsy, len(lead)),
        interpret=True,
    )
    np.testing.assert_array_equal(gx.numpy(), np.asarray(out["qx"]))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(out["qp"]))


@pytest.mark.parametrize("lead", [(3,), (2, 3)], ids=["4d", "5d"])
def test_sync_interfaces_exact(halos, lead):
    """cgrid interface sync (the flux sync of the transport) vs pace_tpu's
    XLA path and its Pallas kernel."""
    jhalo, thalo = halos
    u = _field(jhalo, 5, lead, extra_x=1)
    v = _field(jhalo, 6, lead, extra_y=1)
    ru, rv = jhalo.sync_vector_interfaces(jnp.asarray(u), jnp.asarray(v), kind="cgrid")
    gu, gv = thalo.sync_vector_interfaces(_t(u), _t(v), kind="cgrid")
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ru))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    js = jhalo._slabs
    if "cgrid" not in js._sync_ops:
        js._sync_ops["cgrid"] = js._build_sync_ops("cgrid")
    ops = js._sync_ops["cgrid"]
    out = exchange_pallas(
        {"u": jnp.asarray(u), "v": jnp.asarray(v)},
        [("u", op) for op in ops["u"]] + [("v", op) for op in ops["v"]],
        ("torch-port-sync", jhalo.nsy, len(lead)),
        interpret=True,
    )
    np.testing.assert_array_equal(gu.numpy(), np.asarray(out["u"]))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(out["v"]))


@pytest.mark.parametrize("which", ["scalar", "vector", "fold_patch", "sync"])
def test_kernel_index_maps_match_plain(halos, which):
    """The gather kernel's per-point maps reproduce the strip updates."""
    _, thalo = halos
    slabs = thalo.slabs
    if which == "scalar":
        plan, inputs = slabs.scalar_plan("center", "y"), {"q": _field(thalo, 7)}
    elif which == "fold_patch":
        plan, inputs = slabs.fold_patch_plan("center"), {"q": _field(thalo, 7)}
    elif which == "vector":
        plan = slabs.vector_plan("dgrid", "x")
        inputs = {"u": _field(thalo, 8, extra_y=1), "v": _field(thalo, 9, extra_x=1)}
    else:
        plan = slabs.sync_plan("cgrid")
        inputs = {"u": _field(thalo, 8, extra_x=1), "v": _field(thalo, 9, extra_y=1)}
    ref = halo_kernel.halo_plain({n: halo_kernel._lift(_t(a)) for n, a in inputs.items()}, plan)
    got = _emulate_kernel(inputs, plan)
    for name in ref:
        np.testing.assert_array_equal(got[name].numpy(), ref[name].numpy())


def test_halo_cuda_rejects_cpu_tensors(halos):
    """The kernel wrapper never runs the plain version: CPU input raises."""
    _, thalo = halos
    q = halo_kernel._lift(_t(_field(thalo, 10)))
    with pytest.raises(ValueError, match="must lie on"):
        halo_kernel.halo_cuda({"q": q}, thalo.slabs.scalar_plan())


def _apply_tables(fields, tables):
    """Pointwise oracle: dst[ds, ..., dj, di] = sign * src[ss, ..., sj, si]."""
    out = {k: v.copy() for k, v in fields.items()}
    for (dst, src), t in tables.items():
        if t.size:
            vals = np.moveaxis(fields[src][t.ss, ..., t.sj, t.si], 0, -1) * t.sign
            out[dst][t.ds, ..., t.dj, t.di] = np.moveaxis(vals, -1, 0)
    return out


@pytest.mark.parametrize("which", ["scalar-x", "scalar-y", "vector-cgrid", "sync-cgrid"])
def test_slab_ops_match_pointwise_tables(halos, which):
    """The port's own region tables (the oracle its slab ops are derived
    from) against the exchange the slices run."""
    _, thalo = halos
    if which.startswith("scalar"):
        fold = which[-1]
        q = _field(thalo, 11)
        got = thalo.update_scalar(_t(q), fold=fold).numpy()
        ref = _apply_tables({"q": q}, {("q", "q"): thalo.scalar_table("center", fold)})["q"]
        np.testing.assert_array_equal(got, ref)
        return
    u, v = _field(thalo, 12, extra_x=1), _field(thalo, 13, extra_y=1)
    if which == "vector-cgrid":
        gu, gv = thalo.update_vector(_t(u), _t(v), kind="cgrid", fold="x")
        tables = thalo.vector_tables("cgrid", "x")
    else:
        gu, gv = thalo.sync_vector_interfaces(_t(u), _t(v), kind="cgrid")
        tables = thalo.sync_tables("cgrid")
    ref = _apply_tables({"u": u, "v": v}, tables)
    np.testing.assert_array_equal(gu.numpy(), ref["u"])
    np.testing.assert_array_equal(gv.numpy(), ref["v"])
