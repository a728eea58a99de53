"""The port's hydrostatic interface chain and C-grid pressure gradient
against pace_tpu's.

Same inputs (numpy, seeded) through ``pace_tpu.ops.pgrad`` (XLA path), the
Pallas column kernel in interpret mode, and the port's plain PyTorch
version, in float64. Tolerance: rtol 1e-12; all sums run sequentially in k
on the CPU in both packages, so the cancelling ``pkz`` keeps it too.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pace_tpu.grid.generation import GridSpec as JGridSpec
from pace_tpu.grid.generation import MetricTerms as JMetricTerms
from pace_tpu.grid.grid_data import GridData as JGridData
from pace_tpu.ops import pgrad as jpgrad
from pace_tpu.ops.hydro_pallas import hydrostatic_interfaces_pallas
from pace_tpu_torch.grid.grid_data import GridData
from pace_tpu_torch.ops import hydro_kernel, pgrad

RTOL = 1e-12
PTOP = 300.0
ALL = ("pe", "peln", "pk", "pkz", "gz")


def _fields(S=2, K=8, Y=10, X=11, seed=0):
    rng = np.random.default_rng(seed)
    delp = 500.0 + 1000.0 * rng.random((S, K, Y, X))
    pt = 280.0 + 40.0 * rng.random((S, K, Y, X))
    phis = 1000.0 * rng.random((S, Y, X))
    return delp, pt, phis


@pytest.fixture(scope="module")
def chains():
    delp, pt, phis = _fields()
    j = [jnp.asarray(a) for a in (delp, pt, phis)]
    t = [torch.from_numpy(a) for a in (delp, pt, phis)]
    return {
        "inputs": t,
        "xla": jpgrad.hydrostatic_interfaces(*j, PTOP),
        "pallas": hydrostatic_interfaces_pallas(*j, PTOP, need=ALL, interpret=True),
        "plain": pgrad.hydrostatic_interfaces(*t, PTOP),
    }


@pytest.mark.parametrize("ref", ["xla", "pallas"])
@pytest.mark.parametrize("idx", range(5), ids=ALL)
def test_chain_matches(chains, idx, ref):
    np.testing.assert_allclose(
        chains["plain"][idx].numpy(), np.asarray(chains[ref][idx]), rtol=RTOL, atol=0,
        err_msg=f"{ALL[idx]} vs {ref}",
    )


def test_chain_boundary_levels(chains):
    _delp, _pt, phis = chains["inputs"]
    pe, _peln, _pk, _pkz, gz = chains["plain"]
    assert torch.equal(pe[:, 0], torch.full_like(pe[:, 0], PTOP))
    assert torch.equal(gz[:, -1], phis)


@pytest.mark.parametrize("need", [("pkz",), ("pk", "pkz", "gz"), ALL],
                         ids=["pkz", "pk-pkz-gz", "all"])
def test_best_prunes_to_need(chains, need):
    """On CPU tensors the dispatcher runs the plain version and returns
    ``None`` outside ``need``, as the kernel path does."""
    got = hydro_kernel.hydrostatic_interfaces_best(*chains["inputs"], PTOP, need=need)
    jref = hydrostatic_interfaces_pallas(
        *(jnp.asarray(t.numpy()) for t in chains["inputs"]), PTOP, need=need, interpret=True
    )
    for name, g, full, r in zip(ALL, got, chains["plain"], jref):
        if name in need:
            assert torch.equal(g, full)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=0)
        else:
            assert g is None and r is None


def test_best_rejects_unknown_output(chains):
    with pytest.raises(ValueError, match="unknown hydrostatic outputs"):
        hydro_kernel.hydrostatic_interfaces_best(*chains["inputs"], PTOP, need=("pz",))


def test_kernel_wrapper_rejects_cpu_tensors(chains):
    """The kernel wrapper never runs the plain version: CPU input raises."""
    with pytest.raises(ValueError, match="CUDA device"):
        hydro_kernel.hydrostatic_interfaces_cuda(*chains["inputs"], PTOP)


@pytest.mark.parametrize("comp", ["uc", "vc"])
def test_p_grad_c_matches(comp):
    mt = JMetricTerms.generate(JGridSpec(n_tile=12, npz=4, layout=(1, 1)))
    jgrid = JGridData.from_metric_terms(mt, dtype=jnp.float64)
    arrays = {}
    for f in dataclasses.fields(jgrid):
        v = getattr(jgrid, f.name)
        arrays[f.name] = v if np.isscalar(v) or isinstance(v, tuple) else np.asarray(v)
    tgrid = GridData.from_numpy(arrays, device="cpu", dtype=torch.float64)
    S, Y, X = arrays["area"].shape
    delp, pt, phis = _fields(S, 4, Y, X, seed=2)
    rng = np.random.default_rng(4)
    uc = 10.0 * rng.standard_normal((S, 4, Y, X + 1))
    vc = 10.0 * rng.standard_normal((S, 4, Y + 1, X))
    dt2 = 0.5 * 200.0 / 56
    _, _, jpk, _, jgz = jpgrad.hydrostatic_interfaces(
        jnp.asarray(delp), jnp.asarray(pt), jnp.asarray(phis), PTOP
    )
    ref = jpgrad.p_grad_c(jnp.asarray(uc), jnp.asarray(vc), jpk, jgz, jgrid, dt2)
    _, _, tpk, _, tgz = pgrad.hydrostatic_interfaces(
        torch.from_numpy(delp), torch.from_numpy(pt), torch.from_numpy(phis), PTOP
    )
    got = pgrad.p_grad_c(torch.from_numpy(uc), torch.from_numpy(vc), tpk, tgz, tgrid, dt2)
    i = 0 if comp == "uc" else 1
    r = np.asarray(ref[i])
    np.testing.assert_allclose(got[i].numpy(), r, rtol=RTOL, atol=RTOL * np.abs(r).max())
    assert np.abs(got[i].numpy() - (uc, vc)[i]).max() > 0
