"""The operation order of the redesigned sim1 and multi-field transport
kernels, transliterated to PyTorch and held bit for bit against the plain
versions on the CPU.

The CUDA sources (``pace_tpu_torch/csrc/sim1.cu``, ``csrc/fvtp2d.cu``) run
only on the card. Each kernel rearranges where and when its values are
formed, not how: these transliterations follow the kernels' passes and
loops (vectorised over the columns or lines a pass covers) and must give
``torch.equal`` results to ``ops.nonhydro.sim1_solver`` + ``_p_fac_floor``
and to ``ops.ppm.xppm`` / ``yppm``.

float32 and the running sum of ``delp``: the kernel sums in sequence in
float32, as ``torch.cumsum`` does on the card, but ``torch.cumsum`` of a
float32 tensor on the CPU accumulates in float64. The float32 columns
therefore take ``delp`` on a lattice of 1/4 Pa, where every partial sum is
exact in both; the float64 columns are unrestricted.
"""

import numpy as np
import pytest
import torch

from pace_tpu_torch import constants
from pace_tpu_torch.ops import nonhydro, ppm, sim1_kernel

DT, PTOP = 4.0, 300.0


# ---------------------------------------------------------------- sim1


def _columns(K, dtype, seed, S=2, Y=3, X=5):
    """Hydrostatically plausible columns: delp > 0, delz < 0, pt ~ 300 K."""
    rng = np.random.RandomState(seed)
    shape = (S, K, Y, X)
    delp = 50.0 + 100.0 * rng.rand(*shape)
    if dtype == torch.float32:
        delp = np.round(4.0 * delp) / 4.0
    pt = 270.0 + 40.0 * rng.rand(*shape)
    pkz = 0.3 + 0.5 * rng.rand(*shape)
    delz = -(20.0 + 400.0 * rng.rand(*shape))
    w = 2.0 * rng.randn(*shape)
    ws = 0.5 * rng.randn(S, Y, X)
    return [torch.from_numpy(a).to(dtype) for a in (w, delz, pt, delp, pkz, ws)]


def _phased_sim1(w, delz, pt, delp, pkz, ws, dt, ptop, p_fac):
    """``csrc/sim1.cu`` pass by pass over a block's [level][column] arrays
    (here every column at once): the kernel's scalars are ``T(value)``."""
    dtype = w.dtype

    def T(v):
        return torch.tensor(v, dtype=dtype)

    K = w.shape[1]
    grav, rdgas, gamma = T(constants.GRAV), T(constants.RDGAS), T(1.0 / (1.0 - constants.KAPPA))
    dt_, ptop_, p_fac_, eps = T(dt), T(ptop), T(p_fac), T(1e-10)
    lev = lambda a, k: a[:, k]  # noqa: E731
    # A1
    dm = delp / grav
    t_v = pt * pkz
    gas = dm * rdgas * t_v
    p_full = gas / (-delz)
    b = -gamma * p_full * dt_ / delz
    # A2: the running sum, in sequence
    acc = torch.zeros_like(delp[:, 0])
    accs = []
    for k in range(K):
        acc = acc + lev(delp, k)
        accs.append(acc)
    acc = torch.stack(accs, dim=1)
    # A3
    ln = torch.log(torch.maximum(ptop_ + acc, eps))
    # A4
    ln_top = torch.log(torch.maximum(ptop_, eps)).expand_as(ln[:, :1])
    ln_above = torch.cat([ln_top, ln[:, :-1]], dim=1)
    p_hyd = delp / (ln - ln_above)
    pprime = p_full - p_hyd
    lim = -(gas / (p_fac_ * p_hyd)) if p_fac > 0 else None
    dmh = torch.cat([T(0.5) * dm[:, :1], T(0.5) * (dm[:, :-1] + dm[:, 1:])], dim=1)
    r = dt_ / dmh
    # A5: each row's diagonal and right-hand side
    zero = torch.zeros_like(ws)
    b_up = torch.cat([zero[:, None], b[:, :-1]], dim=1)
    pprime_up = torch.cat([zero[:, None], pprime[:, :-1]], dim=1)
    w0 = torch.cat([w[:, :1], (dm[:, 1:] * w[:, :-1] + dm[:, :-1] * w[:, 1:])
                    / (dm[:, :-1] + dm[:, 1:])], dim=1)
    b_d = T(1) + r * (b_up + b)
    rhs = w0 + r * (pprime - pprime_up)
    rhs = torch.cat([rhs[:, :-1], rhs[:, -1:] + (-(-r[:, -1:] * b[:, -1:]) * ws[:, None])], dim=1)
    # B: the elimination, then the substitution
    cp, dv, b_up_k = zero, zero, zero
    cps, dvs = [], []
    for k in range(K):
        r_k, b_k = lev(r, k), lev(b, k)
        a_d = -r_k * b_up_k
        c_d = torch.zeros_like(r_k) if k == K - 1 else -r_k * b_k
        denom = lev(b_d, k) - a_d * cp
        cp = c_d / denom
        dv = (lev(rhs, k) - a_d * dv) / denom
        cps.append(cp)
        dvs.append(dv)
        b_up_k = b_k
    x_dn = zero
    xs = [None] * K
    for k in range(K - 1, -1, -1):
        x_dn = dvs[k] - cps[k] * x_dn
        xs[k] = x_dn
    x = torch.stack(xs, dim=1)
    # C1
    dwdz = torch.cat([x[:, 1:], ws[:, None]], dim=1) - x
    dz_new = delz + dt_ * dwdz
    if lim is not None:
        dz_new = torch.maximum(dz_new, lim)
    ppn = pprime + b * dwdz
    # C2
    mid = (dm[:, 1:] * ppn[:, :-1] + dm[:, :-1] * ppn[:, 1:]) / (dm[:, :-1] + dm[:, 1:])
    bot = T(1.5) * ppn[:, -1:] - T(0.5) * ppn[:, -2:-1]
    pp = torch.cat([torch.zeros_like(bot), mid, bot], dim=1)
    # C3
    w_new = w + (dt_ / dm) * (pp[:, 1:] - pp[:, :-1])
    return w_new, dz_new, pp


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("p_fac", [0.0, 0.05, 2.0], ids=["no-floor", "floor", "floor-binds"])
@pytest.mark.parametrize("K", [2, 7, 30])
def test_phased_sim1_equals_the_plain_version(K, p_fac, dtype):
    cols = _columns(K, dtype, seed=K)
    w_n, dz_n, pp_n = nonhydro.sim1_solver(*cols, DT, PTOP)
    if p_fac > 0:
        dz_n = nonhydro._p_fac_floor(dz_n, *cols[2:5], PTOP, p_fac)
    got = _phased_sim1(*cols, DT, PTOP, p_fac)
    for name, a, b in zip(("w", "delz", "pp"), got, (w_n, dz_n, pp_n)):
        assert torch.equal(a, b), (name, int((a != b).sum()))
    if p_fac == 2.0:  # the floor binds in places
        free = nonhydro.sim1_solver(*cols, DT, PTOP)[1]
        assert (got[1] != free).any() and (got[1] == free).any()


@pytest.mark.parametrize("K,dtype,want", [
    (2, torch.float32, 32), (79, torch.float32, 16), (79, torch.float64, 8),
    (200, torch.float32, 8), (137, torch.float64, 4), (1000, torch.float64, 1),
])
def test_sim1_tile_columns_rule(K, dtype, want):
    """The widest power of two up to 32 whose eight K-value arrays and one
    surface value a column fit in a quarter of an SM's shared memory (one
    column up to a block's most)."""
    tc = sim1_kernel.tile_columns(K, dtype)
    assert tc == want
    per_col = (sim1_kernel.SMEM_ARRAYS * K + 1) * dtype.itemsize
    assert tc * per_col <= sim1_kernel.SMEM_PER_BLOCK or tc == 1
    assert tc == 32 or 2 * tc * per_col > sim1_kernel.SMEM_PER_BLOCK


def test_sim1_tile_columns_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        sim1_kernel.tile_columns(5000, torch.float64)


# ----------------------------------------------------------------- PPM


def _ppm_line(q, c, hord, seg):
    """``csrc/fvtp2d.cu``'s per-cell-term sweep along the last axis of a
    periodic line (q and c of length L, c[i] at the interface between cells
    i-1 and i), in segments of ``seg`` interfaces, each walked with its
    stencil window in registers: ``al`` once per interface, ``(bl, br, b0)``
    once per cell, each interface's value from its upwind cell's terms."""
    L = q.shape[-1]
    dtype = q.dtype

    def T(v):
        return torch.tensor(v, dtype=dtype)

    def at(i):
        return q[..., i % L]

    def al6(qm2, qm1, q0, qp1):
        return T(7.0 / 12.0) * (qm1 + q0) - T(1.0 / 12.0) * (qm2 + qp1)

    def dm_mono(qm, q0, qp):
        xt = T(0.5) * (qp - qm)
        q_hi = torch.maximum(torch.maximum(qm, q0), qp) - q0
        q_lo = q0 - torch.minimum(torch.minimum(qm, q0), qp)
        lim = torch.minimum(torch.abs(xt), torch.minimum(q_hi, q_lo))
        return torch.where(xt >= 0, lim, -lim)

    def al8(qm1, q0, dm_m1, dm_0):
        return T(0.5) * (qm1 + q0) + T(1.0 / 3.0) * (dm_m1 - dm_0)

    def vertex_min(bl, br, aL):
        da = br - bl
        a6 = T(-3.0) * (bl + br)
        has_vertex = torch.abs(da) < torch.abs(a6)
        safe = torch.where(a6 == 0, T(1e-30), a6)
        t = da + a6
        return torch.where(has_vertex, aL + (t * t) / (T(4.0) * safe), aL)

    def cell(q0, al_l, al_r, dm0):
        if hord == 8:
            xt2 = T(2.0) * dm0
            axt = torch.abs(xt2)
            blm = torch.minimum(axt, torch.abs(al_l - q0))
            brm = torch.minimum(axt, torch.abs(al_r - q0))
            bl = torch.where(xt2 >= 0, -blm, blm)
            br = torch.where(xt2 >= 0, brm, -brm)
        else:
            bl, br = al_l - q0, al_r - q0
            if hord == 7:
                pmin = torch.minimum(torch.minimum(q0 + bl, q0 + br), vertex_min(bl, br, q0 + bl))
                bl1, br1 = torch.maximum(bl, -q0), torch.maximum(br, -q0)
                still = vertex_min(bl1, br1, q0 + bl1) < 0
                bl1 = torch.where(still, T(0.0), bl1)
                br1 = torch.where(still, T(0.0), br1)
                need = pmin < 0
                bl, br = torch.where(need, bl1, bl), torch.where(need, br1, br)
        return bl, br, bl + br

    out = torch.empty_like(c)
    for i0 in range(0, L, seg):
        n = min(seg, L - i0)
        if hord == 1:
            for i in range(i0, i0 + n):
                out[..., i] = torch.where(c[..., i] > 0, at(i - 1), at(i))
            continue
        qm3, qm2, qm1, q0, qp1 = (at(i0 + d) for d in (-3, -2, -1, 0, 1))
        if hord == 8:
            dm_m2, dm_m1 = dm_mono(qm3, qm2, qm1), dm_mono(qm2, qm1, q0)
            dm_0 = dm_mono(qm1, q0, qp1)
            al_m1, al_0 = al8(qm2, qm1, dm_m2, dm_m1), al8(qm1, q0, dm_m1, dm_0)
        else:
            dm_m1 = dm_0 = None
            al_m1, al_0 = al6(qm3, qm2, qm1, q0), al6(qm2, qm1, q0, qp1)
        bl_m1, br_m1, b0_m1 = cell(qm1, al_m1, al_0, dm_m1)
        for i in range(i0, i0 + n):
            qp2 = at(i + 2)
            if hord == 8:
                dm_p1 = dm_mono(q0, qp1, qp2)
                al_p1 = al8(q0, qp1, dm_0, dm_p1)
            else:
                dm_p1 = None
                al_p1 = al6(qm1, q0, qp1, qp2)
            bl_0, br_0, b0_0 = cell(q0, al_0, al_p1, dm_0)
            ci = c[..., i]
            f_pos = qm1 + (T(1.0) - ci) * (br_m1 - ci * b0_m1)
            f_neg = q0 + (T(1.0) + ci) * (bl_0 + ci * b0_0)
            out[..., i] = torch.where(ci > 0, f_pos, f_neg)
            qm1, q0, qp1, al_0, dm_0 = q0, qp1, qp2, al_p1, dm_p1
            bl_m1, br_m1, b0_m1 = bl_0, br_0, b0_0
    return out


def _ppm_inputs(dtype, seed, shape=(2, 3, 11, 13)):
    """Values with ties (small integers), zeros and negatives, and courant
    numbers of both signs with exact zeros."""
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 6, size=shape).astype(np.float64)
    q += np.where(rng.rand(*shape) < 0.5, 0.0, rng.randn(*shape))
    c = np.round(rng.uniform(-0.95, 0.95, size=shape), 2)
    c[rng.rand(*shape) < 0.1] = 0.0
    return torch.from_numpy(q).to(dtype), torch.from_numpy(c).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("hord", [1, 5, 6, 7, 8])
def test_per_cell_term_ppm_equals_xppm_and_yppm(hord, dtype):
    q, c = _ppm_inputs(dtype, seed=hord)
    assert (q == 0).any() and (q < 0).any() and (c == 0).any() and (c < 0).any()
    for seg in (1, 4, 5, 13):
        gx = _ppm_line(q, c, hord, seg)
        assert torch.equal(gx, ppm.xppm(q, c, hord)), (hord, seg)
        gy = _ppm_line(q.transpose(-1, -2), c.transpose(-1, -2), hord, seg).transpose(-1, -2)
        assert torch.equal(gy, ppm.yppm(q, c, hord)), (hord, seg)
