"""Binary Coulomb collisions (Perez et al., Phys. Plasmas 19, 083104 (2012)).

A JAX re-design of the reference's collision module
(ref: /root/reference/src/particles/collisions/CoulombCollision.{H,cpp},
ElasticCollisionPerez.H, UpdateMomentumPerez.H, ComputeTemperature.H):
the per-cell binning + Fisher-Yates shuffle becomes a sort by (cell, random)
— equivalent in distribution — and the sequential per-cell pairing loop
becomes one vectorized pass over pairs (rank r paired with rank r + n/2
within its cell). Same-species cells with ODD counts match the reference's
cyclic reuse exactly (ref ElasticCollisionPerez.H:146-188: ceil(n/2) pairs,
the first lead colliding twice): a second masked kick pass pairs rank 0
with rank n-1 using the post-first-kick momenta, sequentially like the
reference's loop.

All momenta here are proper velocities u = gamma*beta*c; plasma particles
carry (ux, uy, psi), beams (ux, uy, uz).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .. import constants as cst
from ..geometry import Geometry


def _cell_of(x, y, geom: Geometry):
    ix = jnp.floor((x - geom.prob_lo[0]) / geom.dx).astype(jnp.int32)
    iy = jnp.floor((y - geom.prob_lo[1]) / geom.dy).astype(jnp.int32)
    ok = (ix >= 0) & (ix < geom.nx) & (iy >= 0) & (iy < geom.ny)
    return jnp.where(ok, iy * geom.nx + ix, geom.nx * geom.ny), ok


def _shuffled_cell_sort(cell, key):
    """Return a permutation sorting by cell with random order within cells."""
    n = cell.shape[0]
    r = jax.random.uniform(key, (n,))
    perm0 = jnp.argsort(r)
    perm = perm0[jnp.argsort(cell[perm0], stable=True)]
    return perm


def _gamma_plasma(ux, uy, psi, inv_c2):
    return (1.0 + (ux * ux + uy * uy) * inv_c2 + psi * psi) / (2.0 * psi)


def _pair_kick(u1x, u1y, u1z, g1, u2x, u2y, u2z, g2, n1, n2, n12,
               q1, m1, w1, q2, m2, w2, dt, L, lmdD, normalized_units, keys):
    """Vectorized UpdateMomentumPerezElastic (ref UpdateMomentumPerez.H:28-292).

    Returns (new u1 triple, new u2 triple) in the input unit system.
    """
    inv_c_SI = 1.0 / cst.SI_c
    inv_c2_SI = inv_c_SI * inv_c_SI
    tiny = 1e-300

    diffm = jnp.sqrt((u1x - u2x) ** 2 + (u1y - u2y) ** 2 + (u1z - u2z) ** 2)
    summm = jnp.sqrt(u1x**2 + u1y**2 + u1z**2) \
        + jnp.sqrt(u2x**2 + u2y**2 + u2z**2)
    no_collide = (diffm < tiny) | (diffm < 1e-10 * summm)

    if normalized_units:
        m1v = m1 * cst.SI_m_e
        m2v = m2 * cst.SI_m_e
        c = cst.SI_c
        u1x, u1y, u1z = u1x * c, u1y * c, u1z * c
        u2x, u2y, u2z = u2x * c, u2y * c, u2z * c
    else:
        m1v, m2v = m1, m2

    p1x, p1y, p1z = u1x * m1v, u1y * m1v, u1z * m1v
    p2x, p2y, p2z = u2x * m2v, u2y * m2v, u2z * m2v

    mass_g = m1v * g1 + m2v * g2
    vcx = (p1x + p2x) / mass_g
    vcy = (p1y + p2y) / mass_g
    vcz = (p1z + p2z) / mass_g
    vcms = vcx * vcx + vcy * vcy + vcz * vcz
    gc = 1.0 / jnp.sqrt(jnp.maximum(1.0 - vcms * inv_c2_SI, 1e-30))

    vcDv1 = (vcx * u1x + vcy * u1y + vcz * u1z) / g1
    vcDv2 = (vcx * u2x + vcy * u2y + vcz * u2z) / g2

    vc_ok = vcms > tiny
    ltf = jnp.where(vc_ok, ((gc - 1.0) / jnp.maximum(vcms, tiny) * vcDv1 - gc)
                    * m1v * g1, 0.0)
    p1sx = p1x + vcx * ltf
    p1sy = p1y + vcy * ltf
    p1sz = p1z + vcz * ltf
    p1sm = jnp.sqrt(p1sx**2 + p1sy**2 + p1sz**2)
    p1sm_safe = jnp.maximum(p1sm, tiny)

    g1s = (1.0 - vcDv1 * inv_c2_SI) * gc * g1
    g2s = (1.0 - vcDv2 * inv_c2_SI) * gc * g2

    # Coulomb log (ref :107-125)
    b0 = jnp.abs(q1 * q2) * inv_c2_SI / (4.0 * math.pi * cst.SI_ep0) \
        * gc / mass_g * (m1v * g1s * m2v * g2s
                         / (p1sm_safe * p1sm_safe * inv_c2_SI) + 1.0)
    bmin = jnp.maximum(cst.SI_hbar * math.pi / p1sm_safe, b0)
    lnLmd_auto = jnp.maximum(
        2.0, 0.5 * jnp.log(1.0 + lmdD * lmdD / (bmin * bmin)))
    lnLmd = jnp.where(L > 0.0, L, lnLmd_auto)

    # s parameter (ref :127-146)
    tts = m1v * g1s * m2v * g2s / (inv_c2_SI * p1sm_safe * p1sm_safe) + 1.0
    charge_fac = (cst.SI_q_e ** 4) if normalized_units else 1.0
    s = (n1 * n2 / jnp.maximum(n12, tiny) * dt * lnLmd
         * q1 * q1 * q2 * q2 * charge_fac * inv_c2_SI * inv_c2_SI
         / (4.0 * math.pi * cst.SI_ep0 ** 2 * m1v * g1 * m2v * g2)
         * gc * p1sm / mass_g * tts * tts)
    coeff = (4.0 * math.pi / 3.0) ** (1.0 / 3.0)
    vrel = mass_g * p1sm / (m1v * g1s * m2v * g2s * gc)
    sp = (coeff * n1 * n2 / jnp.maximum(n12, tiny) * dt * vrel * (m1v + m2v)
          / jnp.maximum(m1v * n1 ** (2.0 / 3.0), m2v * n2 ** (2.0 / 3.0)))
    s = jnp.minimum(s, sp)

    # scattering angle (ref :148-182); branch-free via nested where
    k1, k2, k3, k4 = keys
    r = jax.random.uniform(k1, s.shape)
    cos_small = jnp.maximum(1.0 + s * jnp.log(jnp.maximum(r, 1e-30)), -1.0)
    s2, s3, s4, s5 = s * s, s**3, s**4, s**5
    Ainv = (0.0056958 + 0.9560202 * s - 0.508139 * s2
            + 0.47913906 * s3 - 0.12788975 * s4 + 0.02389567 * s5)
    Ainv = jnp.maximum(Ainv, 1e-10)
    cos_mid = Ainv * jnp.log(jnp.exp(-1.0 / Ainv)
                             + 2.0 * r * jnp.sinh(1.0 / Ainv))
    A = 3.0 * jnp.exp(-jnp.minimum(s, 30.0))
    cos_big = 1.0 / A * jnp.log(jnp.exp(-A) + 2.0 * r * jnp.sinh(A))
    cos_iso = 2.0 * r - 1.0
    cosXs = jnp.where(s <= 0.1, cos_small,
                      jnp.where(s <= 3.0, cos_mid,
                                jnp.where(s <= 6.0, cos_big, cos_iso)))
    cosXs = jnp.clip(cosXs, -1.0, 1.0)
    sinXs = jnp.sqrt(jnp.maximum(1.0 - cosXs * cosXs, 0.0))

    phis = jax.random.uniform(k2, s.shape) * 2.0 * math.pi
    cosp, sinp = jnp.cos(phis), jnp.sin(phis)

    # post-collision momenta in COM (ref :189-231), with the axis fallback
    p1sp_a = jnp.sqrt(p1sx**2 + p1sy**2)
    use_a = p1sp_a > tiny
    p1sp_b = jnp.maximum(jnp.sqrt(p1sy**2 + p1sz**2), tiny)
    p1sp_a = jnp.maximum(p1sp_a, tiny)
    fax = (p1sx * p1sz / p1sp_a) * sinXs * cosp \
        + (p1sy * p1sm / p1sp_a) * sinXs * sinp + p1sx * cosXs
    fay = (p1sy * p1sz / p1sp_a) * sinXs * cosp \
        - (p1sx * p1sm / p1sp_a) * sinXs * sinp + p1sy * cosXs
    faz = -p1sp_a * sinXs * cosp + p1sz * cosXs
    fby = (p1sy * p1sx / p1sp_b) * sinXs * cosp \
        + (p1sz * p1sm / p1sp_b) * sinXs * sinp + p1sy * cosXs
    fbz = (p1sz * p1sx / p1sp_b) * sinXs * cosp \
        - (p1sy * p1sm / p1sp_b) * sinXs * sinp + p1sz * cosXs
    fbx = -p1sp_b * sinXs * cosp + p1sx * cosXs
    p1fsx = jnp.where(use_a, fax, fbx)
    p1fsy = jnp.where(use_a, fay, fby)
    p1fsz = jnp.where(use_a, faz, fbz)

    # back to the lab frame (ref :233-259)
    vcDp1fs = vcx * p1fsx + vcy * p1fsy + vcz * p1fsz
    factor = (gc - 1.0) / jnp.maximum(vcms, tiny)
    f1 = jnp.where(vc_ok, factor * vcDp1fs + m1v * g1s * gc, 0.0)
    f2 = jnp.where(vc_ok, factor * (-vcDp1fs) + m2v * g2s * gc, 0.0)
    p1fx = p1fsx + vcx * f1
    p1fy = p1fsy + vcy * f1
    p1fz = p1fsz + vcz * f1
    p2fx = -p1fsx + vcx * f2
    p2fy = -p1fsy + vcy * f2
    p2fz = -p1fsz + vcz * f2

    # rejection per species (ref :261-283)
    r1 = jax.random.uniform(k3, s.shape)
    r2 = jax.random.uniform(k4, s.shape)
    wmax = jnp.maximum(w1, w2)
    take1 = (w2 > r1 * wmax) & ~no_collide
    take2 = (w1 > r2 * wmax) & ~no_collide

    scale = inv_c_SI if normalized_units else 1.0
    n1x = jnp.where(take1, p1fx / m1v * scale, u1x * scale if normalized_units else u1x)
    n1y = jnp.where(take1, p1fy / m1v * scale, u1y * scale if normalized_units else u1y)
    n1z = jnp.where(take1, p1fz / m1v * scale, u1z * scale if normalized_units else u1z)
    n2x = jnp.where(take2, p2fx / m2v * scale, u2x * scale if normalized_units else u2x)
    n2y = jnp.where(take2, p2fy / m2v * scale, u2y * scale if normalized_units else u2y)
    n2z = jnp.where(take2, p2fz / m2v * scale, u2z * scale if normalized_units else u2z)
    return (n1x, n1y, n1z), (n2x, n2y, n2z)


def beam_plasma_collision(p1, p2, geom, cfg1, cfg2, pc, coulomb_log,
                          background_density_SI, normalized_units, key,
                          dt_step):
    """Beam against plasma (ref CoulombCollision.cpp:245-350)."""
    return _inter_species_collision(p1, p2, geom, cfg1, cfg2, pc,
                                    coulomb_log, background_density_SI,
                                    normalized_units, key, beam1=True,
                                    dt_step=dt_step)


def plasma_plasma_collision(p1: dict, p2: dict, geom: Geometry, cfg1, cfg2,
                            pc, coulomb_log, background_density_SI,
                            normalized_units, key, is_same_species: bool):
    """Intra/inter-species plasma collisions on one slice
    (ref CoulombCollision.cpp:60-240). Same-species supported natively;
    inter-species pairs species-1 particles with co-located species-2.
    Returns updated particle dicts."""
    if not is_same_species:
        return _inter_species_collision(p1, p2, geom, cfg1, cfg2, pc,
                                        coulomb_log, background_density_SI,
                                        normalized_units, key, beam1=False)
    p = p1
    cfg = cfg1
    clight = pc.c
    inv_c = 1.0 / pc.c
    inv_c2 = inv_c * inv_c
    n = p["x"].size
    ncell = geom.nx * geom.ny
    wp = cst.plasma_frequency_SI(background_density_SI) \
        if normalized_units else 0.0
    dt = geom.dz / wp if normalized_units else geom.dz / cst.SI_c
    inv_dV = 1.0 / (geom.dx * geom.dy * geom.dz)

    cell, ok = _cell_of(p["x"], p["y"], geom)
    cell = jnp.where(p["valid"] & ok, cell, ncell)
    k_sort, k_kick = jax.random.split(key)
    perm = _shuffled_cell_sort(cell, k_sort)
    cs = cell[perm]
    idx = perm

    starts = jnp.searchsorted(cs, jnp.arange(ncell + 1))
    counts = starts[1:].astype(jnp.int32) - starts[:-1].astype(jnp.int32)
    pos = jnp.arange(n)
    my_cell = jnp.clip(cs, 0, ncell - 1)
    rank = pos - starts[my_cell]
    n_in_cell = counts[my_cell]
    nh = n_in_cell // 2     # group-1 size NI1 (ref CoulombCollision.cpp:122)
    is_a = rank < nh        # pair lead: rank k pairs rank k + NI1
    partner_pos = jnp.where(is_a, pos + nh, pos)
    # odd cells: the reference runs max(NI1,NI2)=ceil(n/2) pairs with
    # cyclic index reuse, so lead rank 0 collides a SECOND time with the
    # leftover rank n-1 (ref ElasticCollisionPerez.H:146-188)
    is_wrap = (n_in_cell % 2 == 1) & (n_in_cell >= 3) & (rank == 0)
    wrap_pos = jnp.where(is_wrap, pos + n_in_cell - 1, pos)

    ux = p["ux"][idx]
    uy = p["uy"][idx]
    psi = p["psi"][idx]
    w = jnp.where(p["valid"][idx], p["w"][idx], 0.0)
    ion = p["ion_lev"][idx].astype(ux.dtype) if cfg.can_ionize else None

    g = _gamma_plasma(ux, uy, psi, inv_c2)
    uz = clight * (g - psi)

    # per-cell temperature (ref ComputeTemperature.H)
    def cellsum(v):
        return jnp.zeros((ncell + 1,), v.dtype).at[cs].add(v)[:ncell]

    nn = jnp.maximum(cellsum(jnp.ones_like(ux)
                             * (cs < ncell)), 1.0)
    vx_m = cellsum(ux / g) / nn
    vy_m = cellsum(uy / g) / nn
    vz_m = cellsum(uz / g) / nn
    vs_m = cellsum((ux * ux + uy * uy + uz * uz) / (g * g)) / nn
    mass = cfg.mass
    T_cell = mass / 3.0 * (vs_m - (vx_m**2 + vy_m**2 + vz_m**2))

    n1_cell = cellsum(w)  # same species: n1 = n2 = total
    # n12 = 2 * sum over the ceil(n/2) (wrapped) pairs of min(w_a, w_b)
    # (ref ElasticCollisionPerez.H:106-116)
    w_partner = w[jnp.clip(partner_pos, 0, n - 1)]
    pair_min = jnp.where(is_a, jnp.minimum(w, w_partner), 0.0)
    w_wrap = w[jnp.clip(wrap_pos, 0, n - 1)]
    wrap_min = jnp.where(is_wrap, jnp.minimum(w, w_wrap), 0.0)
    n12_cell = 2.0 * cellsum(pair_min + wrap_min)

    dens_fac = background_density_SI if normalized_units else inv_dV
    n1 = n1_cell * dens_fac
    n12 = n12_cell * dens_fac

    q = cfg.charge
    # Debye length from SI-unit temperature and charge
    if normalized_units:
        T_SI = T_cell * cst.SI_m_e * cst.SI_c * cst.SI_c
        q_SI = q * cst.SI_q_e
    else:
        T_SI = T_cell
        q_SI = q
    lmdD = jnp.where(T_SI > 0.0,
                     1.0 / jnp.sqrt(jnp.maximum(
                         2.0 * n1 * q_SI * q_SI
                         / (jnp.maximum(T_SI, 1e-300) * cst.SI_ep0),
                         1e-300)), 0.0)
    rmin = (4.0 * math.pi / 3.0 * jnp.maximum(n1, 1e-300)) ** (-1.0 / 3.0)
    lmdD = jnp.maximum(lmdD, rmin)

    # gather pair data (lead = a, partner = b)
    bpos = jnp.clip(partner_pos, 0, n - 1)
    q_a = q * ion if ion is not None else q
    q_b = q * ion[bpos] if ion is not None else q

    mc = my_cell
    dt_fac = 0.5 * (g / psi + (g / psi)[bpos])
    keys = jax.random.split(k_kick, 4)
    (a1x, a1y, a1z), (a2x, a2y, a2z) = _pair_kick(
        ux, uy, uz, g,
        ux[bpos], uy[bpos], psi[bpos] * 0 + uz[bpos],
        _gamma_plasma(ux[bpos], uy[bpos], psi[bpos], inv_c2),
        n1[mc], n1[mc], n12[mc],
        q_a, mass, w, q_b, mass, w[bpos],
        dt * dt_fac, coulomb_log, lmdD[mc], normalized_units,
        [jax.random.fold_in(k, 0) for k in keys])

    # valid pairs only
    pair_ok = is_a & (w > 0) & (w[bpos] > 0) & (cs < ncell)

    new_ux = jnp.where(pair_ok, a1x, ux)
    new_uy = jnp.where(pair_ok, a1y, uy)
    new_uz = jnp.where(pair_ok, a1z, uz)

    # partner updates scattered FROM LEAD LANES ONLY: non-lead lanes have
    # partner_pos == pos, and writing their (unchanged) self value races
    # the lead's write at the same index — XLA duplicate-index .set() is
    # last-write-wins, which silently dropped the partner kick. Route
    # non-lead writes to a discarded dummy slot instead.
    def _scatter_partner(base, vals, ok, tgt):
        arr = jnp.concatenate([base, jnp.zeros((1,), base.dtype)])
        arr = arr.at[jnp.where(ok, tgt, n)].set(
            jnp.where(ok, vals, 0.0))
        return arr[:-1]

    new_ux = _scatter_partner(new_ux, a2x, pair_ok, bpos)
    new_uy = _scatter_partner(new_uy, a2y, pair_ok, bpos)
    new_uz = _scatter_partner(new_uz, a2z, pair_ok, bpos)

    # ---- wrap pass (odd cells): rank 0 collides again with rank n-1,
    # AFTER its first kick — sequential like the reference's per-cell loop
    # (ref ElasticCollisionPerez.H:148: k = NI1 reuses i1 = I1s)
    wpos = jnp.clip(wrap_pos, 0, n - 1)
    g_w = jnp.sqrt(1.0 + (new_ux**2 + new_uy**2 + new_uz**2) * inv_c2)
    psi_w = g_w - new_uz * inv_c
    q_bw = q * ion[wpos] if ion is not None else q
    dt_fac_w = 0.5 * (g_w / psi_w + (g_w / psi_w)[wpos])
    (b1x, b1y, b1z), (b2x, b2y, b2z) = _pair_kick(
        new_ux, new_uy, new_uz, g_w,
        new_ux[wpos], new_uy[wpos], new_uz[wpos], g_w[wpos],
        n1[mc], n1[mc], n12[mc],
        q_a, mass, w, q_bw, mass, w[wpos],
        dt * dt_fac_w, coulomb_log, lmdD[mc], normalized_units,
        [jax.random.fold_in(k, 1) for k in keys])
    wrap_ok = is_wrap & (w > 0) & (w[wpos] > 0) & (cs < ncell)
    new_ux = jnp.where(wrap_ok, b1x, new_ux)
    new_uy = jnp.where(wrap_ok, b1y, new_uy)
    new_uz = jnp.where(wrap_ok, b1z, new_uz)
    new_ux = _scatter_partner(new_ux, b2x, wrap_ok, wpos)
    new_uy = _scatter_partner(new_uy, b2y, wrap_ok, wpos)
    new_uz = _scatter_partner(new_uz, b2z, wrap_ok, wpos)

    g_new = jnp.sqrt(1.0 + (new_ux**2 + new_uy**2 + new_uz**2) * inv_c2)
    new_psi = g_new - new_uz * inv_c

    out = dict(p)
    inv_perm = jnp.argsort(idx)
    out["ux"] = new_ux[inv_perm]
    out["uy"] = new_uy[inv_perm]
    out["psi"] = jnp.where(p["valid"], new_psi[inv_perm], p["psi"])
    out["ux"] = jnp.where(p["valid"], out["ux"], p["ux"])
    out["uy"] = jnp.where(p["valid"], out["uy"], p["uy"])
    return out, p2


def _inter_species_collision(p1, p2, geom, cfg1, cfg2, pc, coulomb_log,
                             background_density_SI, normalized_units, key,
                             beam1: bool, dt_step=0.0):
    """Species-1 (beam or plasma) against plasma species-2: each species-1
    particle pairs with a random co-located species-2 particle
    (ref CoulombCollision.cpp:160-240, 245-350)."""
    clight = pc.c
    inv_c = 1.0 / pc.c
    inv_c2 = inv_c * inv_c
    ncell = geom.nx * geom.ny
    wp = cst.plasma_frequency_SI(background_density_SI) \
        if normalized_units else 0.0
    inv_dV = 1.0 / (geom.dx * geom.dy * geom.dz)

    n1p = p1["x"].size
    n2p = p2["x"].size
    cell1, ok1 = _cell_of(p1["x"], p1["y"], geom)
    cell1 = jnp.where(p1["valid"] & ok1, cell1, ncell)
    cell2, ok2 = _cell_of(p2["x"], p2["y"], geom)
    cell2 = jnp.where(p2["valid"] & ok2, cell2, ncell)

    k1, k2, k3 = jax.random.split(key, 3)
    perm2 = _shuffled_cell_sort(cell2, k1)
    cs2 = cell2[perm2]
    starts2 = jnp.searchsorted(cs2, jnp.arange(ncell + 1))
    counts2 = (starts2[1:] - starts2[:-1]).astype(jnp.int32)

    # each species-1 particle draws a random partner among the n2 of its cell
    c1 = jnp.clip(cell1, 0, ncell - 1)
    n2_in = counts2[c1]
    rdraw = jax.random.uniform(k2, (n1p,))
    pick = jnp.minimum((rdraw * n2_in).astype(jnp.int32),
                       jnp.maximum(n2_in - 1, 0))
    partner = jnp.clip(starts2[c1].astype(jnp.int32) + pick, 0, n2p - 1)
    has_partner = (n2_in > 0) & (cell1 < ncell)

    w1 = jnp.where(p1["valid"], p1["w"], 0.0)
    w2s = jnp.where(p2["valid"][perm2], p2["w"][perm2], 0.0)

    def cellsum2(v):
        return jnp.zeros((ncell + 1,), v.dtype).at[cs2].add(v)[:ncell]

    def cellsum1(v):
        return jnp.zeros((ncell + 1,), v.dtype).at[
            jnp.where(has_partner, c1, ncell)].add(v)[:ncell]

    dens_fac = background_density_SI if normalized_units else inv_dV
    n1_cell = cellsum1(w1) * dens_fac
    n2_cell = cellsum2(w2s) * dens_fac
    w2_of_1 = w2s[partner]
    n12_cell = cellsum1(jnp.minimum(w1, w2_of_1)) * dens_fac

    # species-1 kinematics
    if beam1:
        u1x, u1y = p1["ux"], p1["uy"]
        u1z = p1["uz"]
        g1 = jnp.sqrt(1.0 + (u1x**2 + u1y**2 + u1z**2) * inv_c2)
        dt1 = 0.0  # set below
    else:
        u1x, u1y = p1["ux"], p1["uy"]
        g1 = _gamma_plasma(u1x, u1y, p1["psi"], inv_c2)
        u1z = clight * (g1 - p1["psi"])

    u2x = p2["ux"][perm2][partner]
    u2y = p2["uy"][perm2][partner]
    psi2 = p2["psi"][perm2][partner]
    g2 = _gamma_plasma(u2x, u2y, psi2, inv_c2)
    u2z = clight * (g2 - psi2)

    # temperatures per cell (species 2; species 1 via its own sum)
    def temp(pp, is_beam, cells, valid):
        uxt, uyt = pp["ux"], pp["uy"]
        if is_beam:
            gz = jnp.sqrt(1.0 + (uxt**2 + uyt**2 + pp["uz"]**2) * inv_c2)
            uzt = pp["uz"]
        else:
            gz = _gamma_plasma(uxt, uyt, pp["psi"], inv_c2)
            uzt = clight * (gz - pp["psi"])
        m = jnp.where(valid, 1.0, 0.0)
        csum = lambda v: jnp.zeros((ncell + 1,), v.dtype).at[cells].add(v)[:ncell]
        nn = jnp.maximum(csum(m), 1.0)
        vx = csum(m * uxt / gz) / nn
        vy = csum(m * uyt / gz) / nn
        vz = csum(m * uzt / gz) / nn
        vs = csum(m * (uxt**2 + uyt**2 + uzt**2) / gz**2) / nn
        return vs - (vx**2 + vy**2 + vz**2)

    T1 = cfg1.mass / 3.0 * temp(p1, beam1, jnp.where(
        p1["valid"] & ok1, cell1, ncell), p1["valid"])
    T2 = cfg2.mass / 3.0 * temp(
        {k: (v[perm2] if k in ("ux", "uy", "uz", "psi") and k in p2 else v)
         for k, v in p2.items() if k in ("ux", "uy", "psi", "uz")},
        False, cs2, p2["valid"][perm2])

    if normalized_units:
        T1_SI = T1 * cst.SI_m_e * cst.SI_c ** 2
        T2_SI = T2 * cst.SI_m_e * cst.SI_c ** 2
        q1_SI = cfg1.charge * cst.SI_q_e
        q2_SI = cfg2.charge * cst.SI_q_e
    else:
        T1_SI, T2_SI = T1, T2
        q1_SI, q2_SI = cfg1.charge, cfg2.charge
    denom = (n1_cell * q1_SI**2 / jnp.maximum(T1_SI, 1e-300)
             + n2_cell * q2_SI**2 / jnp.maximum(T2_SI, 1e-300)) / cst.SI_ep0
    lmdD = jnp.where((T1_SI > 0) & (T2_SI > 0),
                     1.0 / jnp.sqrt(jnp.maximum(denom, 1e-300)), 0.0)
    rmin = (4.0 * math.pi / 3.0
            * jnp.maximum(jnp.maximum(n1_cell, n2_cell), 1e-300)) ** (-1.0 / 3.0)
    lmdD = jnp.maximum(lmdD, rmin)

    if beam1:
        # dt is the full time step (ref CoulombCollision.cpp:302)
        dt = dt_step / wp if normalized_units else dt_step
        dtv = jnp.broadcast_to(dt, u1x.shape)
    else:
        dt = geom.dz / wp if normalized_units else geom.dz / cst.SI_c
        dtv = dt * 0.5 * (g1 / p1["psi"] + g2 / psi2)

    ion1 = p1["ion_lev"].astype(u1x.dtype) if getattr(cfg1, "can_ionize",
                                                      False) else 1.0
    q1v = cfg1.charge * ion1
    q2v = cfg2.charge

    keys = jax.random.split(k3, 4)
    mc = c1
    (n1x, n1y, n1z), (n2x_, n2y_, n2z_) = _pair_kick(
        u1x, u1y, u1z, g1, u2x, u2y, u2z, g2,
        n1_cell[mc], n2_cell[mc], n12_cell[mc],
        q1v, cfg1.mass, w1, q2v, cfg2.mass, w2_of_1,
        dtv, coulomb_log, lmdD[mc], normalized_units, list(keys))

    okp = has_partner & (w1 > 0) & (w2_of_1 > 0)
    out1 = dict(p1)
    out1["ux"] = jnp.where(okp, n1x, p1["ux"])
    out1["uy"] = jnp.where(okp, n1y, p1["uy"])
    if beam1:
        out1["uz"] = jnp.where(okp, n1z, p1["uz"])
    else:
        gn = jnp.sqrt(1.0 + (n1x**2 + n1y**2 + n1z**2) * inv_c2)
        out1["psi"] = jnp.where(okp, gn - n1z * inv_c, p1["psi"])

    # species 2 update: first pairing wins (duplicates dropped to keep the
    # scatter deterministic; the rejection probability already downweights)
    gn2 = jnp.sqrt(1.0 + (n2x_**2 + n2y_**2 + n2z_**2) * inv_c2)
    psi2_new = gn2 - n2z_ * inv_c
    sorted_targets = jnp.where(okp, partner, n2p)
    uxs = p2["ux"][perm2]
    uys = p2["uy"][perm2]
    psis = p2["psi"][perm2]
    uxs = jnp.concatenate([uxs, jnp.zeros((1,), uxs.dtype)])
    uys = jnp.concatenate([uys, jnp.zeros((1,), uys.dtype)])
    psis = jnp.concatenate([psis, jnp.ones((1,), psis.dtype)])
    uxs = uxs.at[sorted_targets].set(jnp.where(okp, n2x_, uxs[jnp.clip(sorted_targets, 0, n2p)]))
    uys = uys.at[sorted_targets].set(jnp.where(okp, n2y_, uys[jnp.clip(sorted_targets, 0, n2p)]))
    psis = psis.at[sorted_targets].set(jnp.where(okp, psi2_new, psis[jnp.clip(sorted_targets, 0, n2p)]))
    inv_perm2 = jnp.argsort(perm2)
    out2 = dict(p2)
    out2["ux"] = uxs[:-1][inv_perm2]
    out2["uy"] = uys[:-1][inv_perm2]
    out2["psi"] = psis[:-1][inv_perm2]
    return out1, out2
