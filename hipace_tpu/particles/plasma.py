"""Plasma particle species: fixed-capacity SoA arrays, zeta pusher, deposits.

A JAX re-design of the reference's plasma layer:
- container & init:  /root/reference/src/particles/plasma/PlasmaParticleContainer{.cpp,Init.cpp}
- zeta pusher:       /root/reference/src/particles/pusher/PlasmaParticleAdvance.cpp:29-305
                     and PushPlasmaParticles.H:39-75
- current deposit:   /root/reference/src/particles/deposition/PlasmaDepositCurrent.cpp
- explicit Sx/Sy:    /root/reference/src/particles/deposition/ExplicitDeposition.cpp

Particles live in flat (N,) jnp arrays carried through the zeta lax.scan.
The reference's 2nd-order dual-number correction of the leapfrog
(PlasmaParticleAdvance.cpp:136-217, utils/DualNumbers.H) is expressed with
jax.jvp: the dual push is exactly a directional derivative of the momentum
derivative function along itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from ..constants import PhysConst
from ..geometry import Geometry
from ..ops.gather import gather_main_fields, gather_laser_aabs
from ..ops.shape import shape_weights, shape_weights_derivative
from ..parser import Inputs


@dataclasses.dataclass(frozen=True)
class PlasmaConfig:
    """Static per-species configuration (hashable, closed over by jit)."""
    name: str = "plasma"
    charge: float = -1.0
    mass: float = 1.0
    ppc: tuple[int, int] = (1, 1)
    n_subcycles: int = 1
    radius: float = float("inf")
    hollow_core_radius: float = 0.0
    max_qsa_weighting_factor: float = 35.0
    neutralize_background: bool = True
    can_ionize: bool = False
    init_ion_lev: int = -1
    u_mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_std: tuple[float, float, float] = (0.0, 0.0, 0.0)
    min_density: float = 0.0
    # boundary handling: "Periodic" | "Reflecting" | "Absorbing"
    particle_boundary: str = "Periodic"
    # optional tighter particle box (lo0, lo1, hi0, hi1)
    # (ref boundary.particle_lo/hi, parameters.rst:203-210)
    particle_bounds: tuple | None = None
    density_expr: str = "1."
    consts: tuple = ()
    # field ionization (ref PlasmaParticleContainer.cpp:380-461)
    element: str = "electron"
    ionization_product: str = ""
    # per-level ADK constants (power, prefactor, exp_prefactor), attached by
    # the driver once dz and the background density are known
    adk: tuple = ()
    # density table: ((position, density_expr), ...) — the expression for
    # the smallest position >= c*t is used each step
    # (ref <plasma name>.density_table_file, parameters.rst:405-411)
    density_table: tuple = ()
    # fine plasma patch for mesh refinement (ref PlasmaParticleContainer.H:
    # 166-171, Init.cpp:95-160): fine_ppc inside fine_patch(x,y) > 0, with
    # positions morphing from the coarse to the fine layout over
    # fine_transition_cells cells (ParticleUtil.H:66-104)
    fine_patch_expr: str = ""
    fine_ppc: tuple = (0, 0)
    fine_transition_cells: int = 5

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst,
                    particle_boundary: str) -> "PlasmaConfig":
        pp = inputs.prefix(name)
        pa = inputs.prefix("plasmas")  # alt prefix shared by all species
        pblo = inputs.query_list("boundary.particle_lo", [], float)
        pbhi = inputs.query_list("boundary.particle_hi", [], float)
        pbounds = (tuple(pblo[:2]) + tuple(pbhi[:2])
                   if len(pblo) >= 2 and len(pbhi) >= 2 else None)

        def q(key, default, dtype=None):
            return pp.query(key, pa.query(key, default, dtype), dtype)

        element = pp.query("element", "electron", str)
        if element == "electron":
            charge, mass = -pc.q_e, pc.m_e
        elif element == "positron":
            charge, mass = pc.q_e, pc.m_e
        elif element in ("proton",):
            charge, mass = pc.q_e, pc.m_p
        else:
            from ..utils.atomic_data import ATOMIC_WEIGHTS_DA
            charge = pc.q_e
            mass = pc.m_p * ATOMIC_WEIGHTS_DA.get(element, 1.007276466621) \
                / 1.007276466621
        if pp.contains("mass_Da"):
            mass = pc.m_p * pp.get("mass_Da") / 1.007276466621
        mass = pp.query("mass", mass)
        charge = pp.query("charge", charge)
        init_ion_lev = pp.query("initial_ion_level", -1, int)
        can_ionize = pp.query("can_ionize", init_ion_lev >= 0, bool)
        neutralize = q("neutralize_background", not can_ionize, bool)
        if init_ion_lev >= 1:
            charge = abs(charge) * init_ion_lev if charge > 0 else charge * init_ion_lev
        ppc = tuple(pp.query_list("ppc", pa.query_list("ppc", [1, 1], int), int))
        density_expr = "1."
        f = pp.get_function("density", ("x", "y", "z"))
        if f is None:
            f = pa.get_function("density", ("x", "y", "z"))
        if f is not None:
            density_expr = f.expr
        table = []
        table_file = pp.query("density_table_file", "", str)
        if table_file:
            with open(table_file) as fh:
                for line in fh:
                    parts = line.split(None, 1)
                    if len(parts) != 2:
                        continue
                    try:
                        pos = float(parts[0])
                    except ValueError:
                        continue   # comment / malformed line
                    table.append((pos, parts[1].strip()))
            table.sort(key=lambda t: t[0])
            if table:
                density_expr = table[0][1]
        return cls(
            name=name, charge=charge, mass=mass, ppc=ppc,
            n_subcycles=q("n_subcycles", 1, int),
            radius=q("radius", float("inf")),
            hollow_core_radius=q("hollow_core_radius", 0.0),
            max_qsa_weighting_factor=q("max_qsa_weighting_factor", 35.0),
            neutralize_background=neutralize,
            can_ionize=can_ionize, init_ion_lev=init_ion_lev,
            u_mean=tuple(pp.query_list("u_mean", [0.0, 0.0, 0.0])),
            u_std=tuple(pp.query_list("u_std", [0.0, 0.0, 0.0])),
            min_density=q("min_density", 0.0),
            particle_boundary=particle_boundary,
            particle_bounds=pbounds,
            density_expr=density_expr,
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
            element=element,
            ionization_product=pp.query("ionization_product", "", str),
            density_table=tuple(table),
            fine_patch_expr=(pp.get_function("fine_patch", ("x", "y")).expr
                             if pp.get_function("fine_patch", ("x", "y"))
                             is not None else ""),
            fine_ppc=tuple(pp.query_list("fine_ppc", [0, 0], int)),
            fine_transition_cells=pp.query("fine_transition_cells", 5, int),
        )

    def density_fn(self) -> Callable:
        from ..parser import compile_function
        return compile_function(self.density_expr, ("x", "y", "z"),
                                self.consts)


def plasma_count(cfg: PlasmaConfig, geom: Geometry, dtype,
                 normalized_units: bool = True) -> int:
    """Static particle count init_plasma will produce (before padding)."""
    if bool(cfg.fine_patch_expr) and cfg.fine_ppc[0] * cfg.fine_ppc[1] > 0:
        x, *_ = _fine_patch_positions(cfg, geom, dtype, normalized_units)
        return int(x.size)
    return geom.nx * geom.ny * cfg.ppc[0] * cfg.ppc[1]


def pad_plasma(st: dict, extra: int) -> dict:
    """Append `extra` invalid lanes (ionization product slots / banded
    chunk padding); psi pads with 1 so 1/psi stays finite."""
    if not extra:
        return st
    out = {}
    for k, v in st.items():
        fill = 1.0 if k in ("psi", "psi_half") else 0
        z = jnp.full((extra,), fill, v.dtype)
        out[k] = jnp.concatenate([v, z])
    return out


def init_plasma(cfg: PlasmaConfig, geom: Geometry, key, dtype,
                c_t: float = 0.0, normalized_units: bool = True,
                ab5: bool = False) -> dict:
    """Initialize the slice plasma population (ref PlasmaParticleContainerInit.cpp:17-378).

    Fixed ppc per transverse cell; weight = density / num_ppc (normalized
    units) evaluated at the particle position. Returns flat SoA dict; the
    particle count is static: nx*ny*ppc with a validity mask for density /
    radius cuts.
    """
    nx, ny = geom.nx, geom.ny
    px, py = cfg.ppc
    nppc = px * py
    dx, dy = geom.dx, geom.dy

    use_fine = bool(cfg.fine_patch_expr) and cfg.fine_ppc[0] * cfg.fine_ppc[1] > 0
    if use_fine:
        x, y, init_mask, w_scale = _fine_patch_positions(cfg, geom, dtype,
                                                         normalized_units)
        n = x.size
    else:
        ix = jnp.arange(nx)
        iy = jnp.arange(ny)
        sx = (jnp.arange(px) + 0.5) / px
        sy = (jnp.arange(py) + 0.5) / py
        # ordering: ppc slowest (like the reference: particles in the same
        # cell are far apart in memory, Init.cpp:189-192), then y, then x
        # fastest
        X = geom.prob_lo[0] + (ix[None, None, None, :]
                               + sx[:, None, None, None]) * dx
        Y = geom.prob_lo[1] + (iy[None, None, :, None]
                               + sy[None, :, None, None]) * dy
        x = jnp.broadcast_to(X, (px, py, ny, nx)).reshape(-1).astype(dtype)
        y = jnp.broadcast_to(Y, (px, py, ny, nx)).reshape(-1).astype(dtype)
        n = x.size
        init_mask = jnp.ones((n,), bool)
        # scale factor: 1/ppc in normalized units, cell volume/ppc in SI
        # (ref PlasmaParticleContainerInit.cpp:40-45)
        if nppc == 0:
            scale = 0.0  # empty species (e.g. ionization product, ppc 0 0)
        elif normalized_units:
            scale = 1.0 / nppc
        else:
            scale = geom.dx * geom.dy * geom.dz / nppc
        w_scale = jnp.full((n,), scale, dtype)

    dens_fn = cfg.density_fn()
    dens = jnp.asarray(dens_fn(x, y, jnp.full_like(x, c_t)), dtype=dtype)
    dens = jnp.broadcast_to(dens, x.shape)
    rsq = x * x + y * y
    valid = (init_mask
             & (dens > cfg.min_density)
             & (rsq <= cfg.radius ** 2)
             & (rsq >= cfg.hollow_core_radius ** 2))
    if cfg.particle_bounds is not None:
        lo0, lo1, hi0, hi1 = cfg.particle_bounds
        valid = valid & (x >= lo0) & (x < hi0) & (y >= lo1) & (y < hi1)
    w = jnp.where(valid, dens * w_scale, 0.0)

    if any(s != 0.0 for s in cfg.u_std):
        kx, ky, kz = jax.random.split(key, 3)
        u0 = cfg.u_mean[0] + cfg.u_std[0] * jax.random.normal(kx, (n,), dtype)
        u1 = cfg.u_mean[1] + cfg.u_std[1] * jax.random.normal(ky, (n,), dtype)
        u2 = cfg.u_mean[2] + cfg.u_std[2] * jax.random.normal(kz, (n,), dtype)
    else:
        u0 = jnp.full((n,), cfg.u_mean[0], dtype)
        u1 = jnp.full((n,), cfg.u_mean[1], dtype)
        u2 = jnp.full((n,), cfg.u_mean[2], dtype)

    psi = jnp.sqrt(1.0 + u0 * u0 + u1 * u1 + u2 * u2) - u2
    # momenta stored as proper velocity u*c (ref Init.cpp:296-297); psi is
    # computed from the dimensionless u first
    if not normalized_units:
        from ..constants import SI_c
        u0 = u0 * SI_c
        u1 = u1 * SI_c
    # ionizable species start at their configured level (may be 0 = neutral);
    # non-ionizable species use 1 so the ion_lev factor is a no-op
    lev0 = cfg.init_ion_lev if cfg.can_ionize else 1
    ion_lev = jnp.full((n,), lev0, jnp.int32)
    # u stored as proper velocity (* c), ref Init.cpp:296-297
    out = {
        "x": x, "y": y, "w": w,
        "ux": u0, "uy": u1, "psi": psi,
        "x_prev": x, "y_prev": y,
        "ux_half": u0, "uy_half": u1, "psi_half": psi,
        "ion_lev": ion_lev, "valid": valid,
    }
    if cfg.can_ionize:
        # persistent particle identity: ionization draws are keyed to it so
        # the ionized set is invariant under the banded row sort
        out["pid"] = jnp.arange(n, dtype=jnp.int32)
    if ab5:
        # 25 force-history slots for the AB5 multistep pusher
        # (ref PlasmaParticleContainer.H:21-46 under HIPACE_USE_AB5_PUSH)
        z = jnp.zeros((n,), dtype)
        for i in range(1, 6):
            for f in ("Fx", "Fy", "Fux", "Fuy", "Fpsi"):
                out[f"{f}{i}"] = z
    return out


def _fine_patch_positions(cfg: PlasmaConfig, geom: Geometry, dtype,
                          normalized_units: bool):
    """Particle positions for the MR fine plasma patch
    (ref PlasmaParticleContainerInit.cpp:95-160, ParticleUtil.H:66-104).

    Every cell allocates fine_ppc slots (static shape). Outside the patch +
    transition only the first ppc slots initialize (coarse layout); inside
    the transition the positions morph smoothly from the coarse-duplicated
    layout to the fine layout with the smoothstep s = 1.5 t - 0.5 t^3.
    Returns (x, y, init_mask, w_scale) flat arrays.
    """
    import numpy as np
    from ..parser import compile_function

    nx, ny = geom.nx, geom.ny
    dx, dy = geom.dx, geom.dy
    pxc, pyc = cfg.ppc
    pxf, pyf = cfg.fine_ppc
    n_coarse = pxc * pyc
    n_fine = pxf * pyf
    T = cfg.fine_transition_cells

    # per-cell transition counter (static: patch geometry is static;
    # use_numpy keeps the evaluation concrete at trace time)
    fp = compile_function(cfg.fine_patch_expr, ("x", "y"), cfg.consts,
                          use_numpy=True)
    xc = geom.prob_lo[0] + (np.arange(nx) + 0.5) * dx
    yc = geom.prob_lo[1] + (np.arange(ny) + 0.5) * dy
    Xc, Yc = np.meshgrid(xc, yc)
    inside = np.asarray(fp(Xc, Yc)) > 0
    a = np.where(inside, T + 1, 0)
    for _ in range(T):
        b = a.copy()
        b[:, 1:] = np.maximum(b[:, 1:], a[:, :-1] - 1)
        b[:, :-1] = np.maximum(b[:, :-1], a[:, 1:] - 1)
        b[1:, :] = np.maximum(b[1:, :], a[:-1, :] - 1)
        b[:-1, :] = np.maximum(b[:-1, :], a[1:, :] - 1)
        a = b

    # slot layout mirrors the non-fine path: i_part slowest, then y, then x
    i_part = np.arange(n_fine)
    ixf = i_part % pxf
    iyf = i_part // pxf
    ixc = (ixf * pxc) // pxf
    iyc = (iyf * pyc) // pyf
    r_fine_x = (0.5 + ixf) / pxf
    r_fine_y = (0.5 + iyf) / pyf
    # coarse slot layout for i_part < n_coarse
    r_coarse_x = (0.5 + (i_part % pxc)) / pxc
    r_coarse_y = (0.5 + np.minimum(i_part // pxc, pyc - 1)) / pyc
    # transition blend positions
    r_dup_x = (0.5 + ixc) / pxc
    r_dup_y = (0.5 + iyc) / pyc

    A = a[None, :, :]                                   # (1, ny, nx)
    s = A.astype(float) / (T + 1)
    s = 1.5 * s - 0.5 * s ** 3
    in_tr = A > 0                                        # in patch/transition
    rx = np.where(in_tr,
                  r_dup_x[:, None, None] * (1.0 - s)
                  + r_fine_x[:, None, None] * s,
                  r_coarse_x[:, None, None] + 0.0 * s)
    ry = np.where(in_tr,
                  r_dup_y[:, None, None] * (1.0 - s)
                  + r_fine_y[:, None, None] * s,
                  r_coarse_y[:, None, None] + 0.0 * s)
    do_init = in_tr | (i_part[:, None, None] < n_coarse)

    ixg = np.arange(nx)[None, None, :]
    iyg = np.arange(ny)[None, :, None]
    x = geom.prob_lo[0] + (ixg + rx) * dx
    y = geom.prob_lo[1] + (iyg + ry) * dy
    if normalized_units:
        sc_c = 1.0 / n_coarse if n_coarse else 0.0
        sc_f = 1.0 / n_fine
    else:
        vol = geom.dx * geom.dy * geom.dz
        sc_c = vol / n_coarse if n_coarse else 0.0
        sc_f = vol / n_fine
    # weight scale: coarse outside patch+transition, fine inside
    # (ref Init.cpp:290-292: arr_fine == 0 ? scale_fac_coarse : scale_fac_fine)
    wsc = np.where(in_tr, sc_f, sc_c) + 0.0 * rx
    shape = (n_fine, ny, nx)
    return (jnp.asarray(np.broadcast_to(x, shape).reshape(-1), dtype),
            jnp.asarray(np.broadcast_to(y, shape).reshape(-1), dtype),
            jnp.asarray(np.broadcast_to(do_init, shape).reshape(-1)),
            jnp.asarray(np.broadcast_to(wsc, shape).reshape(-1), dtype))


# ----------------------------------------------------------------------
def _momentum_derivative(ux, uy, psi_inv, exmby, eypbx, ez, bx_c, by_c, bz,
                         aabssq, aabssq_dx, aabssq_dy, clight_inv, q_m_c):
    """PlasmaMomentumPush (ref PushPlasmaParticles.H:39-75), vectorized."""
    gamma_psi = 0.5 * psi_inv * psi_inv * (
        1.0 + aabssq
        + ux * ux * clight_inv * clight_inv
        + uy * uy * clight_inv * clight_inv) + 0.5
    dz_ux = (q_m_c * (gamma_psi * exmby + by_c + uy * bz * psi_inv)
             - aabssq_dx * psi_inv)
    dz_uy = (q_m_c * (gamma_psi * eypbx - bx_c - ux * bz * psi_inv)
             - aabssq_dy * psi_inv)
    dz_psi = (q_m_c * clight_inv *
              ((ux * exmby + uy * eypbx) * clight_inv * psi_inv - ez))
    return dz_ux, dz_uy, dz_psi


def _second_order_substep(ux, uy, psi, sdz, fields, clight_inv, q_m_c):
    """One leapfrog substep with the dual-number 2nd-order correction
    (ref PlasmaParticleAdvance.cpp:148-168) via jax.jvp."""
    exmby, eypbx, ez, bx_c, by_c, bz, a2, a2dx, a2dy = fields

    def deriv(u):
        uxx, uyy, psv = u
        return jnp.stack(_momentum_derivative(
            uxx, uyy, 1.0 / psv, exmby, eypbx, ez, bx_c, by_c, bz,
            a2, a2dx, a2dy, clight_inv, q_m_c))

    u = jnp.stack([ux, uy, psi])
    d = deriv(u)
    _, d2 = jax.jvp(deriv, (u,), (d,))
    u = u + sdz * d + 0.5 * sdz * sdz * d2
    return u[0], u[1], u[2]


def enforce_particle_bc(x, y, ux, uy, w, valid, geom: Geometry, mode: str,
                        bounds=None):
    """Transverse particle boundary (ref GetAndSetPosition.H:31-101).
    bounds: optional (lo0, lo1, hi0, hi1) override of the domain box
    (ref boundary.particle_lo/hi, Hipace.cpp:217-231)."""
    if bounds is not None:
        lo0, lo1, hi0, hi1 = bounds
    else:
        lo0, lo1 = geom.prob_lo[0], geom.prob_lo[1]
        hi0, hi1 = geom.prob_hi[0], geom.prob_hi[1]
    out = (x < lo0) | (x > hi0) | (y < lo1) | (y > hi1)
    if mode == "Periodic":
        lx, ly = hi0 - lo0, hi1 - lo1
        x = jnp.where(out, lo0 + jnp.mod(x - lo0, lx), x)
        y = jnp.where(out, lo1 + jnp.mod(y - lo1, ly), y)
        return x, y, ux, uy, w, valid
    if mode == "Reflecting":
        lx, ly = hi0 - lo0, hi1 - lo1
        xm = jnp.mod(x - lo0, 2 * lx)
        refx = xm > lx
        xn = jnp.where(refx, 2 * lx - xm, xm) + lo0
        uxn = jnp.where(refx, -ux, ux)
        ym = jnp.mod(y - lo1, 2 * ly)
        refy = ym > ly
        yn = jnp.where(refy, 2 * ly - ym, ym) + lo1
        uyn = jnp.where(refy, -uy, uy)
        x = jnp.where(out, xn, x)
        y = jnp.where(out, yn, y)
        ux = jnp.where(out, uxn, ux)
        uy = jnp.where(out, uyn, uy)
        return x, y, ux, uy, w, valid
    # Absorbing
    w = jnp.where(out, 0.0, w)
    valid = valid & ~out
    return x, y, ux, uy, w, valid


def adk_constants(cfg: PlasmaConfig, dz: float, normalized_units: bool,
                  background_density_SI: float):
    """Per-level ADK constants (power, prefactor, exp_prefactor)
    (ref PlasmaParticleContainer.cpp:415-453, Chen JCP 236 (2013) eq. 2)."""
    import math
    from .. import constants as cst
    from ..utils.atomic_data import IONIZATION_ENERGIES_EV

    energies = IONIZATION_ENERGIES_EV[cfg.element]
    alpha = 0.0072973525693
    r_e = 2.8179403227e-15
    a3 = alpha ** 3
    a4 = a3 * alpha
    wa = a3 * cst.SI_c / r_e
    Ea = cst.SI_m_e * cst.SI_c ** 2 / cst.SI_q_e * a4 / r_e
    UH = IONIZATION_ENERGIES_EV["H"][0]
    l_eff = math.sqrt(UH / energies[0]) - 1.0

    if normalized_units:
        wp = cst.plasma_frequency_SI(background_density_SI)
        dt = dz / wp
    else:
        dt = dz / cst.SI_c

    out = []
    for i, Uion in enumerate(energies):
        n_eff = (i + 1) * math.sqrt(UH / Uion)
        C2 = 2.0 ** (2 * n_eff) / (n_eff * math.gamma(n_eff + l_eff + 1)
                                   * math.gamma(n_eff - l_eff))
        power = -(2 * n_eff - 1)
        prefactor = dt * wa * C2 * (Uion / (2 * UH)) \
            * (2 * (Uion / UH) ** 1.5 * Ea) ** (2 * n_eff - 1)
        exp_prefactor = -2.0 / 3.0 * (Uion / UH) ** 1.5 * Ea
        out.append((power, prefactor, exp_prefactor))
    return tuple(out)


def ionization_module(ion: dict, elec: dict, fields: dict, geom: Geometry,
                      ion_cfg: PlasmaConfig, pc: PhysConst, order: int,
                      normalized_units: bool, background_density_SI: float,
                      spawn_base: int, elec_init_ion_lev: int, key,
                      spawn_mode: str = "static", lost_out=None):
    """ADK field ionization (ref PlasmaParticleContainer.cpp:263-440).

    Gathers E at the ion's last non-temp position, draws the tunnel
    ionization probability, promotes ion_lev and spawns an electron into
    the product species. Fully static shapes; two slot strategies:

    - "static": each parent owns nlev pre-allocated product slots at
      spawn_base + parent_index*nlev + level. Requires parent array order
      to be stable across slices (the non-banded path).
    - "append": new electrons go to the first free lanes past the valid
      prefix (slot = sum(valid) + prefix-sum over ionized). Requires the
      product array to be compacted valid-first — which the banded row
      sort guarantees every slice — and survives arbitrary re-ordering of
      the parent array. Overflow beyond capacity is dropped and counted
      into lost_out (like the banded deposit window counter).
    """
    import jax
    from .. import constants as cst

    nlev = len(ion_cfg.adk)
    x, y = ion["x_prev"], ion["y_prev"]
    n = x.size
    exmby, eypbx, ez, bx, by, bz = gather_main_fields(
        x, y, fields["Psi"], fields["Ez"], fields["Bx"], fields["By"],
        fields["Bz"], geom, order)
    ex = exmby + by * pc.c
    ey = eypbx - bx * pc.c
    if normalized_units:
        wp = cst.plasma_frequency_SI(background_density_SI)
        E0 = wp * cst.SI_m_e * cst.SI_c / cst.SI_q_e
    else:
        E0 = 1.0
    Ep = jnp.sqrt(ex * ex + ey * ey + ez * ez) * E0
    Ep = jnp.maximum(Ep, 1e-30)

    clight_sq = 1.0 / (pc.c * pc.c)
    psi_h = ion["psi_half"]
    gammap = (1.0 + ion["ux_half"] ** 2 * clight_sq
              + ion["uy_half"] ** 2 * clight_sq
              + psi_h * psi_h) / (2.0 * psi_h)

    lev = jnp.clip(ion["ion_lev"], 0, nlev - 1)
    powers = jnp.asarray([a[0] for a in ion_cfg.adk], Ep.dtype)[lev]
    prefs = jnp.asarray([a[1] for a in ion_cfg.adk], Ep.dtype)[lev]
    exp_prefs = jnp.asarray([a[2] for a in ion_cfg.adk], Ep.dtype)[lev]

    w_dtau = gammap / psi_h * prefs * Ep ** powers * jnp.exp(exp_prefs / Ep)
    prob = 1.0 - jnp.exp(-w_dtau)
    draw = jax.random.uniform(key, (n,), Ep.dtype)
    if "pid" in ion:
        # draws keyed to particle identity, not lane: the ionized set is
        # then independent of the banded row sort's permutation
        draw = draw[ion["pid"]]
    can = ion["valid"] & (ion["ion_lev"] < nlev)
    ionized = can & (draw < prob)

    new_ion = dict(ion)
    new_ion["ion_lev"] = ion["ion_lev"] + ionized.astype(jnp.int32)

    n_elec = elec["x"].size
    if spawn_mode == "append":
        # first free lanes past the valid prefix (banded arrays are
        # compacted valid-first by the per-slice row sort)
        n_valid = jnp.sum(elec["valid"]).astype(jnp.int32)
        rank = jnp.cumsum(ionized.astype(jnp.int32)) - 1
        slot = n_valid + rank
        overflow = ionized & (slot >= n_elec)
        if lost_out is not None:
            lost_out.append(jnp.sum(overflow).astype(jnp.int32))
        slot = jnp.where(ionized & ~overflow, slot, n_elec)  # drop bucket
    else:
        # unique static slots: parent i owns product lanes
        # spawn_base + i*nlev + level
        slot = spawn_base + jnp.arange(n) * nlev \
            + jnp.clip(ion["ion_lev"], 0, nlev - 1)
        slot = jnp.where(ionized, slot, n_elec)  # drop bucket

    def put(arr, vals):
        ext = jnp.concatenate([arr, jnp.zeros((1,), arr.dtype)])
        return ext.at[slot].set(vals)[:-1]

    new_elec = dict(elec)
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    new_elec["x"] = put(elec["x"], ion["x"])
    new_elec["y"] = put(elec["y"], ion["y"])
    new_elec["w"] = put(elec["w"], ion["w"])
    new_elec["ux"] = put(elec["ux"], zero)
    new_elec["uy"] = put(elec["uy"], zero)
    new_elec["psi"] = put(elec["psi"], one)
    new_elec["x_prev"] = put(elec["x_prev"], ion["x_prev"])
    new_elec["y_prev"] = put(elec["y_prev"], ion["y_prev"])
    new_elec["ux_half"] = put(elec["ux_half"], zero)
    new_elec["uy_half"] = put(elec["uy_half"], zero)
    new_elec["psi_half"] = put(elec["psi_half"], one)
    new_elec["ion_lev"] = put(elec["ion_lev"],
                              jnp.full((n,), max(elec_init_ion_lev, 1),
                                       jnp.int32))
    vext = jnp.concatenate([elec["valid"], jnp.zeros((1,), bool)])
    new_elec["valid"] = vext.at[slot].set(ionized)[:-1]
    return new_ion, new_elec


def _banded_main_gather(xp, yp, valid, fields, geom, order, banded,
                        lost_out=None):
    """gather_main_fields via the banded one-hot kernel (requires the caller to
    keep particles approximately row-sorted; see ops/banded.py). Invalid
    lanes read zeros."""
    from ..ops.banded import dispatch_gather_main
    G = geom.nguards
    NY, NX = geom.slice_shape
    dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
    # guard-offset cell positions; invalid lanes get a finite sentinel so
    # the in-kernel shape factors never see NaN (NaN * ok-mask = NaN)
    x = jnp.where(valid, (xp - geom.x_pos_offset) * dx_inv + G, 2.0 * NX)
    y = jnp.where(valid, (yp - geom.y_pos_offset) * dy_inv + G, 2.0 * NY)
    exmby, eypbx, ez, bx, by, bz, lost = dispatch_gather_main(
        [fields["Psi"], fields["Ez"], fields["Bx"], fields["By"],
         fields["Bz"]], y, x, banded, NY, NX, order)
    if lost_out is not None:
        lost_out.append(lost)
    return exmby * dx_inv, eypbx * dy_inv, ez, bx, by, bz


_AB5_COEFFS = (1901.0 / 720.0, -1387.0 / 360.0, 109.0 / 30.0,
               -637.0 / 360.0, 251.0 / 720.0)


def advance_plasma(p: dict, fields: dict, geom: Geometry, cfg: PlasmaConfig,
                   pc: PhysConst, temp_slice: bool, order: int = 2,
                   use_laser: bool = False, banded=None, lost_out=None,
                   fine_levels=(), tag=None, pusher: str = "leapfrog"):
    """Advance plasma particles one zeta slice
    (ref PlasmaParticleAdvance.cpp:29-305, leapfrog path).

    fields: dict with padded slice arrays Psi, Ez, Bx, By, Bz (+ aabs).
    banded: None (XLA gather) or (W, K) to use the banded one-hot gather on
    row-sorted particles. Returns the updated particle dict.

    fine_levels: tuple of (fields_dict, Geometry) for MR levels 1..N; tag is
    the per-particle level assignment from tag_by_level. A tagged particle
    gathers from its level; if a subcycle moves it outside that level's
    bounds the previous gathered values are reused (ref
    PlasmaParticleAdvance.cpp:94,114-135).
    """
    clight = pc.c
    clight_inv = 1.0 / pc.c
    q_m_c = cfg.charge / (cfg.mass * pc.c)
    laser_norm = ((cfg.charge / pc.q_e) * (pc.m_e / cfg.mass)) ** 2
    dz = geom.dz / cfg.n_subcycles

    x = p["x"]
    y = p["y"]
    xprev, yprev = p["x_prev"], p["y_prev"]
    ux_h, uy_h, psi_h = p["ux_half"], p["uy_half"], p["psi_half"]
    valid = p["valid"]
    w = p["w"]

    if cfg.can_ionize:
        ion = p["ion_lev"].astype(x.dtype)
        q_m_c_p = q_m_c * ion
        laser_norm_p = laser_norm * ion * ion
    else:
        q_m_c_p = q_m_c
        laser_norm_p = laser_norm

    stale = None
    for _ in range(cfg.n_subcycles):
        if banded is not None:
            exmby, eypbx, ez, bx, by, bz = _banded_main_gather(
                xprev, yprev, valid, fields, geom, order, banded,
                lost_out=lost_out)
        else:
            exmby, eypbx, ez, bx, by, bz = gather_main_fields(
                xprev, yprev, fields["Psi"], fields["Ez"], fields["Bx"],
                fields["By"], fields["Bz"], geom, order)
        bx_c = bx * clight
        by_c = by * clight
        if use_laser:
            a2, a2dx, a2dy = gather_laser_aabs(xprev, yprev, fields["aabs"],
                                               geom, order)
            a2 = a2 * 0.5 * laser_norm_p
            a2dx = a2dx * 0.25 * clight * laser_norm_p
            a2dy = a2dy * 0.25 * clight * laser_norm_p
        else:
            a2 = a2dx = a2dy = jnp.zeros_like(x)
        fvals = (exmby, eypbx, ez, bx_c, by_c, bz, a2, a2dx, a2dy)
        if fine_levels:
            # MR: tagged particles gather from their fine level; when out of
            # its bounds mid-subcycle keep the previous (stale) values
            from ..fields.mr import in_level_bounds
            if stale is None:
                stale = fvals
            for li, (ff, fg) in enumerate(fine_levels):
                ex1, ey1, ez1, bx1, by1, bz1 = gather_main_fields(
                    xprev, yprev, ff["Psi"], ff["Ez"], ff["Bx"], ff["By"],
                    ff["Bz"], fg, order)
                fine = [ex1, ey1, ez1, bx1 * clight, by1 * clight, bz1,
                        a2, a2dx, a2dy]
                if use_laser:
                    b2, b2dx, b2dy = gather_laser_aabs(
                        xprev, yprev, ff["aabs"], fg, order)
                    fine[6] = b2 * 0.5 * laser_norm_p
                    fine[7] = b2dx * 0.25 * clight * laser_norm_p
                    fine[8] = b2dy * 0.25 * clight * laser_norm_p
                inb = in_level_bounds(xprev, yprev, fg)
                sel = tag == (li + 1)
                fvals = tuple(
                    jnp.where(sel, jnp.where(inb, fv, sv), cv)
                    for fv, sv, cv in zip(fine, stale, fvals))
            stale = fvals

        if pusher == "ab5":
            # Adams-Bashforth 5 multistep (ref PlasmaParticleAdvance.cpp:
            # 218-271 under HIPACE_USE_AB5_PUSH): derivative at the current
            # state becomes history slot 1; the push sums 5 history terms
            exmby, eypbx, ez, bx_c, by_c, bz, a2, a2dx, a2dy = fvals
            psi_inv_h = 1.0 / psi_h
            dz_ux, dz_uy, dz_psi = _momentum_derivative(
                ux_h, uy_h, psi_inv_h, exmby, eypbx, ez, bx_c, by_c, bz,
                a2, a2dx, a2dy, clight_inv, q_m_c_p)
            hist = {
                "Fx1": clight_inv * ux_h * psi_inv_h,
                "Fy1": clight_inv * uy_h * psi_inv_h,
                "Fux1": dz_ux, "Fuy1": dz_uy, "Fpsi1": dz_psi,
            }
            for i in range(2, 6):
                for f in ("Fx", "Fy", "Fux", "Fuy", "Fpsi"):
                    hist[f"{f}{i}"] = p[f"{f}{i}"]
            xnew, ynew = xprev, yprev
            ux, uy, psi = ux_h, uy_h, psi_h
            for i in range(5):
                a_dz = _AB5_COEFFS[i] * dz
                xnew = xnew + a_dz * hist[f"Fx{i + 1}"]
                ynew = ynew + a_dz * hist[f"Fy{i + 1}"]
                ux = ux + a_dz * hist[f"Fux{i + 1}"]
                uy = uy + a_dz * hist[f"Fuy{i + 1}"]
                psi = psi + a_dz * hist[f"Fpsi{i + 1}"]
            xnew, ynew, ux, uy, w, valid = enforce_particle_bc(
                xnew, ynew, ux, uy, w, valid, geom, cfg.particle_boundary,
                bounds=cfg.particle_bounds)
            x, y = xnew, ynew
            if not temp_slice:
                ux_h, uy_h, psi_h = ux, uy, psi
                xprev, yprev = x, y
            continue

        # full momentum push t-1/2 -> t+1/2 in 4 substeps
        nsub = 4
        sdz = dz / nsub
        ux, uy, psi = ux_h, uy_h, psi_h
        for _s in range(nsub):
            ux, uy, psi = _second_order_substep(ux, uy, psi, sdz, fvals,
                                                clight_inv, q_m_c_p)
        # position push t -> t+1 with momentum at t+1/2
        xnew = xprev + dz * clight_inv * (ux / psi)
        ynew = yprev + dz * clight_inv * (uy / psi)
        xnew, ynew, ux, uy, w, valid = enforce_particle_bc(
            xnew, ynew, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=cfg.particle_bounds)
        x, y = xnew, ynew
        if not temp_slice:
            ux_h, uy_h, psi_h = ux, uy, psi
            xprev, yprev = x, y
        # half momentum push t+1/2 -> t+1 (deposit values only)
        for _s in range(nsub // 2):
            ux, uy, psi = _second_order_substep(ux, uy, psi, sdz, fvals,
                                                clight_inv, q_m_c_p)

    out = dict(p)
    out.update(x=x, y=y, w=w, valid=valid, ux=ux, uy=uy, psi=psi)
    if not temp_slice:
        out.update(x_prev=xprev, y_prev=yprev,
                   ux_half=ux_h, uy_half=uy_h, psi_half=psi_h)
        if pusher == "ab5":
            # shift the force history (ref PlasmaParticleAdvance.cpp:276-305)
            for f in ("Fx", "Fy", "Fux", "Fuy", "Fpsi"):
                for i in range(5, 1, -1):
                    out[f"{f}{i}"] = hist[f"{f}{i - 1}"]
    return out


# ----------------------------------------------------------------------
def deposit_plasma(p: dict, stack_comps: list[str], fields: dict,
                   geom: Geometry, cfg: PlasmaConfig, pc: PhysConst,
                   order: int, normalized_units: bool,
                   use_laser: bool = False, which: str = "This",
                   flip_charge: bool = False, banded=None, lost_out=None,
                   extra_mask=None, geom0: Geometry | None = None):
    """Deposit plasma currents/densities (ref PlasmaDepositCurrent.cpp:22-257).

    stack_comps: subset of ["jx","jy","jz","rho","chi","rhomjz"] to deposit.
    fields: dict name->(NY,NX); modified copies are returned along with the
    per-particle QSA-violation mask applied to the weights.
    banded: None (XLA scatter) or (W, K) for the banded one-hot deposit on
    row-sorted particles.
    extra_mask: additional per-particle deposit gate (MR: deposit on a fine
    level only particles tagged >= that level, ref
    PlasmaDepositCurrent.cpp:130); it does NOT invalidate particles.
    """
    charge = -cfg.charge if flip_charge else cfg.charge
    clight = pc.c
    clight_inv = 1.0 / pc.c
    # normalized units: (lev0 cell area) / (this level's cell area), so a
    # fine level sees the same density (ref PlasmaDepositCurrent.cpp:71-73)
    g0 = geom0 if geom0 is not None else geom
    invvol = (g0.dx * g0.dy / (geom.dx * geom.dy) if normalized_units
              else 1.0 / (geom.dx * geom.dy * geom.dz))

    x, y = p["x"], p["y"]
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv
    vy_c = p["uy"] * psi_inv

    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    laser_norm = ((charge / pc.q_e) * (pc.m_e / cfg.mass)) ** 2
    if cfg.can_ionize:
        ion = p["ion_lev"].astype(x.dtype)
        q_invvol = q_invvol * ion
        q_mu0_m = q_mu0_m * ion
        laser_norm = laser_norm * ion * ion

    if use_laser:
        a2, _, _ = gather_laser_aabs(x, y, fields["aabs"], geom, order)
        a2 = a2 * laser_norm
    else:
        a2 = jnp.zeros_like(x)

    gamma_psi = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv
                       + vx_c * vx_c * clight_inv ** 2
                       + vy_c * vy_c * clight_inv ** 2 + 1.0)

    # QSA violation: zero the weight and invalidate
    # (ref PlasmaDepositCurrent.cpp:197-204)
    bad = ((gamma_psi < 0.0) | (gamma_psi > cfg.max_qsa_weighting_factor)
           | (psi_inv < 0.0))
    wmask = jnp.where(p["valid"] & ~bad, 1.0, 0.0).astype(x.dtype)
    q_invvol = q_invvol * wmask
    if extra_mask is not None:
        q_invvol = q_invvol * extra_mask.astype(x.dtype)

    values = {
        "jx": q_invvol * vx_c,
        "jy": q_invvol * vy_c,
        "jz": q_invvol * (gamma_psi - 1.0) * clight,
        "rho": q_invvol * gamma_psi,
        "chi": q_invvol * q_mu0_m * psi_inv,
        "rhomjz": q_invvol,
    }

    def _val(c):
        # rho_<species name> deposits the same charge density channel
        return values["rho"] if c.startswith("rho_") else values[c]

    stack = jnp.stack([fields[c] for c in stack_comps])
    if banded is not None:
        from ..ops.banded import dispatch_deposit
        G = geom.nguards
        NY, NX = geom.slice_shape
        # guard-offset cell positions; invalid lanes (sorted to the tail)
        # get a finite sentinel so they can't drag the window anchor
        xm = jnp.where(p["valid"],
                       (x - geom.x_pos_offset) / geom.dx + G, 2.0 * NX)
        ym = jnp.where(p["valid"],
                       (y - geom.y_pos_offset) / geom.dy + G, 2.0 * NY)
        stack, _lost = dispatch_deposit(
            stack, ym, xm, [_val(c) for c in stack_comps], banded,
            NY, NX, order)
        if lost_out is not None:
            lost_out.append(_lost)
    else:
        from ..ops.deposit import deposit_multi
        stack = deposit_multi(stack, x, y, [_val(c) for c in stack_comps],
                              geom, order)
    out_fields = dict(fields)
    for i, c in enumerate(stack_comps):
        out_fields[c] = stack[i]

    new_p = dict(p)
    new_p["w"] = p["w"] * wmask
    new_p["valid"] = p["valid"] & ~bad
    return out_fields, new_p


def fused_plasma_deposits(p: dict, stack_comps: list[str], fields: dict,
                          geom: Geometry, cfg: PlasmaConfig, pc: PhysConst,
                          order: int, deriv_type: int, normalized_units: bool,
                          use_laser: bool, banded, lost_out=None):
    """Main currents + explicit Sx/Sy coefficient channels in ONE banded
    deposit (banded fast path for deposit_plasma + explicit_deposition).

    The x weight matrix dominates a banded deposit's cost (its build and
    the device-memory traffic of the one-hot product);
    the type-`deriv_type` derivative shape weights generate the SAME
    matrix as the plain order-p weights (their extra taps are zero), so
    the main deposit, the Sy/Sx s-channels (d1) and the dwy-channels (d3)
    all share one matrix. Only the dwx-channels (d2) need a second one.

    Returns (out_fields, new_p, dgrids) where dgrids = (d1, d2, d3) raw
    channel grids for combine_explicit_sxsy, called after the Psi/Ez solve.
    """
    from ..ops.banded import dispatch_deposit
    charge = cfg.charge
    clight = pc.c
    cin = 1.0 / pc.c
    invvol = 1.0 if normalized_units else 1.0 / (geom.dx * geom.dy * geom.dz)

    x, y = p["x"], p["y"]
    psi_inv = 1.0 / p["psi"]
    vx_c = p["ux"] * psi_inv            # velocity * c
    vy_c = p["uy"] * psi_inv
    vx = vx_c * cin                      # dimensionless
    vy = vy_c * cin

    q_invvol = charge * invvol * p["w"]
    q_mu0_m = charge * pc.mu0 / cfg.mass
    q_m = charge / cfg.mass
    laser_norm = ((charge / pc.q_e) * (pc.m_e / cfg.mass)) ** 2
    if cfg.can_ionize:
        ion = p["ion_lev"].astype(x.dtype)
        q_invvol = q_invvol * ion
        q_mu0_m = q_mu0_m * ion
        q_m = q_m * ion
        laser_norm = laser_norm * ion * ion

    if use_laser:
        a2, _, _ = gather_laser_aabs(x, y, fields["aabs"], geom, order)
        a2 = a2 * laser_norm
    else:
        a2 = jnp.zeros_like(x)

    gamma_psi = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv
                       + vx * vx + vy * vy + 1.0)
    bad = ((gamma_psi < 0.0) | (gamma_psi > cfg.max_qsa_weighting_factor)
           | (psi_inv < 0.0))
    wmask = jnp.where(p["valid"] & ~bad, 1.0, 0.0).astype(x.dtype)
    q_invvol = q_invvol * wmask

    values = {
        "jx": q_invvol * vx_c,
        "jy": q_invvol * vy_c,
        "jz": q_invvol * (gamma_psi - 1.0) * clight,
        "rho": q_invvol * gamma_psi,
        "chi": q_invvol * q_mu0_m * psi_inv,
        "rhomjz": q_invvol,
    }

    def _val(c):
        # rho_<species name> deposits the same charge density channel
        return values["rho"] if c.startswith("rho_") else values[c]

    # explicit Sx/Sy coefficient channels (see explicit_deposition)
    cd_mu0 = charge * invvol * pc.mu0 * p["w"] * wmask
    if cfg.can_ionize:
        cd_mu0 = cd_mu0 * ion
    qm_psi = q_m * psi_inv
    base = cd_mu0 * qm_psi
    chans = [base * vx, base * vy, base * vx * vy * cin,
             base * (gamma_psi - vy * vy) * cin,
             base * (gamma_psi - vx * vx) * cin]
    if use_laser:
        chans.append(0.25 * base * qm_psi)
    C1 = len(chans)
    cdc = cd_mu0 * clight
    dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
    v2 = [cdc * dx_inv * vx * vy,
          cdc * dx_inv * (gamma_psi - vx * vx - 1.0)]
    v3 = [-cdc * dy_inv * (gamma_psi - vy * vy - 1.0),
          -cdc * dy_inv * vx * vy]

    G = geom.nguards
    NY, NX = geom.slice_shape
    # guard-offset cell positions; invalid lanes get a finite sentinel
    xm = jnp.where(p["valid"],
                   (x - geom.x_pos_offset) * dx_inv + G, 2.0 * NX)
    ym = jnp.where(p["valid"],
                   (y - geom.y_pos_offset) * dy_inv + G, 2.0 * NY)

    Cm = len(stack_comps)
    if deriv_type == 2:
        # centered derivative factors are column-shift stencils of the plain
        # one-hot: dWx[:, i] = (Wx[:, i+1] - Wx[:, i-1]) / 2, so the dwx/dwy
        # channels deposit with PLAIN weights and the derivative becomes a
        # grid difference in combine_explicit_sxsy — one matrix for all.
        vall = [_val(c) for c in stack_comps] + chans + v2 + v3
        acc = jnp.concatenate([
            jnp.stack([fields[c] for c in stack_comps]),
            jnp.zeros((C1 + 4, NY, NX), x.dtype)])
        acc, lost = dispatch_deposit(acc, ym, xm, vall, banded, NY, NX,
                                     order, deriv_type=2)
        if lost_out is not None:
            lost_out.append(lost)
        dgrids = (acc[Cm:Cm + C1], acc[Cm + C1:Cm + C1 + 2],
                  acc[Cm + C1 + 2:], True)
    else:
        # one fused kernel pass over the positions: main currents +
        # s-channels (w,w) + dwy channels (dw,w) + dwx channels (w,dw)
        from ..ops.banded import dispatch_deposit_blocks
        vmain = [_val(c) for c in stack_comps] + chans
        acc = jnp.concatenate([
            jnp.stack([fields[c] for c in stack_comps]),
            jnp.zeros((C1 + 4, NY, NX), x.dtype)])
        acc, lost1 = dispatch_deposit_blocks(
            acc, ym, xm, vmain + v3 + v2,
            (("w", "w", Cm + C1), ("dw", "w", 2), ("w", "dw", 2)),
            banded, NY, NX, order, deriv_type)
        if lost_out is not None:
            lost_out.append(lost1)
        dgrids = (acc[Cm:Cm + C1], acc[Cm + C1 + 2:],
                  acc[Cm + C1:Cm + C1 + 2], False)

    out_fields = dict(fields)
    for i, c in enumerate(stack_comps):
        out_fields[c] = acc[i]

    new_p = dict(p)
    new_p["w"] = p["w"] * wmask
    new_p["valid"] = p["valid"] & ~bad
    return out_fields, new_p, dgrids


def combine_explicit_sxsy(fields: dict, dgrids, geom: Geometry,
                          pc: PhysConst, use_laser: bool):
    """Pointwise combine of the fused coefficient grids into Sy/Sx, after
    ExmBy/EypBx/Ez/Bz are solved (the per-cell field factors of
    ExplicitDeposition.cpp:187-258)."""
    d1, d2, d3, need_diff = dgrids
    if need_diff:
        # deriv_type-2 channels were deposited with plain weights; apply the
        # centered difference on the grid: D[i] = (E[i+1] - E[i-1]) / 2
        z = jnp.zeros_like(d2[:, :, :1])
        d2 = 0.5 * (jnp.concatenate([d2[:, :, 1:], z], axis=2)
                    - jnp.concatenate([z, d2[:, :, :-1]], axis=2))
        zr = jnp.zeros_like(d3[:, :1, :])
        d3 = 0.5 * (jnp.concatenate([d3[:, 1:, :], zr], axis=1)
                    - jnp.concatenate([zr, d3[:, :-1, :]], axis=1))
    cin = 1.0 / pc.c
    bz_f, ez_f = fields["Bz"], fields["Ez"]
    exmby_f, eypbx_f = fields["ExmBy"], fields["EypBx"]
    sy = (fields["Sy"] + bz_f * d1[0] - cin * ez_f * d1[1]
          + exmby_f * d1[2] - eypbx_f * d1[3] + d2[0] + d3[0])
    sx = (fields["Sx"] + bz_f * d1[1] + cin * ez_f * d1[0]
          + exmby_f * d1[4] - eypbx_f * d1[2] + d2[1] + d3[1])
    if use_laser:
        aab = fields["aabs"]
        lf = (pc.m_e / pc.q_e) ** 2 * pc.c
        dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
        a2dx_f = (jnp.concatenate([aab[:, 1:], aab[:, -1:]], axis=1)
                  - jnp.concatenate([aab[:, :1], aab[:, :-1]], axis=1)
                  ) * (0.5 * dx_inv * lf)
        a2dy_f = (jnp.concatenate([aab[1:, :], aab[-1:, :]], axis=0)
                  - jnp.concatenate([aab[:1, :], aab[:-1, :]], axis=0)
                  ) * (0.5 * dy_inv * lf)
        sy = sy + a2dy_f * d1[5]
        sx = sx - a2dx_f * d1[5]
    out = dict(fields)
    out["Sy"] = sy
    out["Sx"] = sx
    return out


def explicit_deposition(p: dict, fields: dict, geom: Geometry,
                        cfg: PlasmaConfig, pc: PhysConst, order: int,
                        deriv_type: int, normalized_units: bool,
                        use_laser: bool = False, banded=None, lost_out=None,
                        extra_mask=None, geom0: Geometry | None = None):
    """Deposit Sx, Sy source terms for the explicit Bx/By solve
    (WAND-PIC algorithm; ref ExplicitDeposition.cpp:20-263).

    Gathers Ez, Bz, ExmBy, EypBx *per stencil cell* (not interpolated to the
    particle) while scattering, using fused derivative shape factors.

    banded: None (XLA scatter) or (W, K). The banded path factorizes the
    per-cell field dependence: Sy(cell) = sum_F F(cell) * D_s[coef_F] +
    D_sdx[..] + D_sdy[..], where D are standard separable deposits of
    per-particle coefficient channels — each a one-hot matmul.
    """
    clight = pc.c
    clight_inv = 1.0 / pc.c
    g0 = geom0 if geom0 is not None else geom
    invvol = (g0.dx * g0.dy / (geom.dx * geom.dy) if normalized_units
              else 1.0 / (geom.dx * geom.dy * geom.dz))
    laser_fac = (pc.m_e / pc.q_e) ** 2

    x, y = p["x"], p["y"]
    psi_inv = 1.0 / p["psi"]
    vx = p["ux"] * psi_inv * clight_inv
    vy = p["uy"] * psi_inv * clight_inv

    q_invvol_mu0 = cfg.charge * invvol * pc.mu0
    q_m = cfg.charge / cfg.mass
    if cfg.can_ionize:
        ion = p["ion_lev"].astype(x.dtype)
        q_invvol_mu0 = q_invvol_mu0 * ion
        q_m = q_m * ion
    wmask = jnp.where(p["valid"], p["w"], 0.0)
    if extra_mask is not None:
        wmask = jnp.where(extra_mask, wmask, 0.0)
    cd_mu0 = q_invvol_mu0 * wmask  # charge_density_mu0

    if use_laser:
        a2, _, _ = gather_laser_aabs(x, y, fields["aabs"], geom, order)
        a2 = a2 * laser_fac * q_m * q_m
    else:
        a2 = jnp.zeros_like(x)
    gamma_psi = 0.5 * ((1.0 + 0.5 * a2) * psi_inv * psi_inv
                       + vx * vx + vy * vy + 1.0)

    G = geom.nguards
    NY, NX = geom.slice_shape
    dx_inv, dy_inv = 1.0 / geom.dx, 1.0 / geom.dy
    xm = (x - geom.x_pos_offset) * dx_inv
    ym = (y - geom.y_pos_offset) * dy_inv
    ix0, wx, dwx = shape_weights_derivative(xm, order, deriv_type)
    iy0, wy, dwy = shape_weights_derivative(ym, order, deriv_type)
    m = order + deriv_type + 1

    if banded is not None:
        # guard-offset cell positions with a finite sentinel for invalid
        # lanes; the kernels compute the shape factors in-body
        xmb = jnp.where(p["valid"], xm + G, 2.0 * NX)
        ymb = jnp.where(p["valid"], ym + G, 2.0 * NY)
        qm_psi = q_m * psi_inv
        cin = clight_inv
        base = cd_mu0 * qm_psi
        # unique coefficient channels (the 8 Sy/Sx x {Bz,Ez,ExmBy,EypBx}
        # coefficients share 5 distinct particle factors up to constant
        # signs/cin, pulled out of the linear deposit)
        chans = [
            base * vx,                          # u1
            base * vy,                          # u2
            base * vx * vy * cin,               # u3
            base * (gamma_psi - vy * vy) * cin,  # u4
            base * (gamma_psi - vx * vx) * cin,  # u5
        ]
        if use_laser:
            chans.append(0.25 * base * qm_psi)   # u6
        C1 = len(chans)
        # derivative-weighted channels deposit straight into Sy/Sx;
        # one fused kernel pass over the positions (see
        # fused_plasma_deposits)
        from ..ops.banded import dispatch_deposit_blocks
        cdc = cd_mu0 * clight
        v2 = [cdc * dx_inv * vx * vy,
              cdc * dx_inv * (gamma_psi - vx * vx - 1.0)]
        v3 = [-cdc * dy_inv * (gamma_psi - vy * vy - 1.0),
              -cdc * dy_inv * vx * vy]
        dall = jnp.zeros((C1 + 4, NY, NX), x.dtype)
        dall, _lost1 = dispatch_deposit_blocks(
            dall, ymb, xmb, chans + v3 + v2,
            (("w", "w", C1), ("dw", "w", 2), ("w", "dw", 2)),
            banded, NY, NX, order, deriv_type)
        if lost_out is not None:
            lost_out.append(_lost1)
        d1 = dall[:C1]
        d3 = dall[C1:C1 + 2]
        d2 = dall[C1 + 2:]
        bz_f, ez_f = fields["Bz"], fields["Ez"]
        exmby_f, eypbx_f = fields["ExmBy"], fields["EypBx"]
        cinc = jnp.asarray(cin, x.dtype)
        sy = (fields["Sy"] + bz_f * d1[0] - cinc * ez_f * d1[1]
              + exmby_f * d1[2] - eypbx_f * d1[3] + d2[0] + d3[0])
        sx = (fields["Sx"] + bz_f * d1[1] + cinc * ez_f * d1[0]
              + exmby_f * d1[4] - eypbx_f * d1[2] + d2[1] + d3[1])
        if use_laser:
            aab = fields["aabs"]
            lf = laser_fac * clight
            # clamped-edge centered differences (matches the scatter path's
            # jnp.clip of the shifted stencil indices)
            a2dx_f = (jnp.concatenate([aab[:, 1:], aab[:, -1:]], axis=1)
                      - jnp.concatenate([aab[:, :1], aab[:, :-1]], axis=1)
                      ) * (0.5 * dx_inv * lf)
            a2dy_f = (jnp.concatenate([aab[1:, :], aab[-1:, :]], axis=0)
                      - jnp.concatenate([aab[:1, :], aab[:-1, :]], axis=0)
                      ) * (0.5 * dy_inv * lf)
            sy = sy + a2dy_f * d1[5]
            sx = sx - a2dx_f * d1[5]
        out = dict(fields)
        out["Sy"] = sy
        out["Sx"] = sx
        return out
    ii = jnp.clip(ix0[:, None] + jnp.arange(m, dtype=jnp.int32) + G, 0, NX - 1)
    jj = jnp.clip(iy0[:, None] + jnp.arange(m, dtype=jnp.int32) + G, 0, NY - 1)
    jj2 = jj[:, :, None]
    ii2 = ii[:, None, :]

    # per-cell field values (N, m, m)
    bz_v = fields["Bz"][jj2, ii2]
    ez_v = fields["Ez"][jj2, ii2]
    exmby_v = fields["ExmBy"][jj2, ii2]
    eypbx_v = fields["EypBx"][jj2, ii2]

    s = wy[:, :, None] * wx[:, None, :]
    s_dx = wy[:, :, None] * dwx[:, None, :]
    s_dy = dwy[:, :, None] * wx[:, None, :]

    def b(a):
        return a[:, None, None]

    if use_laser:
        aab = fields["aabs"]
        ap1 = aab[jj2, jnp.clip(ii2 + 1, 0, NX - 1)]
        am1 = aab[jj2, jnp.clip(ii2 - 1, 0, NX - 1)]
        bp1 = aab[jnp.clip(jj2 + 1, 0, NY - 1), ii2]
        bm1 = aab[jnp.clip(jj2 - 1, 0, NY - 1), ii2]
        lf = laser_fac * clight
        a2dx = jnp.where(s != 0.0, (ap1 - am1) * (0.5 * dx_inv * lf), 0.0)
        a2dy = jnp.where(s != 0.0, (bp1 - bm1) * (0.5 * dy_inv * lf), 0.0)
    else:
        a2dx = a2dy = jnp.zeros_like(s)

    qm_psi = b(q_m * psi_inv)
    # Sy deposit (ref ExplicitDeposition.cpp:228-242)
    val_sy = b(cd_mu0) * (
        - s * (
            - bz_v * b(vx)
            + (ez_v * b(vy)
               + exmby_v * b(-vx * vy)
               + eypbx_v * (b(gamma_psi) - b(vy * vy))) * clight_inv
            - 0.25 * a2dy * qm_psi
        ) * qm_psi
        + (- s_dx * dx_inv * b(-vx * vy)
           - s_dy * dy_inv * (b(gamma_psi) - b(vy * vy) - 1.0)) * clight
    )
    # Sx deposit (ref ExplicitDeposition.cpp:244-258)
    val_sx = b(cd_mu0) * (
        + s * (
            + bz_v * b(vy)
            + (ez_v * b(vx)
               + exmby_v * (b(gamma_psi) - b(vx * vx))
               + eypbx_v * b(-vx * vy)) * clight_inv
            - 0.25 * a2dx * qm_psi
        ) * qm_psi
        + (+ s_dx * dx_inv * (b(gamma_psi) - b(vx * vx) - 1.0)
           + s_dy * dy_inv * b(-vx * vy)) * clight
    )

    lin = (jnp.broadcast_to(jj2, val_sy.shape) * NX
           + jnp.broadcast_to(ii2, val_sy.shape)).reshape(-1)
    sy = fields["Sy"].reshape(-1).at[lin].add(val_sy.reshape(-1)).reshape(NY, NX)
    sx = fields["Sx"].reshape(-1).at[lin].add(val_sx.reshape(-1)).reshape(NY, NX)
    out = dict(fields)
    out["Sy"] = sy
    out["Sx"] = sx
    return out
