"""The per-slice solve and the zeta-sweep scan — the hot loop.

A JAX re-design of Hipace::SolveOneSlice (ref: src/
Hipace.cpp:557-728) and the Evolve slice loop (Hipace.cpp:478-480): the
head-to-tail sweep becomes a lax.scan carrying the O(1) slice field state,
the plasma particle arrays, and a fixed-capacity slipped-beam buffer; beam
slices stream through scan xs/ys. Both Bx/By solvers are provided:

- explicit (default): WAND-PIC style Sx/Sy deposition + multigrid
  (ref Hipace.cpp:649-667, 745-933)
- predictor-corrector: lax.while_loop fixed-point with B-field mixing
  (ref Hipace.cpp:936-1031, Fields.cpp:1149-1286)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..constants import PhysConst
from ..geometry import Geometry
from ..fields.poisson import DirichletPoissonSolver
from ..fields.multigrid import MultiGrid
from ..fields import slices as sl
from ..particles import plasma as pl
from ..particles import beam as bm


@dataclasses.dataclass(frozen=True)
class DiagConfig:
    """One named field diagnostic (ref diagnostics/Diagnostic.{H,cpp};
    parameter surface docs/source/run/parameters.rst:932-1110).

    Crops/coarsening are static cell-index ranges in the base geometry;
    processing happens device-side per slice so full-resolution 3D stacks
    never materialize unless asked for.
    """
    name: str = "lev0"
    base: str = "level_0"          # "level_0" | "laser"
    diag_type: str = "xyz"         # xyz | xz | yz | xy_integrated
    comps: tuple = ()
    coarsening: tuple = (1, 1, 1)  # (cx, cy, cz)
    include_ghosts: bool = False
    # inclusive cell index ranges (x_lo, x_hi), (y_lo, y_hi), (z_lo, z_hi)
    patch_x: tuple = (0, -1)
    patch_y: tuple = (0, -1)
    patch_z: tuple = (0, -1)
    period: int = -1


def _coarsen_axis(a, axis, r):
    """First-order-interpolated coarsening by integer ratio r
    (ref Fields::Copy coarsening, Fields.cpp:413-533)."""
    if r == 1:
        return a
    n = a.shape[axis]
    nout = n // r
    a = jax.lax.slice_in_dim(a, 0, nout * r, axis=axis)
    if r % 2 == 1:
        return jax.lax.slice_in_dim(a, r // 2, nout * r, stride=r, axis=axis)
    lo = jax.lax.slice_in_dim(a, r // 2 - 1, nout * r, stride=r, axis=axis)
    hi = jax.lax.slice_in_dim(a, r // 2, nout * r, stride=r, axis=axis)
    return 0.5 * (lo + hi)


def _process_diag_slice(arrs, dg: DiagConfig, geom: Geometry):
    """Apply ghost/patch/coarsening/slicing to a list of padded (NY, NX)
    slice arrays; returns the stacked per-slice diagnostic payload."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    out = []
    for a in arrs:
        if dg.diag_type == "xz":
            ny = geom.ny
            mid = G + ny // 2
            row = (0.5 * (a[mid - 1, :] + a[mid, :]) if ny % 2 == 0
                   else a[mid, :])
            if not dg.include_ghosts:
                row = row[G:NX - G][dg.patch_x[0]:dg.patch_x[1] + 1]
            out.append(_coarsen_axis(row, 0, dg.coarsening[0]))
            continue
        if dg.diag_type == "yz":
            nx = geom.nx
            mid = G + nx // 2
            col = (0.5 * (a[:, mid - 1] + a[:, mid]) if nx % 2 == 0
                   else a[:, mid])
            if not dg.include_ghosts:
                col = col[G:NY - G][dg.patch_y[0]:dg.patch_y[1] + 1]
            out.append(_coarsen_axis(col, 0, dg.coarsening[1]))
            continue
        # xyz / xy_integrated (patch crop only without ghosts)
        if not dg.include_ghosts:
            a = a[G:NY - G, G:NX - G]
            a = a[dg.patch_y[0]:dg.patch_y[1] + 1,
                  dg.patch_x[0]:dg.patch_x[1] + 1]
        a = _coarsen_axis(a, 0, dg.coarsening[1])
        a = _coarsen_axis(a, 1, dg.coarsening[0])
        out.append(a)
    return jnp.stack(out)


def _diag_is_identity(dg: DiagConfig, cfg) -> bool:
    """True when the diag equals the legacy full-interior xyz stack (no
    device-side processing needed; host extracts its comps from ys['diag'])."""
    g = cfg.geom
    return (dg.base == "level_0" and dg.diag_type == "xyz"
            and dg.coarsening[:2] == (1, 1) and not dg.include_ghosts
            and dg.patch_x == (0, g.nx - 1) and dg.patch_y == (0, g.ny - 1)
            and all(c in cfg.diag_comps for c in dg.comps))


def diag_slice_shape(dg: DiagConfig, geom: Geometry):
    """Static per-slice payload shape for a processed diagnostic."""
    G = geom.nguards
    if dg.diag_type == "xz":
        n = (geom.slice_shape[1] if dg.include_ghosts
             else dg.patch_x[1] - dg.patch_x[0] + 1)
        return (len(dg.comps), n // dg.coarsening[0])
    if dg.diag_type == "yz":
        n = (geom.slice_shape[0] if dg.include_ghosts
             else dg.patch_y[1] - dg.patch_y[0] + 1)
        return (len(dg.comps), n // dg.coarsening[1])
    if dg.include_ghosts:
        ny, nx = geom.slice_shape
    else:
        ny = dg.patch_y[1] - dg.patch_y[0] + 1
        nx = dg.patch_x[1] - dg.patch_x[0] + 1
    return (len(dg.comps), ny // dg.coarsening[1], nx // dg.coarsening[0])


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration closed over by the jitted step."""
    geom: Geometry
    pc: PhysConst
    normalized_units: bool = True
    explicit: bool = True
    depos_order_xy: int = 2
    depos_derivative_type: int = 2
    do_beam_jx_jy_deposition: bool = True
    # include the beam's rho - jz/c in the Psi source (for beams that are
    # not ultra-relativistic; ref Hipace.cpp:853-857, parameters.rst:151)
    do_beam_jz_minus_rho: bool = False
    deposit_rho: bool = False
    do_symmetrize: bool = False
    use_laser: bool = False
    # predictor-corrector knobs (ref Hipace.H:210-222)
    predcorr_B_error_tolerance: float = 4e-2
    predcorr_max_iterations: int = 30
    predcorr_B_mixing_factor: float = 0.05
    # multigrid knobs (ref Hipace.H:246-248)
    MG_tolerance_rel: float = 1e-4
    MG_tolerance_abs: float = 0.0
    # fields.poisson_solver: FFTDirichletDirect | FFTDirichletExpanded |
    # FFTDirichletFast | MGDirichlet | FFTPeriodic (ref parameters.rst:306)
    poisson_solver: str = "FFTDirichletFast"
    plasmas: tuple = ()
    beams: tuple = ()
    slip_cap: int = 64
    # legacy full-interior stack: union of all identity level_0 diag comps
    diag_comps: tuple = ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi")
    # named field diagnostics (ref diagnostic.names)
    diags: tuple = ()
    deposit_rho_individual: bool = False
    insitu_laser_period: int = 0
    background_density_SI: float = 0.0
    # analytic grid current (ref utils/GridCurrent.{H,cpp}):
    # (peak_current_density, mean xyz, std xyz) or None
    grid_current: tuple | None = None
    laser: object = None  # LaserConfig when use_laser
    # the laser's own grid (ref lasers.n_cell/patch_lo/patch_hi,
    # MultiLaser.cpp:59-110); None = the field grid. laser_zeta is the
    # (zeta_lo, zeta_hi) global slice range where the laser lives.
    laser_geom: object = None
    laser_zeta: tuple | None = None
    # (parent_idx, product_idx, spawn_base, product_init_ion_lev)
    ionization_pairs: tuple = ()
    # per-species extra (invalid) lanes: ionization product slots +
    # banded chunk padding; consumed by every plasma init path
    plasma_pad: tuple = ()
    # in-situ diagnostics periods (0 = off) and radii
    insitu_beam_period: int = 0
    insitu_field_period: int = 0
    insitu_plasma_period: int = 0
    insitu_radius: float = float("inf")
    # SALAME (ref Hipace.H:285-301, salame/Salame.cpp)
    salame_n_iter: int = 3
    salame_do_advance: bool = True
    salame_tolerance: float = 1e-4
    salame_target_expr: str = "Ez_initial"
    salame_consts: tuple = ()
    # Coulomb collisions: ("pp"|"bp", idx1, idx2, is_same_species, CoulombLog)
    collisions: tuple = ()
    # free-space transverse boundaries via multipole expansion
    # (ref OpenBoundary.H; boundary.field = Open)
    open_boundary: bool = False
    # banded one-hot particle kernels (ops/banded.py) in place of the
    # scatter/gather kernels: particles are row-sorted once per slice with
    # lax.sort and deposits/gathers run as dense one-hot matmuls over
    # W-row windows of K-particle chunks. banded_WX > 0 enables 2D
    # (W, WX) windows with the stripe-snake sort.
    use_banded: bool = False
    banded_W: int = 32
    banded_K: int = 8192
    banded_gather_K: int = 8192
    banded_WX: int = 0
    # re-sort every N slices (drift between sorts consumes banded_W slack;
    # the lost counters catch a too-small W / too-large period)
    banded_sort_period: int = 1
    # beam lanes processed per while_loop chunk: per-slice cost scales with
    # occupancy instead of the peak-sized capacity (~6x waste for a
    # gaussian beam). 0 = whole-capacity processing.
    beam_chunk: int = 0
    # occupancy buckets for beam ops: the per-slice beam arrays are sized
    # to the PEAK slice (gaussian beams: ~15% mean occupancy), so every
    # beam op is wrapped in a lax.switch over a halving ladder of static
    # lane prefixes (beam.py prefix_ladder/prefix_apply) selected by the
    # slice's live count — work scales with ceil-to-bucket occupancy
    # (< 2x waste) instead of capacity (~6x). Unlike hipace.beam_chunk
    # this is a single device-side conditional per op, so it is ON by
    # default. 1 = off.
    beam_buckets: int = 4
    # transverse mesh refinement levels (fields/mr.py MRLevel tuple,
    # ref Hipace.cpp:327-374; amr.max_level + mr_lev<N>.* parameters)
    mr_levels: tuple = ()
    # plasma pusher: "leapfrog" (dual-number 2nd order, the reference
    # default) or "ab5" (the reference's HIPACE_USE_AB5_PUSH compile
    # option, exposed at runtime as hipace.plasma_pusher)
    plasma_pusher: str = "leapfrog"

    @property
    def salame_active(self) -> bool:
        return any(b.do_salame for b in self.beams)


THIS_COMPS_EXPLICIT = ("chi", "Sy", "Sx", "ExmBy", "EypBx", "Ez", "Bx", "By",
                       "Bz", "Psi", "jx_beam", "jy_beam", "jz_beam", "jx",
                       "jy", "rhomjz")
THIS_COMPS_PC = ("ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi",
                 "jx", "jy", "jz", "rhomjz")


def init_field_state(cfg: SimConfig, dtype) -> dict:
    """Allocate the zeroed slice field sets (ref Fields::AllocData,
    Fields.cpp:49-220)."""
    g = cfg.geom
    rho_ind = (tuple(f"rho_{p.name}" for p in cfg.plasmas)
               if cfg.deposit_rho_individual else ())
    if cfg.explicit:
        this_comps = THIS_COMPS_EXPLICIT + (("rho",) if cfg.deposit_rho
                                            else ()) + rho_ind
        if cfg.do_beam_jz_minus_rho:
            this_comps = this_comps + ("rhomjz_beam",)
        if cfg.use_laser:
            this_comps = this_comps + ("aabs",)
        out = {
            "This": sl.make_field_set(this_comps, g, dtype),
            "Next": sl.make_field_set(("jx_beam", "jy_beam"), g, dtype),
            "Previous": sl.make_field_set(("jx_beam", "jy_beam"), g, dtype),
            "RhomJzIons": sl.make_field_set(("rhomjz",), g, dtype),
        }
        # per-fine-level slice sets (ref Fields::AllocData per level)
        for i, lv in enumerate(cfg.mr_levels):
            out[f"mr{i + 1}"] = {
                "This": sl.make_field_set(this_comps, lv.geom, dtype),
                "Next": sl.make_field_set(("jx_beam", "jy_beam"), lv.geom,
                                          dtype),
                "Previous": sl.make_field_set(("jx_beam", "jy_beam"),
                                              lv.geom, dtype),
                "RhomJzIons": sl.make_field_set(("rhomjz",), lv.geom, dtype),
            }
        return out
    this_comps = THIS_COMPS_PC + (("rho",) if cfg.deposit_rho
                                  else ()) + rho_ind
    if cfg.use_laser:
        this_comps = this_comps + ("chi", "aabs")
    out = {
        "This": sl.make_field_set(this_comps, g, dtype),
        "Next": sl.make_field_set(("jx", "jy"), g, dtype),
        "Previous": sl.make_field_set(("Bx", "By", "jx", "jy"), g, dtype),
        "PCIter": sl.make_field_set(("Bx", "By"), g, dtype),
        "PCPrevIter": sl.make_field_set(("Bx", "By"), g, dtype),
        "RhomJzIons": sl.make_field_set(("rhomjz",), g, dtype),
    }
    for i, lv in enumerate(cfg.mr_levels):
        out[f"mr{i + 1}"] = {
            "This": sl.make_field_set(this_comps, lv.geom, dtype),
            "Next": sl.make_field_set(("jx", "jy"), lv.geom, dtype),
            "Previous": sl.make_field_set(("Bx", "By", "jx", "jy"),
                                          lv.geom, dtype),
            "PCIter": sl.make_field_set(("Bx", "By"), lv.geom, dtype),
            "PCPrevIter": sl.make_field_set(("Bx", "By"), lv.geom, dtype),
            "RhomJzIons": sl.make_field_set(("rhomjz",), lv.geom, dtype),
        }
    return out


# ----------------------------------------------------------------------
def _solve_psi_ez_bz(f_this, cfg: SimConfig, solver, ob=None):
    """SolvePoissonPsiExmByEypBxEzBz (ref Fields.cpp:840-957): all three
    Poisson equations in one batched DST solve, then ExmBy = -dx Psi,
    EypBx = -dy Psi."""
    g = cfg.geom
    pc = cfg.pc
    if cfg.do_symmetrize:
        f_this = dict(f_this)
        f_this["rhomjz"] = sl.symmetrize(f_this["rhomjz"], g, 1, 1)
        f_this["jx"] = sl.symmetrize(f_this["jx"], g, -1, 1)
        f_this["jy"] = sl.symmetrize(f_this["jy"], g, 1, -1)

    rhomjz_src = f_this["rhomjz"]
    if cfg.explicit and cfg.do_beam_jz_minus_rho:
        rhomjz_src = rhomjz_src + f_this["rhomjz_beam"]
    rhs_psi = -1.0 / pc.ep0 * sl.interior(rhomjz_src, g)
    rhs_ez = (sl.ddx_interior(f_this["jx"], g)
              + sl.ddy_interior(f_this["jy"], g)) / (pc.ep0 * pc.c)
    rhs_bz = pc.mu0 * (sl.ddy_interior(f_this["jx"], g)
                       - sl.ddx_interior(f_this["jy"], g))
    if ob is not None:
        rhs_psi = ob.apply(rhs_psi, monopole=True)
        # Ez/Bz sources are pure derivatives: no physical monopole
        # (ref Fields.cpp:735-739)
        rhs_ez = ob.apply(rhs_ez, monopole=False)
        rhs_bz = ob.apply(rhs_bz, monopole=False)
    sol = solver.solve(jnp.stack([rhs_psi, rhs_ez, rhs_bz]))

    out = dict(f_this)
    out["Psi"] = sl.set_interior(f_this["Psi"], sol[0], g)
    out["Ez"] = sl.set_interior(f_this["Ez"], sol[1], g)
    out["Bz"] = sl.set_interior(f_this["Bz"], sol[2], g)
    exmby, eypbx = sl.grad_neg_full(out["Psi"], g)
    out["ExmBy"] = exmby
    out["EypBx"] = eypbx
    return out


def _init_sx_sy_with_beam(f, cfg: SimConfig, g: Geometry | None = None):
    """Beam contribution to Sx/Sy via finite differences
    (ref Hipace.cpp:745-790)."""
    g = g if g is not None else cfg.geom
    mu0 = cfg.pc.mu0
    dz2_inv = 1.0 / (2.0 * g.dz)
    dx_jzb = sl.ddx_interior(f["This"]["jz_beam"], g)
    dy_jzb = sl.ddy_interior(f["This"]["jz_beam"], g)
    dz_jxb = (sl.interior(f["Previous"]["jx_beam"], g)
              - sl.interior(f["Next"]["jx_beam"], g)) * dz2_inv
    dz_jyb = (sl.interior(f["Previous"]["jy_beam"], g)
              - sl.interior(f["Next"]["jy_beam"], g)) * dz2_inv
    sy = mu0 * (-dy_jzb + dz_jyb)
    sx = -mu0 * (-dx_jzb + dz_jxb)
    this = dict(f["This"])
    this["Sy"] = sl.set_interior(this["Sy"], sy, g)
    this["Sx"] = sl.set_interior(this["Sx"], sx, g)
    return dict(f, This=this)


def _explicit_bxby_solve(f_this, cfg: SimConfig, mg: MultiGrid):
    """ExplicitMGSolveBxBy (ref Hipace.cpp:793-933): solve
    Laplacian(B) - chi*B = (Sy, Sx) with the previous-slice B as guess.
    Returns (f_this with the new Bx/By, V-cycles taken)."""
    g = cfg.geom
    chi_i = sl.interior(f_this["chi"], g)
    sy_i = sl.interior(f_this["Sy"], g)
    sx_i = sl.interior(f_this["Sx"], g)
    if cfg.do_symmetrize:
        chi_i = sl.symmetrize(chi_i, g, 1, 1)
        sx_i = sl.symmetrize(sx_i, g, -1, 1)
        sy_i = sl.symmetrize(sy_i, g, 1, -1)
    b0 = jnp.stack([sl.interior(f_this["Bx"], g),
                    sl.interior(f_this["By"], g)])
    rhs = jnp.stack([sy_i, sx_i])
    b, n_iter = mg.solve_info(b0, rhs, chi_i, tol_rel=cfg.MG_tolerance_rel,
                              tol_abs=cfg.MG_tolerance_abs, max_iters=40)
    out = dict(f_this)
    out["Bx"] = sl.set_interior(f_this["Bx"], b[0], g)
    out["By"] = sl.set_interior(f_this["By"], b[1], g)
    return out, n_iter


def _rel_b_field_error(bx, by, bx_it, by_it, geom):
    """ComputeRelBFieldError (ref Fields.cpp:1228-1286): sum-norm of
    sqrt(Bx^2+By^2) over the interior."""
    b = jnp.sum(jnp.sqrt(sl.interior(bx, geom) ** 2
                         + sl.interior(by, geom) ** 2))
    bd = jnp.sum(jnp.sqrt(sl.interior(bx - bx_it, geom) ** 2
                          + sl.interior(by - by_it, geom) ** 2))
    return jnp.where(b > 0.0, bd / b, 0.0)


def _pc_bxby_solve(f, plasmas, beam_next, cfg: SimConfig, solver, ob=None,
                   mrctx=None, beam_n_active=None, beam_prefix=None):
    """PredictorCorrectorLoopToSolveBxBy (ref Hipace.cpp:936-1031).

    mrctx (mesh refinement): (mr, couplers, fine_solvers, fine_f, actives,
    plasma_tags) — the fine levels iterate inside the same while_loop with
    Dirichlet BCs interpolated from the coarse PCIter solution of the same
    iteration (ref Fields.cpp:1008-1078 lev>0 path); the error norm sums
    over levels (ref Fields.cpp:1228-1286). Updated fine_f entries are
    written back in place.
    """
    g = cfg.geom
    pc = cfg.pc
    order = cfg.depos_order_xy
    tol = cfg.predcorr_B_error_tolerance
    mix = cfg.predcorr_B_mixing_factor

    this = f["This"]
    prev = f["Previous"]
    ppi = f["PCPrevIter"]
    if mrctx is not None:
        from ..fields.mr import in_level_bounds
        mr, couplers, fine_solvers, fine_f, actives, plasma_tags = mrctx
    else:
        mr = ()

    def _norm_pair(bx, by, bx_it, by_it, geom):
        b = jnp.sum(jnp.sqrt(sl.interior(bx, geom) ** 2
                             + sl.interior(by, geom) ** 2))
        bd = jnp.sum(jnp.sqrt(sl.interior(bx - bx_it, geom) ** 2
                              + sl.interior(by - by_it, geom) ** 2))
        return b, bd

    def multi_err(coarse_pair, fine_pairs):
        b, bd = _norm_pair(*coarse_pair, g)
        for i, pair in enumerate(fine_pairs):
            fb, fbd = _norm_pair(*pair, mr[i].geom)
            act = actives[i].astype(fb.dtype)
            b = b + act * fb
            bd = bd + act * fbd
        return jnp.where(b > 0.0, bd / b, 0.0)

    # initial guess (ref Fields.cpp:1149-1171), same mixing factor for all
    # levels (the reference computes one error over all levels)
    err0 = multi_err(
        (prev["Bx"], prev["By"], ppi["Bx"], ppi["By"]),
        [(fine_f[i]["Previous"]["Bx"], fine_f[i]["Previous"]["By"],
          fine_f[i]["PCPrevIter"]["Bx"], fine_f[i]["PCPrevIter"]["By"])
         for i in range(len(mr))])
    mixf = jnp.exp(-0.5 * (err0 / (2.5 * tol)) ** 2)

    def guess(prev_d, ppi_d):
        bx = (1.0 + mixf) * prev_d["Bx"] - mixf * ppi_d["Bx"]
        by = (1.0 + mixf) * prev_d["By"] - mixf * ppi_d["By"]
        return bx, by, bx, by, jnp.zeros_like(bx), jnp.zeros_like(by)

    bx, by, ppx, ppy, pcx, pcy = guess(prev, ppi)
    fstate0 = tuple(guess(fine_f[i]["Previous"], fine_f[i]["PCPrevIter"])
                    for i in range(len(mr)))

    jz = this["jz"]
    G = g.nguards
    if mr:
        # This jz is constant over the iteration: band-correct it once
        # (ref Fields.cpp:1029-1031)
        for i in range(len(mr)):
            fth = dict(fine_f[i]["This"])
            parent_jz = jz if i == 0 else fine_f[i - 1]["This"]["jz"]
            fth["jz"] = couplers[i].up_boundary(fth["jz"], parent_jz,
                                                1, -G + 1)
            fine_f[i]["This"] = fth
    rhs_bx_static = -pc.mu0 * sl.ddy_interior(jz, g)
    rhs_by_static = pc.mu0 * sl.ddx_interior(jz, g)
    dz2_inv = 1.0 / (2.0 * g.dz)
    prev_jx_i = sl.interior(prev["jx"], g)
    prev_jy_i = sl.interior(prev["jy"], g)

    def body(state):
        (bx, by, pcx, pcy, ppx, ppy), fstates, err, err_prev, it = state
        fields_it = dict(this, Bx=bx, By=by)
        fine_fields_it = tuple(
            (dict(fine_f[i]["This"], Bx=fstates[i][0], By=fstates[i][1]),
             mr[i].geom)
            for i in range(len(mr)))
        # temp plasma push + jx/jy deposit on the temp Next slice
        nxt_jx = jnp.zeros_like(jz)
        nxt_jy = jnp.zeros_like(jz)
        nxt = {"jx": nxt_jx, "jy": nxt_jy}
        fnxt = [{"jx": jnp.zeros(mr[i].geom.slice_shape, jz.dtype),
                 "jy": jnp.zeros(mr[i].geom.slice_shape, jz.dtype)}
                for i in range(len(mr))]
        banded = _banded_opts(cfg)
        banded_g = _banded_opts(cfg, gather=True)
        for ip, (p, pcfg) in enumerate(zip(plasmas, cfg.plasmas)):
            if mr:
                p_tmp = pl.advance_plasma(
                    p, fields_it, g, pcfg, pc, temp_slice=True, order=order,
                    use_laser=cfg.use_laser, fine_levels=fine_fields_it,
                    tag=plasma_tags[ip], pusher=cfg.plasma_pusher)
            else:
                p_tmp = pl.advance_plasma(
                    p, fields_it, g, pcfg, pc, temp_slice=True, order=order,
                    use_laser=cfg.use_laser, banded=banded_g,
                    pusher=cfg.plasma_pusher)
            nxt, _ = pl.deposit_plasma(p_tmp, ["jx", "jy"], nxt, g, pcfg, pc,
                                       order, cfg.normalized_units,
                                       use_laser=False, banded=banded)
            for i in range(len(mr)):
                fnxt[i], _ = pl.deposit_plasma(
                    p_tmp, ["jx", "jy"], fnxt[i], mr[i].geom, pcfg, pc,
                    order, cfg.normalized_units, use_laser=False,
                    extra_mask=(plasma_tags[ip] >= i + 1), geom0=g)
        if cfg.do_beam_jx_jy_deposition and cfg.beams:
            for bcfg in cfg.beams:
                nxt = bm.deposit_beam_slice(beam_next, {"jx": "jx", "jy": "jy"},
                                            nxt, g, bcfg, pc, order,
                                            cfg.normalized_units,
                                            chunk=cfg.beam_chunk,
                                            n_active=beam_n_active,
                                            prefix=beam_prefix)
            for i in range(len(mr)):
                bmask = in_level_bounds(beam_next["x"], beam_next["y"],
                                        mr[i].geom) & actives[i]
                fnxt[i] = bm.deposit_beam_slice(
                    beam_next, {"jx": "jx", "jy": "jy"}, fnxt[i],
                    mr[i].geom, cfg.beams, pc, order, cfg.normalized_units,
                    extra_mask=bmask, geom0=g,
                    chunk=cfg.beam_chunk, n_active=beam_n_active,
                    prefix=beam_prefix)
        # SolvePoissonBxBy (ref Fields.cpp:1008-1078)
        rhs_bx = rhs_bx_static + pc.mu0 * dz2_inv * (
            prev_jy_i - sl.interior(nxt["jy"], g))
        rhs_by = rhs_by_static - pc.mu0 * dz2_inv * (
            prev_jx_i - sl.interior(nxt["jx"], g))
        if ob is not None:
            rhs_bx = ob.apply(rhs_bx, monopole=True)
            rhs_by = ob.apply(rhs_by, monopole=True)
        sol = solver.solve(jnp.stack([rhs_bx, rhs_by]))
        pcx = sl.set_interior(pcx, sol[0], g)
        pcy = sl.set_interior(pcy, sol[1], g)

        new_fstates = []
        parent_pc = (pcx, pcy)
        for i in range(len(mr)):
            coup = couplers[i]
            fg = mr[i].geom
            fl = fine_f[i]
            fbx, fby, fpcx, fpcy, fppx, fppy = fstates[i]
            # edge compensation of the temp Next currents
            fjx = coup.up_boundary(fnxt[i]["jx"], nxt["jx"] if i == 0
                                   else fnxt[i - 1]["jx"], 0, -G)
            fjy = coup.up_boundary(fnxt[i]["jy"], nxt["jy"] if i == 0
                                   else fnxt[i - 1]["jy"], 0, -G)
            fjz = fl["This"]["jz"]
            frhs_bx = (-pc.mu0 * sl.ddy_interior(fjz, fg)
                       + pc.mu0 * dz2_inv
                       * (sl.interior(fl["Previous"]["jy"], fg)
                          - sl.interior(fjy, fg)))
            frhs_by = (pc.mu0 * sl.ddx_interior(fjz, fg)
                       - pc.mu0 * dz2_inv
                       * (sl.interior(fl["Previous"]["jx"], fg)
                          - sl.interior(fjx, fg)))
            frhs_bx = coup.apply_bc(frhs_bx, parent_pc[0], 1.0, 1.0)
            frhs_by = coup.apply_bc(frhs_by, parent_pc[1], 1.0, 1.0)
            fsol = fine_solvers[i].solve(jnp.stack([frhs_bx, frhs_by]))
            fpcx = sl.set_interior(fpcx, fsol[0], fg)
            fpcy = sl.set_interior(fpcy, fsol[1], fg)
            fpcx = coup.up_boundary(fpcx, parent_pc[0], G, 0)
            fpcy = coup.up_boundary(fpcy, parent_pc[1], G, 0)
            new_fstates.append((fbx, fby, fpcx, fpcy, fppx, fppy))
            parent_pc = (fpcx, fpcy)
        fstates = tuple(new_fstates)

        err_new = multi_err(
            (bx, by, pcx, pcy),
            [(fs[0], fs[1], fs[2], fs[3]) for fs in fstates])
        err_prev = jnp.where(it == 0, err_new, err_prev)
        # MixAndShiftBfields (ref Fields.cpp:1173-1226), shared weights
        denom = err_new + err_prev
        w_it = jnp.where(denom > 0.0, err_prev / jnp.maximum(denom, 1e-30), 0.5)
        w_pp = jnp.where(denom > 0.0, err_new / jnp.maximum(denom, 1e-30), 0.5)

        def mix_one(bx, by, pcx, pcy, ppx, ppy):
            ppx_m = w_it * pcx + w_pp * ppx
            ppy_m = w_it * pcy + w_pp * ppy
            nbx = (1.0 - mix) * bx + mix * ppx_m
            nby = (1.0 - mix) * by + mix * ppy_m
            return (nbx, nby, pcx, pcy, pcx, pcy)

        bx, by, pcx, pcy, ppx, ppy = mix_one(bx, by, pcx, pcy, ppx, ppy)
        fstates = tuple(mix_one(*fs) for fs in fstates)
        return ((bx, by, pcx, pcy, ppx, ppy), fstates, err_new, err_new,
                it + 1)

    def cond(state):
        _, _, err, _err_prev, it = state
        return (err > tol) & (it < cfg.predcorr_max_iterations)

    state0 = ((bx, by, pcx, pcy, ppx, ppy), fstate0,
              jnp.asarray(1.0, bx.dtype), jnp.asarray(1.0, bx.dtype),
              jnp.zeros((), jnp.int32))
    (cstate, fstates, err, _, n_iter) = jax.lax.while_loop(
        cond, body, state0)
    bx, by, pcx, pcy, ppx, ppy = cstate

    for i in range(len(mr)):
        fbx, fby, fpcx, fpcy, fppx, fppy = fstates[i]
        fine_f[i]["This"] = dict(fine_f[i]["This"], Bx=fbx, By=fby)
        fine_f[i]["PCPrevIter"] = {"Bx": fppx, "By": fppy}
        fine_f[i]["PCIter"] = {"Bx": fpcx, "By": fpcy}

    this = dict(this, Bx=bx, By=by)
    return dict(f, This=this, PCPrevIter={"Bx": ppx, "By": ppy},
                PCIter={"Bx": pcx, "By": pcy}), err, n_iter


# ----------------------------------------------------------------------
def _row_sort(p: dict, geom: Geometry, stripe_h: int = 0,
              static_ion_lev: bool = False):
    """Sort a plasma SoA by current transverse row (the equivalent of the
    reference's ReorderParticles, ref particles/sorting/...). Invalid lanes
    sink to the tail so they never widen a banded window.

    With stripe_h > 0 the key is the stripe-snake order required by 2D
    banded windows (ops/banded.py): stripes of stripe_h rows, x-ascending
    within even stripes and x-descending within odd ones (boustrophedon),
    so a K-chunk spans <= 2 stripes in y AND a contiguous x range — it
    fits a (W, WX) window with W >= 2*stripe_h + taps.

    Multi-operand lax.sort: per-particle attributes ride along as sort
    operands, so pid and the 25 AB5 force-history slots stay consistent
    under banded kernels, with no per-attribute random gather afterwards.
    The sort's cost grows with its payload, so attributes that need not
    ride are dropped:
    x_prev/y_prev (equal to x/y at slice start — the non-temp push syncs
    them), valid (the key maps valid lanes strictly below the sentinel, so
    it is reconstructed exactly as sorted_key < sentinel), and ion_lev when
    static_ion_lev (no species in the sim ionizes: ion_lev is the constant
    1 for every lane, ref PlasmaParticleContainer init)."""
    NY, NX = geom.slice_shape
    ym = (p["y"] - geom.y_pos_offset) / geom.dy
    key = jnp.clip(jnp.floor(ym).astype(jnp.int32) + geom.nguards, 0, NY)
    sentinel = NY + 1
    if stripe_h > 0:
        xm = (p["x"] - geom.x_pos_offset) / geom.dx
        col = jnp.clip(jnp.floor(xm).astype(jnp.int32) + geom.nguards,
                       0, NX)
        stripe = key // stripe_h
        colkey = jnp.where(stripe % 2 == 0, col, NX - col)
        key = stripe * (NX + 2) + colkey
        sentinel = (NY // stripe_h + 1) * (NX + 2)
    key = jnp.where(p["valid"], key, sentinel)
    skip = {"x_prev", "y_prev", "valid"}
    if static_ion_lev and "ion_lev" in p:
        skip.add("ion_lev")
    names = sorted(n for n in p if n not in skip)
    res = jax.lax.sort([key] + [p[n] for n in names], num_keys=1)
    out = dict(zip(names, res[1:]))
    out["valid"] = res[0] < sentinel
    if static_ion_lev and "ion_lev" in p:
        out["ion_lev"] = p["ion_lev"]   # constant per lane, order-free
    out["x_prev"] = out["x"]
    out["y_prev"] = out["y"]
    return out


def make_poisson_solver(name: str, g: Geometry, dtype):
    """fields.poisson_solver selection (ref Fields.cpp:29-44)."""
    from ..fields.poisson import (MGDirichletPoissonSolver,
                                  PeriodicPoissonSolver)
    if name in ("FFTDirichletDirect", "FFTDirichletExpanded"):
        return DirichletPoissonSolver(g.nx, g.ny, g.dx, g.dy, dtype,
                                      variant="expanded")
    if name == "FFTDirichletFast":
        return DirichletPoissonSolver(g.nx, g.ny, g.dx, g.dy, dtype,
                                      variant="fast")
    if name == "MGDirichlet":
        return MGDirichletPoissonSolver(g.nx, g.ny, g.dx, g.dy, dtype)
    if name == "FFTPeriodic":
        return PeriodicPoissonSolver(g.nx, g.ny, g.dx, g.dy, dtype)
    raise ValueError(f"unknown fields.poisson_solver {name}")


def _banded_opts(cfg: SimConfig, gather: bool = False):
    """BandedOpts for the deposit (or gather) kernels, or None when the
    banded path is off."""
    if not cfg.use_banded:
        return None
    from ..ops.banded import BandedOpts
    return BandedOpts(W=cfg.banded_W,
                      K=cfg.banded_gather_K if gather else cfg.banded_K,
                      WX=cfg.banded_WX)


def banded_stripe_h(cfg: SimConfig) -> int:
    """Stripe height of the stripe-snake plasma sort: (W-8)//2 rows keep a
    K-chunk within a W-row window; 0 (plain row sort) only when banded_WX
    spans the whole padded row."""
    if cfg.banded_WX < cfg.geom.slice_shape[1]:
        return max(1, (cfg.banded_W - 8) // 2)
    return 0


def make_slice_step(cfg: SimConfig, dtype):
    """Build the per-slice function used by lax.scan."""
    g = cfg.geom
    pc = cfg.pc
    order = cfg.depos_order_xy
    banded = _banded_opts(cfg)
    banded_gather = _banded_opts(cfg, gather=True)
    solver = make_poisson_solver(cfg.poisson_solver, g, dtype)
    mg = MultiGrid(g.nx, g.ny, g.dx, g.dy, dtype) if cfg.explicit else None
    mr = cfg.mr_levels
    if mr:
        # banded composes with MR: level-0 deposits/gathers use the banded
        # kernels (the expensive grid); fine-patch deposits/gathers keep the
        # XLA scatter path (small subsets, masked by tag). SALAME composes
        # too: the weight iteration runs on level 0, then every fine level
        # is solved with the final weights (see the SALAME block below).
        from ..fields.mr import LevelCoupler, in_level_bounds
        couplers, fine_solvers, fine_mgs = [], [], []
        parent_g = g
        for lv in mr:
            couplers.append(LevelCoupler(parent_g, lv.geom, dtype))
            fine_solvers.append(
                make_poisson_solver(cfg.poisson_solver, lv.geom, dtype))
            fine_mgs.append(MultiGrid(lv.geom.nx, lv.geom.ny, lv.geom.dx,
                                      lv.geom.dy, dtype))
            parent_g = lv.geom
    if cfg.open_boundary:
        from ..fields.open_boundary import OpenBoundary
        ob = OpenBoundary(g, dtype)
    else:
        ob = None
    if cfg.use_laser:
        from ..fields.laser import make_laser_advance, envelope_slice
        lg = cfg.laser_geom if cfg.laser_geom is not None else g
        lz_lo, lz_hi = cfg.laser_zeta if cfg.laser_zeta is not None \
            else (0, g.nz - 1)
        laser_advance = make_laser_advance(cfg.laser, lg, pc, dtype)
        separate_laser_grid = lg != g
        if separate_laser_grid:
            # cross-grid interpolation (ref MultiLaser::InterpolateChi /
            # UpdateLaserAabs): field->laser for chi, laser->field for aabs
            from ..fields.mr import GridInterp
            import numpy as _np
            f2l = GridInterp(g, lg, dtype, order=cfg.laser.interp_order)
            l2f = GridInterp(lg, g, dtype, order=cfg.laser.interp_order,
                             valid_only=True)
            # laser points inside the trusted field chi region (the field
            # valid box shrunk by 2 nguards, ref MultiLaser.cpp:358-373)
            G_ = g.nguards
            NYl, NXl = lg.slice_shape
            xl = (_np.arange(NXl) - G_ + 0.5) * lg.dx + lg.prob_lo[0]
            yl = (_np.arange(NYl) - G_ + 0.5) * lg.dy + lg.prob_lo[1]
            x_ok = (xl >= g.prob_lo[0] + G_ * g.dx) \
                & (xl <= g.prob_hi[0] - G_ * g.dx)
            y_ok = (yl >= g.prob_lo[1] + G_ * g.dy) \
                & (yl <= g.prob_hi[1] - G_ * g.dy)
            laser_trust = jnp.asarray(y_ok[:, None] & x_ok[None, :])

    def slice_step(carry, xs):
        f = carry["fields"]
        plasmas = carry["plasma"]
        slip = carry["slip"]
        dt = carry["dt"]
        time = carry["time"]
        islice = xs["islice"]
        min_z = (g.prob_lo[2] + islice.astype(dtype) * g.dz).astype(dtype)
        extra_ys = {}

        # ---- InitializeSlices (ref Fields.cpp:536-586)
        this = dict(f["This"])
        if cfg.explicit:
            zero_comps = ("chi", "Sy", "Sx", "ExmBy", "EypBx", "jz_beam",
                          "rhomjz") + (("rhomjz_beam",)
                                       if cfg.do_beam_jz_minus_rho else ())
        else:
            zero_comps = ("ExmBy", "EypBx", "jx", "jy", "jz", "rhomjz")
        for c in zero_comps:
            this[c] = jnp.zeros_like(this[c])
        if cfg.deposit_rho:
            this["rho"] = jnp.zeros_like(this["rho"])
        if cfg.deposit_rho_individual:
            for pcfg in cfg.plasmas:
                this[f"rho_{pcfg.name}"] = jnp.zeros_like(
                    this[f"rho_{pcfg.name}"])
        f = dict(f, This=this)
        if cfg.explicit:
            f["Next"] = {c: jnp.zeros_like(v) for c, v in f["Next"].items()}

        # ---- row-sort plasma for the banded kernels (before MR tags:
        # plasma_tags index into the sorted arrays)
        if cfg.use_banded:
            stripe_h = banded_stripe_h(cfg)
            # when no species ionizes, ion_lev is a constant 1 for every
            # lane and need not ride the sort (saves one 1M-f32 operand)
            static_ion = not any(pcfg.can_ionize for pcfg in cfg.plasmas)
            if cfg.banded_sort_period > 1:
                do_sort = (islice % cfg.banded_sort_period) == 0
                plasmas = [jax.lax.cond(do_sort,
                                        lambda ps: _row_sort(ps, g,
                                                             stripe_h,
                                                             static_ion),
                                        lambda ps: ps, p)
                           for p in plasmas]
            else:
                plasmas = [_row_sort(p, g, stripe_h, static_ion)
                           for p in plasmas]

        # ---- MR: fine InitializeSlices (ref Fields.cpp:541-557) + flags
        if mr:
            actives = [(islice >= lv.zeta_lo) & (islice <= lv.zeta_hi)
                       for lv in mr]
            entries = [islice == lv.zeta_hi for lv in mr]
            fine_f = []
            for i, lv in enumerate(mr):
                coup = couplers[i]
                fl = {k: dict(v) for k, v in f[f"mr{i + 1}"].items()}
                parent_this = this if i == 0 else fine_f[i - 1]["This"]
                parent_prev = (f["Previous"] if i == 0
                               else fine_f[i - 1]["Previous"])
                ent = entries[i]
                fth = fl["This"]
                fpv = fl["Previous"]
                if cfg.explicit:
                    # first slice of the level: interpolate the shifted beam
                    # currents from the parent; Bx/By restart from zero (the
                    # reference zeroes all slices at step start)
                    for c in ("jx_beam", "jy_beam"):
                        fth[c] = jnp.where(ent, coup.up_full(parent_this[c]),
                                           fth[c])
                        fpv[c] = jnp.where(ent, coup.up_full(parent_prev[c]),
                                           fpv[c])
                    fth["jx"] = jnp.where(ent, fth["jx_beam"], fth["jx"])
                    fth["jy"] = jnp.where(ent, fth["jy_beam"], fth["jy"])
                    for c in ("Bx", "By"):
                        fth[c] = jnp.where(ent, jnp.zeros_like(fth[c]),
                                           fth[c])
                else:
                    # PC entry (ref Fields.cpp:562-575): interpolate the
                    # B-field history and previous currents from the parent
                    parent_ppi = (f["PCPrevIter"] if i == 0
                                  else fine_f[i - 1]["PCPrevIter"])
                    fppi = fl["PCPrevIter"]
                    for c in ("Bx", "By"):
                        fppi[c] = jnp.where(
                            ent, coup.up_full(parent_ppi[c]), fppi[c])
                        fpv[c] = jnp.where(
                            ent, coup.up_full(parent_prev[c]), fpv[c])
                    for c in ("jx", "jy"):
                        fpv[c] = jnp.where(
                            ent, coup.up_full(parent_prev[c]), fpv[c])
                    fl["PCPrevIter"] = fppi
                for c in zero_comps:
                    fth[c] = jnp.zeros_like(fth[c])
                if cfg.deposit_rho:
                    fth["rho"] = jnp.zeros_like(fth["rho"])
                if cfg.deposit_rho_individual:
                    for pcfg in cfg.plasmas:
                        fth[f"rho_{pcfg.name}"] = jnp.zeros_like(
                            fth[f"rho_{pcfg.name}"])
                fl["Next"] = {c: jnp.zeros_like(v)
                              for c, v in fl["Next"].items()}
                fl["This"] = fth
                fl["Previous"] = fpv
                fine_f.append(fl)

            # TagByLevel (ref PlasmaParticleContainer.cpp:220-259), gated by
            # per-level z activity
            def compute_tag(pp):
                tg = jnp.zeros(pp["x"].shape, jnp.int32)
                for i, lv in enumerate(mr):
                    inb = in_level_bounds(pp["x"], pp["y"], lv.geom)
                    tg = jnp.where(inb & actives[i], i + 1, tg)
                return jnp.where(pp["valid"], tg, 0)

            plasma_tags = [compute_tag(p) for p in plasmas]

        # ---- laser: assemble this slice's envelope state and write aabs
        # (ref Hipace.cpp:603 UpdateLaserAabs)
        if cfg.use_laser:
            step_idx = carry["step"]
            z_sl = (g.z_pos_offset + islice.astype(dtype) * g.dz).astype(dtype)
            has_laser = (islice >= lz_lo) & (islice <= lz_hi)
            if cfg.laser.from_file:
                # the stream was pre-filled from the openPMD file
                n00j00 = xs["laser_n00"]
            else:
                env0 = envelope_slice(cfg.laser, lg, z_sl, dtype)
                n00j00 = jnp.where(step_idx == 0, env0, xs["laser_n00"])
            n00j00 = jnp.where(has_laser, n00j00, 0.0)
            # nm1 is only read for step >= 1 (driver streams step s-1's n00)
            lstate = dict(carry["laser"], n00j00=n00j00,
                          nm1j00=xs["laser_nm1"])
            aabs_l = jnp.abs(n00j00) ** 2
            if separate_laser_grid:
                # laser -> field grid (ref UpdateLaserAabs,
                # MultiLaser.cpp:215-290)
                this["aabs"] = l2f.apply(aabs_l)
            else:
                this["aabs"] = aabs_l

        # ---- plasma deposits on This
        if cfg.explicit:
            base_comps = ["jx", "jy", "chi", "rhomjz"]
        else:
            base_comps = ["jx", "jy", "jz", "rhomjz"] + (
                ["chi"] if cfg.use_laser else [])
        if cfg.deposit_rho:
            base_comps.append("rho")
        this = f["This"]
        new_plasmas = []
        lost_acc = []
        dgrids_list = []
        for p, pcfg in zip(plasmas, cfg.plasmas):
            comps = base_comps + (
                [f"rho_{pcfg.name}"] if cfg.deposit_rho_individual else [])
            if cfg.explicit and cfg.use_banded:
                # fused: main currents + explicit Sx/Sy channels share one
                # one-hot build; Sy/Sx are combined after the field solve
                this, p, dg = pl.fused_plasma_deposits(
                    p, comps, this, g, pcfg, pc, order,
                    cfg.depos_derivative_type, cfg.normalized_units,
                    cfg.use_laser, banded, lost_out=lost_acc)
                dgrids_list.append(dg)
            else:
                this, p = pl.deposit_plasma(
                    p, comps, this, g, pcfg, pc, order,
                    cfg.normalized_units, use_laser=cfg.use_laser,
                    banded=banded, lost_out=lost_acc)
            new_plasmas.append(p)
        plasmas = new_plasmas

        # ---- beam deposit on This (pre-push)
        # occupancy counts for chunked/bucketed beam ops (valid lanes are
        # compacted at the front by bin_beam's rank order)
        bchunk = cfg.beam_chunk
        buckets = 0 if bchunk else max(1, cfg.beam_buckets)
        count_needed = cfg.beams and (bchunk or buckets > 1)
        cnt_this = (jnp.sum(xs["beam_this"]["valid"])
                    if count_needed else None)
        cnt_next = (jnp.sum(xs["beam_next"]["valid"])
                    if count_needed else None)
        if cfg.beams and buckets > 1:
            bcap = xs["beam_this"]["valid"].shape[0]
            dep_prefix = bm.prefix_ladder(bcap, buckets)
            adv_prefix = bm.prefix_ladder(cfg.slip_cap + bcap, buckets)
        else:
            dep_prefix = adv_prefix = None
        if cfg.beams:
            if cfg.explicit:
                cmap = {"jz": "jz_beam"}
                if cfg.do_beam_jz_minus_rho:
                    cmap["rhomjz"] = "rhomjz_beam"
            else:
                cmap = ({"jx": "jx", "jy": "jy", "jz": "jz"}
                        if cfg.do_beam_jx_jy_deposition else {"jz": "jz"})
                if cfg.do_beam_jz_minus_rho:
                    cmap["rhomjz"] = "rhomjz"
            this = bm.deposit_beam_slice(
                xs["beam_this"], cmap, this, g, cfg.beams, pc,
                order, cfg.normalized_units,
                chunk=bchunk, n_active=cnt_this,
                prefix=dep_prefix)

        # ---- MR: fine-level deposits (deposit predicate tag >= lev,
        # ref PlasmaDepositCurrent.cpp:130) + boundary compensation
        if mr:
            for i, lv in enumerate(mr):
                coup = couplers[i]
                fth = fine_f[i]["This"]
                if cfg.use_laser:
                    # aabs to the fine level from its parent
                    # (ref MultiLaser.cpp:289-291 LevelUp of aabs)
                    parent_aabs = (this["aabs"] if i == 0
                                   else fine_f[i - 1]["This"]["aabs"])
                    fth = dict(fth)
                    fth["aabs"] = coup.up_full(parent_aabs)
                for p, pcfg, tg in zip(plasmas, cfg.plasmas, plasma_tags):
                    comps = base_comps + (
                        [f"rho_{pcfg.name}"] if cfg.deposit_rho_individual
                        else [])
                    fth, _ = pl.deposit_plasma(
                        p, comps, fth, lv.geom, pcfg, pc, order,
                        cfg.normalized_units, use_laser=cfg.use_laser,
                        extra_mask=(tg >= i + 1), geom0=g)
                if cfg.beams:
                    bmask = in_level_bounds(xs["beam_this"]["x"],
                                            xs["beam_this"]["y"], lv.geom) \
                        & actives[i]
                    if cfg.explicit:
                        fcmap = {"jz": "jz_beam"}
                        if cfg.do_beam_jz_minus_rho:
                            fcmap["rhomjz"] = "rhomjz_beam"
                    else:
                        fcmap = ({"jx": "jx", "jy": "jy", "jz": "jz"}
                                 if cfg.do_beam_jx_jy_deposition
                                 else {"jz": "jz"})
                        if cfg.do_beam_jz_minus_rho:
                            fcmap["rhomjz"] = "rhomjz"
                    fth = bm.deposit_beam_slice(
                        xs["beam_this"], fcmap, fth, lv.geom,
                        cfg.beams, pc, order, cfg.normalized_units,
                        extra_mask=bmask, geom0=g,
                        chunk=bchunk, n_active=cnt_this,
                        prefix=dep_prefix)
                # AddRhoIons on the fine level
                fth = dict(fth)
                fth["rhomjz"] = fth["rhomjz"] \
                    + fine_f[i]["RhomJzIons"]["rhomjz"]
                if cfg.deposit_rho:
                    fth["rho"] = fth["rho"] \
                        + fine_f[i]["RhomJzIons"]["rhomjz"]
                fine_f[i]["This"] = fth

        # ---- AddRhoIons (ref Fields.cpp:606-615)
        this = dict(this)
        this["rhomjz"] = this["rhomjz"] + f["RhomJzIons"]["rhomjz"]
        if cfg.deposit_rho:
            this["rho"] = this["rho"] + f["RhomJzIons"]["rhomjz"]

        # ---- analytic grid current into jz (ref GridCurrent.cpp:26-71)
        if cfg.grid_current is not None:
            peak, mean, std = cfg.grid_current
            # grid current uses z = lo + islice*dz (ref GridCurrent.cpp:46)
            z_sl = g.prob_lo[2] + islice.astype(dtype) * g.dz
            dz_n = (z_sl - mean[2]) / std[2]
            long_fac = jnp.exp(-0.5 * dz_n * dz_n)
            G = g.nguards
            NY, NX = g.slice_shape
            xs_ = (jnp.arange(NX, dtype=dtype) - G + 0.5) * g.dx + g.prob_lo[0]
            ys_ = (jnp.arange(NY, dtype=dtype) - G + 0.5) * g.dy + g.prob_lo[1]
            dxn = (xs_[None, :] - mean[0]) / std[0]
            dyn = (ys_[:, None] - mean[1]) / std[1]
            jz_add = peak * jnp.exp(-0.5 * (dxn * dxn + dyn * dyn)) * long_fac
            jz_add = sl.set_interior(jnp.zeros_like(jz_add),
                                     sl.interior(jz_add, g), g)
            tgt = "jz_beam" if cfg.explicit else "jz"
            this[tgt] = this[tgt] + jz_add

        # ---- Psi/ExmBy/EypBx/Ez/Bz solve
        this = _solve_psi_ez_bz(this, cfg, solver, ob)
        f = dict(f, This=this)

        # ---- MR: fine Psi/Ez/Bz solves with Dirichlet BCs interpolated
        # from the parent solution (ref Fields.cpp:840-957 lev>0 path)
        if mr:
            G = g.nguards
            for i, lv in enumerate(mr):
                coup = couplers[i]
                fg = lv.geom
                fth = dict(fine_f[i]["This"])
                parent = this if i == 0 else fine_f[i - 1]["This"]
                # source edge compensation (ref Fields.cpp:862-877)
                fth["rhomjz"] = coup.up_boundary(fth["rhomjz"],
                                                 parent["rhomjz"], 0, -G + 1)
                fth["jx"] = coup.up_boundary(fth["jx"], parent["jx"],
                                             1, -G + 1)
                fth["jy"] = coup.up_boundary(fth["jy"], parent["jy"],
                                             1, -G + 1)
                frhom = fth["rhomjz"]
                if cfg.explicit and cfg.do_beam_jz_minus_rho:
                    frhom = frhom + fth["rhomjz_beam"]
                rhs_psi = -1.0 / pc.ep0 * sl.interior(frhom, fg)
                rhs_ez = (sl.ddx_interior(fth["jx"], fg)
                          + sl.ddy_interior(fth["jy"], fg)) / (pc.ep0 * pc.c)
                rhs_bz = pc.mu0 * (sl.ddy_interior(fth["jx"], fg)
                                   - sl.ddx_interior(fth["jy"], fg))
                rhs_psi = coup.apply_bc(rhs_psi, parent["Psi"], 1.0, 1.0)
                rhs_ez = coup.apply_bc(rhs_ez, parent["Ez"], 1.0, 1.0)
                rhs_bz = coup.apply_bc(rhs_bz, parent["Bz"], 1.0, 1.0)
                sol = fine_solvers[i].solve(
                    jnp.stack([rhs_psi, rhs_ez, rhs_bz]))
                fth["Psi"] = sl.set_interior(fth["Psi"], sol[0], fg)
                fth["Ez"] = sl.set_interior(fth["Ez"], sol[1], fg)
                fth["Bz"] = sl.set_interior(fth["Bz"], sol[2], fg)
                # ghost fill from the parent solution (ref Fields.cpp:924-929)
                for c in ("Psi", "Ez", "Bz"):
                    fth[c] = coup.up_boundary(fth[c], parent[c], G, 0)
                exmby_f, eypbx_f = sl.grad_neg_full(fth["Psi"], fg)
                fth["ExmBy"] = exmby_f
                fth["EypBx"] = eypbx_f
                fine_f[i]["This"] = fth

        # ---- laser envelope advance (ref Hipace.cpp:637 AdvanceSlice)
        if cfg.use_laser:
            # chi on the laser grid: field chi in the trusted interior,
            # chi from the density profile near/outside the edge
            # (ref MultiLaser.cpp:335-405 InterpolateChi)
            if separate_laser_grid:
                chi_laser = jnp.where(laser_trust, f2l.apply(this["chi"]),
                                      carry["chi_initial"])
            else:
                G2 = 2 * g.nguards
                NY, NX = g.slice_shape
                trust = jnp.zeros((NY, NX), bool)
                trust = trust.at[G2:NY - G2, G2:NX - G2].set(True)
                chi_laser = jnp.where(trust, this["chi"],
                                      carry["chi_initial"])
            np1j00 = laser_advance(lstate, chi_laser, dt, carry["step"])
            np1j00 = jnp.where(has_laser, np1j00, 0.0)

        # ---- Bx/By solve
        if cfg.explicit:
            # beam Next deposit jx_beam, jy_beam
            if cfg.do_beam_jx_jy_deposition and cfg.beams:
                nxt = bm.deposit_beam_slice(
                    xs["beam_next"], {"jx": "jx_beam", "jy": "jy_beam"},
                    f["Next"], g, cfg.beams, pc, order, cfg.normalized_units,
                    chunk=bchunk, n_active=cnt_next,
                    prefix=dep_prefix)
                f = dict(f, Next=nxt)
            f = _init_sx_sy_with_beam(f, cfg)
            this = f["This"]
            if cfg.use_banded:
                for dg in dgrids_list:
                    this = pl.combine_explicit_sxsy(this, dg, g, pc,
                                                    cfg.use_laser)
            else:
                for p, pcfg in zip(plasmas, cfg.plasmas):
                    this = pl.explicit_deposition(
                        p, this, g, pcfg, pc, order,
                        cfg.depos_derivative_type, cfg.normalized_units,
                        use_laser=cfg.use_laser)
            this, bxby_iters = _explicit_bxby_solve(this, cfg, mg)
            f = dict(f, This=this)
            pc_err = jnp.zeros((), dtype)

            # ---- SALAME beam loading (ref Hipace.cpp:673-678). Runs
            # BEFORE the fine-level solves so every level's Bx/By is
            # computed with the FINAL beam weights — the analogue of the
            # reference's per-level STEP 4 recompute (ref Salame.cpp:160-185).
            # The W averages sample level-0 Ez (the reference weights by
            # each particle's finest level, Salame.cpp:122-131) — see
            # PARITY.md.
            if cfg.salame_active:
                from .salame import salame_slice
                from ..parser import compile_function
                target_fn = compile_function(
                    cfg.salame_target_expr,
                    ("zeta", "zeta_initial", "Ez_initial"),
                    cfg.salame_consts)
                _salf = jnp.asarray([b.do_salame for b in cfg.beams], bool)
                _salm = _salf[jnp.clip(xs["beam_this"]["beam_id"], 0,
                                       len(cfg.beams) - 1)]
                is_sal = (carry["step"] == 0) & jnp.any(
                    xs["beam_this"]["valid"] & _salm)

                def _do(args):
                    this_, bt_, st_ = args
                    return salame_slice(cfg, this_, f["Next"], f["Previous"],
                                        plasmas, bt_, st_, islice, solver,
                                        mg, dtype, target_fn)

                def _skip(args):
                    this_, bt_, st_ = args
                    st_ = dict(st_, prev_was_salame=jnp.zeros((), bool))
                    return this_, bt_, st_

                extra_ys["salame_is_sal"] = is_sal
                this, beam_this_upd, new_sal = jax.lax.cond(
                    is_sal, _do, _skip,
                    (this, xs["beam_this"], carry["salame"]))
                xs = dict(xs, beam_this=beam_this_upd)
                f = dict(f, This=this)
                carry = dict(carry, salame=new_sal)
                extra_ys["salame_W"] = new_sal["W_last"]
                extra_ys["salame_dbg"] = new_sal["dbg"]

            # ---- MR: fine Bx/By (ref ExplicitMGSolveBxBy lev>0,
            # Hipace.cpp:793-933)
            if mr:
                G = g.nguards
                for i, lv in enumerate(mr):
                    coup = couplers[i]
                    fg = lv.geom
                    fl = fine_f[i]
                    parent = this if i == 0 else fine_f[i - 1]["This"]
                    if cfg.do_beam_jx_jy_deposition and cfg.beams:
                        bmask = in_level_bounds(xs["beam_next"]["x"],
                                                xs["beam_next"]["y"],
                                                fg) & actives[i]
                        fl["Next"] = bm.deposit_beam_slice(
                            xs["beam_next"],
                            {"jx": "jx_beam", "jy": "jy_beam"},
                            fl["Next"], fg, cfg.beams, pc, order,
                            cfg.normalized_units, extra_mask=bmask, geom0=g,
                            chunk=bchunk, n_active=cnt_next,
                            prefix=dep_prefix)
                    fl = dict(fl, **{"This": fl["This"]})
                    if cfg.salame_active and cfg.beams:
                        # redeposit This jz_beam with the (possibly
                        # SALAME-updated) weights, the per-level STEP 4
                        # redeposit of the reference (ref Salame.cpp:164-172)
                        bmask_t = in_level_bounds(
                            xs["beam_this"]["x"], xs["beam_this"]["y"],
                            fg) & actives[i]
                        fl_this = dict(fl["This"], jz_beam=jnp.zeros_like(
                            fl["This"]["jz_beam"]))
                        fl_this = bm.deposit_beam_slice(
                            xs["beam_this"], {"jz": "jz_beam"}, fl_this, fg,
                            cfg.beams, pc, order, cfg.normalized_units,
                            extra_mask=bmask_t, geom0=g,
                            chunk=bchunk, n_active=cnt_this,
                            prefix=dep_prefix)
                        fl = dict(fl, This=fl_this)
                    tmp = _init_sx_sy_with_beam(
                        {"This": fl["This"], "Previous": fl["Previous"],
                         "Next": fl["Next"]}, cfg, fg)
                    fth = tmp["This"]
                    for p, pcfg, tg in zip(plasmas, cfg.plasmas,
                                           plasma_tags):
                        fth = pl.explicit_deposition(
                            p, fth, fg, pcfg, pc, order,
                            cfg.depos_derivative_type,
                            cfg.normalized_units, use_laser=cfg.use_laser,
                            extra_mask=(tg >= i + 1), geom0=g)
                    # edge compensation from the parent
                    # (ref Hipace.cpp:823-829)
                    fth = dict(fth)
                    fth["Sy"] = coup.up_boundary(fth["Sy"], parent["Sy"],
                                                 0, -G)
                    fth["Sx"] = coup.up_boundary(fth["Sx"], parent["Sx"],
                                                 0, -G)
                    fth["chi"] = coup.up_boundary(fth["chi"], parent["chi"],
                                                  0, -G + 1)
                    # Dirichlet BC from the parent Bx/By solution
                    # (ref Hipace.cpp:839-853: even-size cell-centered MG
                    # offset 0.5 factor 8/3; odd node-centered 1, 1)
                    if fg.nx % 2 == 0:
                        off_bc, fac_bc = 0.5, 8.0 / 3.0
                    else:
                        off_bc, fac_bc = 1.0, 1.0
                    sy_i = coup.apply_bc(sl.interior(fth["Sy"], fg),
                                         parent["Bx"], off_bc, fac_bc)
                    sx_i = coup.apply_bc(sl.interior(fth["Sx"], fg),
                                         parent["By"], off_bc, fac_bc)
                    b0 = jnp.stack([sl.interior(fth["Bx"], fg),
                                    sl.interior(fth["By"], fg)])
                    bsol = fine_mgs[i].solve(
                        b0, jnp.stack([sy_i, sx_i]),
                        sl.interior(fth["chi"], fg),
                        tol_rel=cfg.MG_tolerance_rel,
                        tol_abs=cfg.MG_tolerance_abs, max_iters=40)
                    fth["Bx"] = sl.set_interior(fth["Bx"], bsol[0], fg)
                    fth["By"] = sl.set_interior(fth["By"], bsol[1], fg)
                    # ghost fill from the parent (ref Hipace.cpp:928-933)
                    fth["Bx"] = coup.up_boundary(fth["Bx"], parent["Bx"],
                                                 G, 0)
                    fth["By"] = coup.up_boundary(fth["By"], parent["By"],
                                                 G, 0)
                    fl["This"] = fth
                    fine_f[i] = fl

        else:
            mrctx = ((mr, couplers, fine_solvers, fine_f, actives,
                      plasma_tags) if mr else None)
            f, pc_err, bxby_iters = _pc_bxby_solve(
                f, plasmas, xs["beam_next"], cfg, solver, ob, mrctx=mrctx,
                beam_n_active=cnt_next, beam_prefix=dep_prefix)
            this = f["This"]

        # ---- per-slice diagnostics (ref Diagnostic.cpp + Fields::Copy)
        if cfg.diag_comps:
            diag = jnp.stack([sl.interior(this[c], g)
                              for c in cfg.diag_comps])
        else:
            diag = jnp.zeros((0,), dtype)
        for dg in cfg.diags:
            if _diag_is_identity(dg, cfg):
                continue   # served from the legacy full-interior stack
            dgeom = g
            if dg.base == "laser":
                dgeom = lg
                if separate_laser_grid:
                    assert all(c == "laserEnvelope" for c in dg.comps), \
                        "separate laser grid: laser diags support only " \
                        "laserEnvelope"
                srcs = [n00j00 if c == "laserEnvelope" else this[c]
                        for c in dg.comps]
            elif dg.base.startswith("level_") and dg.base != "level_0":
                li = int(dg.base[-1]) - 1
                srcs = [fine_f[li]["This"][c] for c in dg.comps]
                dgeom = mr[li].geom
            else:
                srcs = [this[c] for c in dg.comps]
            payload = _process_diag_slice(srcs, dg, dgeom)
            if dg.diag_type == "xy_integrated":
                di = dict(carry["diag_int"])
                di[dg.name] = di[dg.name] + payload
                carry = dict(carry, diag_int=di)
            else:
                extra_ys["diagf_" + dg.name] = payload

        # ---- in-situ reduced diagnostics (ref Hipace.cpp:681-688)
        from ..diagnostics import insitu as ins
        if cfg.insitu_field_period and cfg.explicit:
            extra_ys["insitu_field"] = ins.field_slice_moments(
                this, g, pc, g.dx * g.dy * g.dz)
        if cfg.insitu_plasma_period:
            extra_ys["insitu_plasma"] = jnp.stack([
                ins.plasma_slice_moments(p, pc, cfg.insitu_radius)
                for p in plasmas])
        if cfg.use_laser and cfg.insitu_laser_period:
            extra_ys["insitu_laser"] = ins.laser_slice_moments(n00j00, lg)

        # ---- field ionization (ref Hipace.cpp:693-696)
        if cfg.ionization_pairs:
            key = carry["key"]
            spawn_lost = []
            for (ip_i, prod_i, spawn_base, prod_init_lev) in cfg.ionization_pairs:
                key, sub = jax.random.split(key)
                plasmas = list(plasmas)
                plasmas[ip_i], plasmas[prod_i] = pl.ionization_module(
                    plasmas[ip_i], plasmas[prod_i], this, g,
                    cfg.plasmas[ip_i], pc, order, cfg.normalized_units,
                    cfg.background_density_SI, spawn_base, prod_init_lev,
                    sub,
                    spawn_mode="append" if cfg.use_banded else "static",
                    lost_out=spawn_lost)
            carry = dict(carry, key=key)
            if cfg.use_banded:
                extra_ys["spawn_lost"] = sum(
                    spawn_lost, jnp.zeros((), jnp.int32))

        # ---- push plasma (ref Hipace.cpp:698-701)
        if mr:
            fine_fields = tuple((fine_f[i]["This"], lv.geom)
                                for i, lv in enumerate(mr))
            plasmas = [pl.advance_plasma(p, this, g, pcfg, pc,
                                         temp_slice=False, order=order,
                                         use_laser=cfg.use_laser,
                                         fine_levels=fine_fields, tag=tg,
                                         pusher=cfg.plasma_pusher)
                       for p, pcfg, tg in zip(plasmas, cfg.plasmas,
                                              plasma_tags)]
        else:
            plasmas = [pl.advance_plasma(p, this, g, pcfg, pc,
                                         temp_slice=False, order=order,
                                         use_laser=cfg.use_laser,
                                         banded=banded_gather,
                                         lost_out=lost_acc,
                                         pusher=cfg.plasma_pusher)
                       for p, pcfg in zip(plasmas, cfg.plasmas)]

        # ---- push beam: this slice + slipped carry (ref Hipace.cpp:706-709)
        # slip lanes first: both segments keep their valid lanes compacted
        # at the front, so chunked processing covers [0, slip_cap + count)
        combined = {k: jnp.concatenate([slip[k], xs["beam_this"][k]])
                    for k in bm.BEAM_ATTRS + bm.BEAM_INT_ATTRS + ("valid",)}
        if cfg.insitu_beam_period and cfg.beams:
            # pre-push per-beam moments (ref Hipace.cpp:681: after SALAME,
            # before push; one record file per beam)
            extra_ys["insitu_beam"] = jnp.stack([
                ins.beam_slice_moments(
                    dict(combined,
                         valid=combined["valid"]
                         & (combined["beam_id"] == ib)),
                    pc, cfg.insitu_radius)
                for ib in range(len(cfg.beams))])
        if cfg.beams:
            combined = bm.advance_all_beams(
                combined, this, g, cfg.beams, pc, dt, min_z, order=order,
                time=time, background_density_SI=cfg.background_density_SI,
                fine_levels=(tuple(
                    (fine_f[i]["This"], lv.geom, actives[i])
                    for i, lv in enumerate(mr)) if mr else ()),
                chunk=bchunk,
                n_active=(cfg.slip_cap + cnt_this) if count_needed else None,
                prefix=adv_prefix)
            # particles that stopped mid-subcycles slip to the carry buffer.
            # Multi-operand stable sort, in a 0/1-trip while_loop so slices with nothing slipped
            # (the common case) skip the sort entirely.
            incomplete = combined["valid"] & (combined["nsub"] > 0)

            def _slip_sort(state):
                comb, _ = state
                names = sorted(comb)
                skey = jnp.where(comb["valid"] & (comb["nsub"] > 0),
                                 0, 1).astype(jnp.int32)
                res = jax.lax.sort([skey] + [comb[n] for n in names],
                                   num_keys=1, is_stable=True)
                return dict(zip(names, res[1:])), jnp.zeros((), bool)

            reord, _ = jax.lax.while_loop(
                lambda s: s[1], _slip_sort,
                (combined, jnp.any(incomplete)))
            new_slip = {k: v[:cfg.slip_cap] for k, v in reord.items()}
            new_slip["valid"] = new_slip["valid"] & (new_slip["nsub"] > 0)
            n_incomplete = jnp.sum(incomplete)
            n_slipped = jnp.minimum(n_incomplete, cfg.slip_cap)
            # overflow beyond slip_cap would be emitted with nsub>0 (a
            # partially-pushed particle written as final) — count it, and
            # report the per-slice capacity actually needed so the host
            # driver can grow slip_cap and re-run the step EXACTLY
            # (ref SliceSort.H:16-24 moves ALL slipped particles to Next)
            extra_ys["slip_overflow"] = (n_incomplete - n_slipped).astype(
                jnp.int32)
            extra_ys["slip_need"] = n_incomplete.astype(jnp.int32)
            emit = dict(reord)
            emit["valid"] = emit["valid"] & (
                jnp.arange(emit["valid"].size) >= n_slipped)
        else:
            new_slip = slip
            emit = combined

        # ---- Coulomb collisions (ref Hipace.cpp:712, doCoulombCollision)
        if cfg.collisions:
            from ..particles import collisions as coll
            ckey = carry["key"]
            new_plasmas = list(plasmas)
            for (kind, i1, i2, is_same, clog) in cfg.collisions:
                ckey, sub = jax.random.split(ckey)
                if kind == "pp":
                    new_plasmas[i1], new_plasmas[i2] =                         coll.plasma_plasma_collision(
                            new_plasmas[i1], new_plasmas[i2], g,
                            cfg.plasmas[i1], cfg.plasmas[i2], pc, clog,
                            cfg.background_density_SI, cfg.normalized_units,
                            sub, is_same)
                else:
                    bsel = dict(emit, valid=emit["valid"]
                                & (emit["beam_id"] == i1))
                    b_new, new_plasmas[i2] = coll.beam_plasma_collision(
                        bsel, new_plasmas[i2], g, cfg.beams[i1],
                        cfg.plasmas[i2], pc, clog,
                        cfg.background_density_SI, cfg.normalized_units,
                        sub, dt)
                    sel = emit["valid"] & (emit["beam_id"] == i1)
                    emit = dict(emit,
                                ux=jnp.where(sel, b_new["ux"], emit["ux"]),
                                uy=jnp.where(sel, b_new["uy"], emit["uy"]),
                                uz=jnp.where(sel, b_new["uz"], emit["uz"]))
            plasmas = new_plasmas
            carry = dict(carry, key=ckey)

        # ---- beam uz moments for adaptive dt (ref AdaptiveTimeStep
        # GatherMinUzSlice, post-push)
        c_inv = 1.0 / pc.c
        w_v = jnp.where(emit["valid"], emit["w"], 0.0)
        uz_valid = jnp.where(emit["valid"], emit["uz"],
                             jnp.asarray(jnp.inf, dtype))
        min_uz = jnp.minimum(carry["min_uz"], jnp.min(uz_valid) * c_inv)
        mom = carry["beam_moments"]
        mom = {
            "sum_w": mom["sum_w"] + jnp.sum(w_v),
            "sum_w_uz": mom["sum_w_uz"] + jnp.sum(w_v * emit["uz"]) * c_inv,
            "sum_w_uz2": mom["sum_w_uz2"]
                         + jnp.sum(w_v * emit["uz"] ** 2) * c_inv ** 2,
        }

        # ---- ShiftSlices (ref Fields.cpp:588-604)
        if cfg.explicit:
            prev = {"jx_beam": this["jx_beam"], "jy_beam": this["jy_beam"]}
            new_this = dict(this)
            new_this["jx_beam"] = f["Next"]["jx_beam"]
            new_this["jy_beam"] = f["Next"]["jy_beam"]
            new_this["jx"] = f["Next"]["jx_beam"]
            new_this["jy"] = f["Next"]["jy_beam"]
            f = dict(f, This=new_this, Previous=prev)
            if mr:
                for i in range(len(mr)):
                    fl = fine_f[i]
                    fth = fl["This"]
                    fprev = {"jx_beam": fth["jx_beam"],
                             "jy_beam": fth["jy_beam"]}
                    fth = dict(fth)
                    fth["jx_beam"] = fl["Next"]["jx_beam"]
                    fth["jy_beam"] = fl["Next"]["jy_beam"]
                    fth["jx"] = fl["Next"]["jx_beam"]
                    fth["jy"] = fl["Next"]["jy_beam"]
                    f[f"mr{i + 1}"] = dict(fl, This=fth, Previous=fprev)
        else:
            new_pp = {"Bx": f["Previous"]["Bx"], "By": f["Previous"]["By"]}
            new_prev = {"Bx": this["Bx"], "By": this["By"],
                        "jx": this["jx"], "jy": this["jy"]}
            f = dict(f, Previous=new_prev, PCPrevIter=new_pp)
            if mr:
                for i in range(len(mr)):
                    fl = fine_f[i]
                    fth = fl["This"]
                    fnew_pp = {"Bx": fl["Previous"]["Bx"],
                               "By": fl["Previous"]["By"]}
                    fnew_prev = {"Bx": fth["Bx"], "By": fth["By"],
                                 "jx": fth["jx"], "jy": fth["jy"]}
                    f[f"mr{i + 1}"] = dict(fl, Previous=fnew_prev,
                                           PCPrevIter=fnew_pp)

        if cfg.use_banded:
            # window-overflow safety net: nonzero means banded_W is too small
            # for this density distribution and deposits were dropped
            extra_ys["banded_lost"] = sum(lost_acc, jnp.zeros((), jnp.int32))

        carry = dict(carry, fields=f, plasma=plasmas, slip=new_slip,
                     min_uz=min_uz, beam_moments=mom)
        ys = {"beam_out": emit, "diag": diag, "pc_err": pc_err,
              "bxby_iters": bxby_iters, **extra_ys}

        if cfg.use_laser:
            # ShiftLaserSlices (ref MultiLaser.cpp:181-212)
            carry["laser"] = {
                "n00jp1": lstate["n00j00"], "n00jp2": lstate["n00jp1"],
                "nm1jp1": lstate["nm1j00"], "nm1jp2": lstate["nm1jp1"],
                "np1jp1": np1j00, "np1jp2": lstate["np1jp1"],
                "n00j00": lstate["n00j00"], "nm1j00": lstate["nm1j00"],
            }
            ys["laser_np1"] = np1j00
            ys["laser_n00"] = lstate["n00j00"]
        return carry, ys

    return slice_step


def zero_moments(dtype):
    return {"sum_w": jnp.zeros((), dtype), "sum_w_uz": jnp.zeros((), dtype),
            "sum_w_uz2": jnp.zeros((), dtype)}


def empty_slip(cap: int, dtype) -> dict:
    out = {k: jnp.zeros((cap,), dtype) for k in bm.BEAM_ATTRS}
    out["nsub"] = jnp.zeros((cap,), jnp.int32)
    out["beam_id"] = jnp.zeros((cap,), jnp.int32)
    out["valid"] = jnp.zeros((cap,), bool)
    return out
