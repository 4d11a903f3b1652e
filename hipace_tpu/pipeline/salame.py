"""SALAME beam loading: slice-by-slice Newton iteration on beam weights.

A JAX re-design of the reference's SALAME module (ref:
src/salame/Salame.{H,cpp}, invoked from Hipace.cpp:673-678): at step 0, on
slices carrying a SALAME-flagged beam, the beam weight is iterated so that
the wake's Ez is flattened to the target (Slicing Advanced Loading And
Matching of Electrons). Runs as a lax.cond branch inside the slice scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fields import slices as sl
from ..particles import plasma as pl
from ..particles import beam as bm
from ..ops.gather import gather_fields


def salame_slice(cfg, this, f_next, f_prev, plasmas, beam_this, sal_state,
                 islice, solver, mg, dtype, target_fn):
    """One SALAME slice (ref Salame.cpp:13-189). Returns updated
    (this, beam_this, sal_state)."""
    g = cfg.geom
    pc = cfg.pc
    order = cfg.depos_order_xy
    dz = g.dz
    sal_flags = jnp.asarray([b.do_salame for b in cfg.beams], bool)
    sal_mask = sal_flags[jnp.clip(beam_this["beam_id"], 0,
                                  len(cfg.beams) - 1)]
    zeta = g.prob_lo[2] + (islice.astype(dtype) + 0.5) * dz

    # Ez_target / zeta_initial refresh on the first slice of a SALAME block
    fresh = ~sal_state["prev_was_salame"]
    ez_target = jnp.where(fresh, this["Ez"], sal_state["ez_target"])
    zeta_initial = jnp.where(fresh, zeta, sal_state["zeta_initial"])

    # back up the plasma-only Sx/Sy (ref Salame.cpp:32-39)
    sx_sy = {"Sx": jnp.zeros_like(this["Sx"]),
             "Sy": jnp.zeros_like(this["Sy"]),
             **{k: this[k] for k in ("Bz", "Ez", "ExmBy", "EypBx")}}
    if cfg.use_laser:
        sx_sy["aabs"] = this["aabs"]
    for p, pcfg in zip(plasmas, cfg.plasmas):
        sx_sy = pl.explicit_deposition(
            p, sx_sy, g, pcfg, pc, order, cfg.depos_derivative_type,
            cfg.normalized_units, use_laser=cfg.use_laser)
    sy_back, sx_back = sx_sy["Sy"], sx_sy["Sx"]

    w_beam = beam_this["w"]
    overloaded = sal_state["overloaded"]
    converged = jnp.zeros((), bool)

    def _solve_ez(jx, jy):
        rhs = (sl.ddx_interior(jx, g) + sl.ddy_interior(jy, g)) \
            / (pc.ep0 * pc.c)
        sol = solver.solve(rhs[None])[0]
        return sl.set_interior(jnp.zeros_like(jx), sol, g)

    for _it in range(cfg.salame_n_iter):
        # STEP 1: Ez without extra SALAME weight (plasma response + beam)
        p_tmps = [pl.advance_plasma(p, this, g, pcfg, pc, temp_slice=True,
                                    order=order, use_laser=cfg.use_laser)
                  for p, pcfg in zip(plasmas, cfg.plasmas)]
        jx = f_next["jx_beam"]
        jy = f_next["jy_beam"]
        dep = {"jx": jx, "jy": jy}
        if cfg.use_laser:
            dep["aabs"] = this["aabs"]
        for p_tmp, pcfg in zip(p_tmps, cfg.plasmas):
            dep, _ = pl.deposit_plasma(p_tmp, ["jx", "jy"], dep, g, pcfg, pc,
                                       order, cfg.normalized_units,
                                       use_laser=False)
        ez_no_salame = _solve_ez(dep["jx"], dep["jy"])

        # STEP 2: Ez from the SALAME beam alone
        sal_fields = {"jz_beam": jnp.zeros_like(this["Ez"])}
        sal_fields = bm.deposit_beam_slice(
            dict(beam_this, w=w_beam), {"jz": "jz_beam"}, sal_fields, g,
            cfg.beams, pc, order, cfg.normalized_units, only_salame=True)
        jzb = sal_fields["jz_beam"]
        # Sy = -mu0 dy jzb, Sx = +mu0 dx jzb (ref Salame.cpp:192-225)
        sy_i = -pc.mu0 * sl.ddy_interior(jzb, g)
        sx_i = pc.mu0 * sl.ddx_interior(jzb, g)
        chi_i = sl.interior(this["chi"], g)
        b = mg.solve(jnp.zeros((2, g.ny, g.nx), dtype),
                     jnp.stack([sy_i, sx_i]), chi_i,
                     tol_rel=cfg.MG_tolerance_rel,
                     tol_abs=cfg.MG_tolerance_abs, max_iters=40)
        bx_sal = sl.set_interior(jnp.zeros_like(jzb), b[0], g)
        by_sal = sl.set_interior(jnp.zeros_like(jzb), b[1], g)

        if cfg.salame_do_advance:
            # SalameOnlyAdvancePlasma (ref Salame.cpp:262-338): temp momenta
            # from the SALAME-only B field, deposited at the temp positions
            dep2 = {"jx": jnp.zeros_like(jzb), "jy": jnp.zeros_like(jzb)}
            for p, p_tmp, pcfg in zip(plasmas, p_tmps, cfg.plasmas):
                bx_p, by_p = gather_fields(p["x_prev"], p["y_prev"],
                                           {"Bx": bx_sal, "By": by_sal},
                                           ["Bx", "By"], g, order)
                q_m = pcfg.charge / pcfg.mass
                if pcfg.can_ionize:
                    q_m = q_m * p["ion_lev"].astype(dtype)
                p_sal = dict(p_tmp,
                             ux=1.5 * dz * q_m * by_p,
                             uy=-1.5 * dz * q_m * bx_p)
                dep2, _ = pl.deposit_plasma(p_sal, ["jx", "jy"], dep2, g,
                                            pcfg, pc, order,
                                            cfg.normalized_units,
                                            use_laser=False)
        else:
            # jx = dz chi By / mu0, jy = -dz chi Bx / mu0 (Salame.cpp:228-259)
            dep2 = {"jx": 1.5 * dz * this["chi"] * by_sal / pc.mu0,
                    "jy": -1.5 * dz * this["chi"] * bx_sal / pc.mu0}
        ez_only_salame = _solve_ez(dep2["jx"], dep2["jy"])

        # STEP 3: weighted average W (ref Salame.cpp:341-420)
        jz_i = sl.interior(jzb, g)
        sum_jz = jnp.sum(jz_i)
        sum_jz_safe = jnp.where(sum_jz == 0.0, 1.0, sum_jz)
        avg_t = jnp.sum(jz_i * sl.interior(ez_target, g)) / sum_jz_safe
        avg_n = jnp.sum(jz_i * sl.interior(ez_no_salame, g)) / sum_jz_safe
        avg_o = jnp.sum(jz_i * sl.interior(ez_only_salame, g)) / sum_jz_safe
        # user target function of (zeta of next slice, zeta_initial, Ez)
        zeta_next = g.prob_lo[2] + (islice.astype(dtype) - 0.5) * dz
        avg_t = target_fn(zeta_next, zeta_initial, avg_t)
        avg_o_safe = jnp.where(avg_o == 0.0, 1.0, avg_o)
        W = (avg_t - avg_n) / avg_o_safe + 1.0
        bad = (W < 0.0) | overloaded
        W = jnp.where(bad | converged, jnp.where(bad, 0.0, 1.0), W)
        overloaded = overloaded | bad
        converged = converged | (jnp.abs(W - 1.0) < cfg.salame_tolerance)

        # multiply SALAME beam weights only
        w_beam = jnp.where(sal_mask, w_beam * W, w_beam)

        # STEP 4: recompute This Bx/By with the new weight (all beams)
        dep3 = {"jz_beam": jnp.zeros_like(jzb)}
        dep3 = bm.deposit_beam_slice(
            dict(beam_this, w=w_beam), {"jz": "jz_beam"}, dep3, g, cfg.beams,
            pc, order, cfg.normalized_units)
        this = dict(this, jz_beam=dep3["jz_beam"])
        # beam FD Sx/Sy + plasma backup
        dz2_inv = 1.0 / (2.0 * dz)
        dx_jzb = sl.ddx_interior(this["jz_beam"], g)
        dy_jzb = sl.ddy_interior(this["jz_beam"], g)
        dz_jxb = (sl.interior(f_prev["jx_beam"], g)
                  - sl.interior(f_next["jx_beam"], g)) * dz2_inv
        dz_jyb = (sl.interior(f_prev["jy_beam"], g)
                  - sl.interior(f_next["jy_beam"], g)) * dz2_inv
        sy_new = pc.mu0 * (-dy_jzb + dz_jyb) + sl.interior(sy_back, g)
        sx_new = -pc.mu0 * (-dx_jzb + dz_jxb) + sl.interior(sx_back, g)
        this = dict(this,
                    Sy=sl.set_interior(this["Sy"], sy_new, g),
                    Sx=sl.set_interior(this["Sx"], sx_new, g))
        b0 = jnp.stack([sl.interior(this["Bx"], g),
                        sl.interior(this["By"], g)])
        bb = mg.solve(b0, jnp.stack([sy_new, sx_new]), chi_i,
                      tol_rel=cfg.MG_tolerance_rel,
                      tol_abs=cfg.MG_tolerance_abs, max_iters=40)
        this = dict(this,
                    Bx=sl.set_interior(this["Bx"], bb[0], g),
                    By=sl.set_interior(this["By"], bb[1], g))

    beam_this = dict(beam_this, w=w_beam)
    sal_state = {"ez_target": ez_target, "zeta_initial": zeta_initial,
                 "prev_was_salame": jnp.ones((), bool),
                 "overloaded": overloaded, "W_last": W,
                 "dbg": jnp.stack([avg_t, avg_n, avg_o, sum_jz])}
    return this, beam_this, sal_state


def empty_salame_state(geom, dtype):
    return {"ez_target": jnp.zeros(geom.slice_shape, dtype),
            "zeta_initial": jnp.zeros((), dtype),
            "prev_was_salame": jnp.zeros((), bool),
            "overloaded": jnp.zeros((), bool),
            "W_last": jnp.zeros((), dtype),
            "dbg": jnp.zeros((4,), dtype)}
