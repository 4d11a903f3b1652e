"""Simulation driver: configuration, the jitted time step, the Evolve loop.

A JAX re-design of the Hipace driver singleton (ref:
src/Hipace.cpp:74-554). One full time step — plasma re-init, neutralizing
background, the zeta-sweep scan, beam re-binning — is a single jitted
function; the Python loop over time steps handles IO and (later) the
multi-device pipeline.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import make_constants
from ..geometry import Geometry
from ..parser import Inputs
from ..particles import beam as bm
from ..particles import plasma as pl
from ..diagnostics.openpmd import OpenPMDWriter
from .step import (SimConfig, init_field_state, make_slice_step, empty_slip,
                   zero_moments)
from ..utils import adaptive_dt as adt


class Simulation:
    """End-to-end simulation (ref main.cpp:15-25: InitData + Evolve)."""

    def __init__(self, inputs: Inputs, dtype=None, verbose: int | None = None):
        # persistent XLA compilation cache (utils/backend.py): the
        # production step takes minutes to compile cold
        from ..utils.backend import enable_compilation_cache
        enable_compilation_cache()
        self.inputs = inputs
        self.normalized_units = inputs.query("hipace.normalized_units", False, bool)
        self.pc = make_constants(self.normalized_units)
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype

        depos_order = inputs.query("hipace.depos_order_xy", 2, int)
        self.geom = Geometry.from_inputs(inputs, depos_order)
        from ..fields.mr import parse_mr_levels
        self.mr_levels = parse_mr_levels(inputs, self.geom)

        # ref parameters.rst:159-161: print all input parameters
        if inputs.query("hipace.output_input", False, bool):
            for k in sorted(inputs._raw):
                print(f"{k} = {inputs._raw[k]}")

        self.max_step = inputs.query("max_step", 0, int)
        self.max_time = inputs.query("hipace.max_time", float("inf"))
        self._has_last_step = False
        self.adt_cfg = adt.AdaptiveTimeStepConfig.from_inputs(inputs)
        if self.adt_cfg.enabled:
            self.dt = 0.0  # set after beam init from the initial moments
        else:
            self.dt = inputs.query("hipace.dt", 0.0)
        self.initial_time = 0.0
        self.verbose = verbose if verbose is not None else \
            inputs.query("hipace.verbose", 1, int)

        solver = inputs.query("hipace.bxby_solver", "explicit", str)
        particle_bc = inputs.query("boundary.particle", "Absorbing", str)

        plasma_names = inputs.query_list("plasmas.names", [], str)
        if plasma_names == ["no_plasma"]:
            plasma_names = []
        plasma_cfgs = [
            pl.PlasmaConfig.from_inputs(inputs, n, self.pc, particle_bc)
            for n in plasma_names]

        # field ionization wiring: attach ADK constants, compute product
        # spawn capacities and slot bases (static per-parent slot blocks)
        bg_si = inputs.query("hipace.background_density_SI", 0.0)
        ionization_pairs = []
        self._spawn_extra = [0] * len(plasma_cfgs)
        for i, pcfg in enumerate(plasma_cfgs):
            if pcfg.can_ionize and pcfg.ionization_product:
                import dataclasses as _dc
                adk = pl.adk_constants(pcfg, self.geom.dz,
                                       self.normalized_units, bg_si)
                plasma_cfgs[i] = _dc.replace(pcfg, adk=adk)
                j = plasma_names.index(pcfg.ionization_product)
                # static counts incl. fine-patch particles (spawn slots
                # are addressed by parent lane index, so only capacity
                # depends on the count)
                parent_count = pl.plasma_count(pcfg, self.geom, self.dtype,
                                               self.normalized_units)
                own = pl.plasma_count(plasma_cfgs[j], self.geom, self.dtype,
                                      self.normalized_units)
                spawn_base = own + self._spawn_extra[j]
                self._spawn_extra[j] += parent_count * len(adk)
                ionization_pairs.append(
                    (i, j, spawn_base, plasma_cfgs[j].init_ion_lev))
        self.plasma_cfgs = tuple(plasma_cfgs)
        self.ionization_pairs = tuple(ionization_pairs)

        # MR at >= 2x refinement with only coarse-spaced plasma aliases the
        # fine-level charge so badly the wake can invert (1 coarse ppc
        # lands in 1 of every ratio^2 fine cells); the reference's fine
        # plasma patch exists for this (ref PlasmaParticleContainerInit
        # .cpp:95-160). Warn — same silent behavior as the reference, but
        # the footgun is too sharp to leave unflagged.
        if self.mr_levels and self.plasma_cfgs and not any(
                p.fine_patch_expr for p in self.plasma_cfgs):
            ratio = self.geom.dx / min(lv.geom.dx for lv in self.mr_levels)
            if ratio >= 2.0:
                import sys as _sys
                print(
                    "WARNING: mesh refinement at >=2x without any "
                    "plasma.fine_patch/fine_ppc: the fine-level plasma "
                    "charge will be aliased (1 coarse ppc per "
                    f"~{ratio * ratio:.0f} fine cells) and in-patch "
                    "fields unreliable. Define <plasma>.fine_patch(x,y) "
                    "and <plasma>.fine_ppc covering the patch.",
                    file=_sys.stderr)

        beam_names = inputs.query_list("beams.names", [], str)
        if beam_names == ["no_beam"]:
            beam_names = []
        self.beam_cfgs = tuple(
            bm.BeamConfig.from_inputs(inputs, n, self.pc, self.geom,
                                      self.normalized_units)
            for n in beam_names)

        from ..fields.laser import LaserConfig, make_laser_geometry
        laser_cfg = LaserConfig.from_inputs(inputs, self.pc)
        self.laser_geom = None
        self.laser_zeta = None
        if laser_cfg.use_laser:
            self.laser_geom, lz_lo, lz_hi = make_laser_geometry(inputs,
                                                                self.geom)
            self.laser_zeta = (lz_lo, lz_hi)
        self.laser_stream = None  # (n00, nm1) complex (nz, NY, NX) arrays
        if laser_cfg.from_file:
            from ..fields.laser import load_laser_from_file
            env = load_laser_from_file(laser_cfg, self.laser_geom,
                                       self.dtype, zeta_lo=self.laser_zeta[0],
                                       nz_global=self.geom.nz,
                                       clight=self.pc.c)
            # nm1 is not read at step 0 (two-level scheme); seed it with n00
            self.laser_stream = (env, env)

        self.output_period = inputs.query("diagnostic.output_period", -1, int)
        self.beam_output_period = inputs.query(
            "diagnostic.beam_output_period", self.output_period, int)
        beam_data = inputs.query_list("diagnostic.beam_data", ["all"], str)
        if beam_data == ["all"]:
            self.beam_data = tuple(beam_names)
        elif beam_data == ["none"]:
            self.beam_data = ()
        else:
            self.beam_data = tuple(beam_data)
        solver_name = solver
        self.diags, field_data, dep_rho, dep_rho_ind = self._parse_diags(
            inputs, solver_name == "explicit", laser_cfg.use_laser,
            plasma_names)

        self.cfg = SimConfig(
            geom=self.geom,
            pc=self.pc,
            use_laser=laser_cfg.use_laser,
            laser=laser_cfg if laser_cfg.use_laser else None,
            laser_geom=self.laser_geom,
            laser_zeta=self.laser_zeta,
            normalized_units=self.normalized_units,
            explicit=(solver == "explicit"),
            depos_order_xy=depos_order,
            depos_derivative_type=inputs.query(
                "hipace.depos_derivative_type", 2, int),
            do_beam_jx_jy_deposition=inputs.query(
                "hipace.do_beam_jx_jy_deposition", True, bool),
            do_beam_jz_minus_rho=inputs.query(
                "hipace.do_beam_jz_minus_rho", False, bool),
            open_boundary=(inputs.query("boundary.field", "Dirichlet",
                                        str).lower() == "open"),
            deposit_rho=dep_rho,
            deposit_rho_individual=dep_rho_ind,
            diags=self.diags,
            insitu_laser_period=inputs.query("lasers.insitu_period", 0, int),
            do_symmetrize=inputs.query("fields.do_symmetrize", False, bool),
            predcorr_B_error_tolerance=inputs.query(
                "hipace.predcorr_B_error_tolerance", 4e-2),
            predcorr_max_iterations=inputs.query(
                "hipace.predcorr_max_iterations", 30, int),
            predcorr_B_mixing_factor=inputs.query(
                "hipace.predcorr_B_mixing_factor", 0.05),
            MG_tolerance_rel=inputs.query("hipace.MG_tolerance_rel", 1e-4),
            MG_tolerance_abs=inputs.query("hipace.MG_tolerance_abs", 0.0),
            poisson_solver=inputs.query("fields.poisson_solver",
                                        "FFTDirichletFast", str),
            plasmas=self.plasma_cfgs,
            beams=self.beam_cfgs,
            diag_comps=tuple(field_data),
            background_density_SI=inputs.query(
                "hipace.background_density_SI", 0.0),
            grid_current=self._grid_current_cfg(inputs),
            ionization_pairs=self.ionization_pairs,
            insitu_beam_period=max(
                [inputs.query(f"{b.name}.insitu_period",
                              inputs.query("beams.insitu_period", 0, int), int)
                 for b in self.beam_cfgs] or [0]),
            insitu_field_period=inputs.query("fields.insitu_period", 0, int),
            insitu_plasma_period=max(
                [inputs.query(f"{p.name}.insitu_period",
                              inputs.query("plasmas.insitu_period", 0, int),
                              int)
                 for p in self.plasma_cfgs] or [0]),
            insitu_radius=inputs.query("beams.insitu_radius",
                                       float("inf")),
            salame_n_iter=inputs.query("hipace.salame_n_iter", 3, int),
            salame_do_advance=inputs.query("hipace.salame_do_advance",
                                           True, bool),
            salame_tolerance=inputs.query("hipace.salame_relative_tolerance",
                                          1e-4),
            salame_target_expr=(
                inputs.raw("hipace.salame_Ez_target(zeta,zeta_initial,"
                           "Ez_initial)") or "Ez_initial"),
            salame_consts=tuple(sorted(
                (k, float(v)) for k, v in inputs.my_constants.items()
                if isinstance(v, (int, float)))),
            collisions=self._collision_cfg(inputs, plasma_names,
                                           [b.name for b in self.beam_cfgs]),
            # scatter-add/gather by default: on an H100 at 1023^2 it ran
            # the transverse benchmark at 213 slices/s against 17.4 for
            # the banded one-hot path (PERF.md, PR 1)
            use_banded=inputs.query("hipace.use_banded", False, bool),
            banded_W=inputs.query("hipace.banded_W", SimConfig.banded_W,
                                  int),
            banded_K=inputs.query("hipace.banded_K",
                                  self._banded_auto_k(inputs), int),
            banded_gather_K=inputs.query("hipace.banded_gather_K",
                                         self._banded_auto_k(inputs), int),
            banded_WX=inputs.query("hipace.banded_WX", 0, int),
            slip_cap=inputs.query("hipace.slip_cap", 64, int),
            beam_chunk=inputs.query("hipace.beam_chunk", 0, int),
            beam_buckets=inputs.query("hipace.beam_buckets", 4, int),
            # ref plasmas.reorder_period (PlasmaParticleContainer sorting
            # cadence) maps to the banded sort period. 0 = auto: 2 when no
            # species ionizes, else 1 (append-mode spawning needs the
            # per-slice valid-first compaction). Exactness does not depend
            # on the period — drifted lanes take the exact corrective
            # pass.
            banded_sort_period=inputs.query(
                "hipace.banded_sort_period",
                inputs.query("plasmas.reorder_period", 0, int), int),
            mr_levels=self.mr_levels,
            plasma_pusher=inputs.query("hipace.plasma_pusher", "leapfrog",
                                       str),
        )
        if self.cfg.banded_sort_period == 0:   # auto
            period = 1 if self.ionization_pairs else 2
            self.cfg = dataclasses.replace(self.cfg,
                                           banded_sort_period=period)
        if self.cfg.use_banded and self.ionization_pairs \
                and self.cfg.banded_sort_period != 1:
            raise ValueError(
                "hipace.use_banded with ionization requires "
                "hipace.banded_sort_period=1 (append-mode spawning relies "
                "on the per-slice valid-first compaction)")
        # per-species pad lanes (ionization product slots + banded chunk
        # padding) — on cfg so every init path (serial + pipelined) agrees
        pads = []
        for i, pcfg in enumerate(self.plasma_cfgs):
            extra = self._spawn_extra[i] if hasattr(self, "_spawn_extra") \
                else 0
            if self.cfg.use_banded:
                kd, kg = self.cfg.banded_K, self.cfg.banded_gather_K
                km = max(kd, kg)
                if km % min(kd, kg) != 0:
                    raise ValueError("hipace.banded_K and "
                                     "hipace.banded_gather_K must divide "
                                     "one another")
                n = pl.plasma_count(pcfg, self.geom, self.dtype,
                                    self.normalized_units) + extra
                extra += (-n) % km
            pads.append(extra)
        self.cfg = dataclasses.replace(self.cfg, plasma_pad=tuple(pads))
        self._insitu_writers = {}

        seed = inputs.query("hipace.random_seed", 0, int)
        self.key = jax.random.PRNGKey(seed)

        # ---- beam init (flat) + capacity planning + binning
        self.beams_flat = []
        for bcfg in self.beam_cfgs:
            self.key, sub = jax.random.split(self.key)
            self.beams_flat.append(
                bm.init_beam(bcfg, self.geom, sub, dtype,
                             self.normalized_units, self.pc))
        self.beam_merged = (bm.merge_beams(self.beams_flat)
                            if self.beams_flat else _empty_beam(dtype))
        self.beam_cap = self._plan_capacity()
        self.binned = bm.bin_beam(self.beam_merged, self.geom,
                                  self.beam_cap if self.beams_flat else 1)

        # initial adaptive dt from the initial beam moments
        # (ref AdaptiveTimeStep.cpp GatherMinUzSlice(initial=true) + Hipace.cpp:275-281)
        self._min_uz_mq = float("inf")
        if self.adt_cfg.enabled and self.beam_cfgs:
            mom = self._initial_beam_moments()
            self.dt, self._min_uz_mq = adt.calculate_from_min_uz(
                self.adt_cfg, mom, self.beam_cfgs[0], self.plasma_cfgs,
                self.pc, 0.0, 1e30)

        self.time = self.initial_time
        self.writer = OpenPMDWriter(
            inputs.query("hipace.file_prefix", "diags/hdf5", str),
            self.normalized_units,
            backend=inputs.query("hipace.openpmd_backend", "h5", str))

        self._step_fn = jax.jit(partial(self._time_step))

    def _parse_diags(self, inputs, explicit, use_laser, plasma_names):
        """Build the named field diagnostics (ref Diagnostic.cpp; parameter
        docs parameters.rst:932-1110). Returns (diags, legacy_union_comps,
        deposit_rho, deposit_rho_individual)."""
        from .step import DiagConfig
        g = self.geom
        inf = float("inf")
        default_names = ["lev0"] + (["laser_diag"] if use_laser else [])
        names = inputs.query_list("diagnostic.names", default_names, str)
        if names == ["no_field_diag"]:
            names = []
        if explicit:
            # field_data=all writes every allocated comp, incl. chi/Sx/Sy
            # for the explicit solver (matches the reference's checksum
            # benchmarks, e.g. blowout_wake.Serial.json)
            all_comps = ["ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi",
                         "jx_beam", "jy_beam", "jz_beam", "jx", "jy",
                         "rhomjz", "chi", "Sx", "Sy"]
            avail = set(all_comps) | {"rho"}
        else:
            all_comps = ["ExmBy", "EypBx", "Ez", "Bx", "By", "Bz", "Psi",
                         "jx", "jy", "jz", "rhomjz"]
            avail = set(all_comps) | {"rho"} | ({"chi"} if use_laser
                                                else set())
        if use_laser:
            # aabs is an allocated comp with lasers on (ref
            # Fields.cpp:89,137), so field_data=all writes it
            avail |= {"aabs"}
            all_comps = all_comps + ["aabs"]
        avail |= {f"rho_{p}" for p in plasma_names}
        dd = inputs.prefix("diagnostic")
        dep_rho = inputs.query("hipace.deposit_rho", False, bool)
        dep_rho_ind = inputs.query("hipace.deposit_rho_individual",
                                   False, bool)

        def patch_range(lo, hi, plo, d, n):
            import math
            i0 = 0 if lo == -inf else max(0, int(math.ceil(
                (lo - plo) / d - 0.5)))
            i1 = n - 1 if hi == inf else min(n - 1, int(math.floor(
                (hi - plo) / d - 0.5)))
            return (i0, max(i0, i1))

        diags = []
        for name in names:
            pp = inputs.prefix(name)

            def q(k, dflt, ty=None):
                return pp.query(k, dd.query(k, dflt, ty), ty)

            base_default = {"laser_diag": "laser"}.get(name, "level_0")
            base = q("base_geometry", base_default, str)
            lev_idx = 0
            if base in ("level_1", "level_2"):
                lev_idx = int(base[-1])
                if lev_idx > len(self.mr_levels):
                    continue  # level not configured
            if base == "laser" and not use_laser:
                continue
            dgeom = (self.mr_levels[lev_idx - 1].geom if lev_idx > 0
                     else self.laser_geom if base == "laser"
                     and self.laser_geom is not None else self.geom)
            period = pp.query("output_period",
                              dd.query("output_period",
                                       self.output_period, int), int)
            dtyp = q("diag_type", "xyz", str)
            coars = tuple(pp.query_list(
                "coarsening", dd.query_list("coarsening", [1, 1, 1], int),
                int))
            ghosts = q("include_ghost_cells", False, bool)
            default_fd = ["laserEnvelope"] if base == "laser" else ["all"]
            fd = pp.query_list("field_data",
                               dd.query_list("field_data", default_fd, str),
                               str)
            comps: list = []
            for tok in fd:
                if tok == "all":
                    comps = (["laserEnvelope"] if base == "laser"
                             else list(all_comps))
                elif tok == "none":
                    comps = []
                elif tok.startswith("remove_"):
                    comps = [c for c in comps if c != tok[len("remove_"):]]
                elif tok == "laserEnvelope":
                    if base == "laser":
                        comps.append(tok)
                else:
                    if tok == "rho":
                        dep_rho = True
                    if tok.startswith("rho_") and tok[4:] in plasma_names:
                        dep_rho_ind = True
                    if tok in avail:
                        comps.append(tok)
            seen = set()
            comps = [c for c in comps
                     if not (c in seen or seen.add(c))]
            if not comps:
                continue
            plo = pp.query_list("patch_lo",
                                dd.query_list("patch_lo", [-inf] * 3), float)
            phi = pp.query_list("patch_hi",
                                dd.query_list("patch_hi", [inf] * 3), float)
            if base == "laser" and dgeom is not self.geom:
                # laser-grid diag: transverse patch in the laser grid;
                # z range clipped to the laser zeta span
                pz = patch_range(plo[2], phi[2], g.prob_lo[2], g.dz, g.nz)
                pz = (max(pz[0], self.laser_zeta[0]),
                      min(pz[1], self.laser_zeta[1]))
                diags.append(DiagConfig(
                    name=name, base=base, diag_type=dtyp,
                    comps=tuple(comps), coarsening=coars,
                    include_ghosts=bool(ghosts),
                    patch_x=patch_range(plo[0], phi[0], dgeom.prob_lo[0],
                                        dgeom.dx, dgeom.nx),
                    patch_y=patch_range(plo[1], phi[1], dgeom.prob_lo[1],
                                        dgeom.dy, dgeom.ny),
                    patch_z=pz, period=period))
                continue
            if lev_idx > 0:
                # fine diag: transverse patch in the fine grid; z range in
                # global slice indices, clipped to the level's zeta span
                lv = self.mr_levels[lev_idx - 1]
                pz = patch_range(plo[2], phi[2], g.prob_lo[2], g.dz, g.nz)
                pz = (max(pz[0], lv.zeta_lo), min(pz[1], lv.zeta_hi))
                diags.append(DiagConfig(
                    name=name, base=base, diag_type=dtyp,
                    comps=tuple(comps), coarsening=coars,
                    include_ghosts=bool(ghosts),
                    patch_x=patch_range(plo[0], phi[0], dgeom.prob_lo[0],
                                        dgeom.dx, dgeom.nx),
                    patch_y=patch_range(plo[1], phi[1], dgeom.prob_lo[1],
                                        dgeom.dy, dgeom.ny),
                    patch_z=pz, period=period))
                continue
            diags.append(DiagConfig(
                name=name, base=base, diag_type=dtyp, comps=tuple(comps),
                coarsening=coars, include_ghosts=bool(ghosts),
                patch_x=patch_range(plo[0], phi[0], g.prob_lo[0], g.dx,
                                    g.nx),
                patch_y=patch_range(plo[1], phi[1], g.prob_lo[1], g.dy,
                                    g.ny),
                patch_z=patch_range(plo[2], phi[2], g.prob_lo[2], g.dz,
                                    g.nz),
                period=period))

        # legacy union: comps served by the full-interior xyz stack (kept
        # even for period-0 diags so res["diag"] stays available to callers)
        union: list = []
        ident = []
        for dg in diags:
            is_id = (dg.base == "level_0" and dg.diag_type == "xyz"
                     and dg.coarsening[:2] == (1, 1)
                     and not dg.include_ghosts
                     and dg.patch_x == (0, g.nx - 1)
                     and dg.patch_y == (0, g.ny - 1))
            ident.append(is_id)
            if is_id:
                union.extend(c for c in dg.comps if c not in union)
        # period-0 diags never write; drop non-identity ones so the scan
        # doesn't emit device-side payloads for them
        kept = tuple(dg for dg, is_id in zip(diags, ident)
                     if dg.period != 0 or is_id)
        return kept, union, dep_rho, dep_rho_ind

    @staticmethod
    def _collision_cfg(inputs, plasma_names, beam_names):
        """ref CoulombCollision.cpp:8-60: hipace.collisions + <name>.species."""
        names = inputs.query_list("hipace.collisions", [], str)
        out = []
        for cname in names:
            sp = inputs.get_list(f"{cname}.species", str)
            clog = inputs.query(f"{cname}.CoulombLog", -1.0)
            if sp[0] in beam_names:
                out.append(("bp", beam_names.index(sp[0]),
                            plasma_names.index(sp[1]), False, clog))
            elif sp[1] in beam_names:
                out.append(("bp", beam_names.index(sp[1]),
                            plasma_names.index(sp[0]), False, clog))
            else:
                out.append(("pp", plasma_names.index(sp[0]),
                            plasma_names.index(sp[1]), sp[0] == sp[1], clog))
        return tuple(out)

    def _banded_auto_k(self, inputs) -> int:
        """Default banded chunk size, scaled so a chunk's row span fits the
        W window at ~1 particle/cell/row: K ~ (W-6)*nx rounded down to a
        power of two, capped at 8192.
        Chunks that still overflow (vacuum gaps, absorbing boundaries) are
        handled exactly — but slowly — by the corrective pass."""
        w = inputs.query("hipace.banded_W", SimConfig.banded_W, int)
        # margin for thinned rows: blown-out cavities reduce row occupancy
        # (a bubble spanning ~half the row widens a chunk's row span ~2x),
        # the widest stencil is 5 taps (centered derivative, order 2), and
        # chunks that outgrow the W window fall onto the (slow, exact)
        # corrective pass — so leave W - 11 rows of nominal span
        cap = max(256, (w - 11) * self.geom.nx)
        k = 256
        while k * 2 <= min(8192, cap):
            k *= 2
        return k

    @staticmethod
    def _grid_current_cfg(inputs):
        """ref utils/GridCurrent.cpp: grid_current.use_grid_current etc."""
        pp = inputs.prefix("grid_current")
        if not pp.query("use_grid_current", False, bool):
            return None
        return (pp.get("peak_current_density"),
                tuple(pp.get_list("position_mean")),
                tuple(pp.get_list("position_std")))

    # ------------------------------------------------------------------
    def _plan_capacity(self) -> int:
        if not self.beams_flat:
            return 1
        z = np.asarray(self.beam_merged["z"])
        v = np.asarray(self.beam_merged["valid"])
        isl = np.floor((z - self.geom.prob_lo[2]) / self.geom.dz).astype(int)
        isl = isl[v & (isl >= 0) & (isl < self.geom.nz)]
        if isl.size == 0:
            return 1
        counts = np.bincount(isl, minlength=self.geom.nz)
        return int(counts.max() * 1.25) + 16

    # ------------------------------------------------------------------
    def _init_plasma_state(self, key, c_t):
        states = []
        pads = self.cfg.plasma_pad or (0,) * len(self.plasma_cfgs)
        for i, pcfg in enumerate(self.plasma_cfgs):
            key, sub = jax.random.split(key)
            st = pl.init_plasma(pcfg, self.geom, sub, self.dtype, c_t,
                                self.normalized_units,
                                ab5=self.cfg.plasma_pusher == "ab5")
            states.append(pl.pad_plasma(st, pads[i]))
        return states

    def _time_step(self, binned, time, dt, key, step=0, laser_stream=None):
        """One full time step: the jitted hot path."""
        cfg = self.cfg
        g = self.geom
        fields = init_field_state(cfg, self.dtype)

        # fresh plasma for this step (ref Hipace.cpp:450)
        plasmas = self._init_plasma_state(key, self.pc.c * time)

        # neutralizing background (ref Hipace.cpp:455-472). With the
        # banded kernels on, stripe-snake sort the fresh plasma once here
        # so the deposit takes the banded path with few corrective passes;
        # the slice loop re-sorts anyway, so the order change is free and
        # the deposit itself is order-independent.
        from .step import _banded_opts, _row_sort, banded_stripe_h
        banded = _banded_opts(cfg)
        if banded is not None:
            stripe_h = banded_stripe_h(cfg)
            static_ion = not any(pc.can_ionize for pc in self.plasma_cfgs)
            plasmas = [_row_sort(p, g, stripe_h, static_ion)
                       for p in plasmas]
        rhomjz_ion = fields["RhomJzIons"]["rhomjz"]
        for p, pcfg in zip(plasmas, self.plasma_cfgs):
            if pcfg.neutralize_background:
                tmp, _ = pl.deposit_plasma(
                    p, ["rhomjz"], {"rhomjz": rhomjz_ion}, g, pcfg, self.pc,
                    cfg.depos_order_xy, cfg.normalized_units,
                    flip_charge=True, banded=banded)
                rhomjz_ion = tmp["rhomjz"]
        fields = dict(fields, RhomJzIons={"rhomjz": rhomjz_ion})
        # fine-level neutralizing background: deposit per level with the
        # tag predicate (default) or interpolate from level 0
        # (hipace.interpolate_neutralizing_background, ref Hipace.cpp:455-471)
        if cfg.mr_levels:
            from ..fields.mr import in_level_bounds, LevelCoupler
            interp_bg = self.inputs.query(
                "hipace.interpolate_neutralizing_background", False, bool)
            parent_geom, parent_rhom = g, rhomjz_ion
            for i, lv in enumerate(cfg.mr_levels):
                fion = fields[f"mr{i + 1}"]["RhomJzIons"]["rhomjz"]
                if interp_bg:
                    coup = LevelCoupler(parent_geom, lv.geom, self.dtype)
                    fion = coup.up_full(parent_rhom)
                else:
                    for p, pcfg in zip(plasmas, self.plasma_cfgs):
                        if pcfg.neutralize_background:
                            tmp, _ = pl.deposit_plasma(
                                p, ["rhomjz"], {"rhomjz": fion}, lv.geom,
                                pcfg, self.pc, cfg.depos_order_xy,
                                cfg.normalized_units, flip_charge=True,
                                extra_mask=in_level_bounds(p["x"], p["y"],
                                                           lv.geom),
                                geom0=g)
                            fion = tmp["rhomjz"]
                fields[f"mr{i + 1}"] = dict(fields[f"mr{i + 1}"],
                                            RhomJzIons={"rhomjz": fion})
                parent_geom, parent_rhom = lv.geom, fion

        carry = {
            "fields": fields,
            "plasma": plasmas,
            "slip": empty_slip(cfg.slip_cap, self.dtype),
            "dt": dt,
            "time": time,
            "min_uz": jnp.asarray(jnp.inf, self.dtype),
            "beam_moments": zero_moments(self.dtype),
            "step": step,
        }
        if cfg.ionization_pairs or cfg.collisions:
            key, sub = jax.random.split(key)
            carry["key"] = sub
        if cfg.salame_active:
            from .salame import empty_salame_state
            carry["salame"] = empty_salame_state(g, self.dtype)
        nz = g.nz
        if cfg.use_laser:
            from ..fields.laser import laser_empty_state, initial_chi
            lg = cfg.laser_geom if cfg.laser_geom is not None else g
            carry["laser"] = laser_empty_state(lg, self.dtype)
            carry["chi_initial"] = initial_chi(
                cfg.laser, self.plasma_cfgs, lg, self.pc, self.pc.c * time,
                self.dtype)
        int_diags = [dg for dg in cfg.diags
                     if dg.diag_type == "xy_integrated"]
        if int_diags:
            from .step import diag_slice_shape

            def _dgeom(dg):
                if dg.base.startswith("level_") and dg.base != "level_0":
                    return cfg.mr_levels[int(dg.base[-1]) - 1].geom
                return g

            carry["diag_int"] = {
                dg.name: jnp.zeros(
                    diag_slice_shape(dg, _dgeom(dg)),
                    jnp.complex64 if "laserEnvelope" in dg.comps
                    and self.dtype == jnp.float32
                    else jnp.complex128 if "laserEnvelope" in dg.comps
                    else self.dtype)
                for dg in int_diags}

        beam_next = {k: jnp.concatenate([jnp.zeros_like(v[:1]), v[:-1]])
                     for k, v in binned.items() if k != "n_dropped"}
        beam_next["valid"] = beam_next["valid"].at[0].set(False)
        xs = {
            "islice": jnp.arange(nz),
            "beam_this": {k: v for k, v in binned.items() if k != "n_dropped"},
            "beam_next": beam_next,
        }
        if cfg.use_laser:
            ctype = jnp.complex64 if self.dtype == jnp.float32 \
                else jnp.complex128
            if laser_stream is None:
                lg = cfg.laser_geom if cfg.laser_geom is not None else g
                zc = jnp.zeros((nz,) + lg.slice_shape, ctype)
                laser_stream = (zc, zc)
            xs["laser_n00"] = laser_stream[0]
            xs["laser_nm1"] = laser_stream[1]
        slice_step = make_slice_step(cfg, self.dtype)
        carry, ys = jax.lax.scan(slice_step, carry, xs, reverse=True)

        # merge emitted beam + final slip, re-bin by new z
        flat = {}
        for k in bm.BEAM_ATTRS + bm.BEAM_INT_ATTRS + ("valid",):
            flat[k] = jnp.concatenate([ys["beam_out"][k].reshape(-1),
                                       carry["slip"][k]])
        new_binned = bm.bin_beam(flat, g, self.beam_cap)

        out = {
            "binned": new_binned,
            "diag": ys["diag"],
            "min_uz": carry["min_uz"],
            "beam_moments": carry["beam_moments"],
            "bxby_iters": ys["bxby_iters"],
        }
        if cfg.use_laser:
            # stream for the next step: n00 <- np1, nm1 <- n00
            out["laser_stream"] = (ys["laser_np1"], ys["laser_n00"])
        for k in ("insitu_beam", "insitu_field", "insitu_plasma",
                  "insitu_laser", "salame_W", "salame_dbg", "salame_is_sal"):
            if k in ys:
                out[k] = ys[k]
        for k in ys:
            if k.startswith("diagf_"):
                out[k] = ys[k]
        if int_diags:
            for dg in int_diags:
                out["diag_int_" + dg.name] = carry["diag_int"][dg.name]
        if "banded_lost" in ys:
            out["banded_lost"] = jnp.sum(ys["banded_lost"])
        if "slip_overflow" in ys:
            out["slip_overflow"] = jnp.sum(ys["slip_overflow"])
            out["slip_need"] = jnp.max(ys["slip_need"])
        if "spawn_lost" in ys:
            out["spawn_lost"] = jnp.sum(ys["spawn_lost"])
        return out

    # ------------------------------------------------------------------
    def _grow_slip_cap(self, need: int, step) -> None:
        """Grow hipace.slip_cap (next power of two covering `need`, at
        least doubled) and rebuild the jitted step.  Used by the exact
        slipped-beam handling: the reference moves ALL slipped particles
        to the Next slice (ref SliceSort.H:16-24); here the fixed-capacity
        carry is re-sized on the host and the step re-run, so no particle
        is ever emitted partially pushed."""
        import sys
        new_cap = max(self.cfg.slip_cap * 2,
                      1 << max(1, int(need) - 1).bit_length())
        print(f"NOTE: step {step}: growing hipace.slip_cap "
              f"{self.cfg.slip_cap} -> {new_cap} (a slice had {need} "
              "slipped beam particles) and re-running the step exactly",
              file=sys.stderr)
        self.cfg = dataclasses.replace(self.cfg, slip_cap=new_cap)
        self._step_fn = jax.jit(partial(self._time_step))

    def run_step(self, step: int):
        self.key, sub = jax.random.split(self.key)
        for _retry in range(16):
            res = self._step_fn(self.binned,
                                jnp.asarray(self.time, self.dtype),
                                jnp.asarray(self.dt, self.dtype), sub,
                                jnp.asarray(step, jnp.int32),
                                self.laser_stream)
            over = int(res["slip_overflow"]) if "slip_overflow" in res else 0
            if over == 0:
                break
            # exact slipped-beam handling: grow the carry and re-run this
            # step from the identical inputs (the step fn is functional —
            # self.binned/time/dt/laser_stream are untouched until below)
            self._grow_slip_cap(int(res["slip_need"]), step)
        else:
            raise RuntimeError(
                f"step {step}: slip_cap growth did not converge "
                f"(cap={self.cfg.slip_cap}, still {over} overflowing)")
        if self.cfg.use_laser:
            self.laser_stream = res["laser_stream"]
        if "banded_lost" in res:
            lost = int(res["banded_lost"])
            if lost > 0:
                import sys
                print(f"WARNING: step {step}: {lost} banded deposit "
                      "contributions dropped — increase hipace.banded_W "
                      "or decrease hipace.banded_K", file=sys.stderr)
        if "spawn_lost" in res:
            lost = int(res["spawn_lost"])
            if lost > 0:
                import sys
                print(f"WARNING: step {step}: {lost} ionization products "
                      "dropped (product species at capacity)",
                      file=sys.stderr)
        return res

    def _initial_beam_moments(self):
        import numpy as np
        b = self.beams_flat[0]
        v = np.asarray(b["valid"])
        w = np.asarray(b["w"])[v]
        uz = np.asarray(b["uz"])[v] / self.pc.c
        if w.sum() == 0.0:
            return adt.initial_moments(self.beam_cfgs[0])
        return {"sum_w": float(w.sum()),
                "sum_w_uz": float((w * uz).sum()),
                "sum_w_uz2": float((w * uz * uz).sum()),
                "min_uz": float(uz.min()), "min_acc": 0.0}

    def evolve(self, write_output: bool = True, start_step: int = 0):
        """Time loop (ref Hipace.cpp:393-507)."""
        for step in range(start_step, self.max_step + 1):
            if self.adt_cfg.enabled:
                # phase-advance control through density gradients
                self.dt = adt.calculate_from_density(
                    self.adt_cfg, self.plasma_cfgs, self.pc, self.time,
                    self.dt, self._min_uz_mq)
            # adjust dt to land exactly on hipace.max_time; the step AT
            # max_time runs once with dt = 0 (ref Hipace.cpp:424-435)
            if self.time == self.max_time:
                self._has_last_step = True
                self.dt = 0.0
            elif ((self.time + self.dt >= self.max_time > self.time)
                  or (self.time + self.dt <= self.max_time < self.time)):
                self.dt = self.max_time - self.time
            if self.verbose >= 1:
                print(f"Rank 0 started step {step} at time {self.time}"
                      f" with dt {self.dt}")
            self._apply_density_table()
            pre_push_binned = self.binned
            res = self.run_step(step)
            if write_output and self._do_output(step):
                self._write_diagnostics(step, res, pre_push_binned)
            if write_output:
                self._write_insitu(step, res)
            self.binned = res["binned"]
            self.time += self.dt
            if self._has_last_step:
                break
            if self.adt_cfg.enabled and self.beam_cfgs:
                mom = {k: float(v) for k, v in res["beam_moments"].items()}
                mom["min_uz"] = float(res["min_uz"])
                self.dt, self._min_uz_mq = adt.calculate_from_min_uz(
                    self.adt_cfg, mom, self.beam_cfgs[0], self.plasma_cfgs,
                    self.pc, self.time, self.dt)
        return self

    # ------------------------------------------------------------------
    def evolve_pipelined(self, devices=None, write_output: bool = True):
        """Production multi-device time loop: windows of n_dev consecutive
        steps run as a temporal pipeline (device d computes step base+d,
        streaming beam/laser slices over the ring), with full per-step
        openPMD + in-situ diagnostics and a host-predicted adaptive-dt
        ladder per window (the analogue of the reference's cross-rank dt
        prediction + time streaming, ref AdaptiveTimeStep.cpp:338-370,
        MultiBuffer.cpp:618-644, Hipace.cpp:411,446).

        Falls back to the serial loop for the tail (< n_dev steps left),
        when max_time would be crossed mid-window, and for per-step plasma
        density tables (which rebuild the jitted step between steps).
        """
        import jax as _jax
        devices = list(devices) if devices is not None else _jax.devices()
        n_dev = len(devices)
        if n_dev <= 1 or any(p.density_table for p in self.plasma_cfgs):
            return self.evolve(write_output)
        from ..parallel import pipeline as pp

        step = 0
        while step <= self.max_step:
            remaining = self.max_step - step + 1
            if remaining < n_dev:
                self.evolve(write_output, start_step=step)
                return self
            # ---- dt/time ladder for this window (host prediction)
            dts, times = [], []
            t, dt = self.time, self.dt
            for _d in range(n_dev):
                if self.adt_cfg.enabled:
                    dt = adt.calculate_from_density(
                        self.adt_cfg, self.plasma_cfgs, self.pc, t, dt,
                        self._min_uz_mq)
                crosses = (t == self.max_time
                           or (t + dt >= self.max_time > t)
                           or (t + dt <= self.max_time < t))
                if crosses:
                    break
                dts.append(dt)
                times.append(t)
                t += dt
            if len(dts) < n_dev:
                # max_time inside the window: finish serially
                self.evolve(write_output, start_step=step)
                return self
            if self.verbose >= 1:
                for d in range(n_dev):
                    print(f"Rank {d} started step {step + d} at time "
                          f"{times[d]} with dt {dts[d]}")

            self.key, sub = jax.random.split(self.key)
            binned = {k: v for k, v in self.binned.items()
                      if k != "n_dropped"}
            for _retry in range(16):
                res = pp.pipelined_window(
                    self.cfg, self.dtype, binned, dts, times, step, sub,
                    devices=devices, laser_stream=self.laser_stream)
                over = (int(np.sum(np.asarray(res["stage"]["slip_overflow"])))
                        if "slip_overflow" in res["stage"] else 0)
                if over == 0:
                    break
                # exact slipped-beam handling (same as run_step): grow the
                # carry and re-run the whole window from identical inputs
                need = int(np.max(np.asarray(res["stage"]["slip_need"])))
                self._grow_slip_cap(need, step)
            else:
                raise RuntimeError(
                    f"window at step {step}: slip_cap growth did not "
                    f"converge (cap={self.cfg.slip_cap})")

            # ---- per-step diagnostics from the staged buffers
            for d in range(n_dev):
                s = step + d
                res_d = {k: v[d] for k, v in res["stage"].items()}
                if "diag_int" in res:
                    for name, v in res["diag_int"].items():
                        res_d["diag_int_" + name] = v[d]
                if "banded_lost" in res_d:
                    n_bad = int(np.sum(np.asarray(res_d["banded_lost"])))
                    if n_bad > 0:
                        import sys as _sys
                        print(f"WARNING: step {s}: {n_bad} banded deposit "
                              "contributions dropped", file=_sys.stderr)
                pre = (self.binned if d == 0
                       else {k: v[d] for k, v in res["beam"].items()})
                saved_time, saved_dt = self.time, self.dt
                self.time, self.dt = times[d], dts[d]
                if write_output and self._do_output(s):
                    self._write_diagnostics(s, res_d, pre)
                if write_output:
                    self._write_insitu(s, res_d)
                self.time, self.dt = saved_time, saved_dt

            # ---- advance host state past the window
            flat = {}
            for k in bm.BEAM_ATTRS + bm.BEAM_INT_ATTRS + ("valid",):
                flat[k] = res["beam"][k][0].reshape(-1)
            self.binned = bm.bin_beam(flat, self.geom, self.beam_cap)
            if self.cfg.use_laser:
                self.laser_stream = (res["laser"]["n00"][0],
                                     res["laser"]["nm1"][0])
            self.time = times[-1] + dts[-1]
            self.dt = dts[-1]
            if self.adt_cfg.enabled and self.beam_cfgs:
                mom = {k: float(v[-1]) for k, v in res["moments"].items()}
                mom["min_uz"] = float(res["min_uz"][-1])
                # multi-rank prediction ladder: iterate the dt prediction
                # numprocs=n_dev times like the reference pipeline
                # (ref AdaptiveTimeStep.cpp:338-370)
                self.dt, self._min_uz_mq = adt.calculate_from_min_uz(
                    self.adt_cfg, mom, self.beam_cfgs[0], self.plasma_cfgs,
                    self.pc, self.time, self.dt, numprocs=n_dev)
            step += n_dev
        return self

    def _apply_density_table(self):
        """Select each tabulated plasma's density expression for the current
        c*t (rounded up to the nearest table position, ref
        parameters.rst:405-411). Changing an expression rebuilds the jitted
        step (recompile per table segment)."""
        import dataclasses as _dc
        if not any(p.density_table for p in self.plasma_cfgs):
            return
        c_t = self.pc.c * self.time
        changed = False
        new_cfgs = list(self.plasma_cfgs)
        for i, p in enumerate(self.plasma_cfgs):
            if not p.density_table:
                continue
            expr = p.density_table[-1][1]
            for pos, e in p.density_table:
                if pos >= c_t:
                    expr = e
                    break
            if expr != p.density_expr:
                new_cfgs[i] = _dc.replace(p, density_expr=expr)
                changed = True
        if changed:
            self.plasma_cfgs = tuple(new_cfgs)
            self.cfg = _dc.replace(self.cfg, plasmas=self.plasma_cfgs)
            self._step_fn = jax.jit(partial(self._time_step))

    def _period_hit(self, period: int, step: int) -> bool:
        last = (step == self.max_step) or self._has_last_step
        if period < 0:
            return last
        if period == 0:
            return False
        return (step % period == 0) or last

    def _do_output(self, step: int) -> bool:
        return (any(self._period_hit(dg.period, step) for dg in self.diags)
                or (bool(self.beam_data)
                    and self._period_hit(self.beam_output_period, step)))

    # ------------------------------------------------------------------
    def _write_insitu(self, step, res):
        """Write reduced diagnostics (ref Hipace.cpp:487-490)."""
        from ..diagnostics import insitu as ins
        inputs = self.inputs
        cfg = self.cfg

        def writer(kind, name, default_prefix, key):
            prefix = inputs.query(key, default_prefix, str)
            wkey = (kind, name)
            if wkey not in self._insitu_writers:
                self._insitu_writers[wkey] = ins.InsituWriter(prefix, name)
            return self._insitu_writers[wkey]

        if "insitu_beam" in res and cfg.insitu_beam_period \
                and step % cfg.insitu_beam_period == 0:
            for ib, b in enumerate(self.beam_cfgs):
                rec = ins.beam_record(step, self.time,
                                      res["insitu_beam"][:, ib],
                                      b.charge, b.mass,
                                      self.geom, self.normalized_units)
                writer("beam", b.name, "diags/insitu",
                       f"{b.name}.insitu_file_prefix").write_record(rec)
        if "insitu_field" in res and cfg.insitu_field_period \
                and step % cfg.insitu_field_period == 0:
            rec = ins.field_record(step, self.time,
                                   res["insitu_field"], self.geom,
                                   self.normalized_units)
            writer("field", "field", "diags/field_insitu",
                   "fields.insitu_file_prefix").write_record(rec)
        if "insitu_laser" in res and cfg.insitu_laser_period \
                and step % cfg.insitu_laser_period == 0:
            rec = ins.laser_record(step, self.time, res["insitu_laser"],
                                   self.geom, self.normalized_units)
            writer("laser", "laser", "diags/laser_insitu",
                   "lasers.insitu_file_prefix").write_record(rec)
        if "insitu_plasma" in res and cfg.insitu_plasma_period \
                and step % cfg.insitu_plasma_period == 0:
            for i, p in enumerate(self.plasma_cfgs):
                rec = ins.plasma_record(step, self.time,
                                        res["insitu_plasma"][:, i],
                                        p.charge, p.mass, self.geom,
                                        self.normalized_units)
                writer("plasma", p.name, "diags/plasma_insitu",
                       f"{p.name}.insitu_file_prefix").write_record(rec)

    @staticmethod
    def _z_process(arr, dg, geom):
        """Host-side z patch crop + coarsening on a z-leading stack."""
        z0, z1 = dg.patch_z
        arr = arr[z0:z1 + 1]
        cz = dg.coarsening[2]
        if cz > 1:
            n = (arr.shape[0] // cz) * cz
            arr = arr[:n]
            if cz % 2 == 1:
                arr = arr[cz // 2::cz]
            else:
                arr = 0.5 * (arr[cz // 2 - 1::cz] + arr[cz // 2::cz])
        return arr

    def _diag_geometry(self, dg):
        """(spacing, offset) per written axis, reference layout z,y,x."""
        g = self.geom
        if dg.base == "laser" and self.laser_geom is not None \
                and self.laser_geom != self.geom:
            fg = self.laser_geom
            cx, cy, cz = dg.coarsening
            return ((g.dz * cz, fg.dy * cy, fg.dx * cx),
                    (g.prob_lo[2] + dg.patch_z[0] * g.dz,
                     fg.prob_lo[1] + dg.patch_y[0] * fg.dy,
                     fg.prob_lo[0] + dg.patch_x[0] * fg.dx))
        if dg.base.startswith("level_") and dg.base != "level_0":
            fg = self.mr_levels[int(dg.base[-1]) - 1].geom
            cx, cy, cz = dg.coarsening
            return ((g.dz * cz, fg.dy * cy, fg.dx * cx),
                    (g.prob_lo[2] + dg.patch_z[0] * g.dz,
                     fg.prob_lo[1] + dg.patch_y[0] * fg.dy,
                     fg.prob_lo[0] + dg.patch_x[0] * fg.dx))
        cx, cy, cz = dg.coarsening
        sp_z = g.dz * cz
        off_z = g.prob_lo[2] + dg.patch_z[0] * g.dz
        sp_y = g.dy * cy
        off_y = g.prob_lo[1] + dg.patch_y[0] * g.dy
        sp_x = g.dx * cx
        off_x = g.prob_lo[0] + dg.patch_x[0] * g.dx
        return (sp_z, sp_y, sp_x), (off_z, off_y, off_x)

    def _write_diagnostics(self, step: int, res, pre_binned):
        """Per-diag processing + openPMD write (ref OpenPMDWriter.cpp)."""
        diag = np.asarray(res["diag"]) if "diag" in res else None
        from .step import _diag_is_identity
        fields = {}
        field_meta = {}
        for dg in self.diags:
            if not self._period_hit(dg.period, step):
                continue
            spacing, offset = self._diag_geometry(dg)
            if _diag_is_identity(dg, self.cfg):
                for c in dg.comps:
                    arr = self._z_process(
                        diag[:, self.cfg.diag_comps.index(c)], dg, self.geom)
                    fields[f"{dg.name}/{c}" if dg.name != "lev0" else c] = arr
                    field_meta[f"{dg.name}/{c}" if dg.name != "lev0"
                               else c] = (spacing, offset)
                continue
            if dg.diag_type == "xy_integrated":
                arr = np.asarray(res["diag_int_" + dg.name]) * self.geom.dz
                for ic, c in enumerate(dg.comps):
                    key = f"{dg.name}/{c}" if dg.name != "lev0" else c
                    fields[key] = arr[ic]
                    field_meta[key] = ((spacing[1], spacing[2]),
                                      (offset[1], offset[2]), ("y", "x"))
                continue
            arr = self._z_process(np.asarray(res["diagf_" + dg.name]),
                                  dg, self.geom)          # (nz', C, ...)
            for ic, c in enumerate(dg.comps):
                key = f"{dg.name}/{c}" if dg.name != "lev0" else c
                fields[key] = arr[:, ic]
                if dg.diag_type == "xz":
                    field_meta[key] = ((spacing[0], spacing[2]),
                                      (offset[0], offset[2]), ("z", "x"))
                elif dg.diag_type == "yz":
                    field_meta[key] = ((spacing[0], spacing[1]),
                                      (offset[0], offset[1]), ("z", "y"))
                else:
                    field_meta[key] = (spacing, offset)

        beams = {}
        if self.beam_data and self._period_hit(self.beam_output_period,
                                               step):
            bid = np.asarray(pre_binned["beam_id"].reshape(-1))
            v_all = np.asarray(pre_binned["valid"].reshape(-1))
            for ib, bcfg in enumerate(self.beam_cfgs):
                if bcfg.name not in self.beam_data:
                    continue
                v = v_all & (bid == ib)
                bout = {k: np.asarray(pre_binned[k].reshape(-1))[v]
                        for k in bm.BEAM_ATTRS}
                # openPMD momenta are dimensionless gamma*beta (the
                # reference's convention, ref OpenPMDWriter.H:79-95);
                # internal momenta are proper velocities u*c
                for k in ("ux", "uy", "uz"):
                    bout[k] = bout[k] / self.pc.c
                beams[bcfg.name] = bout
        self.writer.write(step, self.time, self.dt, fields, self.geom,
                          beams=beams, field_meta=field_meta)


def _empty_beam(dtype):
    out = {k: jnp.zeros((1,), dtype) for k in bm.BEAM_ATTRS}
    out["nsub"] = jnp.zeros((1,), jnp.int32)
    out["beam_id"] = jnp.zeros((1,), jnp.int32)
    out["valid"] = jnp.zeros((1,), bool)
    return out
