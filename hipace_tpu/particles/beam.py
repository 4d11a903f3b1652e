"""Beam particle species: init, per-slice binning, time pusher, deposits.

A JAX re-design of the reference's beam layer:
- container/config:  /root/reference/src/particles/beam/BeamParticleContainer.cpp
- init modes:        /root/reference/src/particles/beam/BeamParticleContainerInit.cpp
                     (fixed_ppc :119-347, fixed_weight :348-475)
- z binning:         /root/reference/src/particles/sorting/BoxSort.cpp
- time pusher:       /root/reference/src/particles/pusher/BeamParticleAdvance.cpp:19-336
- deposition:        /root/reference/src/particles/deposition/BeamDepositCurrent.cpp

Beam particles are flat (N,) SoA arrays binned into fixed-capacity per-slice
arrays (nslices, cap) for the zeta lax.scan: the reference's BoxSorter
becomes a scatter by slice index; variable per-slice counts become a
validity mask. Momenta are stored as proper velocity u = gamma*beta*c.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..constants import PhysConst
from ..geometry import Geometry
from ..parser import Inputs
from ..ops.gather import gather_main_fields
from ..ops.deposit import deposit_multi
from .plasma import enforce_particle_bc


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    name: str = "beam"
    injection_type: str = "fixed_weight"
    charge: float = -1.0
    mass: float = 1.0
    num_particles: int = 0
    density: float = 0.0
    total_charge: float = 0.0            # in units of beam charge * weight
    profile: str = "gaussian"            # fixed_weight: gaussian | can
    zmin: float = -float("inf")
    zmax: float = float("inf")
    radius: float = float("inf")
    position_mean: tuple[str, str, float] = ("0.", "0.", 0.0)
    position_std: tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    u_std: tuple[float, float, float] = (0.0, 0.0, 0.0)
    duz_per_uz0_dzeta: float = 0.0
    # 4-fold transverse mirror: draw N/4, add (+x,+y) (-x,+y) (+x,-y)
    # (-x,-y) with matching (+-ux, +-uy) (ref Init.cpp:453-472)
    do_symmetrize: bool = False
    z_foc: float = 0.0
    ppc: tuple[int, int, int] = (1, 1, 1)
    density_expr: str = "1."
    n_subcycles: int = 10
    do_z_push: bool = True
    do_salame: bool = False
    particle_boundary: str = "Absorbing"
    particle_bounds: tuple | None = None
    # external fields: 6 expressions of (x,y,z,t) for Ex,Ey,Ez,Bx,By,Bz
    # (ref BeamParticleContainer.cpp:72-88, ExternalFields.H)
    use_external_fields: bool = False
    external_fields_expr: tuple = ("0", "0", "0", "0", "0", "0")
    do_radiation_reaction: bool = False
    do_spin_tracking: bool = False
    initial_spin: tuple[float, float, float] = (0.0, 0.0, 1.0)
    spin_anom: float = 0.00115965218128  # electron anomalous moment
    # deck my_constants needed by expression-valued parameters (hashable)
    consts: tuple = ()
    # fixed_weight_pdf (ref BeamParticleContainer.cpp:200-250): expressions
    # of z for pdf, position mean/std (x,y) and momentum mean/std (x,y,z)
    pdf_expr: str = "1."
    pdf_pos_mean_expr: tuple = ("0.", "0.")
    pdf_pos_std_expr: tuple = ("0.", "0.")
    pdf_u_mean_expr: tuple = ("0.", "0.", "0.")
    pdf_u_std_expr: tuple = ("0.", "0.", "0.")
    pdf_ref_ratio: int = 4
    peak_density_is_specified: bool = False
    # from_file injection (ref BeamParticleContainer.cpp:252-276)
    input_file: str = ""
    file_iteration: int = 0

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst,
                    geom: Geometry, normalized_units: bool) -> "BeamConfig":
        pp = inputs.prefix(name)
        pa = inputs.prefix("beams")

        def q(key, default, dtype=None):
            return pp.query(key, pa.query(key, default, dtype), dtype)

        element = pp.query("element", "electron", str)
        if element == "electron":
            charge, mass = -pc.q_e, pc.m_e
        elif element == "positron":
            charge, mass = pc.q_e, pc.m_e
        elif element == "proton":
            charge, mass = pc.q_e, pc.m_p
        else:
            charge, mass = -pc.q_e, pc.m_e
        mass = pp.query("mass", mass)
        charge = pp.query("charge", charge)

        # ref BeamParticleContainer.cpp:52-55: dx/dy_per_dzeta were
        # replaced by position_mean expressions of z
        for dep in ("dx_per_dzeta", "dy_per_dzeta"):
            if pp.contains(dep):
                raise ValueError(
                    f"{name}.{dep} is no longer supported; use "
                    '{name}.position_mean = "x_center+(z-z_center)'
                    '*dx_per_dzeta" "y_center+(z-z_center)*dy_per_dzeta" '
                    '"z_center" instead')
        injection = pp.get("injection_type", str)
        profile = pp.query("profile", "gaussian", str)
        num_particles = pp.query("num_particles", 0, int)
        if pp.query("do_symmetrize", False, bool) and num_particles % 4:
            # silently truncating to 4*(n//4) would under-deposit total
            # charge; the reference hard-errors too
            # (ref BeamParticleContainer.cpp:176)
            raise ValueError(
                f"{name}.do_symmetrize requires "
                f"{name}.num_particles ({num_particles}) to be divisible "
                "by 4")
        density = pp.query("density", 0.0)
        if injection == "fixed_weight_pdf":
            # position/momentum params are expressions of z, parsed below
            position_std = (0.0, 0.0, 0.0)
            pos_mean = ["0.", "0.", "0."]
        else:
            position_std = tuple(pp.query_list("position_std",
                                               [0.0, 0.0, 0.0]))
            pos_mean = pp.query_list("position_mean", ["0.", "0.", "0."], str)

        # total weight = m_total_charge / charge
        # (ref BeamParticleContainer.cpp:167-194, Init.cpp:425)
        total_charge = 0.0
        if injection == "fixed_weight":
            if pp.contains("total_charge"):
                total_charge = pp.get("total_charge") / charge
            else:
                # peak density -> integrated weight
                total_charge = density
                for std in position_std:
                    total_charge *= std * math.sqrt(2.0 * math.pi)
                if normalized_units:
                    total_charge /= geom.dx * geom.dy * geom.dz
        elif injection == "fixed_weight_pdf" and pp.contains("total_charge"):
            total_charge = pp.get("total_charge") / charge

        density_expr = "1."
        f = pp.get_function("density", ("x", "y", "z"))
        if f is not None:
            density_expr = f.expr

        # external_E/B are 3-component expression lists of (x,y,z,t)
        def _three(key):
            raw = inputs.raw(f"{name}.{key}(x,y,z,t)")
            if raw is None:
                raw = inputs.raw(f"beams.{key}(x,y,z,t)")
            if raw is None:
                return None
            toks = inputs._split(raw)
            return tuple(toks) if len(toks) == 3 else (raw, "0", "0")
        e3 = _three("external_E")
        b3 = _three("external_B")
        use_ext = e3 is not None or b3 is not None
        ext_exprs = (e3 or ("0", "0", "0")) + (b3 or ("0", "0", "0"))

        return cls(
            name=name,
            injection_type=injection,
            charge=charge, mass=mass,
            num_particles=num_particles,
            density=density,
            total_charge=total_charge,
            profile=profile,
            zmin=pp.query("zmin", -float("inf")),
            zmax=pp.query("zmax", float("inf")),
            radius=pp.query("radius", float("inf")),
            position_mean=(str(pos_mean[0]), str(pos_mean[1]),
                           float(inputs._eval_scalar(str(pos_mean[2])))
                           if injection != "fixed_ppc" else 0.0),
            position_std=position_std
            if injection != "fixed_weight_pdf" else (0.0, 0.0, 0.0),
            u_mean=tuple(pp.query_list("u_mean", [0.0, 0.0, 0.0]))
            if injection != "fixed_weight_pdf" else (0.0, 0.0, 0.0),
            u_std=tuple(pp.query_list("u_std", [0.0, 0.0, 0.0]))
            if injection != "fixed_weight_pdf" else (0.0, 0.0, 0.0),
            duz_per_uz0_dzeta=pp.query("duz_per_uz0_dzeta", 0.0),
            do_symmetrize=pp.query("do_symmetrize", False, bool),
            z_foc=pp.query("z_foc", 0.0),
            ppc=tuple(pp.query_list("ppc", [1, 1, 1], int)),
            density_expr=density_expr,
            n_subcycles=q("n_subcycles", 10, int),
            do_z_push=q("do_z_push", True, bool),
            do_salame=pp.query("do_salame", False, bool),
            particle_boundary=inputs.query("boundary.particle", "Absorbing", str),
            particle_bounds=(
                tuple(inputs.query_list("boundary.particle_lo", [], float)[:2])
                + tuple(inputs.query_list("boundary.particle_hi", [],
                                          float)[:2])
                if len(inputs.query_list("boundary.particle_lo", [],
                                         float)) >= 2
                and len(inputs.query_list("boundary.particle_hi", [],
                                          float)) >= 2 else None),
            use_external_fields=use_ext,
            external_fields_expr=ext_exprs,
            do_radiation_reaction=q("do_radiation_reaction", False, bool),
            do_spin_tracking=q("do_spin_tracking", False, bool),
            initial_spin=tuple(pp.query_list("initial_spin", [0., 0., 1.])),
            spin_anom=q("spin_anom", 0.00115965218128),
            pdf_expr=(inputs.raw(f"{name}.pdf(z)") or "1."),
            pdf_pos_mean_expr=tuple(pp.query_list(
                "position_mean", ["0.", "0."], str)[:2])
            if injection == "fixed_weight_pdf" else ("0.", "0."),
            pdf_pos_std_expr=tuple(pp.query_list(
                "position_std", ["0.", "0."], str)[:2])
            if injection == "fixed_weight_pdf" else ("0.", "0."),
            pdf_u_mean_expr=tuple(pp.query_list(
                "u_mean", ["0.", "0.", "0."], str))
            if injection == "fixed_weight_pdf" else ("0.", "0.", "0."),
            pdf_u_std_expr=tuple(pp.query_list(
                "u_std", ["0.", "0.", "0."], str))
            if injection == "fixed_weight_pdf" else ("0.", "0.", "0."),
            pdf_ref_ratio=pp.query("pdf_ref_ratio", 4, int),
            peak_density_is_specified=pp.contains("density"),
            input_file=pp.query("input_file", "", str),
            file_iteration=pp.query("iteration", 0, int),
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
        )

    def external_field_fns(self):
        """Compile the 6 external field expressions to traceable callables."""
        if not self.use_external_fields:
            return None
        from ..parser import compile_function
        fns = [compile_function(e, ("x", "y", "z", "t"), self.consts)
               for e in self.external_fields_expr]

        def apply(x, y, z, t, clight, exmby, eypbx, ez, bx, by, bz):
            import jax.numpy as jnp
            vals = [jnp.broadcast_to(jnp.asarray(f(x, y, z, t), x.dtype), x.shape)
                    for f in fns]
            ex_e, ey_e, ez_e, bx_e, by_e, bz_e = vals
            return (exmby + ex_e - clight * by_e,
                    eypbx + ey_e + clight * bx_e,
                    ez + ez_e, bx + bx_e, by + by_e, bz + bz_e)
        return apply

    def mean_fn(self, comp: int):
        from ..parser import compile_function
        return compile_function(self.position_mean[comp], ("z",), self.consts)

    def density_fn(self):
        from ..parser import compile_function
        return compile_function(self.density_expr, ("x", "y", "z"),
                                self.consts)


# spin components always carried (zeros when spin tracking is off) so the
# binning/streaming pytree structure is static
BEAM_ATTRS = ("x", "y", "z", "ux", "uy", "uz", "w", "sx", "sy", "sz")
# integer attributes carried alongside (subcycle resume counter + species id)
BEAM_INT_ATTRS = ("nsub", "beam_id")


def merge_beams(flats: list[dict]) -> dict:
    """Concatenate several beams into one SoA with a beam_id attribute."""
    import jax.numpy as _jnp
    out = {}
    for k in BEAM_ATTRS + ("valid", "nsub"):
        out[k] = _jnp.concatenate([f[k] for f in flats])
    out["beam_id"] = _jnp.concatenate([
        _jnp.full((f["x"].size,), i, _jnp.int32)
        for i, f in enumerate(flats)])
    return out


def init_beam(cfg: BeamConfig, geom: Geometry, key, dtype,
              normalized_units: bool, pc: PhysConst | None = None) -> dict:
    """Initialize the full beam as flat SoA arrays + validity mask.

    Deck momenta are dimensionless gamma*beta; stored momenta are proper
    velocities u = gamma*beta*c (ref AddOneBeamParticle: u * clight).
    """
    c = 1.0 if pc is None else pc.c
    if cfg.injection_type == "fixed_weight":
        out = _init_fixed_weight(cfg, geom, key, dtype)
    elif cfg.injection_type == "fixed_weight_pdf":
        out = _init_fixed_weight_pdf(cfg, geom, key, dtype, normalized_units)
    elif cfg.injection_type == "fixed_ppc":
        out = _init_fixed_ppc(cfg, geom, dtype, normalized_units)
    elif cfg.injection_type == "from_file":
        # openPMD files store dimensionless gamma*beta (the reference's
        # convention, ref OpenPMDWriter.H:79-95) -> scale to u*c below
        out = _init_from_file(cfg, dtype)
    else:
        raise NotImplementedError(f"injection_type {cfg.injection_type}")
    if c != 1.0:
        out = dict(out, ux=out["ux"] * c, uy=out["uy"] * c,
                   uz=out["uz"] * c)
    return out


def _init_fixed_weight_pdf(cfg: BeamConfig, geom: Geometry, key, dtype,
                           normalized_units: bool) -> dict:
    """Longitudinal-PDF beam (ref BeamParticleContainerInit.cpp:477-695):
    z sampled by inverse-CDF of the piecewise-linear pdf on a refined slice
    grid; transverse/momentum moments are expressions of z."""
    import numpy as np
    from ..parser import compile_function

    n = cfg.num_particles
    pdf = compile_function(cfg.pdf_expr, ("z",), cfg.consts)
    pos_f = [compile_function(e, ("z",), cfg.consts)
             for e in cfg.pdf_pos_mean_expr + cfg.pdf_pos_std_expr]
    u_f = [compile_function(e, ("z",), cfg.consts)
           for e in cfg.pdf_u_mean_expr + cfg.pdf_u_std_expr]

    nzf = geom.nz * cfg.pdf_ref_ratio
    edges = np.linspace(geom.prob_lo[2], geom.prob_hi[2], nzf + 1)
    pdf_e = np.maximum(np.asarray([float(np.asarray(pdf(z))) for z in edges]),
                       0.0)
    # piecewise-linear pdf -> piecewise-quadratic CDF
    seg_w = 0.5 * (pdf_e[:-1] + pdf_e[1:])
    cdf = np.concatenate([[0.0], np.cumsum(seg_w)])
    integral = cdf[-1]
    cdf = cdf / integral

    ks = jax.random.split(key, 6)
    u = jax.random.uniform(ks[0], (n,), dtype)
    seg = jnp.clip(jnp.searchsorted(jnp.asarray(cdf), u) - 1, 0, nzf - 1)
    # invert the quadratic CDF within the segment (ref Init.cpp:645-652)
    lo_w = jnp.asarray(pdf_e, dtype)[seg]
    hi_w = jnp.asarray(pdf_e, dtype)[seg + 1]
    frac = (u - jnp.asarray(cdf, dtype)[seg]) / \
        jnp.maximum(jnp.asarray(cdf[1:] - cdf[:-1], dtype)[seg], 1e-300)
    dz = edges[1] - edges[0]
    use_taylor = jnp.minimum(lo_w, hi_w) * 1.1 > jnp.maximum(lo_w, hi_w)
    denom_t = hi_w + lo_w
    denom_e = jnp.where(jnp.abs(hi_w - lo_w) > 0, hi_w - lo_w, 1.0)
    z_t = frac - frac * (frac - 1.0) * (hi_w - lo_w) / jnp.maximum(denom_t, 1e-300)
    z_e = (jnp.sqrt(lo_w ** 2 + frac * (hi_w ** 2 - lo_w ** 2)) - lo_w) / denom_e
    z = jnp.asarray(edges[:-1], dtype)[seg] + dz * jnp.where(use_taylor, z_t, z_e)

    x_mean = jnp.asarray(pos_f[0](z), dtype)
    y_mean = jnp.asarray(pos_f[1](z), dtype)
    x_std = jnp.broadcast_to(jnp.asarray(pos_f[2](z), dtype), z.shape)
    y_std = jnp.broadcast_to(jnp.asarray(pos_f[3](z), dtype), z.shape)
    x = x_std * jax.random.normal(ks[1], (n,), dtype)
    y = y_std * jax.random.normal(ks[2], (n,), dtype)
    valid = x * x + y * y <= cfg.radius ** 2
    ux = jnp.asarray(u_f[0](z), dtype) + jnp.asarray(u_f[3](z), dtype) \
        * jax.random.normal(ks[3], (n,), dtype)
    uy = jnp.asarray(u_f[1](z), dtype) + jnp.asarray(u_f[4](z), dtype) \
        * jax.random.normal(ks[4], (n,), dtype)
    uz = jnp.asarray(u_f[2](z), dtype) + jnp.asarray(u_f[5](z), dtype) \
        * jax.random.normal(ks[5], (n,), dtype)
    ux = jnp.broadcast_to(ux, z.shape)
    uy = jnp.broadcast_to(uy, z.shape)
    uz = jnp.broadcast_to(uz, z.shape)
    x = x - cfg.z_foc * ux / uz + x_mean
    y = y - cfg.z_foc * uy / uz + y_mean

    # total weight (ref Init.cpp:514-542)
    if cfg.peak_density_is_specified:
        mids = 0.5 * (edges[:-1] + edges[1:])
        xs_std = np.array([float(np.asarray(pos_f[2](zm))) for zm in mids])
        ys_std = np.array([float(np.asarray(pos_f[3](zm))) for zm in mids])
        max_density = np.max(seg_w / (dz * xs_std * ys_std * 2.0 * math.pi))
        total_weight = cfg.density * integral / max_density
    else:
        total_weight = cfg.total_charge
    if normalized_units:
        total_weight /= geom.dx * geom.dy * geom.dz
    w = jnp.where(valid, total_weight / max(n, 1), 0.0).astype(dtype)

    out = {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz,
           "w": w, "valid": valid, "nsub": jnp.zeros((n,), jnp.int32)}
    out.update(_init_spin(cfg, n, dtype))
    return out


def _init_from_file(cfg: BeamConfig, dtype) -> dict:
    """Read a beam from an openPMD file written by this framework or the
    reference (ref BeamParticleContainerInit.cpp:698+; restart mechanism)."""
    from ..diagnostics.openpmd import read_beam
    b = read_beam(cfg.input_file, cfg.file_iteration, cfg.name)
    n = b["x"].size
    out = {k: jnp.asarray(b[k], dtype) for k in
           ("x", "y", "z", "ux", "uy", "uz", "w")}
    out["valid"] = jnp.ones((n,), bool)
    out["nsub"] = jnp.zeros((n,), jnp.int32)
    out.update(_init_spin(cfg, n, dtype))
    return out


def _init_fixed_weight(cfg: BeamConfig, geom: Geometry, key, dtype) -> dict:
    n = cfg.num_particles
    nd = n // 4 if cfg.do_symmetrize else n
    kz, kx, ky, ku = jax.random.split(key, 4)
    if cfg.profile == "can":
        z = cfg.zmin + (cfg.zmax - cfg.zmin) * jax.random.uniform(
            kz, (nd,), dtype)
        z_mean = 0.5 * (cfg.zmin + cfg.zmax)
    else:
        z_mean = cfg.position_mean[2]
        z = z_mean + cfg.position_std[2] * jax.random.normal(kz, (nd,), dtype)
    x = cfg.position_std[0] * jax.random.normal(kx, (nd,), dtype)
    y = cfg.position_std[1] * jax.random.normal(ky, (nd,), dtype)

    k0, k1, k2 = jax.random.split(ku, 3)
    ux = cfg.u_mean[0] + cfg.u_std[0] * jax.random.normal(k0, (nd,), dtype)
    uy = cfg.u_mean[1] + cfg.u_std[1] * jax.random.normal(k1, (nd,), dtype)
    uz = cfg.u_mean[2] + cfg.u_std[2] * jax.random.normal(k2, (nd,), dtype)
    # z-correlated energy chirp (ref GetInitialMomentum.H:47)
    uz = uz + (z - z_mean) * cfg.duz_per_uz0_dzeta * cfg.u_mean[2]

    valid = ((z >= cfg.zmin) & (z <= cfg.zmax)
             & (x * x + y * y <= cfg.radius ** 2))
    # ballistic propagation to focal plane (ref Init.cpp:445-447)
    x = x - cfg.z_foc * ux / uz
    y = y - cfg.z_foc * uy / uz
    if cfg.do_symmetrize:
        # quadruple each draw with mirrored transverse deviations and
        # momenta (ref Init.cpp:458-472)
        sx = jnp.asarray([1.0, -1.0, 1.0, -1.0], dtype)
        sy = jnp.asarray([1.0, 1.0, -1.0, -1.0], dtype)
        x = (x[:, None] * sx).reshape(-1)
        y = (y[:, None] * sy).reshape(-1)
        ux = (ux[:, None] * sx).reshape(-1)
        uy = (uy[:, None] * sy).reshape(-1)
        z = jnp.repeat(z, 4)
        uz = jnp.repeat(uz, 4)
        valid = jnp.repeat(valid, 4)
        n = 4 * nd
    x = x + jnp.asarray(cfg.mean_fn(0)(z), dtype)
    y = y + jnp.asarray(cfg.mean_fn(1)(z), dtype)

    w = jnp.full((n,), cfg.total_charge / max(cfg.num_particles, 1), dtype)
    w = jnp.where(valid, w, 0.0)
    # momenta stored as proper velocity * c in SI (c=1 normalized)
    out = {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz,
           "w": w, "valid": valid,
           "nsub": jnp.zeros((n,), jnp.int32)}
    out.update(_init_spin(cfg, n, dtype))
    return out


def _init_fixed_ppc(cfg: BeamConfig, geom: Geometry, dtype,
                    normalized_units: bool) -> dict:
    """Fixed particles-per-cell beam on the full 3D grid
    (ref BeamParticleContainerInit.cpp:119-347)."""
    px, py, pz = cfg.ppc
    nx, ny, nz = geom.n_cell
    dx, dy, dz = geom.dx, geom.dy, geom.dz
    # sub-cell offsets
    ox = (jnp.arange(px) + 0.5) / px
    oy = (jnp.arange(py) + 0.5) / py
    oz = (jnp.arange(pz) + 0.5) / pz
    ix = jnp.arange(nx)
    iy = jnp.arange(ny)
    iz = jnp.arange(nz)
    X = geom.prob_lo[0] + (ix[None, :] + ox[:, None]) * dx  # (px, nx)
    Y = geom.prob_lo[1] + (iy[None, :] + oy[:, None]) * dy
    Z = geom.prob_lo[2] + (iz[None, :] + oz[:, None]) * dz
    Xf = X.reshape(-1)
    Yf = Y.reshape(-1)
    Zf = Z.reshape(-1)
    x, y, z = [a.reshape(-1).astype(dtype) for a in
               jnp.meshgrid(Xf, Yf, Zf, indexing="ij")]

    prof = _beam_profile_density(cfg, x, y, z, dtype)
    # radius cut is relative to the (z-dependent) transverse beam center
    # (ref BeamParticleContainerInit.cpp fixed_ppc: x_c, y_c offsets)
    mx = jnp.asarray(cfg.mean_fn(0)(z), dtype)
    my = jnp.asarray(cfg.mean_fn(1)(z), dtype)
    rx = x - mx
    ry = y - my
    valid = ((z >= cfg.zmin) & (z <= cfg.zmax)
             & (rx * rx + ry * ry <= cfg.radius ** 2)
             & (prof > 0.0))
    nppc = px * py * pz
    scale = 1.0 / nppc if normalized_units else dx * dy * dz / nppc
    w = jnp.where(valid, prof * scale, 0.0)
    n = x.size
    ux = jnp.full((n,), cfg.u_mean[0], dtype)
    uy = jnp.full((n,), cfg.u_mean[1], dtype)
    uz = jnp.full((n,), cfg.u_mean[2], dtype)
    out = {"x": x, "y": y, "z": z, "ux": ux, "uy": uy, "uz": uz,
           "w": w, "valid": valid, "nsub": jnp.zeros((n,), jnp.int32)}
    out.update(_init_spin(cfg, n, dtype))
    return out


def _init_spin(cfg: BeamConfig, n: int, dtype) -> dict:
    """Initial spin, normalized (ref BeamParticleContainerInit.cpp:390-396)."""
    if cfg.do_spin_tracking:
        s0 = jnp.asarray(cfg.initial_spin, dtype)
        s0 = s0 / jnp.linalg.norm(s0)
        return {"sx": jnp.full((n,), s0[0], dtype),
                "sy": jnp.full((n,), s0[1], dtype),
                "sz": jnp.full((n,), s0[2], dtype)}
    z = jnp.zeros((n,), dtype)
    return {"sx": z, "sy": z, "sz": z}


def _beam_profile_density(cfg, x, y, z, dtype):
    if cfg.profile == "flattop":
        return jnp.full_like(x, cfg.density)
    if cfg.profile == "gaussian":
        mx = jnp.asarray(cfg.mean_fn(0)(z), dtype)
        my = jnp.asarray(cfg.mean_fn(1)(z), dtype)
        mz = cfg.position_mean[2]
        sx, sy, sz = cfg.position_std
        arg = jnp.zeros_like(x)
        if sx > 0:
            arg = arg + (x - mx) ** 2 / (2 * sx ** 2)
        if sy > 0:
            arg = arg + (y - my) ** 2 / (2 * sy ** 2)
        if sz > 0:
            arg = arg + (z - mz) ** 2 / (2 * sz ** 2)
        return cfg.density * jnp.exp(-arg)
    if cfg.profile == "parsed":
        return jnp.asarray(cfg.density_fn()(x, y, z), dtype)
    raise NotImplementedError(f"beam profile {cfg.profile}")


# ----------------------------------------------------------------------
def slice_index(z, geom: Geometry):
    """Beam slice binning (ref BoxSort.cpp:40-46): floor((z - lo_z)/dz)."""
    return jnp.floor((z - geom.prob_lo[2]) / geom.dz).astype(jnp.int32)


def bin_beam(beam: dict, geom: Geometry, cap: int) -> dict:
    """Scatter the flat beam into per-slice fixed-capacity arrays.

    Returns dict of (nz, cap) arrays with a 'valid' mask. Particles beyond a
    slice's capacity or outside the z domain are dropped (counted in
    'n_dropped'). The JAX equivalent of BoxSorter's counting sort.
    """
    nz = geom.nz
    isl = slice_index(beam["z"], geom)
    ok = beam["valid"] & (isl >= 0) & (isl < nz)
    isl_c = jnp.where(ok, isl, nz)  # overflow bucket
    # rank within slice: stable ordering by position in the flat array
    order = jnp.argsort(isl_c, stable=True)
    isl_sorted = isl_c[order]
    # position within the run of equal slice indices
    idx = jnp.arange(isl_sorted.size)
    # start offset of each slice via searchsorted
    starts = jnp.searchsorted(isl_sorted, jnp.arange(nz + 1))
    rank = idx - starts[jnp.clip(isl_sorted, 0, nz)]
    keep = (rank < cap) & (isl_sorted < nz)
    dst = jnp.where(keep, isl_sorted * cap + rank, nz * cap)  # drop bucket

    out = {}
    keys = BEAM_ATTRS + tuple(k for k in BEAM_INT_ATTRS if k in beam)
    for k in keys:
        src = beam[k][order]
        flat = jnp.zeros((nz * cap + 1,), src.dtype).at[dst].set(src)
        out[k] = flat[:-1].reshape(nz, cap)
    vsrc = ok[order]
    vflat = jnp.zeros((nz * cap + 1,), bool).at[dst].set(vsrc & keep)
    out["valid"] = vflat[:-1].reshape(nz, cap)
    out["n_dropped"] = jnp.sum(ok) - jnp.sum(out["valid"])
    return out


def unbin_beam(binned: dict) -> dict:
    """Flatten per-slice arrays back to flat SoA (drop the slice structure)."""
    out = {}
    for k in BEAM_ATTRS + tuple(k for k in BEAM_INT_ATTRS if k in binned):
        out[k] = binned[k].reshape(-1)
    out["valid"] = binned["valid"].reshape(-1)
    return out


# ----------------------------------------------------------------------
def chunk_apply(arrs: dict, n_active, chunk: int, body_fn):
    """Apply body_fn (dict of (chunk,) lanes -> same) to successive
    chunk-size lane windows while i*chunk < n_active, writing results back.

    The per-slice beam capacity is sized to the PEAK slice, but the lax.scan
    body pays for every lane on EVERY slice — ~6x padding waste for a
    gaussian beam. This is the JAX equivalent of the reference's per-box
    particle loops, which size to the actual count (ref
    BeamParticleAdvance.cpp:60: ParallelFor(num_particles)): a
    dynamic-trip-count while_loop processes only ceil(n_active/chunk)
    chunks, so cost scales with occupancy, not capacity.

    Requires all lanes >= n_active to be invalid (callers keep valid lanes
    compacted at the front: bin_beam rank order, slip-buffer sort order).
    """
    N = next(iter(arrs.values())).shape[0]
    CH = min(chunk, N)
    pad = (-N) % CH
    if pad:
        arrs = {k: jnp.concatenate(
            [v, jnp.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in arrs.items()}

    def cond(state):
        i, _ = state
        return i * CH < n_active

    def body(state):
        i, a = state
        off = i * CH
        ch = {k: jax.lax.dynamic_slice_in_dim(v, off, CH, 0)
              for k, v in a.items()}
        out = body_fn(ch)
        a = dict(a)
        for k, v in out.items():
            a[k] = jax.lax.dynamic_update_slice_in_dim(a[k], v, off, 0)
        return i + 1, a

    _, arrs = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), arrs))
    if pad:
        arrs = {k: v[:N] for k, v in arrs.items()}
    return arrs


def prefix_ladder(N: int, buckets: int, quantum: int = 1024) -> tuple:
    """Static prefix sizes for occupancy-bucketed dispatch: halving ladder
    {N, N/2, N/4, ...} rounded up to `quantum` lanes (a (8, 128) f32 VREG
    block), deduplicated, ascending. With buckets <= 1 returns (N,)."""
    sizes = {N}
    p = N
    for _ in range(max(0, buckets - 1)):
        p = (p + 1) // 2
        sizes.add(min(N, max(quantum, -(-p // quantum) * quantum)))
    return tuple(sorted(sizes))


def _prefix_index(n_active, sizes):
    return sum((n_active > s).astype(jnp.int32) for s in sizes[:-1])


def prefix_apply(arrs: dict, n_active, sizes, body_fn):
    """Occupancy-bucketed lane processing: run body_fn on the shortest
    static prefix >= n_active, selected with lax.switch (each bucket is
    compiled once; runtime cost scales with the bucket, not the full
    capacity — the gaussian-beam peak-sized slice arrays run at ~15%
    mean occupancy otherwise). Unlike chunk_apply this is a single
    device-side conditional, not a dynamic-trip while_loop.

    Requires every lane >= n_active to be invalid (bin_beam rank order /
    slip-buffer sort keep valid lanes front-compacted; holes inside the
    prefix are fine — they stay masked). body_fn may reorder lanes
    within the prefix."""
    if len(sizes) == 1:
        P = sizes[0]
        out = body_fn({k: v[:P] for k, v in arrs.items()})
        return {k: (jnp.concatenate([out[k], v[P:]])
                    if P < v.shape[0] else out[k])
                for k, v in arrs.items()}

    def mk(P):
        def br(a):
            out = body_fn({k: v[:P] for k, v in a.items()})
            return {k: (jnp.concatenate([out[k], v[P:]])
                        if P < v.shape[0] else out[k])
                    for k, v in a.items()}
        return br

    return jax.lax.switch(_prefix_index(n_active, sizes),
                          [mk(P) for P in sizes], arrs)


def prefix_reduce(arrs: dict, n_active, sizes, acc, body_fn):
    """Like prefix_apply for reductions: body_fn(acc, head_dict) -> acc
    (acc shapes are bucket-independent, e.g. a field stack)."""
    if len(sizes) == 1:
        return body_fn(acc, {k: v[:sizes[0]] for k, v in arrs.items()})

    def mk(P):
        def br(a):
            return body_fn(acc, {k: v[:P] for k, v in a.items()})
        return br

    return jax.lax.switch(_prefix_index(n_active, sizes),
                          [mk(P) for P in sizes], arrs)


def chunk_reduce(arrs: dict, n_active, chunk: int, acc, body_fn):
    """Like chunk_apply, but body_fn(acc, chunk_dict) -> acc accumulates
    into a carried value (e.g. a field stack) instead of updating lanes."""
    N = next(iter(arrs.values())).shape[0]
    CH = min(chunk, N)
    pad = (-N) % CH
    if pad:
        arrs = {k: jnp.concatenate(
            [v, jnp.zeros((pad,) + v.shape[1:], v.dtype)])
            for k, v in arrs.items()}

    def cond(state):
        i, _ = state
        return i * CH < n_active

    def body(state):
        i, a = state
        off = i * CH
        ch = {k: jax.lax.dynamic_slice_in_dim(v, off, CH, 0)
              for k, v in arrs.items()}
        return i + 1, body_fn(a, ch)

    _, acc = jax.lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), acc))
    return acc


def advance_all_beams(bp: dict, fields: dict, geom: Geometry, cfgs,
                      pc: PhysConst, dt, min_z, order: int = 2, time=0.0,
                      background_density_SI: float = 0.0, fine_levels=(),
                      chunk: int = 0, n_active=None, prefix=None):
    """Push all beam species in the merged array, one masked pass per
    species (static per-species parameters). With chunk > 0 and n_active
    given, lanes are processed in dynamic-count chunks (see chunk_apply).
    With prefix (a prefix_ladder sizes tuple) and n_active given, the
    whole advance runs on an occupancy-bucketed static prefix (see
    prefix_apply)."""
    if chunk and n_active is not None:
        return chunk_apply(
            bp, n_active, chunk,
            lambda ch: advance_all_beams(
                ch, fields, geom, cfgs, pc, dt, min_z, order=order,
                time=time, background_density_SI=background_density_SI,
                fine_levels=fine_levels))
    if prefix is not None and n_active is not None:
        return prefix_apply(
            bp, n_active, prefix,
            lambda head: advance_all_beams(
                head, fields, geom, cfgs, pc, dt, min_z, order=order,
                time=time, background_density_SI=background_density_SI,
                fine_levels=fine_levels))
    out = bp
    for b, cfg in enumerate(cfgs):
        mask = (bp["beam_id"] == b) if len(cfgs) > 1 else None
        out = advance_beam_slice(
            out, fields, geom, cfg, pc, dt, min_z, order=order,
            external_fields=cfg.external_field_fns(), time=time,
            background_density_SI=background_density_SI, species_mask=mask,
            fine_levels=fine_levels)
    return out


def advance_beam_slice(bp: dict, fields: dict, geom: Geometry,
                       cfg: BeamConfig, pc: PhysConst, dt, min_z,
                       order: int = 2, external_fields=None,
                       time=0.0, background_density_SI: float = 0.0,
                       species_mask=None, fine_levels=()):
    """Push beam particles of one slice forward in time by dt
    (ref BeamParticleAdvance.cpp:19-336). Subcycled leapfrog-like push with
    optional external fields, TBMT spin precession (:218-241) and Tamburini
    radiation reaction (:244-299).

    bp: dict of (cap,) arrays. min_z: lower zeta edge of this slice —
    particles that slip below stop being pushed (their remaining subcycles
    continue when their new slice is processed; the resume counter is
    carried in 'nsub').
    """
    from .. import constants as cst

    n_sub = cfg.n_subcycles
    dt = dt / n_sub
    clight = pc.c
    inv_c = 1.0 / pc.c
    inv_c2 = 1.0 / (pc.c * pc.c)
    q_m = cfg.charge / cfg.mass
    spin = cfg.do_spin_tracking
    rr = cfg.do_radiation_reaction
    normalized = pc.c == 1.0

    if rr:
        inv_c_SI = 1.0 / cst.SI_c
        q_over_mc = (q_m / cst.SI_c * cst.SI_q_e / cst.SI_m_e
                     if normalized else q_m / cst.SI_c)
        rr_coeff = (2.0 / 3.0) * cst.SI_r_e * q_over_mc * q_over_mc
        wp_inv = (1.0 / cst.plasma_frequency_SI(background_density_SI)
                  if normalized else 1.0)
        E0 = (cst.SI_m_e * cst.SI_c / wp_inv / cst.SI_q_e
              if normalized else 1.0)

    x, y, z = bp["x"], bp["y"], bp["z"]
    ux, uy, uz = bp["ux"], bp["uy"], bp["uz"]
    w, valid = bp["w"], bp["valid"]
    nsub0 = bp["nsub"]
    if spin:
        sx, sy, sz = bp["sx"], bp["sy"], bp["sz"]

    stopped = jnp.zeros_like(valid)
    nsub_out = nsub0

    for i in range(n_sub):
        # resume semantics: only particles with nsub0 <= i and not stopped
        slipped = z < min_z
        active = valid & (nsub0 <= i) & ~stopped & ~slipped
        if species_mask is not None:
            active = active & species_mask
        stopped = stopped | (slipped & valid & (nsub0 <= i))

        gam_inv = 1.0 / jnp.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * inv_c2)
        xh = x + dt * 0.5 * ux * gam_inv
        yh = y + dt * 0.5 * uy * gam_inv
        xh, yh, ux_b, uy_b, w_b, val_b = enforce_particle_bc(
            xh, yh, ux, uy, w, valid, geom, cfg.particle_boundary,
            bounds=getattr(cfg, "particle_bounds", None))

        exmby, eypbx, ez, bx, by, bz = gather_main_fields(
            xh, yh, fields["Psi"], fields["Ez"], fields["Bx"],
            fields["By"], fields["Bz"], geom, order)
        # MR: gather from the finest level containing the particle
        # (ref BeamParticleAdvance.cpp:165-186); `act` gates levels whose
        # zeta range does not cover this slice
        for ff, fg, act in fine_levels:
            from ..fields.mr import in_level_bounds
            e1, e2, e3, b1, b2, b3 = gather_main_fields(
                xh, yh, ff["Psi"], ff["Ez"], ff["Bx"], ff["By"],
                ff["Bz"], fg, order)
            inb = in_level_bounds(xh, yh, fg) & act
            exmby = jnp.where(inb, e1, exmby)
            eypbx = jnp.where(inb, e2, eypbx)
            ez = jnp.where(inb, e3, ez)
            bx = jnp.where(inb, b1, bx)
            by = jnp.where(inb, b2, by)
            bz = jnp.where(inb, b3, bz)
        if external_fields is not None:
            exmby, eypbx, ez, bx, by, bz = external_fields(
                xh, yh, z, time, clight, exmby, eypbx, ez, bx, by, bz)

        ux_next = ux_b + dt * q_m * (exmby + (clight - uz * gam_inv) * by
                                     + uy_b * gam_inv * bz)
        uy_next = uy_b + dt * q_m * (eypbx + (uz * gam_inv - clight) * bx
                                     - ux_b * gam_inv * bz)
        ux_mid = 0.5 * (ux_next + ux_b)
        uy_mid = 0.5 * (uy_next + uy_b)
        uz_mid = uz + dt * 0.5 * q_m * ez
        gam_mid_inv = 1.0 / jnp.sqrt(
            1.0 + (ux_mid ** 2 + uy_mid ** 2 + uz_mid ** 2) * inv_c2)

        if spin:
            # TBMT precession (ref BeamParticleAdvance.cpp:218-241)
            ex_v = exmby + clight * by
            ey_v = eypbx - clight * bx
            ubx = ux_mid * inv_c
            uby = uy_mid * inv_c
            ubz = uz_mid * inv_c
            btx, bty, btz = (ubx * gam_mid_inv, uby * gam_mid_inv,
                             ubz * gam_mid_inv)
            g1 = gam_mid_inv / (1.0 + gam_mid_inv)
            bXe_x = (bty * ez - btz * ey_v) * inv_c
            bXe_y = (btz * ex_v - btx * ez) * inv_c
            bXe_z = (btx * ey_v - bty * ex_v) * inv_c
            bdotB = btx * bx + bty * by + btz * bz
            aqm = jnp.abs(q_m)
            a = cfg.spin_anom
            omx = aqm * (bx * gam_mid_inv - bXe_x * g1
                         + a * (bx - g1 * ubx * bdotB - bXe_x))
            omy = aqm * (by * gam_mid_inv - bXe_y * g1
                         + a * (by - g1 * uby * bdotB - bXe_y))
            omz = aqm * (bz * gam_mid_inv - bXe_z * g1
                         + a * (bz - g1 * ubz * bdotB - bXe_z))
            hx, hy, hz = omx * dt * 0.5, omy * dt * 0.5, omz * dt * 0.5
            spx = sx + (hy * sz - hz * sy)
            spy = sy + (hz * sx - hx * sz)
            spz = sz + (hx * sy - hy * sx)
            o = 1.0 / (1.0 + hx * hx + hy * hy + hz * hz)
            hdots = hx * spx + hy * spy + hz * spz
            sx_n = o * (spx + hdots * hx + (hy * spz - hz * spy))
            sy_n = o * (spy + hdots * hy + (hz * spx - hx * spz))
            sz_n = o * (spz + hdots * hz + (hx * spy - hy * spx))
            sx = jnp.where(active, sx_n, sx)
            sy = jnp.where(active, sy_n, sy)
            sz = jnp.where(active, sz_n, sz)

        uz_next = uz + dt * q_m * (ez + (ux_mid * by - uy_mid * bx) * gam_mid_inv)

        if rr:
            # Tamburini RR force (ref BeamParticleAdvance.cpp:244-299)
            ex_v = exmby + clight * by
            ey_v = eypbx - clight * bx
            ez_v = ez
            bx_v, by_v, bz_v = bx, by, bz
            if normalized:
                ex_v = ex_v * E0
                ey_v = ey_v * E0
                ez_v = ez_v * E0
                bx_v = bx_v * E0 * inv_c_SI
                by_v = by_v * E0 * inv_c_SI
                bz_v = bz_v * E0 * inv_c_SI
            gam_mid = 1.0 / gam_mid_inv
            vx_n = ux_mid * gam_mid_inv * cst.SI_c * inv_c
            vy_n = uy_mid * gam_mid_inv * cst.SI_c * inv_c
            vz_n = uz_mid * gam_mid_inv * cst.SI_c * inv_c
            bx_n, by_n, bz_n = (vx_n * inv_c_SI if normalized else vx_n / cst.SI_c,
                                vy_n * inv_c_SI if normalized else vy_n / cst.SI_c,
                                vz_n * inv_c_SI if normalized else vz_n / cst.SI_c)
            flx = ex_v + vy_n * bz_v - vz_n * by_v
            fly = ey_v + vz_n * bx_v - vx_n * bz_v
            flz = ez_v + vx_n * by_v - vy_n * bx_v
            fl2 = flx * flx + fly * fly + flz * flz
            bdotE = bx_n * ex_v + by_n * ey_v + bz_n * ez_v
            coeff = gam_mid * gam_mid * (fl2 - bdotE * bdotE)
            frx = rr_coeff * (cst.SI_c * (fly * bz_v - flz * by_v)
                              + bdotE * ex_v - coeff * bx_n)
            fry = rr_coeff * (cst.SI_c * (flz * bx_v - flx * bz_v)
                              + bdotE * ey_v - coeff * by_n)
            frz = rr_coeff * (cst.SI_c * (flx * by_v - fly * bx_v)
                              + bdotE * ez_v - coeff * bz_n)
            fac = dt * wp_inv * clight * inv_c_SI if normalized else dt
            ux_next = ux_next + frx * fac
            uy_next = uy_next + fry * fac
            uz_next = uz_next + frz * fac

        gam_next_inv = 1.0 / jnp.sqrt(
            1.0 + (ux_next ** 2 + uy_next ** 2 + uz_next ** 2) * inv_c2)
        xn = xh + dt * 0.5 * ux_next * gam_next_inv
        yn = yh + dt * 0.5 * uy_next * gam_next_inv
        zn = z + dt * (uz_next * gam_next_inv - clight) if cfg.do_z_push else z

        x = jnp.where(active, xn, x)
        y = jnp.where(active, yn, y)
        z = jnp.where(active, zn, z)
        ux = jnp.where(active, ux_next, ux)
        uy = jnp.where(active, uy_next, uy)
        uz = jnp.where(active, uz_next, uz)
        w = jnp.where(active, w_b, w)
        valid = jnp.where(active, val_b, valid)
        nsub_out = jnp.where(active, i + 1, nsub_out)

    # completed particles reset their counter for the next step
    done = nsub_out >= n_sub
    if species_mask is not None:
        done = done & species_mask
    nsub_out = jnp.where(done, 0, nsub_out)

    out = dict(bp)
    out.update(x=x, y=y, z=z, ux=ux, uy=uy, uz=uz, w=w, valid=valid,
               nsub=nsub_out)
    if spin:
        out.update(sx=sx, sy=sy, sz=sz)
    return out


def _beam_deposit_values(bp, quantities, cfg, pc, invvol, only_salame,
                         skip_slipped_min_z, extra_mask):
    """Per-lane deposit values for deposit_beam_slice (one lane window)."""
    clight_inv = 1.0 / pc.c
    clight_sq = 1.0 / (pc.c * pc.c)
    ux, uy, uz = bp["ux"], bp["uy"], bp["uz"]
    gam_inv = 1.0 / jnp.sqrt(1.0 + (ux * ux + uy * uy + uz * uz) * clight_sq)
    mask = bp["valid"]
    if extra_mask is not None:
        mask = mask & bp["_xmask"]
    if skip_slipped_min_z is not None:
        mask = mask & (bp["z"] >= skip_slipped_min_z)
    if isinstance(cfg, (tuple, list)):
        charges = jnp.asarray([b.charge for b in cfg], ux.dtype)
        charge_p = charges[jnp.clip(bp["beam_id"], 0, len(cfg) - 1)]
        if only_salame:
            sal = jnp.asarray([b.do_salame for b in cfg], bool)
            mask = mask & sal[jnp.clip(bp["beam_id"], 0, len(cfg) - 1)]
    else:
        charge_p = cfg.charge
        if only_salame and not cfg.do_salame:
            mask = jnp.zeros_like(mask)
    wq = jnp.where(mask, charge_p * bp["w"] * invvol, 0.0)
    vx, vy, vz = ux * gam_inv, uy * gam_inv, uz * gam_inv
    values = {
        "jx": wq * vx,
        "jy": wq * vy,
        "jz": wq * vz,
        "rhomjz": wq * (1.0 - vz * clight_inv),
    }
    return [values[q] for q in quantities], mask


def deposit_beam_slice(bp: dict, comp_map: dict, fields: dict,
                       geom: Geometry, cfg, pc: PhysConst,
                       order: int, normalized_units: bool,
                       skip_slipped_min_z=None, only_salame: bool = False,
                       extra_mask=None, geom0: Geometry | None = None,
                       chunk: int = 0, n_active=None, prefix=None):
    """Deposit beam currents (ref BeamDepositCurrent.cpp:60-200).

    comp_map maps quantity -> destination field name, e.g.
    {"jz": "jz_beam"} with quantities in {jx, jy, jz, rhomjz}. cfg may be a
    single BeamConfig or a tuple of configs (multi-beam: per-particle charge
    via the beam_id attribute). only_salame restricts to SALAME-flagged
    beams. Slipped particles (z < skip_slipped_min_z, already deposited on
    their original slice) are excluded when given. chunk/n_active enable
    occupancy-scaled chunked processing (see chunk_apply).
    """
    # normalized units on a fine MR level: (lev0 area)/(level area)
    # (ref BeamDepositCurrent.cpp:72-81)
    g0 = geom0 if geom0 is not None else geom
    invvol = (g0.dx * g0.dy / (geom.dx * geom.dy) if normalized_units
              else 1.0 / (geom.dx * geom.dy * geom.dz))
    quantities = list(comp_map.keys())
    stack = jnp.stack([fields[comp_map[q]] for q in quantities])

    if chunk and n_active is not None:
        lanes = {k: bp[k] for k in ("x", "y", "z", "ux", "uy", "uz", "w",
                                    "valid")}
        if isinstance(cfg, (tuple, list)):
            lanes["beam_id"] = bp["beam_id"]
        if extra_mask is not None:
            lanes["_xmask"] = extra_mask

        def dep(acc, ch):
            vals, _ = _beam_deposit_values(ch, quantities, cfg, pc, invvol,
                                           only_salame, skip_slipped_min_z,
                                           extra_mask)
            return deposit_multi(acc, ch["x"], ch["y"], vals, geom, order)

        stack = chunk_reduce(lanes, n_active, chunk, stack, dep)
    elif prefix is not None and n_active is not None:
        lanes = {k: bp[k] for k in ("x", "y", "z", "ux", "uy", "uz", "w",
                                    "valid")}
        if isinstance(cfg, (tuple, list)):
            lanes["beam_id"] = bp["beam_id"]
        if extra_mask is not None:
            lanes["_xmask"] = extra_mask

        def dep_head(acc, head):
            vals, _ = _beam_deposit_values(
                head, quantities, cfg, pc, invvol, only_salame,
                skip_slipped_min_z,
                head.get("_xmask") if extra_mask is not None else None)
            return deposit_multi(acc, head["x"], head["y"], vals, geom,
                                 order)

        stack = prefix_reduce(lanes, n_active, prefix, stack, dep_head)
    else:
        bpv = dict(bp)
        if extra_mask is not None:
            bpv["_xmask"] = extra_mask
        vals, _ = _beam_deposit_values(bpv, quantities, cfg, pc, invvol,
                                       only_salame, skip_slipped_min_z,
                                       extra_mask)
        stack = deposit_multi(stack, bp["x"], bp["y"], vals, geom, order)
    out = dict(fields)
    for i, q in enumerate(quantities):
        out[comp_map[q]] = stack[i]
    return out
