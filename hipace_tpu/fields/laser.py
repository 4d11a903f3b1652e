"""Laser envelope solver (Benedetti 2017 / Wake-T scheme).

A JAX re-design of MultiLaser (ref: src/laser/
MultiLaser.{H,cpp}, Laser.{H,cpp}): the complex envelope A(x, y, zeta) is
advanced one time step per slice by solving a 2D complex Helmholtz equation

    (Laplacian_perp - a) A^{n+1}_j = rhs(A^n, A^{n-1}, neighbors, chi)

with either the complex multigrid (hpmg solve2 equivalent,
ref MultiLaser.cpp:430-607) or a periodic-FFT spectral solve
(ref MultiLaser.cpp:610-780). The on-axis phase extraction and the djn
phase-advance term follow MultiLaser.cpp:470-529.

State layout per scan iteration (the reference's 18-component slice fab,
ref MultiLaser.H:23-49, becomes complex jnp arrays):
  xs:     n00j00, nm1j00        (streamed between steps)
  carry:  n00jp1/jp2, nm1jp1/jp2, np1jp1/jp2
  output: np1j00 (the advanced slice), also used as the next step's n00.
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp

from ..constants import PhysConst
from ..geometry import Geometry
from ..parser import Inputs, compile_function
from .multigrid import MultiGrid
from . import slices as sl


@dataclasses.dataclass(frozen=True)
class LaserPulseConfig:
    """One pulse (ref Laser.{H,cpp}): gaussian or parsed profile."""
    init_type: str = "gaussian"
    a0: float = 0.0
    w0: float = 0.0
    L0: float = 0.0
    CEP: float = 0.0
    focal_distance: float = 0.0
    position_mean: tuple[float, float, float] = (0.0, 0.0, 0.0)
    propagation_angle_yz: float = 0.0
    # default pi/2 makes the (pft - pi/2) rotation the identity
    # (ref Laser.H:39)
    PFT_yz: float = math.pi / 2.0
    profile_real_expr: str = "0"
    profile_imag_expr: str = "0"
    consts: tuple = ()
    # from_file init (ref Laser.H:53-62, Laser.cpp:22-30)
    input_file: str = ""
    file_envelope_name: str = "laserEnvelope"
    file_iteration: int = 0

    @classmethod
    def from_inputs(cls, inputs: Inputs, name: str, pc: PhysConst):
        pp = inputs.prefix(name)
        init_type = pp.query("init_type", "gaussian", str)
        L0 = pp.query("L0", 0.0)
        if pp.contains("tau"):
            L0 = pp.get("tau") * pc.c
        pr, pi = "0", "0"
        f = pp.get_function("laser_real", ("x", "y", "z"))
        if f is not None:
            pr = f.expr
            init_type = "parser" if pp.query("init_type", "", str) == "" else init_type
        f = pp.get_function("laser_imag", ("x", "y", "z"))
        if f is not None:
            pi = f.expr
        return cls(
            init_type=init_type,
            a0=pp.query("a0", 0.0),
            w0=pp.query("w0", 0.0),
            L0=L0,
            CEP=pp.query("CEP", 0.0),
            focal_distance=pp.query("focal_distance", 0.0),
            position_mean=tuple(pp.query_list("position_mean", [0., 0., 0.])),
            propagation_angle_yz=pp.query("propagation_angle_yz", 0.0),
            PFT_yz=pp.query("PFT_yz", math.pi / 2.0),
            input_file=pp.query("input_file", "", str),
            file_envelope_name=pp.query("openPMD_laser_name",
                                        "laserEnvelope", str),
            file_iteration=pp.query("iteration", 0, int),
            profile_real_expr=pr, profile_imag_expr=pi,
            consts=tuple(sorted((k, float(v)) for k, v in
                                inputs.my_constants.items()
                                if isinstance(v, (int, float)))),
        )


@dataclasses.dataclass(frozen=True)
class LaserConfig:
    """The laser subsystem (ref MultiLaser::ReadParameters)."""
    pulses: tuple = ()
    lambda0: float = 0.8e-6
    solver_type: str = "multigrid"      # "multigrid" | "fft"
    use_phase: bool = True
    interp_order: int = 1  # laser<->field grid interpolation (ref :40)
    MG_tolerance_rel: float = 1e-4
    MG_tolerance_abs: float = 0.0
    MG_average_rhs: bool = True

    @classmethod
    def from_inputs(cls, inputs: Inputs, pc: PhysConst):
        names = inputs.query_list("lasers.names", [], str)
        if names == ["no_laser"]:
            names = []
        pulses = tuple(LaserPulseConfig.from_inputs(inputs, n, pc)
                       for n in names)
        pp = inputs.prefix("lasers")
        return cls(
            pulses=pulses,
            lambda0=pp.query("lambda0", 0.8e-6),
            solver_type=pp.query("solver_type", "multigrid", str),
            use_phase=pp.query("use_phase", True, bool),
            interp_order=pp.query("interp_order", 1, int),
            MG_tolerance_rel=pp.query("MG_tolerance_rel", 1e-4),
            MG_tolerance_abs=pp.query("MG_tolerance_abs", 0.0),
            MG_average_rhs=pp.query("MG_average_rhs", True, bool),
        )

    @property
    def use_laser(self) -> bool:
        return len(self.pulses) > 0

    @property
    def from_file(self) -> bool:
        return any(p.init_type == "from_file" for p in self.pulses)


def make_laser_geometry(inputs: Inputs, geom0: Geometry):
    """Build the laser's own 3D geometry (ref MultiLaser::MakeLaserGeometry,
    MultiLaser.cpp:59-110): lasers.n_cell / patch_lo / patch_hi, defaulting
    to the field geometry; zeta snaps to field slices. Returns
    (Geometry, zeta_lo, zeta_hi)."""
    pp = inputs.prefix("lasers")
    n_cell = pp.query_list("n_cell", [geom0.nx, geom0.ny], int)
    patch_lo = pp.query_list("patch_lo", list(geom0.prob_lo))
    patch_hi = pp.query_list("patch_hi", list(geom0.prob_hi))
    poff_z = geom0.z_pos_offset
    zeta_lo = max(0, round((patch_lo[2] - poff_z) / geom0.dz))
    zeta_hi = min(geom0.nz - 1, round((patch_hi[2] - poff_z) / geom0.dz))
    lo_z = (zeta_lo - 0.5) * geom0.dz + poff_z
    hi_z = (zeta_hi + 0.5) * geom0.dz + poff_z
    # snap to the field geometry exactly when they coincide (identity
    # interpolation fast path; avoids float round-off in the z rebuild)
    tol = 1e-12 * max(abs(geom0.prob_hi[0] - geom0.prob_lo[0]), 1e-300)
    if (tuple(n_cell) == (geom0.nx, geom0.ny)
            and zeta_lo == 0 and zeta_hi == geom0.nz - 1
            and all(abs(patch_lo[d] - geom0.prob_lo[d]) < tol
                    and abs(patch_hi[d] - geom0.prob_hi[d]) < tol
                    for d in (0, 1))):
        return geom0, 0, geom0.nz - 1
    g = Geometry(
        n_cell=(int(n_cell[0]), int(n_cell[1]), zeta_hi - zeta_lo + 1),
        prob_lo=(patch_lo[0], patch_lo[1], lo_z),
        prob_hi=(patch_hi[0], patch_hi[1], hi_z),
        nguards=geom0.nguards, is_periodic=(False, False, False))
    return g, zeta_lo, zeta_hi


def _lin_take(arr, axis, idx, w0, w1, n_src):
    """Separable order-1 interpolation along one axis with zero fill
    outside the source extent (ref ShapeFactors.H compute_shape_factor<1>
    + the bounds checks in Laser.cpp:207-224)."""
    import numpy as np
    i0 = np.clip(idx, 0, n_src - 1)
    i1 = np.clip(idx + 1, 0, n_src - 1)
    v0 = np.where((idx >= 0) & (idx < n_src), 1.0, 0.0)
    v1 = np.where((idx + 1 >= 0) & (idx + 1 < n_src), 1.0, 0.0)
    a0 = np.take(arr, i0, axis=axis)
    a1 = np.take(arr, i1, axis=axis)
    shape = [1] * arr.ndim
    shape[axis] = -1
    return (a0 * (w0 * v0).reshape(shape)
            + a1 * (w1 * v1).reshape(shape))


def _shape1(mid):
    """floor index + (1-frac, frac) weights (compute_shape_factor<1>)."""
    import numpy as np
    idx = np.floor(mid).astype(np.int64)
    frac = mid - idx
    return idx, 1.0 - frac, frac


def _read_envelope_file(p, geom: Geometry, clight: float):
    """One pulse's from_file envelope on the laser grid interior
    (nz, ny, nx complex) — the rebuild of the reference's
    GetEnvelopeFromFile (ref Laser.cpp:119-330): openPMD/lasy layouts
    xyt (axes t,y,x), xyz (z,y,x) and rt (t,r with azimuthal modes),
    order-1 interpolation onto the simulation grid, unitSI scaling."""
    import h5py
    import numpy as np

    name = p.file_envelope_name
    with h5py.File(p.input_file, "r") as f:
        it = f[f"data/{p.file_iteration}"]
        mesh = it["fields"]
        if name in mesh:
            ds = mesh[name]
        elif f"laser_diag/{name}" in mesh:
            ds = mesh[f"laser_diag/{name}"]
        else:
            raise KeyError(f"{name} not found in {p.input_file}")
        arr = np.asarray(ds)
        labels = [lb.decode() if isinstance(lb, bytes) else str(lb)
                  for lb in ds.attrs.get("axisLabels",
                                         [b"z", b"y", b"x"])]
        spacing = np.asarray(ds.attrs.get("gridSpacing",
                                          [geom.dz, geom.dy, geom.dx]),
                             np.float64)
        offset = np.asarray(ds.attrs.get("gridGlobalOffset",
                                         [0.0, 0.0, 0.0]), np.float64)
        position = np.asarray(ds.attrs.get("position",
                                           [0.0] * arr.ndim), np.float64)
        unitSI = float(ds.attrs.get("unitSI", 1.0))

    arr = arr.astype(np.complex128) * unitSI
    # target grid (cell centers, interior only)
    x = (np.arange(geom.nx) + 0.5) * geom.dx + geom.prob_lo[0]
    y = (np.arange(geom.ny) + 0.5) * geom.dy + geom.prob_lo[1]
    z = (np.arange(geom.nz) + 0.5) * geom.dz + geom.prob_lo[2]
    zmax = geom.prob_hi[2] - geom.dz / 2

    if labels == ["t", "y", "x"] or labels == ["z", "y", "x"]:
        # arr axes: (t_or_z, y, x)
        ymin_l = offset[1] + position[1] * spacing[1]
        xmin_l = offset[2] + position[2] * spacing[2]
        ix, wx0, wx1 = _shape1((x - xmin_l) / spacing[2])
        iy, wy0, wy1 = _shape1((y - ymin_l) / spacing[1])
        if labels[0] == "t":
            tmid = (zmax - z) / clight / spacing[0]
        else:
            zmin_l = offset[0] + position[0] * spacing[0]
            tmid = (z - zmin_l) / spacing[0]
        iz, wz0, wz1 = _shape1(tmid)
        out = _lin_take(arr, 2, ix, wx0, wx1, arr.shape[2])
        out = _lin_take(out, 1, iy, wy0, wy1, arr.shape[1])
        out = _lin_take(out, 0, iz, wz0, wz1, arr.shape[0])
        return out

    if labels == ["t", "r"]:
        # lasy rt: arr axes (modes, t, r); mode 0 + (cos, sin) pairs
        # (ref Laser.cpp:281-330)
        if arr.ndim == 2:
            arr = arr[None]
        nmodes, nt, nr = arr.shape
        rmin_l = offset[1] + position[1] * spacing[1]
        X, Y = np.meshgrid(x, y)                     # (ny, nx)
        r = np.sqrt(X * X + Y * Y)
        theta = np.arctan2(Y, X)
        ir, wr0, wr1 = _shape1((r - rmin_l) / spacing[1])
        it_, wt0, wt1 = _shape1((zmax - z) / clight / spacing[0])
        # radial interp per mode: (nmodes, nt, ny, nx)
        ir0 = np.clip(ir, 0, nr - 1)
        ir1 = np.clip(ir + 1, 0, nr - 1)
        vr0 = ((ir >= 0) & (ir < nr)).astype(np.float64) * wr0
        vr1 = ((ir + 1 >= 0) & (ir + 1 < nr)).astype(np.float64) * wr1
        rad = arr[:, :, ir0] * vr0 + arr[:, :, ir1] * vr1
        # azimuthal synthesis -> (nt, ny, nx)
        acc = rad[0]
        for m in range(1, (nmodes - 1) // 2 + 1):
            acc = acc + rad[2 * m - 1] * np.cos(m * theta) \
                      + rad[2 * m] * np.sin(m * theta)
        # temporal interp -> (nz, ny, nx)
        it0 = np.clip(it_, 0, nt - 1)
        it1 = np.clip(it_ + 1, 0, nt - 1)
        vt0 = ((it_ >= 0) & (it_ < nt)).astype(np.float64) * wt0
        vt1 = ((it_ + 1 >= 0) & (it_ + 1 < nt)).astype(np.float64) * wt1
        return acc[it0] * vt0[:, None, None] + acc[it1] * vt1[:, None, None]

    raise ValueError(f"unsupported laser file axisLabels {labels} "
                     "(must be t/y/x, z/y/x or t/r)")


def load_laser_from_file(lcfg: LaserConfig, geom: Geometry, dtype,
                         zeta_lo: int = 0, nz_global: int | None = None,
                         clight: float = 1.0):
    """Assemble the initial envelope stream from openPMD file(s)
    (ref Laser.cpp:19-60 + GetEnvelopeFromFile): every from_file pulse is
    read and interpolated onto the laser grid; analytic (gaussian/parser)
    pulses in the same run are summed in so multi-pulse decks compose
    freely. The returned stream is indexed by GLOBAL slice index (rows
    outside the laser zeta range stay zero); guards zero."""
    import numpy as np

    G = geom.nguards
    NY, NX = geom.slice_shape
    nz_global = geom.nz if nz_global is None else nz_global
    interior = np.zeros((geom.nz, geom.ny, geom.nx), np.complex128)
    analytic = [p for p in lcfg.pulses if p.init_type != "from_file"]
    for p in lcfg.pulses:
        if p.init_type == "from_file":
            interior += _read_envelope_file(p, geom, clight)
    if analytic:
        import dataclasses as _dc
        sub = _dc.replace(lcfg, pulses=tuple(analytic))
        z = (np.arange(geom.nz) + 0.5) * geom.dz + geom.prob_lo[2]
        rows = [np.asarray(envelope_slice(sub, geom, float(zk), dtype))
                for zk in z]
        interior += np.stack(rows)[:, G:NY - G, G:NX - G]

    ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    full = np.zeros((nz_global, NY, NX), np.complex128)
    full[zeta_lo:zeta_lo + geom.nz, G:NY - G, G:NX - G] = interior
    return jnp.asarray(full, ctype)


def envelope_slice(lcfg: LaserConfig, geom: Geometry, z, dtype):
    """Initial envelope A0 at zeta position z, all pulses summed
    (ref MultiLaser.cpp:804-920 InitLaserSlice). geom is the laser
    geometry (transverse); z may be traced."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    k0 = 2.0 * math.pi / lcfg.lambda0
    x = (jnp.arange(NX, dtype=dtype) - G + 0.5) * geom.dx + geom.prob_lo[0]
    y = (jnp.arange(NY, dtype=dtype) - G + 0.5) * geom.dy + geom.prob_lo[1]
    X = x[None, :]
    Y = y[:, None]
    ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    env = jnp.zeros((NY, NX), ctype)
    for p in lcfg.pulses:
        if p.init_type == "gaussian":
            x0, y0, z0 = p.position_mean
            ang = p.propagation_angle_yz
            pft = p.PFT_yz - math.pi / 2.0
            xs = X - x0
            ys = Y - y0
            zs = z - z0
            yp = math.cos(ang + pft) * ys - math.sin(ang + pft) * zs
            zp = math.sin(ang + pft) * ys + math.cos(ang + pft) * zs
            diffract = 1.0 + 1j * (zp - p.focal_distance
                                   + z0 * math.cos(ang)) * 2.0 / (k0 * p.w0 ** 2)
            inv_w2 = 1.0 / (p.w0 ** 2 * diffract)
            pref = p.a0 / diffract
            stc = pref * jnp.exp(-(zp * zp) / (p.L0 ** 2))
            envp = stc * jnp.exp(-(xs * xs + yp * yp) * inv_w2) \
                * jnp.exp(1j * (yp * k0 * ang) + p.CEP)
            env = env + envp.astype(ctype)
        else:  # parser
            fr = compile_function(p.profile_real_expr, ("x", "y", "z"), p.consts)
            fi = compile_function(p.profile_imag_expr, ("x", "y", "z"), p.consts)
            zz = jnp.broadcast_to(jnp.asarray(z, dtype), (NY, NX))
            env = env + (jnp.asarray(fr(X + 0 * Y, Y + 0 * X, zz), dtype)
                         + 1j * jnp.asarray(fi(X + 0 * Y, Y + 0 * X, zz), dtype)
                         ).astype(ctype)
    # zero ghosts (valid region only), like the reference's tilebox fill
    mask = jnp.zeros((NY, NX), bool).at[G:NY - G, G:NX - G].set(True)
    return jnp.where(mask, env, 0.0)


def initial_chi(lcfg: LaserConfig, plasma_cfgs, geom: Geometry, pc: PhysConst,
                c_t, dtype):
    """chi from the plasma density function (ref MultiLaser.cpp:294-331)."""
    NY, NX = geom.slice_shape
    G = geom.nguards
    x = (jnp.arange(NX, dtype=dtype) - G + 0.5) * geom.dx + geom.prob_lo[0]
    y = (jnp.arange(NY, dtype=dtype) - G + 0.5) * geom.dy + geom.prob_lo[1]
    X = jnp.broadcast_to(x[None, :], (NY, NX))
    Y = jnp.broadcast_to(y[:, None], (NY, NX))
    chi = jnp.zeros((NY, NX), dtype)
    for pcfg in plasma_cfgs:
        fac = pcfg.charge ** 2 * pc.mu0 / pcfg.mass
        if pcfg.can_ionize:
            fac *= pcfg.init_ion_lev ** 2
        fn = pcfg.density_fn()
        dens = jnp.broadcast_to(
            jnp.asarray(fn(X, Y, jnp.broadcast_to(c_t, X.shape)), dtype),
            X.shape)
        chi = chi + dens * fac
    return chi


def _on_axis_phase(a, geom: Geometry):
    """Mean on-axis phase (ref MultiLaser.cpp:470-515): sum the central
    cell(s), take the argument."""
    G = geom.nguards
    nx, ny = geom.nx, geom.ny
    imid = (nx + 1) // 2 + G
    jmid = (ny + 1) // 2 + G
    if nx % 2 == 0:
        ax = a[..., imid - 1] + a[..., imid]
    else:
        ax = a[..., imid]
    if ny % 2 == 0:
        v = ax[..., jmid - 1] + ax[..., jmid]
    else:
        v = ax[..., jmid]
    return jnp.arctan2(v.imag, v.real)


def make_laser_advance(lcfg: LaserConfig, geom: Geometry, pc: PhysConst,
                       dtype):
    """Build the per-slice laser advance: returns np1j00 given the state.

    Implements both AdvanceSliceMG (ref MultiLaser.cpp:430-607) and
    AdvanceSliceFFT (:610-780); `step0` selects the non-centered first-step
    variant as a traced boolean via jnp.where on the coefficient sets.
    """
    g = geom
    k0 = 2.0 * math.pi / lcfg.lambda0
    c = pc.c
    dx, dy, dz = g.dx, g.dy, g.dz
    G = g.nguards
    NY, NX = g.slice_shape
    mg = MultiGrid(g.nx, g.ny, dx, dy, dtype) \
        if lcfg.solver_type == "multigrid" else None

    def lap_tr(a):
        """Transverse Laplacian, zero on the valid-box edge
        (ref MultiLaser.cpp: lapR/lapI edge guard)."""
        lap = jnp.zeros_like(a)
        lap = lap.at[1:-1, 1:-1].set(
            (a[1:-1, 2:] + a[1:-1, :-2] - 2 * a[1:-1, 1:-1]) / (dx * dx)
            + (a[2:, 1:-1] + a[:-2, 1:-1] - 2 * a[1:-1, 1:-1]) / (dy * dy))
        # zero outside + on the edge of the valid box
        mask = jnp.zeros_like(a.real, dtype=bool)
        mask = mask.at[G + 1:NY - G - 1, G + 1:NX - G - 1].set(True)
        return jnp.where(mask, lap, 0.0)

    def advance(state, chi, dt, step):
        """state: dict with complex (NY, NX) arrays n00j00, n00jp1, n00jp2,
        nm1j00, nm1jp1, nm1jp2, np1jp1, np1jp2. chi: real (NY, NX).
        Returns np1j00."""
        n00j00 = state["n00j00"]
        is0 = step == 0

        if lcfg.use_phase:
            tj00 = _on_axis_phase(state["n00j00"], g)
            tjp1 = _on_axis_phase(state["n00jp1"], g)
            tjp2 = _on_axis_phase(state["n00jp2"], g)
            two_pi = 2.0 * math.pi
            dt1 = tj00 - tjp1
            dt2 = tjp1 - tjp2
            dt1 = jnp.where(dt1 < -1.5 * math.pi, dt1 + two_pi, dt1)
            dt1 = jnp.where(dt1 > 1.5 * math.pi, dt1 - two_pi, dt1)
            dt2 = jnp.where(dt2 < -1.5 * math.pi, dt2 + two_pi, dt2)
            dt2 = jnp.where(dt2 > 1.5 * math.pi, dt2 - two_pi, dt2)
            exp1 = jnp.exp(1j * (tj00 - tjp1))
            exp2 = jnp.exp(1j * (tj00 - tjp2))
            djn = (-3.0 * dt1 + dt2) / (2.0 * dz)
        else:
            exp1 = jnp.asarray(1.0 + 0j)
            exp2 = jnp.asarray(1.0 + 0j)
            djn = jnp.asarray(0.0, dtype)

        acoeff_r = jnp.where(is0, 6.0 / (c * dt * dz),
                             3.0 / (c * dt * dz) + 2.0 / (c * c * dt * dt))
        acoeff_i = jnp.where(is0, -4.0 * (k0 + djn) / (c * dt),
                             -2.0 * (k0 + djn) / (c * dt))

        lapA = jnp.where(is0, lap_tr(state["n00j00"]), lap_tr(state["nm1j00"]))

        # rhs, both step variants (ref MultiLaser.cpp:536-596)
        rhs0 = (+ 8.0 / (c * dt * dz) * (-state["np1jp1"] + state["n00jp1"]) * exp1
                + 2.0 / (c * dt * dz) * (+state["np1jp2"] - state["n00jp2"]) * exp2
                - lapA
                + (-6.0 / (c * dt * dz) + 4.0j * djn / (c * dt)
                   + 4.0j * k0 / (c * dt)) * n00j00)
        rhs1 = (+ 4.0 / (c * dt * dz) * (-state["np1jp1"] + state["nm1jp1"]) * exp1
                + 1.0 / (c * dt * dz) * (+state["np1jp2"] - state["nm1jp2"]) * exp2
                - 4.0 / (c * c * dt * dt) * n00j00
                - lapA
                + (-3.0 / (c * dt * dz) + 2.0j * djn / (c * dt)
                   + 2.0 / (c * c * dt * dt) + 2.0j * k0 / (c * dt))
                * state["nm1j00"])
        if lcfg.solver_type == "multigrid" and lcfg.MG_average_rhs:
            rhs0 = rhs0 + chi * n00j00
            rhs1 = rhs1 + chi * state["nm1j00"]
        else:
            rhs0 = rhs0 + 2.0 * chi * n00j00
            rhs1 = rhs1 + 2.0 * chi * n00j00
        rhs = jnp.where(is0, rhs0, rhs1)

        if lcfg.solver_type == "fft":
            # spectral solve with periodic Laplacian eigenvalues -(kx^2+ky^2)
            # (ref MultiLaser.cpp:758-780)
            rhs_i = sl.interior(rhs, g)
            kx = 2.0 * math.pi * jnp.fft.fftfreq(g.nx, d=dx).astype(dtype)
            ky = 2.0 * math.pi * jnp.fft.fftfreq(g.ny, d=dy).astype(dtype)
            k2 = kx[None, :] ** 2 + ky[:, None] ** 2
            acoeff = acoeff_r + 1j * acoeff_i
            spec = jnp.fft.fft2(rhs_i)
            sol = jnp.fft.ifft2(spec * (-1.0 / (k2 + acoeff)))
            np1j00 = sl.set_interior(jnp.zeros_like(rhs), sol, g)
        else:
            # complex multigrid (hpmg solve2 equivalent)
            acf_r = acoeff_r + sl.interior(chi, g) if lcfg.MG_average_rhs \
                else jnp.broadcast_to(acoeff_r, (g.ny, g.nx))
            acf = acf_r + 1j * acoeff_i
            guess = sl.interior(state["np1jp1"], g)
            sol = mg.solve(guess, sl.interior(rhs, g), acf,
                           tol_rel=lcfg.MG_tolerance_rel,
                           tol_abs=lcfg.MG_tolerance_abs, max_iters=40)
            np1j00 = sl.set_interior(jnp.zeros_like(rhs), sol, g)
        return np1j00

    return advance


def laser_empty_state(geom: Geometry, dtype) -> dict:
    ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    z = jnp.zeros(geom.slice_shape, ctype)
    return {k: z for k in ("n00j00", "n00jp1", "n00jp2", "nm1j00", "nm1jp1",
                           "nm1jp2", "np1jp1", "np1jp2")}
