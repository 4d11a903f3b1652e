"""In-situ reduced diagnostics: per-slice weighted moments.

JAX equivalent of the reference's high-frequency observability path
(ref: /root/reference/src/utils/InsituUtil.H; Fields.cpp:1288-1348;
BeamParticleContainer.cpp:476-594; PlasmaParticleContainer.cpp:443-505):
cheap per-slice moments computed inside the zeta scan, written per step as a
NumPy structured-dtype binary with a JSON header — the same on-disk format
as the reference, readable by tools/read_insitu_diagnostics.py and the
reference's own reader.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np


# moment orders match the reference reduce tuples
BEAM_NAMES = ("sum(w)", "[x]", "[x^2]", "[y]", "[y^2]", "[z]", "[z^2]",
              "[ux]", "[ux^2]", "[uy]", "[uy^2]", "[uz]", "[uz^2]",
              "[x*ux]", "[y*uy]", "[z*uz]", "[x*uy]", "[y*ux]",
              "[ux/uz]", "[uy/uz]", "[ga]", "[ga^2]", "Np")

PLASMA_NAMES = ("sum(w)", "[x]", "[x^2]", "[y]", "[y^2]",
                "[ux]", "[ux^2]", "[uy]", "[uy^2]", "[uz]", "[uz^2]",
                "[ga]", "[ga^2]", "[(ga-1)*(1-vz)]", "Np")

FIELD_NAMES = ("[Ex^2]", "[Ey^2]", "[Ez^2]", "[Bx^2]", "[By^2]", "[Bz^2]",
               "[ExmBy^2]", "[EypBx^2]", "[jz_beam]", "[Ez*jz_beam]")


def beam_slice_moments(bp: dict, pc, insitu_radius: float = float("inf")):
    """(23,) raw weighted sums (ref BeamParticleContainer.cpp:511-535)."""
    c_inv = 1.0 / pc.c
    x, y, z = bp["x"], bp["y"], bp["z"]
    ux = bp["ux"] * c_inv
    uy = bp["uy"] * c_inv
    uz = bp["uz"] * c_inv
    m = bp["valid"] & (x * x + y * y <= insitu_radius ** 2)
    w = jnp.where(m, bp["w"], 0.0)
    gam = jnp.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    uz_inv = jnp.where(uz == 0.0, 0.0, 1.0 / jnp.where(uz == 0.0, 1.0, uz))
    vals = [w, w * x, w * x * x, w * y, w * y * y, w * z, w * z * z,
            w * ux, w * ux * ux, w * uy, w * uy * uy, w * uz, w * uz * uz,
            w * x * ux, w * y * uy, w * z * uz, w * x * uy, w * y * ux,
            w * ux * uz_inv, w * uy * uz_inv, w * gam, w * gam * gam,
            m.astype(w.dtype)]
    return jnp.stack([jnp.sum(v) for v in vals])


def plasma_slice_moments(p: dict, pc, insitu_radius: float = float("inf")):
    """(15,) raw weighted sums (ref PlasmaParticleContainer.cpp:488-504)."""
    c_inv = 1.0 / pc.c
    x, y = p["x"], p["y"]
    ux = p["ux"] * c_inv
    uy = p["uy"] * c_inv
    psi = p["psi"]
    m = p["valid"] & (x * x + y * y <= insitu_radius ** 2)
    w = jnp.where(m, p["w"], 0.0)
    gam = (1.0 + ux * ux + uy * uy + psi * psi) / (2.0 * psi)
    uz = gam - psi
    energy = w * (gam - 1.0) * psi / gam  # (ga-1)*(1-vz), 1-vz = psi/gam
    vals = [w, w * x, w * x * x, w * y, w * y * y,
            w * ux, w * ux * ux, w * uy, w * uy * uy, w * uz, w * uz * uz,
            w * gam, w * gam * gam, energy, m.astype(w.dtype)]
    return jnp.stack([jnp.sum(v) for v in vals])


def field_slice_moments(this: dict, geom, pc, dxdydz):
    """(10,) per-slice field sums x cell volume (ref Fields.cpp:1322-1346)."""
    from ..fields.slices import interior
    c = pc.c
    ex = interior(this["ExmBy"] + this["By"] * c, geom)
    ey = interior(this["EypBx"] - this["Bx"] * c, geom)
    ez = interior(this["Ez"], geom)
    bx = interior(this["Bx"], geom)
    by = interior(this["By"], geom)
    bz = interior(this["Bz"], geom)
    jzb = interior(this["jz_beam"], geom)
    vals = [ex * ex, ey * ey, ez * ez, bx * bx, by * by, bz * bz,
            interior(this["ExmBy"], geom) ** 2,
            interior(this["EypBx"], geom) ** 2,
            jzb, ez * jzb]
    return jnp.stack([jnp.sum(v) for v in vals]) * dxdydz


LASER_NAMES = ("max(|a|^2)", "[|a|^2]", "[|a|^2*x]", "[|a|^2*x*x]",
               "[|a|^2*y]", "[|a|^2*y*y]")


def laser_slice_moments(env, geom):
    """(8,) laser per-slice moments (ref MultiLaser.H:241-256): max|a|^2,
    integrated |a|^2 moments and the on-axis complex envelope (re, im)."""
    from ..fields.slices import interior
    G = geom.nguards
    a = interior(env, geom)
    aabs = jnp.abs(a) ** 2
    xs = geom.prob_lo[0] + (jnp.arange(geom.nx) + 0.5) * geom.dx
    ys = geom.prob_lo[1] + (jnp.arange(geom.ny) + 0.5) * geom.dy
    X = xs[None, :]
    Y = ys[:, None]
    ax = a[geom.ny // 2, geom.nx // 2]
    return jnp.stack([
        jnp.max(aabs), jnp.sum(aabs), jnp.sum(aabs * X),
        jnp.sum(aabs * X * X), jnp.sum(aabs * Y), jnp.sum(aabs * Y * Y),
        jnp.real(ax), jnp.imag(ax)])


def laser_record(step, time, moments, geom, normalized_units):
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "is_normalized_units": int(normalized_units),
    }
    dxdy = geom.dx * geom.dy
    rec["max(|a|^2)"] = m[:, 0]
    for i, name in enumerate(LASER_NAMES[1:], start=1):
        rec[name] = m[:, i] * dxdy
    rec["axis(a).re"] = m[:, 6]
    rec["axis(a).im"] = m[:, 7]
    return rec


# ----------------------------------------------------------------------
def _dtype_json(record):
    """Build the JSON dtype description for one record (nested dicts become
    nested structured dtypes, like insitu_utils::write_header)."""
    names, formats = [], []
    for k, v in record.items():
        names.append(k)
        if isinstance(v, dict):
            formats.append(_dtype_json(v))
        elif isinstance(v, (int, np.integer)):
            formats.append("<i4")
        elif isinstance(v, float):
            formats.append("<f8")
        else:
            arr = np.asarray(v)
            t = "<i4" if arr.dtype.kind in "iu" else "<f8"
            formats.append(f"({arr.size},){t}")
    return {"names": names, "formats": formats}


def _pack(record, out: list):
    for k, v in record.items():
        if isinstance(v, dict):
            _pack(v, out)
        elif isinstance(v, (int, np.integer)):
            out.append(np.int32(v).tobytes())
        elif isinstance(v, float):
            out.append(np.float64(v).tobytes())
        else:
            arr = np.asarray(v)
            t = np.int32 if arr.dtype.kind in "iu" else np.float64
            out.append(np.ascontiguousarray(arr, t).tobytes())


class InsituWriter:
    """Appends one structured record per step; JSON header written once."""

    def __init__(self, prefix: str, name: str, rank: int = 0):
        self.prefix = prefix
        self.name = name
        self.rank = rank
        self._wrote_header = False

    def _file(self):
        os.makedirs(self.prefix, exist_ok=True)
        return os.path.join(self.prefix,
                            f"reduced_{self.name}.{self.rank:04d}.txt")

    def write_record(self, record: dict):
        payload: list = []
        _pack(record, payload)
        mode = "ab" if self._wrote_header else "wb"
        with open(self._file(), mode) as f:
            if not self._wrote_header:
                f.write(json.dumps(_dtype_json(record)).encode())
                self._wrote_header = True
            for p in payload:
                f.write(p)


def beam_record(step, time, moments, charge, mass, geom, normalized_units):
    """Assemble the beam record (ref BeamParticleContainer.cpp:620-686):
    per-slice moments normalized by the slice weight, plus 'average' and
    'total' sub-records. moments: (nslices, 23) raw sums."""
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    sw = m[:, 0]
    sw_inv = np.where(sw > 0, 1.0 / np.where(sw > 0, sw, 1.0), 0.0)
    tot = m.sum(axis=0)
    sw0 = tot[0] if tot[0] > 0 else 1.0
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "charge": float(charge), "mass": float(mass),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "normalized_density_factor": float(
            geom.dx * geom.dy * geom.dz if normalized_units else 1.0),
        "is_normalized_units": int(normalized_units),
    }
    for i, name in enumerate(BEAM_NAMES[1:-1], start=1):
        rec[name] = m[:, i] * sw_inv
    rec["sum(w)"] = sw
    rec["Np"] = m[:, 22].astype(np.int32)
    rec["average"] = {name: float(tot[i] / sw0)
                      for i, name in enumerate(BEAM_NAMES[1:-1], start=1)}
    rec["total"] = {"sum(w)": float(tot[0]), "Np": int(tot[22])}
    return rec


def plasma_record(step, time, moments, charge, mass, geom, normalized_units):
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    sw = m[:, 0]
    sw_inv = np.where(sw > 0, 1.0 / np.where(sw > 0, sw, 1.0), 0.0)
    tot = m.sum(axis=0)
    sw0 = tot[0] if tot[0] > 0 else 1.0
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "charge": float(charge), "mass": float(mass),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "normalized_density_factor": float(
            geom.dx * geom.dy * geom.dz if normalized_units else 1.0),
        "is_normalized_units": int(normalized_units),
    }
    for i, name in enumerate(PLASMA_NAMES[1:-1], start=1):
        rec[name] = m[:, i] * sw_inv
    rec["sum(w)"] = sw
    rec["Np"] = m[:, 14].astype(np.int32)
    rec["average"] = {name: float(tot[i] / sw0)
                      for i, name in enumerate(PLASMA_NAMES[1:-1], start=1)}
    rec["total"] = {"sum(w)": float(tot[0]), "Np": int(tot[14])}
    return rec


def field_record(step, time, moments, geom, normalized_units):
    m = np.asarray(moments, np.float64)
    nsl = m.shape[0]
    rec = {
        "time": float(time), "step": int(step), "n_slices": int(nsl),
        "z_lo": float(geom.prob_lo[2]), "z_hi": float(geom.prob_hi[2]),
        "is_normalized_units": int(normalized_units),
    }
    for i, name in enumerate(FIELD_NAMES):
        rec[name] = m[:, i]
    rec["sum"] = {name: float(m[:, i].sum())
                  for i, name in enumerate(FIELD_NAMES)}
    return rec
