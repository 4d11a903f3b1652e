"""Physical constants in SI and normalized unit systems.

A JAX re-implementation of the unit handling in HiPACE++
(ref: /root/reference/src/utils/Constants.H:16-80). The reference switches a
PhysConst struct at runtime between CODATA-2018 SI values and all-ones
normalized units; we do the same with a frozen dataclass that is hashable so
it can be closed over by jitted functions as a static argument.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PhysConst:
    """Physical constants used by all kernels. Hashable and static under jit."""
    c: float
    ep0: float
    mu0: float
    q_e: float
    m_e: float
    m_p: float


# CODATA 2018 values (ref Constants.H:17-26)
SI = PhysConst(
    c=299_792_458.0,
    ep0=8.8541878128e-12,
    mu0=1.25663706212e-06,
    q_e=1.602176634e-19,
    m_e=9.1093837015e-31,
    m_p=1.67262192369e-27,
)

# Normalized units: lengths in c/wp, fields in m_e c wp / e, densities in n0
# (ref Constants.H:69-80)
NORMALIZED = PhysConst(
    c=1.0,
    ep0=1.0,
    mu0=1.0,
    q_e=1.0,
    m_e=1.0,
    m_p=1836.15267343,
)

# Extra SI constants that are needed even in normalized runs (radiation
# reaction, ionization): ref Constants.H PhysConstSI namespace.
SI_c = SI.c
SI_ep0 = SI.ep0
SI_mu0 = SI.mu0
SI_q_e = SI.q_e
SI_m_e = SI.m_e
SI_m_p = SI.m_p
SI_hbar = 1.054571817e-34
SI_r_e = 2.817940326204929e-15

PI = math.pi


def make_constants(normalized_units: bool) -> PhysConst:
    return NORMALIZED if normalized_units else SI


def plasma_frequency_SI(density_SI: float) -> float:
    """omega_p = sqrt(n e^2 / (eps0 m_e)) in SI units."""
    return math.sqrt(density_SI * SI_q_e * SI_q_e / (SI_ep0 * SI_m_e))
