"""docs/parameters.md completeness: every input key the code asks for must
be documented (VERDICT r4 item 8; the reference documents its full surface
in /root/reference/docs/source/run/parameters.rst).

Mechanism: Inputs records every key requested through get/query/
get_list/query_list/get_function/raw in `inputs._queried` (present in the
deck or not — the *reachable surface* for the features a deck activates).
We construct Simulations from a feature-covering battery of decks and
assert each recorded key matches a documented entry, with species/beam/
laser/diag/collision names normalized to the doc's generic placeholders.
"""

import os
import re

import pytest

import decks
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

DOC = os.path.join(os.path.dirname(__file__), "..", "docs", "parameters.md")

TINY = ["amr.n_cell=16 16 8", "max_step=0", "diagnostic.output_period=0"]

# Feature battery: each entry is (deck-or-path, overrides). Together these
# activate: SI + normalized units, explicit + predictor-corrector solvers,
# every injection type reachable without files, lasers, MR levels, SALAME,
# spin, radiation reaction, collisions, grid current, open boundaries,
# adaptive dt, ionization, fine patch, in-situ diags, external fields.
FULL_FEATURE_DECK = """
amr.n_cell = 16 16 8
amr.max_level = 1
mr_lev1.n_cell = 8 8
mr_lev1.patch_lo = -2. -2. -8.
mr_lev1.patch_hi = 2. 2. 8.
hipace.normalized_units = 1
hipace.dt = adaptive
hipace.nt_per_betatron = 30
hipace.verbose = 0
max_step = 0
hipace.random_seed = 7
hipace.deposit_rho = 1
hipace.background_density_SI = 1e23
hipace.collisions = coll1
coll1.species = plasma plasma
coll1.CoulombLog = 5.
grid_current.use_grid_current = 1
grid_current.peak_current_density = 0.1
grid_current.position_mean = 0. 0. 0.
grid_current.position_std = 0.4 0.4 1.
boundary.field = Dirichlet
boundary.particle = Reflecting
boundary.particle_lo = -7. -7.
boundary.particle_hi = 7. 7.
geometry.prob_lo = -8. -8. -8.
geometry.prob_hi =  8.  8.  8.
beams.names = drive witness
beams.insitu_period = 1
drive.injection_type = fixed_weight
drive.num_particles = 64
drive.profile = gaussian
drive.position_mean = 0. 0. 2.
drive.position_std = 0.3 0.3 1.0
drive.density = 2.
drive.u_mean = 0. 0. 2000.
drive.u_std = 0. 0. 0.
drive.do_spin_tracking = 1
drive.initial_spin = 0 0 1
drive.do_radiation_reaction = 1
witness.injection_type = fixed_weight_pdf
witness.pdf(z) = exp(-0.5*(z+2)**2)
witness.num_particles = 64
witness.density = 0.4
witness.position_mean = 0. 0.
witness.position_std = 0.2 0.2
witness.u_mean = 0. 0. 1000.
witness.u_std = 0. 0. 0.
witness.do_salame = 1
beams.E(x,y,z,t) = 0. 0. .01*z
beams.B(x,y,z,t) = 0. 0. 0.
plasmas.names = plasma ions
plasmas.reorder_period = 2
plasmas.insitu_period = 1
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
plasma.fine_patch(x,y) = sqrt(x*x+y*y) < 2
plasma.fine_ppc = 2 2
plasma.fine_transition_cells = 2
ions.element = N
ions.initial_ion_level = 2
ions.ionization_product = plasma
ions.density(x,y,z) = 1.
ions.ppc = 1 1
fields.insitu_period = 1
diagnostic.output_period = 0
"""

DECKS = [
    (decks.path("get_started/inputs_pwfa"), TINY),
    (decks.path("get_started/inputs_lwfa"), TINY),
    (decks.path("blowout_wake/inputs_normalized"),
     TINY + ["hipace.bxby_solver=predictor-corrector"]),
    (decks.path("beam_in_vacuum/inputs_normalized"),
     TINY + ["boundary.field=Open", "beam.injection_type=fixed_ppc",
             "beam.ppc=1 1 1", "beam.profile=flattop",
             "hipace.use_banded=0"]),
    (decks.path("laser/inputs_SI"), TINY),
    (FULL_FEATURE_DECK, []),
]

# keys consciously undocumented: internal/diagnostic-only switches
ALLOWED_UNDOCUMENTED = {
    "hipace.do_device_synchronize",   # accepted for deck compat, no-op
}


def _doc_tokens():
    """All backticked key tokens in the doc's table rows, expanded:
    `a.b_rel` / `_abs` pairs, bare alternates (`zmax` after `<b>.zmin`),
    parenthesized function args stripped."""
    toks = []
    with open(DOC) as f:
        for line in f:
            if not line.startswith("|"):
                continue
            cell = line.split("|")[1]
            toks.append(re.findall(r"`([^`]+)`", cell))
    out = set()
    for row in toks:
        prev = None
        for t in row:
            t = re.sub(r"\(.*?\)", "", t).strip()
            if not t:
                continue
            if t.startswith("_") and prev and "_" in prev:
                t = prev[:prev.rfind("_")] + t
            elif "." not in t and prev and "." in prev:
                t = prev.rsplit(".", 1)[0] + "." + t
            out.add(t)
            prev = t
    return out


def _generic(key: str, names: dict) -> str:
    """Normalize a recorded key to the doc's placeholder form (function
    argument lists stripped, like the doc tokens)."""
    key = re.sub(r"\(.*?\)$", "", key)
    if "." not in key:
        return key
    pre, suf = key.split(".", 1)
    if pre in names.get("beams", ()):
        return f"<beam>.{suf}"
    if pre in names.get("plasmas", ()):
        return f"<plasma>.{suf}"
    if pre in names.get("lasers", ()):
        return f"<laser>.{suf}"
    if pre in names.get("diags", ()) or re.fullmatch(r"lev\d+", pre) \
            or pre == "laser_diag":   # default diag names (simulation.py)
        return f"<diag>.{suf}"
    if pre in names.get("collisions", ()):
        return f"<collision>.{suf}"
    if re.fullmatch(r"mr_lev\d+", pre):
        return f"mr_lev<L>.{suf}"
    return key


def _alternates(gk: str):
    """Doc-accepted spellings for a normalized key: the key itself, and the
    shared-prefix form the doc documents once (`beams.*` sets all, etc.)."""
    yield gk
    for ph, shared in (("<beam>", "beams"), ("<plasma>", "plasmas"),
                       ("<laser>", "lasers"), ("<diag>", "diagnostic")):
        if gk.startswith(ph + "."):
            yield shared + gk[len(ph):]
    for shared, ph in (("beams", "<beam>"), ("plasmas", "<plasma>"),
                       ("lasers", "<laser>"), ("diagnostic", "<diag>")):
        if gk.startswith(shared + "."):
            yield ph + gk[len(shared):]


def test_every_queried_key_is_documented():
    doc = _doc_tokens()
    assert len(doc) > 100, "doc parse failed"
    missing = {}
    for deck, overrides in DECKS:
        if deck.startswith("/"):
            inputs = Inputs.from_file(deck, overrides=overrides)
        else:
            inputs = Inputs(deck, overrides=overrides)
        Simulation(inputs, verbose=0)
        names = {
            "beams": inputs.query_list("beams.names", [], str),
            "plasmas": inputs.query_list("plasmas.names", [], str),
            "lasers": inputs.query_list("lasers.names", [], str),
            "diags": inputs.query_list("diagnostic.names", [], str),
            "collisions": inputs.query_list("hipace.collisions", [], str),
        }
        for key in inputs._queried:
            if key.startswith("my_constants."):
                continue
            gk = _generic(key, names)
            if gk in ALLOWED_UNDOCUMENTED:
                continue
            if not any(alt in doc for alt in _alternates(gk)):
                missing.setdefault(gk, key)
    assert not missing, (
        f"{len(missing)} queried input keys missing from docs/parameters.md: "
        f"{sorted(missing)}")
