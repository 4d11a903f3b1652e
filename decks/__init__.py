"""Input decks written after the reference's examples.

Each deck's header names the reference file it follows and lists every
value that was assumed rather than recorded. Tests, tools and the
benchmark locate decks through ``path()``.
"""

import os

DIR = os.path.dirname(os.path.abspath(__file__))


def path(name: str) -> str:
    """Absolute path of a deck, e.g. ``path("transverse_benchmark")``."""
    p = os.path.join(DIR, name)
    if not os.path.isfile(p):
        raise FileNotFoundError(f"no deck {name!r} in {DIR}")
    return p
