"""The round walk of :mod:`benchmark.core.inputs` over more cohorts than
int64 counts.

``inputs.round_chunks`` walks over every multiset of ``per_round`` of the
``resident`` chunks, and ``inputs._walk`` draws the walk's start and steps
with numpy's ``Generator.integers``, which takes state counts below 2^63
only. 128 chunks of 128 from 80 resident make C(207, 128), about 2^195,
cohorts. :func:`install` extends ``inputs._walk`` to such counts: the
start and the steps are drawn in Python ints (``random.Random``, keyed by
the same streams of the run's seed). Below 2^63 every call goes to numpy's
walk unchanged, so a cell whose count fits draws the rounds it drew before.
A route that needs the wide walk installs it when it is loaded, before the
first round is drawn.
"""

from __future__ import annotations

import functools
import random

from benchmark.core import inputs

NARROW = 1 << 63


def _wide(narrow):
    @functools.lru_cache(maxsize=64)
    def walk(seed: int, states: int, block: int) -> tuple:
        if states < NARROW:
            return narrow(seed, states, block)
        start = (random.Random(inputs._key(seed, inputs._CHUNKS)).randrange(states)
                 if block == 0 else walk(seed, states, block - 1)[-1])
        rng = random.Random(inputs._key(seed, inputs._CHUNKS, block))
        out, state = [], start
        for _ in range(inputs._WALK_BLOCK):
            state = (state + rng.randrange(1, states)) % states
            out.append(state)
        return tuple(out)

    walk.narrow = narrow
    return walk


def install() -> None:
    """Make ``inputs.round_chunks`` take state counts of 2^63 and more;
    a second call changes nothing."""
    if not hasattr(inputs._walk, "narrow"):
        inputs._walk = _wide(inputs._walk)
