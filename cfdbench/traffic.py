"""The one generator of the benchmark's traffic: the cases of a cell.

A traffic mix (mixes/<traffic>.json) names obstacle classes, the
obstacle sizes each class may take (`sizes`) and the number of cases of
each class (`per_class`). The seed draws each class's sizes from its
list, without repeats, and shuffles the cases' order in the stack (a
fleet is predicted case by case in that order). The seed also draws
which cases the check of the first step compares.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per purpose, from any non-negative seed
    (numpy takes integers of any size)."""
    return np.random.default_rng([int(seed), sum(map(ord, stream))])


def cases(workload: dict, seed: int) -> list[tuple[str, float]]:
    """[(class, obstacle size)] in stack order."""
    rng = rng_for(seed, "cases")
    n = int(workload["per_class"])
    out = [(shape, float(size)) for shape in workload["classes"]
           for size in sorted(rng.choice(workload["sizes"][shape], size=n,
                                         replace=False))]
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def check_cases(workload: dict, seed: int, members: list) -> list[int]:
    """The indices of the cases whose first step the reference checks:
    `check_cases_per_class` cases of each class, drawn from the seed."""
    rng = rng_for(seed, "check")
    per = int(workload.get("check_cases_per_class", 1))
    picked = []
    for shape in workload["classes"]:
        idx = [i for i, (s, _) in enumerate(members) if s == shape]
        picked += rng.choice(idx, size=min(per, len(idx)),
                             replace=False).tolist()
    return sorted(picked)
