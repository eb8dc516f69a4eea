"""Multigrid V-cycles per step, from the program's counter
(solvers.multigrid.v_cycle.cycles; one cycle of a fleet's stack counts
once)."""


def read(d):
    return d["v_cycles"] / d["steps"] if d["v_cycles"] else None
