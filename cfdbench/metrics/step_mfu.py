"""The whole step's share of the chip's peak: the least time the chip
could take for the step's counted work (work.step_terms: the state and
case fields, the momentum sweeps' operands, each pressure solve's passes
over the hierarchy at the counted V-cycles, the surrogate's blocks, bases
and weights) over the time an untraced step of the same run takes (the
probe steps before the traced ones, timed by CUDA events; the traced
steps carry the profiler's host overhead)."""

from cfdbench import work


def read(d):
    if not d["trace"] or not d["trace"]["launches"] \
            or not d.get("probe_step_s"):
        return None
    terms = work.step_terms(d["config"], d["bundle"], d["cases"],
                            d["v_cycles"] / d["steps"])
    return 100.0 * work.step_least_seconds(terms) / d["probe_step_s"]
