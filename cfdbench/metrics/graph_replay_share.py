"""Share of the surrogate's case predictions served by CUDA-graph
replay: 100 x the bound predictor's `graph_replays` (cases predicted by
replay) over its `calls` (one a step) x the cases in the stack, over the
traced run's untraced and traced steps. 0 where the graphs serve no call
(no CUDA device, autograd on, another stitch)."""


def read(d):
    c = d["counters"]
    if not c["predictor_calls"]:
        return None
    return 100.0 * c["graph_replays"] / (c["predictor_calls"] * d["cases"])
