"""Share of an untraced step in which the host runs the step's Python and
dispatch: the host time in the program's span `piso.step` less that in
`host_read` (the host blocked on the card), per step of the untraced
steps with spans on, over their step time (CUDA events at the step
boundaries, as the window times its steps)."""


def read(d):
    h = d["span_host"]
    step = h["spans"].get("tpufoam_torch.piso.step") if h else None
    if not step or not h["step_s"]:
        return None
    read_s = h["spans"].get("tpufoam_torch.host_read", {}).get("host_s",
                                                               0.0)
    return 100.0 * (step["host_s"] - read_s) / h["steps"] / h["step_s"]
