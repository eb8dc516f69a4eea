"""Host reads (and host uploads) per step, each a wait for the card's
stream: the program's counter `host_read.count` over the traced run's
untraced and traced steps."""


def read(d):
    c = d["counters"]
    return c["host_reads"] / c["steps"] if c["steps"] else None
