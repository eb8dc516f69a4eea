"""Share of the safeguard's rescue work that served a case that needed
it: 100 x the cases its rescue solves were for over the cases they solved
(each solve solves the whole stack), from the program's counters
`_rescue_if_unconverged.solves` and `.cases` over the traced run's
untraced and traced steps. 100 where no rescue ran: no rescue work was
wasted."""


def read(d):
    c = d["counters"]
    if not c["rescue_solves"]:
        return 100.0
    return 100.0 * c["rescue_cases"] / (c["rescue_solves"] * d["cases"])
