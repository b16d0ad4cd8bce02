"""What the probes share: the operator in the layout the solver used, and a vector in it."""


def operator_and_vector(ctx):
    """(apply(v), v): the system's operator in the layout CG used during the
    warm-up, and the last answer of the window in that layout."""
    system, layout = ctx["case"].system, ctx["layout"]
    fn, consts = system.operator_parts(layout=layout)
    x = ctx["x"]
    if layout == "lattice":
        x = system.to_lattice_layout(x)
    return (lambda v: fn(v, *consts)), x
