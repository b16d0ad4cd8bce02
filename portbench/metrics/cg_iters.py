"""Mean CG iterations per solve of the window (``IterSolveResult.num_iters``, the program's count)."""


def read(ctx):
    its = [r.num_iters for r in ctx["results"]]
    return sum(its) / len(its) if its else None
