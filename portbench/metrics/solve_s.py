"""Seconds per solve: the window, from the first solve's start to the end of the
last solve that ends inside it, over the number of solves in it."""


def read(ctx):
    return ctx["window_s"] / len(ctx["results"])
