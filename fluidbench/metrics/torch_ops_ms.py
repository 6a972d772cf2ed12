"""Device milliseconds a unit in kernels that are not the program's own
(PyTorch's operators), copies and fills left out."""

from fluidbench.work import kernel_pass


def read(ctx, args):
    d = ctx["digest"]
    us = [e.dur for e in d.kernels() if kernel_pass(e.name) is None]
    return sum(us) / d.units / 1e3 if us else None
