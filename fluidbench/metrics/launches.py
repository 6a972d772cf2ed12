"""Kernels the device ran a unit, the program's and PyTorch's."""


def read(ctx, args):
    d = ctx["digest"]
    n = len(d.kernels())
    return n / d.units if n else None
