"""A pass's share of its roofline: the least time the card could take for
the pass's work, max(bytes / bandwidth, operations / float32 peak), over
the device time of the kernels the work files map to the pass."""

from fluidbench.work import kernel_pass, pass_work


def bound_s(ctx, name: str) -> float:
    nbytes, ops = pass_work(name, ctx["shape"])
    peaks = ctx["peaks"]
    return max(nbytes / peaks["bytes_per_s"], ops / peaks["flops_per_s"])


def read(ctx, args):
    (name,) = args
    d = ctx["digest"]
    us = sum(e.dur for e in d.kernels() if kernel_pass(e.name) == name)
    if us <= 0:
        return None
    return 100.0 * bound_s(ctx, name) / (us * 1e-6 / d.units)
