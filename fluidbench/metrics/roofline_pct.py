"""A pass's share of its roofline: the least time one card could take for
the pass's work over the whole grid, max(bytes / bandwidth, operations /
float32 peak), over the device time of the kernels the work files map to
the pass, summed over the cards. Over several cards the halo's padded
texels, worked on and not counted, read as lost efficiency."""

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
