"""Host milliseconds a unit inside the program's span ``<span>``, its
children included, over the span window: ``trace_calls`` calls at a
time after the traced window with the program's recorder on, in turns
with as many off, and no profiler (fluidbench/programspans.py). None
where the run has no program spans or the span never opened."""

from fluidbench.programspans import value


def read(ctx, args):
    return value(ctx, "host_ms", args)
