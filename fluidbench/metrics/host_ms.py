"""Host milliseconds inside the entry's calls a unit (the benchmark's spans
around each call, the frames' copy left out), over the measured window."""


def read(ctx, args):
    s = ctx["spans"]
    return 1e3 * s["host_s"] / s["units"] if s["units"] else None
