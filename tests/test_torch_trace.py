"""The port's numpy trace machinery against tpufluid's: same seed, same
batches and dts, bit for bit."""

import numpy as np
import pytest

import tpufluid.config as jconfig
import tpufluid.trace as jtrace
import tpufluid_torch.config as tconfig
import tpufluid_torch.trace as ttrace


@pytest.mark.parametrize("seed", [0, 3, 7, 1234])
@pytest.mark.parametrize("canvas,max_splats", [((1280, 720), 16), ((192, 128), 4),
                                               ((720, 1280), 8)])
def test_swirl_trace_bit_equal(seed, canvas, max_splats):
    kw = dict(CANVAS_WIDTH=canvas[0], CANVAS_HEIGHT=canvas[1], MAX_SPLATS=max_splats)
    j = jtrace.swirl_trace(jconfig.FluidConfig(**kw), 150, seed=seed)
    t = ttrace.swirl_trace(tconfig.FluidConfig(**kw), 150, seed=seed)
    np.testing.assert_array_equal(t.batches, j.batches)
    np.testing.assert_array_equal(t.dts, j.dts)
    assert t.batches.dtype == np.float32 and t.batches.any()


def test_tracer_events_and_v2_roundtrip(tmp_path):
    """Bursts that spill, pointer up/down, per-step dts clamped at MAX_DT,
    and the .npz round trip, against tpufluid's tracer."""
    def drive(mod, cfg):
        tr = mod.PointerTracer(cfg, seed=5)
        tr.feed("burst", n=6)
        tr.feed("down", pid=1, x=10.0, y=20.0)
        steps = []
        for k in range(12):
            tr.feed("move", pid=1, x=10.0 + 7 * k, y=20.0 + 3 * k)
            if k == 6:
                tr.feed("up", pid=1)
            steps.append(tr.drain_step(1 / 30))
        dts = [0.01, 1 / 60, 0.05] * 4
        return mod.Trace.from_events(steps, dts, cfg.MAX_SPLATS)

    kw = dict(CANVAS_WIDTH=320, CANVAS_HEIGHT=200, MAX_SPLATS=4)
    j = drive(jtrace, jconfig.FluidConfig(**kw))
    t = drive(ttrace, tconfig.FluidConfig(**kw))
    np.testing.assert_array_equal(t.batches, j.batches)
    np.testing.assert_array_equal(t.dts, j.dts)
    assert t.dts.max() == np.float32(tconfig.MAX_DT)
    path = str(tmp_path / "trace.npz")
    t.save(path)
    back = ttrace.Trace.load(path)
    np.testing.assert_array_equal(back.batches, t.batches)
    np.testing.assert_array_equal(back.dts, t.dts)
    np.testing.assert_array_equal(jtrace.Trace.load(path).batches, j.batches)
