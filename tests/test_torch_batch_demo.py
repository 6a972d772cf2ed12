"""The port's batch demo (tpufluid_torch.tools.batch_demo) on the CPU
(TPUFLUID_DEVICE=cpu): its grids against those of the JAX tool
(tools/batch_demo.py, run unchanged, its GIF frames caught at save_gif),
its chunked loop against a loop of make_batched_step calls, equal clocks
against equal panels, an expanded splat view against a contiguous one, its
options against the JAX tool's and its device rule.

Tolerances: within the port, bit for bit (the same plain versions on the
same inputs in the same order). Against JAX, at 32 / 64 over 12 steps:
every uint8 level within 1, and in each panel under 0.1% of the values
differing, or no more than differ in the JAX tool's own panel when every
sim's dt is moved down by one float32 ulp. The fastest sim's panel needs
the second bar: one ulp of dt moves 1.1% of its values by up to 2 levels
at step 12 (the flow amplifies the step's last-bit differences there,
both packages alike), where the port differs from JAX on 0.58% by 1
(``-rP`` prints each panel's shares). A fault in a pass moves whole
texels, by far more than a level.
"""

import argparse
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid.batch as jbatch
import tpufluid.io as jio
from tpufluid.config import MAX_DT as JAX_MAX_DT
from tpufluid_torch import init_batch, make_batched_multi_step, make_batched_render
from tpufluid_torch import make_batched_step
from tpufluid_torch.tools import batch_demo as demo

ROOT = Path(__file__).resolve().parents[1]
STEPS, EVERY, SIM, DYE = 12, 6, 32, 64
SMALL = ["--sim-res", str(SIM), "--dye-res", str(DYE), "--steps", str(STEPS),
         "--every", str(EVERY)]
CPU = torch.device("cpu")
FIELDS = ("velocity", "dye", "pressure")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("_jax_batch_demo",
                                                  ROOT / "tools" / "batch_demo.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def jax_grids(tmp_path_factory):
    """The JAX tool's grids at SMALL, as it runs and with every sim's
    clamped dt one ulp lower (its own sensitivity to the last bit)."""
    tool, out = _jax_tool(), tmp_path_factory.mktemp("jax") / "grid.gif"
    caught = []
    real_step = jbatch.make_batched_step

    def nudged(cfg):
        step = real_step(cfg)
        lower = lambda dt: jnp.nextafter(jnp.minimum(dt, jnp.float32(JAX_MAX_DT)),  # noqa: E731
                                         jnp.float32(0))
        return lambda state, dt, splats: step(state, lower(dt), splats)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUFLUID_DEVICE", "cpu")
        mp.setattr(jio, "save_gif", lambda frames, path, fps=60.0: caught.append(list(frames)))
        mp.setattr(sys, "argv", ["batch_demo.py", "--out", str(out), *SMALL])
        tool.main()
        mp.setattr(jbatch, "make_batched_step", nudged)
        tool.main()
    return caught


def _panels(g):
    h, w = g.shape[0] // 2, g.shape[1] // 2
    return [g[:h, :w], g[:h, w:], g[h:, :w], g[h:, w:]]


def _diff(a, b):
    return np.abs(a.astype(np.int32) - b.astype(np.int32))


def test_tool_matches_the_jax_tool(tmp_path, monkeypatch, jax_grids):
    from PIL import Image

    want, nudged = jax_grids
    monkeypatch.setenv("TPUFLUID_DEVICE", "cpu")
    out = tmp_path / "grid.gif"
    got = demo.main(["--out", str(out), *SMALL])
    assert len(got["frames"]) == len(want) == STEPS // EVERY
    for k, (g, w, n) in enumerate(zip(got["frames"], want, nudged)):
        assert g.dtype == np.uint8 and g.shape == w.shape == (2 * DYE, 2 * DYE, 3)
        for p, (gp, wp, np_) in enumerate(zip(_panels(g), _panels(w), _panels(n))):
            d = _diff(gp, wp)
            share, own = float((d > 0).mean()), float((_diff(np_, wp) > 0).mean())
            print(f"frame {k} panel {p}: {share:.3%} of values differ from JAX's, at most "
                  f"{d.max()} level(s); JAX's own one-ulp run moves {own:.3%}")
            assert d.max() <= 1, (k, p, d.max())
            assert share < 1e-3 or share <= own, (k, p, share, own)
    with Image.open(out) as gif:
        assert gif.n_frames == STEPS // EVERY and gif.size == (2 * DYE, 2 * DYE)
    assert got["state"].dye.shape == (4, 3, DYE, DYE) and got["display_form"] == "plain"


@pytest.mark.parametrize("steps,every", [(STEPS, EVERY), (7, 3)])
def test_chunked_loop_equals_per_step_loop(steps, every):
    """The tool's chunks of make_batched_multi_step equal one
    make_batched_step call a step with the same inputs, bit for bit: every
    grid and the state after the last (partial) chunk."""
    cfg = demo.demo_config(SIM, DYE)
    runs = list(demo.run(cfg, steps, every, CPU))
    dts, rows = demo.demo_inputs(cfg, steps, CPU)
    step, render = make_batched_step(cfg, device=CPU), make_batched_render(cfg, device=CPU)
    state, frames = init_batch(cfg, 4, device=CPU), []
    for t in range(steps):
        state = step(state, dts, rows[t].expand(4, -1, -1))
        if (t + 1) % every == 0:
            frames.append(demo.grid(render(state).numpy()))
    assert [t for t, _, _ in runs] == list(range(every, steps, every)) + [steps]
    grids = [g for _, g, _ in runs if g is not None]
    assert len(grids) == len(frames) == steps // every
    assert all(np.array_equal(a, b) for a, b in zip(grids, frames))
    for f in FIELDS:
        assert torch.equal(getattr(runs[-1][2], f), getattr(state, f)), f


def test_equal_speeds_give_equal_panels():
    """The panels differ by their clocks alone: at one speed the four sims
    step and render bit for bit alike."""
    cfg = demo.demo_config(SIM, DYE)
    runs = list(demo.run(cfg, STEPS, EVERY, CPU, speeds=(0.5,) * 4))
    for _, g, _ in runs:
        first, *rest = _panels(g)
        assert all(np.array_equal(first, p) for p in rest)
    state = runs[-1][2]
    for f in FIELDS:
        x = getattr(state, f)
        assert all(torch.equal(x[0], x[i]) for i in range(1, 4)), f
    assert float(state.dye.abs().max()) > 0


def test_expanded_splats_equal_contiguous():
    """A (T, B, S, 8) splat view with stride 0 along B, as the tool passes
    the shared rows, steps every sim as its own contiguous copy does."""
    cfg = demo.demo_config(SIM, DYE)
    dts, rows = demo.demo_inputs(cfg, EVERY, CPU)
    expanded = rows[:, None].expand(-1, 4, -1, -1)
    assert expanded.stride(1) == 0
    multi = make_batched_multi_step(cfg, device=CPU)
    a = multi(init_batch(cfg, 4, device=CPU), dts.expand(EVERY, 4), expanded)
    b = multi(init_batch(cfg, 4, device=CPU), dts.expand(EVERY, 4).contiguous(),
              expanded.contiguous())
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_options_and_defaults_equal_jax(monkeypatch):
    """The JAX tool's flags, types and defaults, but --out: out/, never the
    docs/ file the JAX tool writes."""
    class Parsed(Exception):
        pass

    def stop(self, args=None, namespace=None):
        raise Parsed(self)

    tool = _jax_tool()
    monkeypatch.setattr(sys, "argv", ["batch_demo.py"])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(Parsed) as caught:
        tool.main()
    monkeypatch.undo()

    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.type, a.default) for a in parser._actions
                if not isinstance(a, argparse._HelpAction)}

    want, got = options(caught.value.args[0]), options(demo.build_argparser())
    assert want.pop("out")[2] == "docs/batch_grid.gif"
    assert got.pop("out")[2] == "out/batch_grid.gif"
    assert got == want


def test_tool_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool runs there")
    monkeypatch.delenv("TPUFLUID_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="TPUFLUID_DEVICE=cpu"):
        demo.main(["--out", str(tmp_path / "g.gif"), "--steps", "1"])
    assert not (tmp_path / "g.gif").exists()
