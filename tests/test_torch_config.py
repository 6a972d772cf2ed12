"""The port's config against tpufluid's, its independence from JAX, and its
refusal to drop to the CPU unasked."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpufluid.config as jconfig
import tpufluid_torch as T
from tpufluid_torch import config as tconfig
from tpufluid_torch.interop import config_from_dict

CANVASES = [(1280, 720), (720, 1280), (192, 128), (1024, 1024), (1920, 1080)]


@pytest.mark.parametrize("canvas", CANVASES)
def test_config_properties_match(canvas):
    w, h = canvas
    for dtype in ("float32", "bfloat16", "float16"):
        j = jconfig.FluidConfig(CANVAS_WIDTH=w, CANVAS_HEIGHT=h, DTYPE=dtype).validate()
        t = tconfig.FluidConfig(CANVAS_WIDTH=w, CANVAS_HEIGHT=h, DTYPE=dtype).validate()
        for name in ("aspect_ratio", "sim_size", "dye_size", "bloom_size",
                     "sunrays_size", "capture_size"):
            assert getattr(t, name) == getattr(j, name), name
        assert t.bloom_mip_sizes() == j.bloom_mip_sizes()
        assert t.splat_radius_uv() == j.splat_radius_uv()
        assert str(t.dtype) == f"torch.{dtype}"
        assert tconfig.get_resolution(257, w, h) == jconfig.get_resolution(257, w, h)


def test_fields_and_defaults_match():
    j = jconfig.FluidConfig()
    assert dataclasses.asdict(tconfig.FluidConfig()) == dataclasses.asdict(j)
    assert config_from_dict(dataclasses.asdict(j)) == tconfig.FluidConfig()
    with pytest.raises(TypeError):
        config_from_dict({"NOT_A_FIELD": 1})


def test_max_dt_literal():
    assert T.MAX_DT == jconfig.MAX_DT == 0.016666


def test_package_imports_neither_jax_nor_tpufluid():
    repo = Path(__file__).resolve().parents[1]
    code = (
        "import sys, pkgutil, importlib, tpufluid_torch\n"
        "for m in pkgutil.walk_packages(tpufluid_torch.__path__, 'tpufluid_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tpufluid')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('tpufluid_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15  # every module was imported


@pytest.mark.parametrize("entry", ["init_state", "make_step", "make_multi_step"])
def test_entry_points_refuse_missing_gpu(entry, monkeypatch):
    """Without a GPU and without device='cpu' the entry points raise; with
    device='cpu' they run the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.FluidConfig(SIM_RESOLUTION=8, DYE_RESOLUTION=16, CANVAS_WIDTH=32,
                              CANVAS_HEIGHT=32, MAX_SPLATS=2)
    fn = getattr(T, entry)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(cfg)
    fn(cfg, device="cpu")
