"""The port's I/O, checkpoints, tracer session state and small API pieces
against tpufluid's on the CPU, on the same seeded arrays.

Tolerances:
  * frame quantization, PNG, GIF, dither, splat arrays, state_bytes, the
    config presets, the tracer state: exact (the same numpy and Pillow
    calls on the same arrays);
  * checkpoints: bit for bit, both ways, in float32, bfloat16 and float16;
  * apply_splats: 1e-5 of the field's scale in float32, the bound of
    tests/test_torch_ops.py's splat batch (the libraries sum the rank-S
    einsum in other orders); in bfloat16 one storage ulp of the scale, 2^-7.
"""

import dataclasses
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import tpufluid.checkpoint as jckpt
import tpufluid.config as jconfig
import tpufluid.io as jio
import tpufluid.state as jstate
import tpufluid.trace as jtrace
from tpufluid.ops import splat as jsplat
from tpufluid.step import apply_splats as jax_apply_splats
import tpufluid_torch as T
import tpufluid_torch.checkpoint as tckpt
import tpufluid_torch.config as tconfig
import tpufluid_torch.io as tio
import tpufluid_torch.trace as ttrace
from tpufluid_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from tpufluid_torch.ops import splat as tsplat
from tpufluid_torch.state import state_bytes

KW = dict(SIM_RESOLUTION=16, DYE_RESOLUTION=24, CANVAS_WIDTH=60, CANVAS_HEIGHT=40,
          MAX_SPLATS=4, USE_PALLAS=False)


def _frames(seed):
    """Float frames with values outside [0, 1] and on quantization edges."""
    rng = np.random.default_rng(seed)
    f = (rng.random((4, 20, 30)) * 1.4 - 0.2).astype(np.float32)
    f[:, 0, :4] = [k / 255.0 for k in (0, 1, 128, 255)]
    return f


# ------------------------------------------------------------------ io


@pytest.mark.parametrize("channels", [4, 3])
def test_frame_to_uint8_matches_jax(channels):
    f = _frames(1)[:channels]
    want = jio.frame_to_uint8(f)
    np.testing.assert_array_equal(tio.frame_to_uint8(f), want)
    np.testing.assert_array_equal(tio.frame_to_uint8(torch.from_numpy(f)), want)
    np.testing.assert_array_equal(tio.frame_to_uint8(f.astype(np.float64)), want)
    assert want.shape == (20, 30, channels) and want.dtype == np.uint8


def test_frame_to_uint8_passes_uint8_through():
    u8 = np.random.default_rng(2).integers(0, 256, (20, 30, 3), dtype=np.uint8)
    assert tio.frame_to_uint8(u8) is u8
    np.testing.assert_array_equal(tio.frame_to_uint8(torch.from_numpy(u8)), u8)
    np.testing.assert_array_equal(tio.frame_to_uint8(u8), jio.frame_to_uint8(u8))


@pytest.mark.parametrize("channels", [4, 3])
def test_png_round_trip_matches_jax(tmp_path, channels):
    f = _frames(3)[:channels]
    tio.save_png(torch.from_numpy(f), str(tmp_path / "t.png"))
    jio.save_png(f, str(tmp_path / "j.png"))
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    back = tio.load_png(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(back, jio.load_png(str(tmp_path / "j.png")))
    assert back.shape == (channels, 20, 30)
    np.testing.assert_array_equal(tio.frame_to_uint8(back), jio.frame_to_uint8(f))


def test_gif_and_video_frames_match_jax(tmp_path):
    frames = [_frames(s) for s in range(4)]
    assert tio.save_gif(frames, str(tmp_path / "t.gif"), fps=12.0) == 4
    assert jio.save_gif(frames, str(tmp_path / "j.gif"), fps=12.0) == 4
    assert (tmp_path / "t.gif").read_bytes() == (tmp_path / "j.gif").read_bytes()
    assert tio.save_gif([], str(tmp_path / "none.gif")) == 0
    n = tio.save_video_frames((torch.from_numpy(f) for f in frames), str(tmp_path / "tv"))
    assert n == jio.save_video_frames(frames, str(tmp_path / "jv")) == 4
    for i in range(4):
        name = f"frame_{i:06d}.png"
        assert (tmp_path / "tv" / name).read_bytes() == (tmp_path / "jv" / name).read_bytes()


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_load_dither_matches_jax(tmp_path, mode):
    rng = np.random.default_rng(4)
    shape = (48, 40) if mode == "L" else (48, 40, len(mode))
    Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8), mode).save(tmp_path / "d.png")
    got = tio.load_dither(str(tmp_path / "d.png"))
    np.testing.assert_array_equal(got, jio.load_dither(str(tmp_path / "d.png")))
    assert got.shape == (48, 40) and got.dtype == np.float32


# ------------------------------------------------------------ tracer state


def _feed(mod, cfg):
    """The same seeded feed sequence: pointers down, moved and lifted, a
    burst that spills past MAX_SPLATS, colors cycled."""
    tr = mod.PointerTracer(cfg, seed=9)
    tr.feed("down", pid=0, x=10.0, y=12.0)
    tr.feed("down", pid=3, x=40.0, y=30.0)
    tr.feed("burst", n=20)
    for k in range(5):
        tr.feed("move", pid=0, x=10.0 + 4 * k, y=12.0 + k)
        if k == 2:
            tr.feed("up", pid=3)
        tr.drain_step(1 / 30)
    tr.feed("burst", n=2)
    return tr


def test_tracer_state_dict_equals_jax_and_loads_both_ways():
    jcfg, tcfg = jconfig.FluidConfig(**KW), tconfig.FluidConfig(**KW)
    j, t = _feed(jtrace, jcfg), _feed(ttrace, tcfg)
    jd, td = j.state_dict(), t.state_dict()
    assert json.dumps(td) == json.dumps(jd)
    assert td["spill"] and td["splat_stack"] == [2] and set(td["pointers"]) == {"0", "3"}

    # JAX's dict, through JSON as a checkpoint carries it, into a fresh port
    # tracer, and the port's into a fresh JAX tracer: all go on alike.
    t2 = ttrace.PointerTracer(tcfg, seed=0)
    t2.load_state_dict(json.loads(json.dumps(jd)))
    j2 = jtrace.PointerTracer(jcfg, seed=0)
    j2.load_state_dict(json.loads(json.dumps(td)))
    for tracer in (j, t, t2, j2):
        tracer.feed("move", pid=0, x=50.0, y=20.0)
        tracer.feed("down", pid=5, x=5.0, y=5.0)
    for _ in range(6):
        want = j.drain_step(1 / 60)
        assert t.drain_step(1 / 60) == want
        assert t2.drain_step(1 / 60) == want
        assert j2.drain_step(1 / 60) == want
    assert json.dumps(t2.state_dict()) == json.dumps(j.state_dict())


def test_generate_color_and_random_splats_match_jax():
    j, t = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(10):
        assert T.generate_color(t) == jtrace.generate_color(j)
    assert T.random_splats(t, 7) == jtrace.random_splats(j, 7)
    assert T.Pointer() == ttrace.Pointer() and dataclasses.asdict(T.Pointer()) == \
        dataclasses.asdict(jtrace.Pointer())


# ------------------------------------------------------------- checkpoints


def _jax_state(jcfg, seed):
    """A JAX state of numpy-made fields in the config's dtype."""
    rng = np.random.default_rng(seed)
    (sw, sh), (dw, dh) = jcfg.sim_size, jcfg.dye_size
    s = jstate.init_state(jcfg)
    s.velocity = jnp.asarray(rng.standard_normal((2, sh, sw)).astype(np.float32) * 300
                             ).astype(jcfg.DTYPE)
    s.dye = jnp.asarray(rng.random((3, dh, dw)).astype(np.float32) * 2).astype(jcfg.DTYPE)
    s.pressure = jnp.asarray(rng.standard_normal((sh, sw)).astype(np.float32)
                             ).astype(jcfg.DTYPE)
    return s


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _tensor_bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]).numpy().view(
        {2: np.uint16, 4: np.uint32}[t.element_size()])


DTYPES = ["float32", "bfloat16", "float16"]


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_checkpoint_loads_in_the_port(tmp_path, dtype, compress):
    jcfg = jconfig.FluidConfig(**KW, DTYPE=dtype, BACK_COLOR=(3, 20, 250)).validate()
    s = _jax_state(jcfg, seed=6)
    tracer = _feed(jtrace, jcfg)
    path = str(tmp_path / "j.npz")
    jckpt.save_state(path, s, jcfg, step=17, extra={"note": "x"}, tracer=tracer,
                     compress=compress)
    state, cfg, step, extra = tckpt.load_state(path, device="cpu")
    assert state.velocity.dtype == cfg.dtype == tconfig._DTYPES[dtype]
    for got, want in zip((state.velocity, state.dye, state.pressure),
                         (s.velocity, s.dye, s.pressure)):
        np.testing.assert_array_equal(_tensor_bits(got), _bits(want))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.BACK_COLOR == (3, 20, 250) and cfg.DTYPE == dtype
    assert step == 17 and extra["note"] == "x"
    assert json.dumps(extra["tracer"]) == json.dumps(tracer.state_dict())


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_loads_in_jax(tmp_path, dtype):
    jcfg = jconfig.FluidConfig(**KW, DTYPE=dtype).validate()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    s = _jax_state(jcfg, seed=7)
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    tracer = _feed(ttrace, cfg)
    buf = io.BytesIO()
    tckpt.save_state(buf, ts, cfg, step=5, extra={"k": [1, 2]}, tracer=tracer)
    raw = np.load(io.BytesIO(buf.getvalue()), allow_pickle=False)
    assert raw["dye"].dtype == {"float32": np.float32, "bfloat16": np.uint16,
                                "float16": np.float16}[dtype]
    js, jc, step, extra = jckpt.load_state(io.BytesIO(buf.getvalue()))
    for got, want in zip((js.velocity, js.dye, js.pressure), (s.velocity, s.dye, s.pressure)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert jc == jcfg and step == 5 and extra["k"] == [1, 2]
    assert json.dumps(extra["tracer"]) == json.dumps(tracer.state_dict())
    # and back in the port, bit for bit
    back, cfg2, _, _ = tckpt.load_state(io.BytesIO(buf.getvalue()), device="cpu")
    assert cfg2 == cfg
    for got, want in zip(state_to_numpy(back), state_to_numpy(ts)):
        np.testing.assert_array_equal(got, want)


def test_load_state_needs_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    cfg = tconfig.FluidConfig(**KW).validate()
    path = str(tmp_path / "c.npz")
    tckpt.save_state(path, T.init_state(cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tckpt.load_state(path)


def test_load_state_rejects_another_version(tmp_path):
    cfg = tconfig.FluidConfig(**KW).validate()
    path = str(tmp_path / "c.npz")
    tckpt.save_state(path, T.init_state(cfg, device="cpu"), cfg)
    data = dict(np.load(path))
    meta = json.loads(str(data["meta"]))
    meta["version"] = 2
    data["meta"] = json.dumps(meta)
    np.savez(path, **data)
    with pytest.raises(ValueError, match="version 2"):
        tckpt.load_state(path, device="cpu")


# ------------------------------------------------------------ small API


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_splats_matches_jax(dtype):
    jcfg = jconfig.FluidConfig(**KW, DTYPE=dtype).validate()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    s = _jax_state(jcfg, seed=8)
    ts = state_from_numpy(*(np.asarray(x) for x in (s.velocity, s.dye, s.pressure)),
                          device="cpu")
    splats = np.array(jsplat.make_splat_array(
        [(0.3, 0.6, 200.0, -100.0, (1.0, 0.2, 0.5)), (0.8, 0.1, -50.0, 80.0, (0.0, 2.0, 0.1))],
        4))
    got = T.apply_splats(ts, splats, cfg)
    want = jax_apply_splats(s, jnp.asarray(splats), jcfg)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for g, w in zip(state_to_numpy(got), (want.velocity, want.dye, want.pressure)):
        w = np.asarray(w, np.float32)
        assert np.abs(g - w).max() <= tol * np.abs(w).max()
    assert got.pressure is ts.pressure and got.dye.dtype == cfg.dtype
    assert not torch.equal(got.dye, ts.dye)


def test_make_splat_array_matches_jax():
    events = [(0.1, 0.2, 3.0, 4.0, (0.5, 0.6, 0.7)), (0.9, 0.8, -1.0, 2.0, (1.0, 0.0, 0.25))]
    got = tsplat.make_splat_array(events, 4)
    assert got.dtype == torch.float32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsplat.make_splat_array(events, 4)))
    with pytest.raises(ValueError, match="MAX_SPLATS=1"):
        tsplat.make_splat_array(events, 1)


@pytest.mark.parametrize("dtype", DTYPES)
def test_state_bytes_matches_jax(dtype):
    jcfg = jconfig.FluidConfig(**KW, DTYPE=dtype).validate()
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    n = state_bytes(T.init_state(cfg, device="cpu"))
    assert n == jstate.state_bytes(jstate.init_state(jcfg))
    (sw, sh), (dw, dh) = cfg.sim_size, cfg.dye_size
    assert n == (3 * sw * sh + 3 * dw * dh) * cfg.dtype.itemsize


@pytest.mark.parametrize("preset", ["mobile_config", "low_capability_config"])
def test_config_presets_match_jax(preset):
    got = getattr(tconfig, preset)(CANVAS_WIDTH=320)
    want = getattr(jconfig, preset)(CANVAS_WIDTH=320)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.DYE_RESOLUTION == 512


def test_package_exports_the_api_of_tpufluid():
    import tpufluid

    for name in ("Pointer", "PointerTracer", "generate_color", "random_splats",
                 "apply_splats", "Trace"):
        assert name in T.__all__ and name in tpufluid.__all__
        assert getattr(T, name).__name__ == getattr(tpufluid, name).__name__
