"""The port's profiling path (tpufluid_torch/ops/floors.py,
ops/cuda/floors.py) against tpufluid/ops/pallas/floors.py on the CPU.

The three plain versions are held to the Pallas microbenchmark kernels run in
interpret mode on the very inputs measure_* builds (``_scan_rate`` is
stubbed to capture one call's output): uint32 words bit-equal, the float32
sweep within 1e-6 of the field's scale (both sum in the same order; the
margin is for XLA's CPU code). The work models are pinned by hand counts,
the report's arithmetic and the profiler attribution by fixed numbers. The
measurements themselves need the card, and raise without one.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import tpufluid.ops.pallas.floors as fl
import tpufluid_torch as T
from tpufluid_torch.ops import floors as pf
from tpufluid_torch.ops.cuda import check
from tpufluid_torch.ops.cuda import floors as fk


def _pallas_output(measure, *args, **kwargs) -> np.ndarray:
    """Output of one call of the Pallas kernel that ``measure`` times, in
    interpret mode, from the seed and inputs ``measure`` builds."""
    orig = fl.pl.pallas_call
    got = []

    def scan_rate(call, seed, scan_len=10, reps=3):
        got.append(np.asarray(call(seed)))
        return 1.0

    with mock.patch.object(fl.pl, "pallas_call",
                           lambda *a, **k: orig(*a, interpret=True, **k)), \
            mock.patch.object(fl, "_scan_rate", scan_rate):
        measure(*args, **kwargs)
    return got[0]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("planes,n_idx,reps,trips", [(2, 2, 2, 2), (3, 4, 5, 3), (2, 8, 32, 8)])
def test_taa_plain_matches_pallas(planes, n_idx, reps, trips):
    want = _pallas_output(fl.measure_taa_row_rate, planes=planes, n_idx=n_idx,
                          reps=reps, trips=trips)
    got = pf.taa_plain(*pf.taa_inputs(planes, n_idx, reps), trips, reps)
    assert want.dtype == np.uint32 and want.shape == (64, 128)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("planes,nrk,cbw,trips", [(2, 96, 384, 3), (1, 10, 128, 23),
                                                     (2, 96, 384, 256)])
def test_roll_plain_matches_pallas(planes, nrk, cbw, trips):
    """nrk = 96 with 3 trips is not symmetric in the roll's direction;
    23 trips over nrk = 10 wrap the shift k mod nrk; the last is the shape
    chip_smoke.py times."""
    want = _pallas_output(fl.measure_roll_rate, planes, nrk, cbw, trips=trips)
    got = pf.roll_plain(*pf.roll_inputs(planes, nrk, cbw), trips)
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("chunks,sweeps", [(1, 2), (2, 1)])
def test_sweep_plain_matches_pallas(chunks, sweeps):
    want = _pallas_output(fl.measure_sweep_rate, chunks=chunks, sweeps=sweeps)
    got = pf.sweep_plain(*pf.sweep_inputs(), chunks, sweeps).numpy()
    assert got.shape == want.shape == (256, 1024)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def _pallas_direct(kernel, out_shape, *inputs, **params) -> np.ndarray:
    """One call of a floors Pallas kernel in interpret mode on given inputs,
    whole arrays as the blocks, as measure_* calls it."""
    import jax

    call = fl.pl.pallas_call(functools.partial(kernel, **params), interpret=True,
                             out_shape=jax.ShapeDtypeStruct(out_shape, inputs[0].dtype))
    return np.asarray(call(*inputs))


@pytest.mark.parametrize("h,w,chunks,sweeps", [(256, 1024, 1, 2), (37, 131, 2, 3)])
def test_sweep_plain_matches_pallas_on_a_random_field(h, w, chunks, sweeps):
    """A field and right-hand side that are not uniform: every neighbour,
    the clamped edges and the order of the sum count (floors.py:171-175
    sums L, R, B, T in that order). Bit-equal: both run the same float32
    adds in the same order."""
    rng = np.random.default_rng(7)
    seed = rng.random((h, w), dtype=np.float32)
    x = rng.standard_normal((h, w), dtype=np.float32)
    want = _pallas_direct(fl._sweep_kernel, (h, w), seed, x, chunks=chunks, sweeps=sweeps)
    got = pf.sweep_plain(torch.from_numpy(seed), torch.from_numpy(x), chunks, sweeps).numpy()
    assert np.ptp(want) > 1.0
    np.testing.assert_array_equal(got, want)


def test_taa_and_roll_plain_match_pallas_on_random_words():
    """Random uint32 words, whose sums wrap, and gather indices that vary
    by row as well as by lane."""
    rng = np.random.default_rng(8)
    planes, n_idx, reps, trips = 2, 3, 4, 2
    seed = rng.integers(0, 2 ** 32, (64, 128), dtype=np.uint32)
    idx = rng.integers(0, 128, (n_idx, 64, 128), dtype=np.int32)
    op = rng.integers(0, 2 ** 32, (planes, 64 + reps, 128), dtype=np.uint32)
    want = _pallas_direct(fl._taa_kernel, (64, 128), seed, idx, op, trips=trips,
                          planes=planes, n_idx=n_idx, reps=reps)
    got = pf.taa_plain(*(torch.from_numpy(a.view(np.int32)) for a in (seed, idx, op)),
                       trips, reps)
    np.testing.assert_array_equal(_u32(got), want)

    rseed = rng.integers(0, 2 ** 32, (2, 96, 128), dtype=np.uint32)
    rop = rng.integers(0, 2 ** 32, (2, 96, 128), dtype=np.uint32)
    want = _pallas_direct(fl._roll_kernel, (2, 96, 128), rseed, rop, trips=101)
    got = pf.roll_plain(torch.from_numpy(rseed.view(np.int32)),
                        torch.from_numpy(rop.view(np.int32)), 101)
    np.testing.assert_array_equal(_u32(got), want)


def test_words_wrap_as_uint32():
    """Seeds near 2^32: the plain versions wrap like uint32 arithmetic."""
    rng = np.random.default_rng(0)
    seed = rng.integers(2 ** 32 - 5000, 2 ** 32, (64, 128), dtype=np.uint64).astype(np.uint32)
    _, idx, op = pf.taa_inputs(2, 3, 4)
    got = pf.taa_plain(torch.from_numpy(seed.view(np.int32)), idx, op, 2, 4)
    acc = seed.copy()
    o, ix = op.numpy().view(np.uint32), idx.numpy()
    for _ in range(2):
        for rep in range(4):
            for j in range(3):
                for ch in range(2):
                    acc = acc + np.take_along_axis(o[ch, rep:rep + 64], ix[j], axis=1)
    np.testing.assert_array_equal(_u32(got), acc)

    rseed = rng.integers(2 ** 32 - 50, 2 ** 32, (2, 7, 5), dtype=np.uint64).astype(np.uint32)
    _, rop = pf.roll_inputs(2, 7, 5)
    got = pf.roll_plain(torch.from_numpy(rseed.view(np.int32)), rop, 9)
    acc = rseed.copy()
    for k in range(9):
        acc = acc + np.roll(rop.numpy().view(np.uint32), k % 7, axis=1)
    np.testing.assert_array_equal(_u32(got), acc)


def _square(res, dtype="bfloat16", iters=20):
    return T.FluidConfig(SIM_RESOLUTION=res, DYE_RESOLUTION=res, CANVAS_WIDTH=res,
                         CANVAS_HEIGHT=res, PRESSURE_ITERATIONS=iters, DTYPE=dtype).validate()


def test_gather_rows_hand_counts():
    """4 corners per channel per texel, in 128-word rows; the demo's dye
    also samples the coarser velocity's 2 channels at 4 corners."""
    cfg = _square(1024)
    vel = torch.zeros((2, 1024, 1024), dtype=torch.bfloat16)
    (vr, vc, vt), (dr, dc, dt) = fk.gather_rows_per_step(cfg, vel, 1 / 60)
    assert (vr, vc, vt) == (4 * 2 * 1024 * 1024 / 128, 2, 1024 * 1024) == (65536, 2, 1048576)
    assert (dr, dc, dt) == (98304, 3, 1048576)
    # the count depends on neither the velocity nor dt
    fast = torch.full((2, 1024, 1024), 900.0)
    assert fk.gather_rows_per_step(cfg, fast, 0.01) == fk.gather_rows_per_step(cfg, vel, 1 / 60)
    demo = T.FluidConfig().validate()      # sim 228 x 128, dye 1820 x 1024
    (vr, _, _), (dr, _, _) = fk.gather_rows_per_step(demo, None, 1 / 60)
    assert vr == 4 * 2 * 128 * 228 / 128 == 1824
    assert dr == (4 * 3 + 4 * 2) * 1024 * 1820 / 128 == 291200


def test_jacobi_cell_sweeps_hand_counts():
    assert fk.jacobi_cell_sweeps(_square(1024)) == 1024 * 1024 * 20
    assert fk.jacobi_cell_sweeps(_square(1024, iters=45)) == 1024 * 1024 * 45
    assert fk.jacobi_cell_sweeps(T.FluidConfig().validate()) == 128 * 228 * 20


def test_floor_table_arithmetic():
    measured = {"velocity_gather": 20.0, "dye_gather": 40.0, "jacobi": 50.0,
                "stencil": 30.0, "gradient_subtract": 10.0}
    other = {"other_device_us": 15.0, "cuda_runtime_host_us": 300.0, "top_other_ops": [],
             "kernel_events": {}}
    gathers = [(65536.0, 2, 1 << 20), (98304.0, 3, 1 << 20)]
    out = fk.floor_table(measured, other, gathers, 20 << 20, 5 * (1 << 20) * 2,
                         taa_rate=2.0e9, sweep_rate=1.0e11, device_bw_gbps=3000.0,
                         measured_steps_per_s=1000.0)
    assert out["velocity_gather"] == {"measured_us": 20.0, "taa_rows": 65536.0,
                                      "achieved_rows_per_us": 3276.8,
                                      "reference_rows_per_us": 2000.0, "advantage": 1.64}
    assert out["dye_gather"]["achieved_rows_per_us"] == 2457.6
    assert out["dye_gather"]["advantage"] == 1.23
    assert out["jacobi"] == {"measured_us": 50.0, "cell_sweeps": 20971520,
                             "achieved_gcells_per_s": 419.4,
                             "reference_gcells_per_s": 100.0, "advantage": 4.19}
    assert out["stencil"] == {"occupancy_us": 30.0, "hbm_stream_us": 3.5}
    assert out["kernel_total_us"] == 150.0 and out["step_us"] == 1000.0
    assert out["step_coverage"] == 0.15
    assert out["other"]["glue_idle_us"] == 835.0
    assert out["other"]["attributed_coverage"] == 0.165
    assert out["other"]["cuda_runtime_host_us"] == 300.0
    assert "north_star" not in out
    # a kernel the profile did not see reads 0 and has no rate
    out = fk.floor_table({}, other, gathers, 1, 1, 1.0, 1.0, 1.0, 10.0)
    assert out["velocity_gather"]["achieved_rows_per_us"] is None
    assert out["jacobi"]["advantage"] is None


def _events(steps):
    """Synthetic profiler events of ``steps`` steps in stream order:
    (name, on_device, start_us, duration_us)."""
    ev, t = [], 0.0
    names = [("void splat_curl_kernel<float>(float const*, float const*)", 2.0),
             ("void at::native::vectorized_elementwise_kernel<4, float>(int)", 1.5),
             ("void confine_divergence_kernel<float>(float const*)", 3.0)]
    names += [("void jacobi_sweep_kernel<float, float, float>(float const*)", 0.5)] * 20
    names += [("void gradient_subtract_kernel<float>(float const*)", 1.0),
              ("void advect_kernel<float>(float const*, int)", 4.0),
              ("Memcpy HtoD (Pageable -> Device)", 0.25),
              ("void advect_kernel<float>(float const*, int)", 8.0)]
    for _ in range(steps):
        for name, dur in names:
            ev.append((name, True, t, dur))
            ev.append(("cudaLaunchKernel", False, t, 5.0))
            t += 10.0
    ev.append(("cudaDeviceSynchronize", False, t, 100.0))
    return ev


def test_attribute_device_events():
    launched = {"splat_curl": 3, "confine_divergence": 3, "jacobi_sweep": 60,
                "gradient_subtract": 3, "advect": 6, "display": 0}
    # any order in, stream order used
    ev = _events(3)[::-1]
    kt, other = fk.attribute_device_events(ev, launched, steps=3, top_other=1)
    assert kt == {"velocity_gather": 4.0, "dye_gather": 8.0, "jacobi": 10.0, "stencil": 5.0,
                  "gradient_subtract": 1.0}
    assert other["other_device_us"] == 1.8            # 1.5 + 0.25 a step
    assert other["top_other_ops"] == [
        {"op": "void at::native::vectorized_elementwise_kernel<4, float>(int)", "us": 1.5}]
    assert other["cuda_runtime_host_us"] == 5.0 * 27   # the sync is not counted
    assert other["kernel_events"]["jacobi_sweep"] == {"events": 60, "us": 10.0}
    with pytest.raises(AssertionError, match="jacobi_sweep"):
        fk.attribute_device_events(ev, {**launched, "jacobi_sweep": 59}, steps=3)
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        fk.attribute_device_events([("Memcpy HtoD", True, 0.0, 1.0),
                                    ("cudaLaunchKernel", False, 0.0, 1.0)], {}, steps=1)


def test_port_kernel_names():
    assert fk.port_kernel("void advect_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)") \
        == "advect"
    assert fk.port_kernel("floor_sweep_kernel(float const*, float const*)") == "floor_sweep"
    assert fk.port_kernel("void jacobi_sweep_kernel<float, __half, __half>(float const*)") \
        == "jacobi_sweep"
    assert fk.port_kernel("void at::native::vectorized_elementwise_kernel<4>(int)") is None
    assert fk.port_kernel("Memset (Device)") is None
    assert fk.port_kernel("void unknown_kernel<float>(float)") is None


def test_floors_cases_on_the_cpu():
    """The cases' plain versions run on the CPU at both shape sets, carry
    their work, and the kernel wrappers refuse CPU tensors."""
    for ragged in (False, True):
        cases = check.floors_cases("cpu", ragged)
        assert [c.kernel_name for c in cases] == ["floor_taa", "floor_roll", "floor_sweep"]
        for case in cases:
            out = case.run(plain=True)
            assert case.nbytes > 0 and case.flops > 0
            assert check.compare(out, out)[0] == 0.0
            with pytest.raises(ValueError, match="expected a CUDA tensor"):
                case.run()
    bytes_, ops = check.floors_work()["floors.py:163 _sweep_kernel"]
    assert (bytes_, ops) == (3 * 4 * 256 * 1024, 16 * 20 * 256 * 1024 * 5)
    a = torch.tensor([1, -1], dtype=torch.int32)
    assert check.compare(a, torch.tensor([1, 2 ** 31 - 1], dtype=torch.int32)) == (2.0 ** 31, 0.0)


@pytest.mark.parametrize("ragged", [False, True], ids=["default", "ragged"])
def test_random_floors_cases_on_the_cpu(ragged):
    """The random cases give what the microbenchmarks' inputs do not: an
    index that varies by row, a ragged gather tile that fills no 256-thread
    block evenly, a sweep field that is not uniform; their plain versions
    agree with numpy loops (the gather) and run on the CPU, and the kernel
    wrappers refuse CPU tensors."""
    taa, roll, sweep = check.random_floors_cases("cpu", ragged, seed=1)
    assert [c.label for c in (taa, roll, sweep)] == [
        f"{k}{':ragged' if ragged else ''}:random"
        for k in ("floor_taa", "floor_roll", "floor_sweep")]
    seed, idx, op, trips, reps = taa.args
    rows, lanes = seed.shape
    assert (rows, lanes) == (check.TAA_RAGGED_TILE if ragged else (64, 128))
    assert (rows * lanes % 256 != 0) == ragged
    assert not torch.equal(idx[:, 0], idx[:, 1])
    assert float(sweep.args[0].std()) > 0.1 and float(sweep.args[1].std()) > 0.1

    acc = _u32(seed).copy()
    o, ix = _u32(op), idx.numpy()
    for _ in range(trips):
        for rep in range(reps):
            for j in range(ix.shape[0]):
                for ch in range(o.shape[0]):
                    acc = acc + np.take_along_axis(o[ch, rep:rep + rows], ix[j], axis=1)
    np.testing.assert_array_equal(_u32(taa.run(plain=True)), acc)
    for case in (roll, sweep):
        out = case.run(plain=True)
        assert check.compare(out, out)[0] == 0.0 and case.nbytes > 0 and case.flops > 0
    for case in (taa, roll, sweep):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            case.run()


def test_measurements_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _square(32, "float32")
    state = T.init_state(cfg, device="cpu")
    for call in (fk.measure_taa_row_rate, fk.measure_sweep_rate, fk.measure_hbm_bandwidth_gbps,
                 lambda: fk.measure_roll_rate(2, 96, 384),
                 lambda: fk.profile_step_kernels(cfg, state, 1 / 60),
                 lambda: fk.floor_report(cfg, state, 1 / 60, 3000.0, 1000.0)):
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            call()
