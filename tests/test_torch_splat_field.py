"""The one-impulse splat of the port (tpufluid_torch.ops.splat.gaussian_splat
and splat_field) against tpufluid.ops.splat on the CPU, and the public
names of tpufluid_torch.ops against those of tpufluid.ops.

Inputs are made with numpy from a seed: a field N(0, 1) scaled, a point in
the unit square, an amount a channel, a radius and the grid's aspect. The
two packages compute the same float32 operations but for exp, whose
rounding differs by an ulp or so. Tolerances: in float32 within 2e-6 of the
field's scale (the gaussian's scale is 1); a 16-bit field within one ulp
of its storage type, the sum being taken in that type by both.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufluid.ops as jops
from tpufluid.ops.splat import gaussian_splat as jax_gaussian_splat
from tpufluid.ops.splat import splat_field as jax_splat_field
import tpufluid_torch.ops as tops
from tpufluid_torch.ops.splat import gaussian_splat, splat_field

SHAPES = [(3, 16, 24), (2, 17, 31), (3, 40, 40)]   # (C, H, W); 31: an odd width
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
# (mantissa bits, least normal exponent) of each 16-bit storage type
ULP = {"bfloat16": (7, -126), "float16": (10, -14)}


def _inputs(seed, c, h, w):
    rng = np.random.default_rng(seed)
    field = (rng.standard_normal((c, h, w)) * 3.0).astype(np.float32)
    x, y = (float(v) for v in rng.random(2, dtype=np.float32))
    amount = (rng.standard_normal(c) * 2.0).astype(np.float32)
    radius = float(np.float32(rng.uniform(0.005, 0.05)))
    return field, x, y, amount, radius, w / h


def _ulp(v: np.ndarray, dtype: str) -> np.ndarray:
    bits, emin = ULP[dtype]
    e = np.floor(np.log2(np.maximum(np.abs(v), np.float32(2.0) ** emin)))
    return np.float32(2.0) ** (np.maximum(e, emin) - bits)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gaussian_splat_matches_jax(shape):
    _, h, w = shape
    _, x, y, _, radius, aspect = _inputs(1, *shape)
    got = gaussian_splat(h, w, x, y, radius, aspect)
    want = np.asarray(jax_gaussian_splat(h, w, x, y, radius, aspect))
    assert got.dtype == torch.float32 and got.shape == (h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_splat_field_matches_jax(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    field, x, y, amount, radius, aspect = _inputs(2, *shape)
    got = splat_field(torch.from_numpy(field).to(tdt), x, y, torch.from_numpy(amount), radius,
                      aspect)
    want = jax_splat_field(jnp.asarray(field).astype(jdt), x, y, jnp.asarray(amount), radius,
                           aspect)
    assert got.dtype == tdt and got.shape == shape
    g, wf = got.to(torch.float32).numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        assert np.abs(g - wf).max() <= 2e-6 * np.abs(wf).max()
    else:
        bound = _ulp(np.maximum(np.abs(g), np.abs(wf)), dtype)
        assert (np.abs(g - wf) <= bound).all(), float(np.abs(g - wf).max())


def test_ops_exports_equal_jax():
    """tpufluid_torch.ops binds the same public names as tpufluid.ops, each
    the port's own function."""
    def names(mod):
        return sorted(n for n, v in vars(mod).items()
                      if not n.startswith("_") and not inspect.ismodule(v))

    assert names(tops) == names(jops)
    assert len(names(tops)) == 11
    for n in names(tops):
        assert getattr(tops, n).__module__.startswith("tpufluid_torch.ops."), n

