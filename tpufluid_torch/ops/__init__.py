"""tpufluid_torch.ops — plain PyTorch ops of the step (the counterparts of
``tpufluid.ops``, with its public names); the CUDA kernels and their
wrappers are in ``tpufluid_torch.ops.cuda``, which this package does not
import."""

from tpufluid_torch.ops.sampling import sample_bilinear, sample_bilinear_repeat, resample_bilinear
from tpufluid_torch.ops.stencil import (
    curl,
    divergence,
    vorticity_confinement,
    jacobi_pressure,
    gradient_subtract,
)
from tpufluid_torch.ops.advect import advect
from tpufluid_torch.ops.splat import splat_field, gaussian_splat
