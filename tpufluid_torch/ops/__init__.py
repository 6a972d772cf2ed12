"""tpufluid_torch.ops — plain PyTorch ops of the step (the counterparts of
``tpufluid.ops``); the CUDA kernels and their wrappers are in
``tpufluid_torch.ops.cuda``."""
