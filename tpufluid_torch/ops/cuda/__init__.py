"""tpufluid_torch.ops.cuda — the hand-written CUDA kernels' wrappers, each
beside its plain PyTorch version, and the dispatch that picks between them
by device (the counterpart of ``tpufluid.ops.pallas``)."""
