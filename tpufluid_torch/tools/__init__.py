"""Command-line tools of the port (``python -m tpufluid_torch.tools.<name>``)."""
