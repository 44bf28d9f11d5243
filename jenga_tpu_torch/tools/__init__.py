"""Probe tools of the port: each times one probe kernel (P1-P4) beside
what it splits or competes with, at the JAX tool's own shape, and prints
the JAX tool's table. Run on the card as ``python -m
jenga_tpu_torch.tools.<name>``; ``run(..., device=...)`` is what the smoke
test and the CPU tests call."""
