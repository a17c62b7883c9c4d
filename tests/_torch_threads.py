"""Torch's intra-op threads in the port's CPU tests.

Tier-1 runs the suite in six xdist workers on one host. Each worker would
otherwise give torch an intra-op pool as wide as the host, beside XLA's own
pool, and the workers' pools would contend for the same cores. Every
``tests/test_torch_*.py`` module imports this one, so each worker that
collects them runs torch on ``TORCH_THREADS`` threads.
"""

import torch

TORCH_THREADS = 2

torch.set_num_threads(TORCH_THREADS)
