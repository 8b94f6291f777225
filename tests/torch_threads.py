"""Torch on one intra-op thread in each pytest-xdist worker.

Every ``tests/test_torch_*.py`` imports this module first, so each
worker, which collects every file, caps torch's thread pool before any
test runs. The Tier-1 run has 6 workers on 8 CPUs; at torch's default of
one thread a CPU, 48 threads spun against each other and a test whose
body takes 1.5 s alone took minutes. A run outside xdist keeps torch's
default. No test compares bits across thread counts: a bit-for-bit check
runs both sides in one process, under the same cap.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
