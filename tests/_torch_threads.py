"""Cap torch's intra-op threads in the port's CPU tests.

Under pytest-xdist each worker's torch would otherwise size its thread pool
to the whole host, beside XLA's own pool, and the workers then contend for
the same cores.  Each worker takes its share of the cores instead (all of
them without xdist).  The port's test files import this module for that
side effect.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
