"""Thread count of the port's test processes, imported first by each
``tests/test_torch_*.py``.

torch starts as many intra-op threads as the machine has cores. Under
pytest-xdist every worker does, so n workers run n times the cores' threads
and spend most of their time switching. Under xdist each worker takes its
share of the cores instead. The local clusters the tests start give each
rank process one thread (``RANK_ENV``).
"""
import os

import torch

RANK_ENV = {"OMP_NUM_THREADS": "1"}  # a rank process of a test's local cluster

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 0:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
