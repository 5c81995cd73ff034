"""One intra-op thread a pytest-xdist worker for the port's tests.

The suite runs in several xdist workers on one machine. Each worker is a
process whose torch would otherwise start an intra-op pool of one thread a
core, so six workers keep six pools spinning over the same cores, and a
port test of small CPU ops runs many times slower than alone (a sampled
engine test, six concurrent runs on an 8-core machine: 183 s each with the
default pool, 10 s with one thread a run). Every worker collects every test
module before it runs a test, so this setting, made when this module is
collected, holds for every test of the worker. Run alone (no xdist), the
tests keep torch's default pool. The spawned gloo ranks set their own
(``launch.mesh.run_local_ranks``).
"""
import os

import pytest

torch = pytest.importorskip("torch")

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_an_xdist_worker_runs_one_intra_op_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        assert torch.get_num_threads() == 1
    else:
        assert torch.get_num_threads() >= 1
