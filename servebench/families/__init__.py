"""Each model family's own rules, one file a family (``<family>.py``, named by
the ``family`` of a configuration file): the kernels its serving step
launches, how the weight leaves only it has are drawn, and the matmul work a
token passes through. The harness, ``weights.py`` and ``flops.py`` find the
file by that name, so a new family is a new file here (and its reference in
``servebench/reference/``)."""
import importlib


def load(name: str):
    return importlib.import_module(f"servebench.families.{name}")
