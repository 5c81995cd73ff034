"""Checks on the serving step, the port's counterpart of ``repro.analysis``.

PyTorch has no compiled program to read, so the step is checked by running
it: ``census`` records what one call of a step closure does (every op's
outputs, every read to the host), ``contract`` holds that record to the
serving contract, ``retrace`` checks that serving a trace again builds and
plans nothing new, and ``lint`` holds the source to named AST rules.

Entry points:

* ``contract.audit_engine(engine)`` -- call and check every step closure of
  a constructed ``ServeEngine`` (``engine.step_closures()``).
* ``retrace.retrace_findings(trace)`` -- serve a trace twice; the second
  run may build no kernel library and grow no plan cache.
* ``lint.lint_paths(roots)`` -- AST rules over the source tree.
* ``python -m repro_torch.analysis.audit`` -- all of it across family x
  {dense, fused, paged}, into one JSON file.
"""
from repro_torch.analysis.findings import Finding, format_findings, gating  # noqa: F401
