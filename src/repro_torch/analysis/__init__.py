"""Static and runtime analysis of the port (``python -m
repro_torch.analysis lint|kernels|audit``), the counterpart of the JAX
package's ``repro/analysis`` and ``tools/dtmlint``:

* :mod:`repro_torch.analysis.lint` — AST rules that hold for torch code
  (env reads, hot-path syncs, mutable defaults, bare excepts, unlocked
  stats reads, non-atomic durable writes), scoped to ``repro_torch/``;
* :mod:`repro_torch.analysis.kernel_check` — CUDA launch geometry of
  every kernel wrapper (threads, shared memory, clusters, grid limits,
  coverage) over every plan the autotuner can emit, against a
  ``launch.mesh.HardwareModel``;
* :mod:`repro_torch.analysis.trace_audit` — the five-kind scenario
  through sessions, banks and the scheduler: graphs per stage,
  dispatches per epoch, no sync in the guarded sections on the card, and
  the dispatch tables against the port's golden ``baseline.json``.
"""

from repro_torch.analysis.lint import RULES, Finding, lint_paths, lint_source

__all__ = ["RULES", "Finding", "lint_paths", "lint_source"]
