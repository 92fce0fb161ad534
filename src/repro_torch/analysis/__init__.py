"""Static analysis for the port's R-FAST engines: plan-invariant linting
and program auditing.

Counterpart of ``src/repro/analysis/``.  Two passes over two artifact
families:

* :mod:`.planlint` — host-side race/alias/sentinel checks (RF101–RF106)
  over ``CommPlan`` / ``WavefrontPlan`` / ``EpochTrace`` objects and
  every transform composition; a verbatim copy of the reference's.
* :mod:`.torchlint` — the counterpart of ``jaxlint.py``: checks
  RF201–RF205 over the aten ops that one call of an engine runs, and
  the runtime contracts (in-place state, serving cache, kernel
  launches).

Run everything with ``python -m repro_torch.analysis --all``; it emits
the JSON report documented in DESIGN.md §12.  The engines' and
``launch/train.py``'s ``verify_plans`` run the plan pass alone.
"""
from .diagnostics import CODES, Diagnostic, PlanInvariantError

__all__ = ["CODES", "Diagnostic", "PlanInvariantError"]
