"""repro_torch.analysis — static invariant checker for the PyTorch port
(port of ``repro.analysis``).

Two modes, one CLI (``python -m repro_torch.analysis``):

* **lint** (:mod:`repro_torch.analysis.lint`) — AST rules over
  ``src/repro_torch`` that need the repo's conventions and a
  cross-module step-reachability graph: raw matmuls outside the blessed
  Q-MAC/Q-Conv entry points (QF101), host syncs on likely tensors
  (QF201), draws from hidden generators or clocks (QF301) and whole
  copies of threaded state (QF401) inside step-reachable code, env
  wrappers that bypass the ``wrapper_stack`` tagging protocol (QF501)
  and bare ``print()`` in library code (QF601).  Audited exceptions
  live in ``allowlist.toml`` next to this file; unlisted findings fail,
  stale entries fail too.

* **trace** (:mod:`repro_torch.analysis.trace_audit`) — one real
  iteration of every (env x net x algo x precision) combination the
  training CLI accepts, at small sizes, under an op recorder, on the
  card unless ``--device cpu``: no float64/complex128 value in the step
  (QF901a), threaded state back with the shape, dtype and device it
  went in with (QF901b), every packed QTensor on its consumer's
  per-out-channel scale grid (QF902), every served forward on a warmed
  bucket of the ladder (QF903), and the replay (and the other state
  the reference donates that the port writes in place) kept in its own
  storage (QF904).
"""
from repro_torch.analysis.rules import Finding, RULES, rule_ids

__all__ = ["Finding", "RULES", "rule_ids"]
