"""Fault injection, self-healing consensus and Byzantine-robust mixing
(the twin of the JAX package's ``repro.faults``).

* :mod:`repro_torch.faults.models` — registered fault models (link_drop,
  crash, corrupt, straggle, byzantine) compiled on the host by
  :func:`compile_plan` into a :class:`FaultPlan` of per-round numpy
  schedules: an ``(R, K, K)`` link mask folded into the eta stacks and
  ``(R, K)`` node-health / wire-behavior stacks read round by round;
  :func:`wire_guard` quarantines non-finite / blown-up payloads;
* :mod:`repro_torch.faults.robust` — Byzantine-robust aggregation
  (coordinate-wise trimmed mean / median over neighbor rows, kernel B7)
  replacing the eq. 5 mix.
"""
from repro_torch.faults.models import (  # noqa: F401
    FaultPlan,
    compile_plan,
    config_active,
    corrupt_rows,
    wire_guard,
    wire_kinds,
)
from repro_torch.faults.robust import (  # noqa: F401
    make_robust,
    robust_exchange,
)
