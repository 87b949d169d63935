"""Redundancy-aware ingest (the twin of the JAX package's ``repro.ingest``).

The source paper's second motivation, redundant onboard-sensor data
degrading aggregation, lands here as three layers:

* :mod:`repro_torch.ingest.sketches`: per-node rolling count-min and
  HyperLogLog estimators on the device next to the flat ``(K, P)`` buffer:
  effective-cardinality and per-item multiplicity estimates maintained as
  batches stream in;
* :mod:`repro_torch.ingest.scenarios`: registered redundancy generators
  (``duplicate_heavy`` / ``sensor_overlap`` / ``skewed_multiset``)
  compiled on the host, like mobility traces and fault schedules, into
  per-node item streams that ``run_rounds`` samples;
* :mod:`repro_torch.ingest.weighting`: distinct-count-derived per-node
  sampling probabilities and redundancy-aware mixing weights (eta column
  reweighting each round, and the static ``"redundancy"`` mixing policy).

Selected by ``FedConfig.ingest`` (an :class:`repro_torch.configs.base.
IngestConfig`); ``None`` or ``scenario="none"`` keeps the ingest-free
pipeline bit for bit. The sketches are plain tensor ops: the JAX package
computes them outside any kernel too.
"""
from repro_torch.ingest.scenarios import IngestPlan, apply_plan, compile_plan
from repro_torch.ingest.sketches import (SketchState, SlotHashes,
                                         hll_cardinality, init_state,
                                         multiplicity, slot_hashes, update)
from repro_torch.ingest.weighting import (redundancy_mixing, reweight_eta,
                                          sampling_weights, weighted_indices)

__all__ = [
    "IngestPlan", "apply_plan", "compile_plan",
    "SketchState", "SlotHashes", "init_state", "slot_hashes", "update",
    "hll_cardinality", "multiplicity",
    "redundancy_mixing", "reweight_eta", "sampling_weights",
    "weighted_indices",
]
