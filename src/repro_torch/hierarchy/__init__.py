"""Hierarchical cluster consensus: mobility-driven clustering, leader
election and two-tier mixing (``mixing_format="hierarchical"``)::

    cluster   = clustering.cluster_stack(adj_stack, pos, ...)   # (R, K)
    leader_of = leaders.elect_leaders(cluster, adj_stack, pos)  # (R, K)
    h, gammas = mixing.build_hier_stacks(geometry, ...)         # HierEta

See :mod:`repro_torch.hierarchy.mixing` for the two-tier mix.
"""
from repro_torch.hierarchy import clustering, leaders, mixing
from repro_torch.hierarchy.clustering import cluster_stack, remerge_flags
from repro_torch.hierarchy.leaders import elect_leaders, leader_table
from repro_torch.hierarchy.mixing import (HierEta, build_hier_stacks,
                                          constant_hier_stacks,
                                          hier_gamma_stack, hier_mix_flat,
                                          hier_scenario_stacks,
                                          hier_static_stacks)

__all__ = [
    "clustering", "leaders", "mixing", "cluster_stack", "remerge_flags",
    "elect_leaders", "leader_table", "HierEta", "build_hier_stacks",
    "constant_hier_stacks", "hier_gamma_stack", "hier_mix_flat",
    "hier_scenario_stacks", "hier_static_stacks",
]
