# The paper's primary contribution: cluster-scale experiment orchestration
# (grid expansion, templated job manifests, heterogeneous-resource
# scheduling, staged artifacts, dynamic batch sizing) — the port's copy of
# ``repro.core``, the campaign executor (``run_cluster``) included.
from repro_torch.core.jobs import JobSpec, JobState, Resources
from repro_torch.core.placement import (PlacementPolicy, PLACEMENT_POLICIES,
                                        get_placement_policy)
from repro_torch.core.experiment import ExperimentGrid, ExperimentSpec
from repro_torch.core.templating import render_template, render_job_manifest
from repro_torch.core.scheduler import (ClusterSim, LearnedRequests,
                                        NodeSpec, NAUTILUS_INVENTORY,
                                        node_spec_from_dict,
                                        node_specs_from_json)
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.executor import (CampaignExecutor, ChaosSpec,
                                       ResourcePool, SpeculationSpec,
                                       replay_events)
from repro_torch.core.artifacts import PersistentVolume, S3Store
from repro_torch.core.autobatch import autobatch

__all__ = [
    "JobSpec", "JobState", "Resources",
    "PlacementPolicy", "PLACEMENT_POLICIES", "get_placement_policy",
    "ExperimentGrid", "ExperimentSpec",
    "render_template", "render_job_manifest",
    "ClusterSim", "LearnedRequests", "NodeSpec", "NAUTILUS_INVENTORY",
    "node_spec_from_dict", "node_specs_from_json",
    "Orchestrator", "CampaignExecutor", "ChaosSpec", "ResourcePool",
    "SpeculationSpec", "replay_events",
    "PersistentVolume", "S3Store", "autobatch",
]
