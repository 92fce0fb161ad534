"""R-FAST core: topology, the CommPlan/protocol substrate, schedules and
scenarios (numpy copies of the JAX package's planners), the flat
parameter substrate, the engines (wavefront, event-serial, the fleet
sweep) and the baselines.

Layering (DESIGN.md): ``Topology`` -> :class:`CommPlan` (one static
edge-plan extraction) -> :mod:`protocol` (the single S.1–S.5 update, with
``plain``/``kernel`` backends) -> execution engines (``simulator``,
``runtime``)."""
from .topology import (  # noqa: F401
    Topology, get_topology, binary_tree, line, directed_ring,
    undirected_ring, exponential, mesh2d, parameter_server, robust_tree,
    TOPOLOGIES, validate_weights, spanning_tree_roots,
    spanning_tree_roots_dense, common_roots, subgraph_topology,
    bfs_tree_topology, epoch_topology,
)
from .plan import (  # noqa: F401
    CommPlan, build_comm_plan, pad_comm_plan, matchings,
)
from .paramvec import (  # noqa: F401
    RavelSpec, make_ravel_spec, ravel, unravel,
    GradProvider, ModelGradProvider, as_grad_fn,
)
from .protocol import (  # noqa: F401
    ProtocolState, init_protocol_state, make_protocol_round,
    protocol_tracked_mass, descent_step, momentum_mix, consensus_mix,
    tracking_step, mailbox_merge, IMPLS,
)
from .schedule import (  # noqa: F401
    Schedule, WavefrontPlan, build_wavefront_plan, pad_plan, stack_plans,
    generate_schedule, round_robin_schedule,
)
from .scenario import (  # noqa: F401
    NetworkScenario, ScenarioTrace, Epoch, EpochTrace, GilbertElliott,
    EdgeChannels, SCENARIOS, get_scenario, realize_batch,
    realize_epochs_batch,
)
from .simulator import (  # noqa: F401
    RFASTState, init_state, rfast_scan, run_rfast, run_sweep, tracked_mass,
)
from . import baselines  # noqa: F401
