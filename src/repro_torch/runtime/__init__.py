"""Training runtime of the port: the fault-tolerance supervisor and the
elastic re-mesh planner."""
from .elastic import plan_mesh, restore_on_mesh  # noqa: F401
from .supervisor import (SimulatedHostFailure, StragglerDetector,  # noqa: F401
                         Supervisor, SupervisorConfig)
