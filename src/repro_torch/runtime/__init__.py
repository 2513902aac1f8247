"""Training runtime of the port: the fault-tolerance supervisor."""
from .supervisor import (SimulatedHostFailure, StragglerDetector,  # noqa: F401
                         Supervisor, SupervisorConfig)
