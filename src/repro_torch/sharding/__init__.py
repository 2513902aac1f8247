"""Sharding of the port: the reference's rules and their DTensor placements."""
from .rules import (  # noqa: F401
    NamedSharding,
    P,
    batch_specs,
    cache_specs,
    current_mesh,
    distribute,
    distribute_model,
    param_specs,
    state_specs,
    to_named,
    use_mesh,
)
