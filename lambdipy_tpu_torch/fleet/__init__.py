"""Replica fleet: prefix-affinity router + health-driven replica pool.

The port's copy of ``lambdipy_tpu/fleet/`` (same modules, classes and
``__all__``), over the port's replicas: ``python -m lambdipy_tpu_torch
fleet <bundle>`` spawns them on the card (``--device cpu`` for the CPU).

The front door that multiplies the per-replica serve stack across N
supervised bundle servers — see pool.py (spawn/attach/probe/eject/
readmit/rolling drain), affinity.py (rendezvous hashing over leading
token blocks, matching the radix prefix cache), router.py (the HTTP
front-door with retry/hedge/spill/metrics-aggregation), breaker.py
(per-replica circuit breakers + the fleet-wide retry budget), spill.py
(the router-level overload parking lot built from the sched layer's
queue/policy pieces), and policy.py + controller.py (the elastic
control loop: pure decisions over the published signals, acted through
the pool/router's own safe primitives).
"""

from lambdipy_tpu_torch.fleet.affinity import (
    DEFAULT_BLOCK,
    pick_replica,
    prefix_key,
    warm_prompt,
)
from lambdipy_tpu_torch.fleet.affinity import ship_prompt
from lambdipy_tpu_torch.fleet.breaker import CircuitBreaker, RetryBudget
from lambdipy_tpu_torch.fleet.controller import FleetController
from lambdipy_tpu_torch.fleet.policy import (
    Action,
    PolicyConfig,
    PolicyState,
    ReplicaView,
    Snapshot,
    decide,
)
from lambdipy_tpu_torch.fleet.pool import (
    CLASSES,
    DECODE,
    DRAINING,
    EJECTED,
    MIXED,
    PREFILL,
    READY,
    STOPPED,
    FleetError,
    Replica,
    ReplicaPool,
    parse_attach_spec,
)
from lambdipy_tpu_torch.fleet.router import FleetRouter
from lambdipy_tpu_torch.fleet.spill import SpillQueue

__all__ = [
    "CLASSES",
    "DECODE",
    "DEFAULT_BLOCK",
    "DRAINING",
    "EJECTED",
    "MIXED",
    "PREFILL",
    "READY",
    "STOPPED",
    "Action",
    "CircuitBreaker",
    "FleetController",
    "FleetError",
    "FleetRouter",
    "PolicyConfig",
    "PolicyState",
    "Replica",
    "ReplicaPool",
    "ReplicaView",
    "RetryBudget",
    "Snapshot",
    "SpillQueue",
    "decide",
    "parse_attach_spec",
    "pick_replica",
    "prefix_key",
    "ship_prompt",
    "warm_prompt",
]
