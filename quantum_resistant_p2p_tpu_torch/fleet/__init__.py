"""Gateway-pod fleet: the multi-process serving tier.

Counterpart of the JAX package's ``fleet/`` (the router and the storm
driver excepted, which are still to port): N gateway PROCESSES, each one
P2PNode + SecureMessaging engine on the GPU, behind a peer-routing tier,
with gateway death as the first-class case:

* :mod:`.ring`     — seeded consistent-hash peer→gateway assignment
                     (bounded virtual nodes; adding/removing one gateway
                     moves only its arc).
* :mod:`.lease`    — the leader lease of replicated routers (monotonic
                     epochs, relative TTLs, rank-staggered claims).
* :mod:`.control`  — the framed control-plane protocol (hello /
                     heartbeat / probe / stop / route) between the router
                     and its gateways, reusing net/p2p_node.py's wire
                     format.
* :mod:`.gateway`  — the gateway worker entry point
                     (``python -m quantum_resistant_p2p_tpu_torch.fleet.gateway``):
                     one P2PNode + SecureMessaging engine, heartbeats to
                     the router, per-node ``slo_report.json`` on exit.
* :mod:`.manager`  — :class:`GatewayFleet`: spawns/watches the gateways,
                     owns the ring and the fleet-scope breakers (a dead
                     gateway is a breaker-open shard at fleet scope —
                     provider/batched.py ``Breaker`` reused at the second
                     placement level), serves route queries, aggregates
                     cross-process SLO totals into one burn-rate engine.
* :mod:`.stormlib` — the storm workload environment every gateway
                     subprocess applies (``storm_env()``, the stdlib toy
                     providers, facade pre-warming).

None of these modules holds a kernel: the gateways' engines reach the
port's kernels through the provider layer.
"""

from .manager import FleetBusy, GatewayFleet, GatewayMember  # noqa: F401
from .ring import HashRing  # noqa: F401
from .stormlib import StormAEAD, register_storm_providers, storm_env  # noqa: F401
