"""Gateway-pod fleet: the multi-process serving tier.

Counterpart of the JAX package's ``fleet/``: N gateway PROCESSES, each
one P2PNode + SecureMessaging engine on the GPU, behind a peer-routing
tier of one router or of replicated router processes, with gateway and
router death as the first-class cases:

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
* :mod:`.router`   — the router replica worker
                     (``python -m quantum_resistant_p2p_tpu_torch.fleet.router``:
                     a manager in attach mode holding or following the
                     leader lease) and :class:`RouterFleet`, the driver of
                     N router processes and G gateway processes, their
                     seeded chaos and their rolling restart; it runs no
                     crypto and never touches the GPU.
* :mod:`.storm`    — ``run_fleet_storm`` and ``run_router_storm``: the
                     seeded chaos storms over a gateway fleet and over a
                     router fleet.
* :mod:`.stormlib` — the storm workload environment every gateway
                     subprocess applies (``storm_env()``, the stdlib toy
                     providers, facade pre-warming).

None of these modules holds a kernel: the gateways' engines, and a
storm's client plane, reach the port's kernels through the provider layer.
:mod:`.router` and :mod:`.storm` are imported lazily, by name.
"""

from .manager import FleetBusy, GatewayFleet, GatewayMember  # noqa: F401
from .ring import HashRing  # noqa: F401
from .stormlib import StormAEAD, register_storm_providers, storm_env  # noqa: F401
