"""Deterministic fault injection for chaos-testing the serving stack.

See :mod:`.plan` for the engine, its scopes and which hooks the port
feeds.
"""

from .plan import (ACTIONS, SCOPES, FaultInjected, FaultPlan,  # noqa: F401
                   FaultRule, active, device_dispatch, install,
                   instrument_scalar_ops, net_send, poison_results,
                   process_control, router_control, scalar_op,
                   ticket_validation, uninstall, warmup)
