"""SecureMessaging: the post-quantum secure messaging protocol engine.

Counterpart of the JAX package's ``app/messaging.py``, method for method in
the same order, over the port's providers, batching queues, scheduler,
breaker, autotuner, transport and tickets:

* 5-message authenticated handshake with ephemeral KEM keys (init /
  response / confirm / test / reject), signature-authenticated with a 300 s
  replay window and typed rejection reasons, with a bounded retry;
* sign-then-encrypt AEAD messaging with associated-data cross-checks,
  duplicate suppression and an automatic re-key after an AEAD failure;
* session healing (reconnect, re-handshake, flush of the queued messages),
  1-RTT ticket resumption on a fresh connection, graceful drain;
* crypto-settings gossip and algorithm hot-swap.

With ``use_batching`` every KEM, signature and AEAD operation of every
concurrent peer coalesces into batches through ``provider/batched.py``;
ML-KEM x ML-DSA pairs run each handshake step as one fused device trip
(``BatchedFused``), and ChaCha20-Poly1305 seals and opens on the device
data plane (``BatchedAEAD``).

Where it differs from the JAX package's engine:

* ``backend`` defaults to "cuda" (batching and warm-ups key on "cuda"
  where that engine keys on "tpu"); without a GPU a default engine raises
  in its providers and never carries on on the CPU;
* the batching queues get no CPU fallback unless the caller passes
  ``degrade=True`` (that engine arms one on every queue of a device
  engine): by default a slow dispatch waits for the card, and a failed
  health verdict or warm-up is raised by :meth:`wait_ready` and keeps
  :meth:`ready_status` not ready instead of moving the work to the CPU;
* it fuses on the "cpu" backend too, where ``get_fused`` gives the
  capability for "cpu" providers (the bytes on the wire are the same);
* ``mesh_devices`` splits the KEM's and the signature's batches across
  the first N GPUs (-1: all) and raises when fewer exist, where that
  engine falls back to logical shards; ``shard_devices`` >= 1 on "cuda"
  places shard ``i`` on GPU ``i`` and raises likewise (1 pins the one
  shard to GPU 0, where that engine keeps it logical);
* the batched AEAD is built on the engine's own backend;
* :meth:`close` stops the scheduler's device workers.
"""

from __future__ import annotations

import asyncio
import enum
import hmac
import json
import logging
import os
import time
import uuid
from pathlib import Path
from typing import Any, Callable

from ..faults import plan as _faults
from ..net.p2p_node import P2PNode
from ..obs import flight as obs_flight
from ..obs import trace as obs_trace
from ..obs.cost import CostLedger
from ..obs.metrics import Registry
from ..provider import get_fused, get_kem, get_signature, get_symmetric
from ..provider.base import KeyExchangeAlgorithm, SignatureAlgorithm, SymmetricAlgorithm
from ..provider.batched import (LANE_BULK, LANE_HANDSHAKE, LANE_REKEY,
                                LaneShed)
from ..utils.wipe import wipe
from .message_store import Message
from .resumption import (ReplayCache, STEKRing, TicketError,
                         derive_resumed_key, derive_resumption_secret,
                         hkdf_sha256 as _hkdf_sha256,
                         mint_fields, ratchet_resumption_secret,
                         resume_binder, resume_confirm_tag,
                         resumption_default)

logger = logging.getLogger(__name__)

REPLAY_WINDOW = 300.0  # seconds a handshake transcript's timestamp may be off
KEY_EXCHANGE_TIMEOUT = 20.0
DEDUP_CAPACITY = 1000
#: bounded retry for initiate_key_exchange: a single dropped datagram (or a
#: transiently corrupted handshake message) no longer needs a caller-driven
#: retry.  Retries cover timeouts and invalid_signature rejections only —
#: structural failures (algorithm mismatch, disconnect) fail fast.
KE_RETRY_ATTEMPTS = 2
KE_RETRY_BACKOFF_S = 0.25
#: session healing: a mid-session disconnect triggers reconnection (with
#: backoff) then an automatic re-handshake; outbound messages sent during
#: the outage are queued (bounded) and flushed after re-establishment
HEAL_ATTEMPTS = 3
HEAL_BACKOFF_S = 0.25
OUTBOX_CAPACITY = 32
#: consecutive AEAD decrypt failures from one peer before the session key is
#: declared desynchronised/tampered and dropped for an automatic re-key (a
#: corrupted ciphertext mid-session must trigger a rekey, never plaintext)
REKEY_AFTER_AEAD_FAILURES = 1
#: minimum spacing between automatic re-keys per peer: old-key messages
#: legitimately in flight across a rekey (and attacker-sent garbage) must
#: not force handshake churn — at most one forced handshake per window
REKEY_COOLDOWN_S = 5.0
#: how long a completed session keeps its peer on the rekey lane (and
#: exempt from the handshake budget) after the key is gone, and the cap
#: on remembered peers (oldest evicted) — bounds both the memory and the
#: budget-bypass surface of the rekey exemption
HAD_SESSION_TTL_S = 3600.0
HAD_SESSION_CAP = 4096
#: pow2 flush buckets the background warm-up runs once: bucket 1 (the
#: sequential-handshake case) plus the first pow-2 buckets a small burst of
#: concurrent handshakes coalesces into.  On the GPU the first launches
#: build and load the kernel libraries, which must not happen inside
#: KEY_EXCHANGE_TIMEOUT
WARMUP_SIZES = (1, 2, 4)
#: latency SLO threshold for an initiated handshake attempt (obs/slo.py):
#: chosen ON a DEFAULT_LATENCY_BUCKETS boundary so the good/bad split of
#: the burn-rate math is exact, and generous enough that only a degraded
#: plane (kernel builds on the hot path, breaker storms, gateway
#: saturation) burns budget
HANDSHAKE_SLO_THRESHOLD_S = 2.0
#: session-resumption tickets (docs/protocol.md "Session resumption"):
#: how long a minted ticket may resume, and the bound on tickets a client
#: holds (oldest evicted, secrets wiped) — both sides of the memory story
RESUME_TICKET_TTL_S = 2 * 3600.0
TICKET_CAP = 1024


class KeyExchangeState(enum.Enum):
    NONE = "none"
    INITIATED = "initiated"
    RESPONDED = "responded"
    CONFIRMED = "confirmed"
    ESTABLISHED = "established"


class RejectReason(str, enum.Enum):
    INVALID_SIGNATURE = "invalid_signature"
    IDENTITY_MISMATCH = "identity_mismatch"
    TIMESTAMP_INVALID = "timestamp_invalid"
    ALGORITHM_MISMATCH = "algorithm_mismatch"
    KEYGEN_ERROR = "keypair_generation_error"
    ENCAPSULATION_ERROR = "encapsulation_error"
    GENERAL_ERROR = "general_error"
    #: gateway admission control (docs/gateway.md): the responder is over
    #: its concurrent-handshake budget — a typed, FAST rejection the
    #: initiator treats as transient (retry with backoff), never a timeout
    BUSY = "server_busy"


def _canonical(data: dict) -> bytes:
    return json.dumps(data, sort_keys=True, separators=(",", ":")).encode()


#: sentinel: a fused handler consumed the message (failed the exchange with
#: a typed reason) — distinct from None, which means "not applicable, run
#: the per-op path"
_HANDLED = object()


class KeyExchangeFailed(RuntimeError):
    """A handshake attempt failed with a typed ``reason`` (a RejectReason
    value or a local failure tag) — carried as an attribute so the retry
    classifier never parses message text."""

    def __init__(self, reason: str):
        super().__init__(f"key exchange failed: {reason}")
        self.reason = reason


def _wipe(buf) -> None:
    """In-place zeroization of a mutable secret buffer (``utils/wipe.py``).

    Secrets this engine must shorten the lifetime of (ephemeral KEM secret
    keys, per-peer raw shared secrets) are stored as ``bytearray`` so that
    dropping them clears the bytes; ``bytes`` copies made transiently by
    providers are immutable and left to the GC.  None is a no-op.
    """
    if buf is not None:
        wipe(buf)


# RFC 5869 HKDF-SHA256 on the stdlib: one copy lives in app/resumption.py
# (the ticket machinery needs it below the engine), imported above as
# ``_hkdf_sha256``.


def derive_message_key(shared_secret: bytes, id_a: str, id_b: str, aead_name: str) -> bytes:
    """HKDF-SHA256 over the raw KEM secret, salted by the sorted peer ids.

    Sorted ids make both sides derive identically; binding the AEAD name
    lets an AEAD hot-swap re-derive a distinct key from the same secret.
    """
    ids = "|".join(sorted([id_a, id_b]))
    return _hkdf_sha256(
        shared_secret,
        salt=ids.encode(),
        info=b"qrp2p-tpu/msgkey/" + aead_name.encode(),
    )


class SecureMessaging:
    """Protocol engine: owns algorithms, per-peer keys, and the handshake FSM."""

    def __init__(
        self,
        node: P2PNode,
        key_storage=None,
        secure_logger=None,
        kem: KeyExchangeAlgorithm | None = None,
        symmetric: SymmetricAlgorithm | None = None,
        signature: SignatureAlgorithm | None = None,
        backend: str = "cuda",
        use_batching: bool = False,
        max_batch: int = 4096,
        max_wait_ms: float = 2.0,
        batch_floor: int = 1,
        mesh_devices: int = 0,
        shard_devices: int = 0,
        sig_keypair: tuple[bytes, bytes] | None = None,
        breaker_cooloff_s: float = 30.0,
        auto_heal: bool = True,
        autotune: bool | None = None,
        max_inflight_handshakes: int = 0,
        bulk_lane_capacity: int = 0,
        telemetry_port: int | None = None,
        batch_aead: bool | None = None,
        resumption: bool | None = None,
        stek: STEKRing | None = None,
        degrade: bool = False,
    ):
        self.node = node
        self.key_storage = key_storage
        self.secure_logger = secure_logger
        self.backend = backend
        #: arm the "cpu" twins as the batching queues' degrade fallbacks
        #: (the JAX package's engine always does on its device backend)
        self.degrade = degrade
        # the providers split each batch across this many GPUs
        # (provider/base.py mesh_dispatch; 0 = unsplit, -1 = every GPU)
        self.mesh_devices = mesh_devices
        # the batching queues place each flush on one of this many shards
        # (provider/scheduler.py; 0 = one logical shard, N >= 1 on "cuda" =
        # GPUs 0..N-1)
        self.shard_devices = shard_devices
        self.kem = kem or get_kem("ML-KEM-768", backend, devices=mesh_devices)
        self.symmetric = symmetric or get_symmetric("AES-256-GCM")
        self.signature = signature or get_signature("ML-DSA-65", backend,
                                                    devices=mesh_devices)

        # Optional batching queues: when enabled, every handshake/sign/verify
        # op from every concurrent peer coalesces into padded device batches
        # instead of dispatching one by one.
        self.use_batching = use_batching
        self._batch_cfg = (max_batch, max_wait_ms)
        # bucket_floor collapses the flush-size bucket space so a pre-warm
        # covers every size a live swarm can hit (keyword so the positional
        # _batch_cfg unpacking at hot-swap stays untouched)
        self._batch_floor = batch_floor
        self._bkem = self._bsig = self._bfused = self._baead = None
        # batched device AEAD (the data plane): None reads the
        # QRP2P_BATCH_AEAD default (on); False pins the scalar path
        self._batch_aead = batch_aead
        self._warmup_thread = None
        #: the first exception of a background gate or warm-up, raised by
        #: wait_ready() and reported by ready_status()
        self._warmup_error: BaseException | None = None
        self._queue_breaker = None
        # The engine's metrics registry (obs/metrics.py) — the single source
        # metrics() reads from: the pre-existing queue/breaker/opcache
        # counters join via collectors, new resilience counters and the
        # per-handshake trip histogram live here directly.
        self.registry = Registry(name=f"messaging:{node.node_id[:8]}")
        #: dispatch trips per completed initiated handshake (integer samples;
        #: meaningful at concurrency 1 — overlapping handshakes share the
        #: breaker counter).  docs/dispatch_budget.md defines the budget;
        #: integer bucket boundaries make the percentiles exact.
        self._handshake_trips = self.registry.histogram(
            "handshake_trips", "dispatch trips per initiated handshake",
            buckets=tuple(float(i) for i in range(33)),
        )
        self._ctr_rekeys = self.registry.counter(
            "rekeys", "automatic re-keys after AEAD failures")
        self._ctr_heals_ok = self.registry.counter(
            "heals_ok", "session heals that reconnected and re-keyed")
        self._ctr_heals_failed = self.registry.counter(
            "heals_failed", "session heals that gave up")
        self._ctr_outbox_queued = self.registry.counter(
            "outbox_queued", "messages parked while a session healed")
        self._ctr_outbox_dropped = self.registry.counter(
            "outbox_dropped", "parked messages dropped (capacity or give-up)")
        self._ctr_handshake_giveups = self.registry.counter(
            "handshake_giveups", "initiated handshakes that failed finally")
        # gateway admission counters (docs/gateway.md): every shed is loud
        self._ctr_handshake_sheds = self.registry.counter(
            "handshake_sheds", "inbound handshakes rejected over budget")
        self._ctr_bulk_sheds = self.registry.counter(
            "bulk_sheds", "bulk sends shed at the bulk-lane bound")
        self._ctr_hs_admitted = self.registry.counter(
            "handshakes_admitted", "inbound ke_inits admitted past the budget")
        #: wall latency of every initiated-handshake attempt (success or
        #: failure — a timed-out attempt is exactly what the latency SLO
        #: must count against the budget).  Default le-buckets include the
        #: 2 s SLO threshold boundary, so the good/bad split is exact.
        self._handshake_latency = self.registry.histogram(
            "handshake_latency_s", "initiated handshake attempt latency (s)")
        # session-resumption tickets (docs/protocol.md "Session
        # resumption"): None reads the QRP2P_RESUMPTION default (on);
        # engine-level behavior only fires for peers whose hello ALSO
        # offered resumption (net/p2p_node.py negotiation), so an opted-out
        # or older peer sees wire-byte-identical frames (pinned).
        self.resumption = (resumption_default() if resumption is None
                           else resumption)
        #: this engine's ticket-sealing keys: a locally random ring by
        #: default (standalone responder); gateways that resume each
        #: other's tickets share one ring (``stek=``)
        self.tickets = stek if stek is not None else STEKRing()
        self._replay = ReplayCache()
        #: client side: issuer peer -> {ticket, expires_at, secret, ...};
        #: bounded (TICKET_CAP), secrets wiped on every drop path
        self._tickets: dict[str, dict] = {}
        #: in-flight resume exchanges: message_id -> context
        self._resume_pending: dict[str, dict] = {}
        #: peers whose CURRENT connection has not yet established a
        #: session: the one window a ticket may be presented in.  Armed on
        #: every connect, disarmed on establishment — an in-session rekey
        #: (AEAD failure, forced rekey) always runs the full KEM handshake
        #: for fresh entropy; resumption is strictly a reconnect fast path.
        self._resume_armed: set[str] = set()
        #: graceful drain (docs/robustness.md "Rolling restarts"): once
        #: set, /readyz answers 503 draining, new handshakes shed BUSY,
        #: resumes are rejected typed, and peers have been nudged to
        #: resume on their ring successor
        self.draining = False
        self.drain_reason: str | None = None
        self._ctr_tickets_minted = self.registry.counter(
            "tickets_minted", "resumption tickets sealed and sent")
        self._ctr_resumes_ok = self.registry.counter(
            "resumes_ok", "inbound ticket resumes accepted (responder)")
        self._ctr_resume_rejects = self.registry.counter(
            "resume_rejects", "inbound ticket resumes rejected, typed")
        self._ctr_resumes_used = self.registry.counter(
            "resumes_used", "handshakes completed via ticket resume (initiator)")
        self._ctr_resume_fallbacks = self.registry.counter(
            "resume_fallbacks", "resume attempts that fell back to a full handshake")
        self._ctr_rehome_nudges = self.registry.counter(
            "rehome_nudges", "drain nudges received from draining peers")
        self.registry.register_collector("queues", self._collect_queues)
        self.registry.register_collector("opcaches", self._collect_opcaches)
        #: engine birth (uptime for /healthz and snapshot-mode hs/s rates)
        self._t0 = time.monotonic()
        #: the device-cost ledger (obs/cost.py): padding waste, compile
        #: attribution, device seconds per op family, opcache windows, and
        #: the autotuner decision journal — registered on this registry so
        #: one Prometheus scrape exports the serving economics
        self.cost = CostLedger(registry=self.registry)
        # both halves of the handshake work feed the per-1k denominator:
        # a pure fleet gateway only RESPONDS (admitted ke_inits), so an
        # initiator-only count would leave the headline gauge permanently
        # None on exactly the processes the ledger exists to price
        self.cost.set_handshakes_fn(
            lambda: self._handshake_latency.count + self._ctr_hs_admitted.value)
        #: responder-side concurrent-handshake budget (0 = unlimited):
        #: over it, ke_init draws a typed BUSY rejection instead of joining
        #: a pile-up that times every initiator out
        self._hs_budget = max_inflight_handshakes
        #: responder handshakes in flight that hold a slot of the budget;
        #: re-keys are exempt from it, so they neither wait for a slot nor
        #: hold one (the JAX package counts them, and an established
        #: session's re-keys then keep new sessions shed for as long as
        #: they run)
        self._responding = 0
        #: per-queue bulk-lane pending bound (0 = unbounded), applied to
        #: every facade queue so a bulk flood sheds bulk, not handshakes
        self._lane_capacity = (
            {LANE_BULK: bulk_lane_capacity} if bulk_lane_capacity else None
        )
        #: peer -> monotonic time of the last COMPLETED session: a recent
        #: entry makes the peer's next handshake a re-key (top-priority
        #: lane, exempt from the handshake budget).  Bounded and
        #: time-limited — an unbounded ever-seen set would grow one entry
        #: per peer forever AND hand every historical peer a permanent
        #: budget bypass, defeating admission control in exactly the
        #: mass-reconnect flood it exists for.
        self._had_session: dict[str, float] = {}
        self._autotuner = None
        self._scheduler = None
        if use_batching:
            from ..provider.batched import BatchedKEM, BatchedSignature
            from ..provider.scheduler import DeviceProgramScheduler

            # the device-program scheduler: the placement axis every queue
            # flush routes through.  One shard (the default) IS the old
            # one-breaker world — shard 0's breaker doubles as the legacy
            # _queue_breaker handle, so either path discovering slowness
            # shields its sibling queues exactly as before; with
            # shard_devices > 1 each shard gets its own breaker + heal
            # cycle and a sick GPU quarantines one shard, not the fleet.
            self._scheduler = DeviceProgramScheduler(
                shards=shard_devices, cooloff_s=breaker_cooloff_s,
                registry=self.registry, backend=backend,
            )
            self._queue_breaker = self._scheduler.shards[0].breaker
            self._scheduler.attach_cost(self.cost)
            # the adaptive batch/flush autotuner (provider/autotune.py):
            # replaces the static flush policy on the hot path when armed;
            # autotune=None reads the QRP2P_AUTOTUNE env default, and OFF
            # leaves every queue reading its static constants bit-for-bit
            from ..provider.autotune import (Autotuner,
                                             autotune_enabled_default)

            enabled = (autotune_enabled_default() if autotune is None
                       else autotune)
            if enabled:
                self._autotuner = Autotuner(registry=self.registry,
                                            scheduler=self._scheduler,
                                            cost=self.cost)
            self._bkem = BatchedKEM(self.kem, max_batch, max_wait_ms,
                                    fallback=self._cpu_fallback_kem(),
                                    scheduler=self._scheduler,
                                    bucket_floor=batch_floor,
                                    lane_capacity=self._lane_capacity)
            self._bsig = BatchedSignature(self.signature, max_batch, max_wait_ms,
                                          fallback=self._cpu_fallback_sig(),
                                          scheduler=self._scheduler,
                                          bucket_floor=batch_floor,
                                          lane_capacity=self._lane_capacity)
            self._bfused = self._make_fused()
            # the DATA plane: bulk AEAD seal/open batches through the same
            # scheduler/lanes/breaker machinery (provider/batched.py
            # BatchedAEAD); None when the AEAD has no device capability
            self._baead = self._make_batched_aead()
            self._attach_tuners()
            self._attach_cost()
            self._spawn_warmup()

        # the SLO engine (obs/slo.py): burn-rate evaluation over the
        # counters above — metrics()["slo"], the CLI /slo command, and the
        # slo_burn flight trigger all read through it
        self.slo = self._build_slo_engine()

        # per-peer protocol state.  raw_secrets values are bytearrays so
        # every drop path (rekey, reconnect, hot-swap) can zeroize in place
        # (_wipe) instead of leaving the KEM secret to the GC.
        self.shared_keys: dict[str, bytes] = {}
        self.raw_secrets: dict[str, bytearray] = {}  # for AEAD-change re-derive
        self.ke_state: dict[str, KeyExchangeState] = {}
        self.peer_settings: dict[str, dict] = {}
        #: msg_id -> (peer, ephemeral KEM sk) — sk is a bytearray so every
        #: drop path can zeroize it in place (_wipe)
        self._ephemeral: dict[str, tuple[str, bytearray]] = {}
        self._pending: dict[str, asyncio.Future] = {}
        #: msg_id -> confirm transcript signed by the fused initiator step,
        #: parked so _handle_ke_response sends EXACTLY the signed bytes
        self._fused_confirm: dict[str, dict] = {}
        self._processed_ids: dict[str, float] = {}
        self._listeners: list[Callable[[str, Message], None]] = []
        #: session resilience (docs/robustness.md): peers currently being
        #: healed, per-peer queued outbound messages, and consecutive AEAD
        #: failure counters driving the automatic re-key
        self.auto_heal = auto_heal
        self._healing: set[str] = set()
        self._outbox: dict[str, list[Message]] = {}
        self._aead_failures: dict[str, int] = {}
        self._last_rekey: dict[str, float] = {}
        #: strong refs to fire-and-forget tasks — the event loop only keeps
        #: weak ones, so an unreferenced task can be GC'd mid-flight
        self._bg_tasks: set[asyncio.Task] = set()

        # sig_keypair injection skips the one-time scalar keygen dispatch —
        # a caller building many stacks can pre-generate their keypairs in
        # one device batch
        self._sig_keypair = (
            sig_keypair if sig_keypair is not None
            else self._load_or_generate_sig_keypair()
        )

        for msg_type, handler in (
            ("ke_init", self._handle_ke_init),
            ("ke_response", self._handle_ke_response),
            ("ke_confirm", self._handle_ke_confirm),
            ("ke_test", self._handle_ke_test),
            ("ke_reject", self._handle_ke_reject),
            ("ke_resume", self._handle_ke_resume),
            ("ke_resume_ok", self._handle_ke_resume_ok),
            ("ke_resume_reject", self._handle_ke_resume_reject),
            ("ke_rehome", self._handle_ke_rehome),
            ("secure_message", self._handle_secure_message),
            ("settings_update", self._handle_settings_update),
            ("settings_request", self._handle_settings_request),
        ):
            node.register_message_handler(msg_type, handler)
        node.register_connection_handler(self._on_connection_event)

        # live telemetry endpoints (obs/http.py), started LAST so a scrape
        # can never race a partially constructed engine.  OFF by default —
        # no listener, no thread, not even the module import.  An explicit
        # telemetry_port wins; otherwise QRP2P_HTTP_PORT decides (unset/
        # empty = disabled, 0 = ephemeral, N = fixed port).
        self.telemetry = None
        if telemetry_port is None and os.environ.get("QRP2P_HTTP_PORT"):
            from ..obs.http import env_port

            telemetry_port = env_port()
        if telemetry_port is not None:
            from ..obs.http import TelemetryServer

            try:
                self.telemetry = TelemetryServer.for_engine(
                    self, port=telemetry_port)
            except OSError as e:
                # same policy as a malformed env value: an optional
                # observability listener (port in use, privileged port)
                # must degrade loudly, never kill the serving engine
                logger.warning(
                    "telemetry endpoints disabled: cannot bind port %s "
                    "(%s)", telemetry_port, e)

    # ------------------------------------------------------------------ util

    @property
    def node_id(self) -> str:
        return self.node.node_id

    def register_message_listener(self, cb: Callable[[str, Message], None]) -> None:
        if cb not in self._listeners:
            self._listeners.append(cb)

    def _spawn(self, coro, what: str) -> asyncio.Task:
        """Supervised fire-and-forget: keep a strong reference until done and
        log unexpected exceptions (otherwise they only surface at GC)."""
        task = asyncio.ensure_future(coro)
        self._bg_tasks.add(task)

        def _done(t: asyncio.Task) -> None:
            self._bg_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                logger.error("background %s failed", what, exc_info=t.exception())

        task.add_done_callback(_done)
        return task

    def _notify(self, peer_id: str, message: Message) -> None:
        for cb in list(self._listeners):
            try:
                cb(peer_id, message)
            except Exception:
                logger.exception("message listener failed")

    def _log(self, event_type: str, **fields: Any) -> None:
        if self.secure_logger is not None:
            try:
                self.secure_logger.log_event(event_type, **fields)
            except Exception:
                logger.exception("audit log failed")

    def _load_or_generate_sig_keypair(self) -> tuple[bytes, bytes]:
        """Per-algorithm persistent signature keypair."""
        name = f"signature_keypair_{self.signature.name}"
        if self.key_storage is not None and getattr(self.key_storage, "is_unlocked", False):
            stored = self.key_storage.retrieve(name)
            if stored:
                import base64

                return (
                    base64.b64decode(stored["public"]),
                    base64.b64decode(stored["secret"]),
                )
            pk, sk = self.signature.generate_keypair()
            import base64

            self.key_storage.store(
                name,
                {
                    "public": base64.b64encode(pk).decode(),
                    "secret": base64.b64encode(sk).decode(),
                },
            )
            return pk, sk
        return self.signature.generate_keypair()

    # -- async crypto helpers: route through the batch queue when enabled ----

    def _attach_tuners(self) -> None:
        """(Re-)attach the autotuner to every live facade queue — called at
        construction and after every hot-swap facade rebuild (the rebuilt
        queues are fresh objects; attach is idempotent per queue)."""
        if self._autotuner is not None:
            self._autotuner.attach_facades(self._bkem, self._bsig,
                                           self._bfused, self._baead)

    def _attach_cost(self) -> None:
        """(Re-)attach the cost ledger to every live facade queue and the
        providers' opcaches — called at construction and after every
        hot-swap facade/provider rebuild (fresh queue and cache objects
        each time; attach is a plain attribute set, so re-running is
        idempotent)."""
        from ..provider.batched import facade_queues

        for facade in (self._bkem, self._bsig, self._bfused, self._baead):
            if facade is None:
                continue
            facade.cost = self.cost
            for q in facade_queues(facade):
                q.cost = self.cost
        for algo, kind in ((self.kem, "kem"), (self.signature, "sig")):
            cache = getattr(algo, "opcache", None)
            if cache is not None and hasattr(cache, "attach_cost"):
                cache.attach_cost(self.cost, kind)

    def _is_rekey(self, peer_id: str) -> bool:
        """True while ``peer_id`` has a RECENT completed session (within
        HAD_SESSION_TTL_S): its next handshake is a re-key — top-priority
        lane, exempt from the handshake budget.  The table is pruned here
        (TTL + size cap), so stale peers age back to stranger status and
        the exemption never becomes a permanent budget bypass."""
        now = time.monotonic()
        t = self._had_session.get(peer_id)
        if t is not None and now - t > HAD_SESSION_TTL_S:
            del self._had_session[peer_id]
            t = None
        if len(self._had_session) > HAD_SESSION_CAP:
            for pid, ts in sorted(self._had_session.items(),
                                  key=lambda kv: kv[1])[: HAD_SESSION_CAP // 2]:
                del self._had_session[pid]
        return t is not None

    def _hs_lane(self, peer_id: str) -> int:
        """Handshake priority lane for ``peer_id``: a peer with a recent
        completed session is RE-KEYING (top priority — an established
        session must never lose its key behind a flood of strangers); a
        fresh (or long-gone) peer rides the new-handshake lane."""
        return LANE_REKEY if self._is_rekey(peer_id) else LANE_HANDSHAKE

    async def _kem_keygen(self, lane: int = LANE_HANDSHAKE) -> tuple[bytes, bytes]:
        if self._bkem is not None:
            return await self._bkem.generate_keypair(lane)
        return self.kem.generate_keypair()

    async def _kem_encaps(self, pk: bytes,
                          lane: int = LANE_HANDSHAKE) -> tuple[bytes, bytes]:
        if self._bkem is not None:
            return await self._bkem.encapsulate(pk, lane)
        return self.kem.encapsulate(pk)

    async def _kem_decaps(self, sk: bytes, ct: bytes,
                          lane: int = LANE_HANDSHAKE) -> bytes:
        if self._bkem is not None:
            return await self._bkem.decapsulate(sk, ct, lane)
        return self.kem.decapsulate(sk, ct)

    async def _sign(self, message: bytes, lane: int = LANE_HANDSHAKE) -> bytes:
        if self._bsig is not None:
            return await self._bsig.sign(self._sig_keypair[1], message, lane)
        return self.signature.sign(self._sig_keypair[1], message)

    async def _verify(self, sig_algo: str, pk: bytes, message: bytes, sig: bytes,
                      lane: int = LANE_HANDSHAKE) -> bool | None:
        """False on verification failure, None for an unknown/unsupported
        signature algorithm (the caller maps None to ALGORITHM_MISMATCH, the
        reference's typed rejection, rather than INVALID_SIGNATURE).  Never
        raises: malformed attacker input means False."""
        if sig_algo != self.signature.name:
            try:
                verifier = get_signature(sig_algo, self.backend)
            except (KeyError, ValueError, TypeError):
                # TypeError: attacker-supplied non-string sig_algo (unhashable)
                return None
            try:
                return verifier.verify(pk, message, sig)
            except Exception:  # verify contract: malformed input is False, never a raise
                return False
        try:
            if self._bsig is not None:
                return await self._bsig.verify(pk, message, sig, lane)
            return self.signature.verify(pk, message, sig)
        except LaneShed:
            if lane != LANE_BULK:
                # a capped handshake/rekey lane (not reachable through
                # this engine's own knobs, which bound only bulk) must
                # surface as a typed shed, never as a signature verdict —
                # _check_common maps it to RejectReason.BUSY
                raise
            # inbound bulk shed at its lane bound: loud and counted — the
            # caller still sees False (the message is dropped), so its
            # "verification failed" log line follows this shed line
            self._ctr_bulk_sheds.inc()
            logger.warning("inbound bulk-lane verify shed (%d total)",
                           self._ctr_bulk_sheds.value)
            return False
        except Exception:  # verify contract: malformed input is False, never a raise
            return False

    def _dedup(self, message_id: str) -> bool:
        """True if already seen; prunes the table at capacity."""
        if message_id in self._processed_ids:
            return True
        self._processed_ids[message_id] = time.time()
        if len(self._processed_ids) > DEDUP_CAPACITY:
            for mid, _ in sorted(self._processed_ids.items(), key=lambda kv: kv[1])[
                : DEDUP_CAPACITY // 2
            ]:
                del self._processed_ids[mid]
        return False

    def _on_connection_event(self, event: str, peer_id: str) -> None:
        if event == "connect":
            # Fresh handshake per session: drop any stale key.
            self.shared_keys.pop(peer_id, None)
            _wipe(self.raw_secrets.pop(peer_id, None))
            self.ke_state[peer_id] = KeyExchangeState.NONE
            # a fresh connection is the one window a held resumption
            # ticket may be presented in (disarmed on establishment)
            self._resume_armed.add(peer_id)
            self._spawn(self.request_peer_settings(peer_id), "settings gossip")
        elif event == "disconnect":
            self.ke_state[peer_id] = KeyExchangeState.NONE
            self._resume_armed.discard(peer_id)
            # fail any in-flight ticket resume with this peer, typed, and
            # wipe its parked secret — same promptness contract as the
            # ephemeral-KEM cleanup below
            for mid, ctx in list(self._resume_pending.items()):
                if ctx["peer"] == peer_id:
                    _wipe(self._resume_pending.pop(mid)["secret"])
                    self._fail_pending(mid, "peer_disconnected")
            # Fail any IN-FLIGHT handshake with the dropped peer now, with
            # a typed reason: no ke_response can ever resolve its future,
            # and burning the full protocol timeout on it would stall the
            # initiator's retry loop — which is exactly the loop a fleet
            # handoff relies on to re-route promptly to the ring successor
            # of a dead gateway.
            for mid, entry in list(self._ephemeral.items()):
                if entry[0] == peer_id:
                    self._fail_pending(mid, "peer_disconnected")
            if (
                self.auto_heal
                and peer_id not in self._healing
                and self.node.should_heal(peer_id)
            ):
                # Mid-session drop of a peer WE dialed: reconnect with
                # backoff, re-handshake, then flush queued outbound —
                # instead of the old permanent dead peer.
                self._healing.add(peer_id)
                self._spawn(self._heal_session(peer_id), "session heal")

    async def _heal_session(self, peer_id: str) -> None:
        """Reconnect -> automatic re-handshake -> flush the outbox.

        Bounded: HEAL_ATTEMPTS redials with exponential backoff (each redial
        itself uses P2PNode.connect_to_peer's transient-failure retry); on
        exhaustion the outbox is dropped with a loud warning — messages are
        never silently black-holed, and never sent unencrypted.
        """
        try:
            delay = HEAL_BACKOFF_S
            for _attempt in range(HEAL_ATTEMPTS):
                if not self.node.should_heal(peer_id):
                    # the disconnect became intentional (stop(), explicit
                    # API) mid-heal: the outbox must not strand silently
                    dropped = len(self._outbox.pop(peer_id, []))
                    if dropped:
                        self._ctr_outbox_dropped.inc(dropped)
                        logger.warning(
                            "session heal for %s abandoned (no longer "
                            "healable); %d queued message(s) dropped",
                            peer_id[:8], dropped,
                        )
                    self._ctr_heals_failed.inc()
                    obs_flight.record("heal_abandoned", peer=peer_id[:8],
                                      dropped=dropped)
                    return
                await asyncio.sleep(delay)
                delay *= 2
                if await self.node.reconnect(peer_id):
                    break
            else:
                dropped = len(self._outbox.pop(peer_id, []))
                self._ctr_outbox_dropped.inc(dropped)
                self._ctr_heals_failed.inc()
                logger.warning(
                    "session heal: %s unreachable after %d redials; giving up"
                    " (%d queued message(s) dropped)",
                    peer_id[:8], HEAL_ATTEMPTS, dropped,
                )
                self._log("session_heal", peer=peer_id, success=False)
                obs_flight.trigger("heal_giveup", peer=peer_id[:8],
                                   reason="unreachable", dropped=dropped)
                return
            # reconnect fired the "connect" event, which reset the session
            # state; establish a fresh key before flushing anything
            ok = await self.initiate_key_exchange(peer_id)
            if not ok:
                # a concurrent initiator (an app send, the AEAD rekey) may
                # own the handshake ("already_in_flight"): give it a bounded
                # moment before declaring the heal failed
                for _ in range(40):
                    if self.verify_key_exchange_state(peer_id):
                        ok = True
                        break
                    if not self.node.is_connected(peer_id):
                        break
                    await asyncio.sleep(0.05)
            if ok:
                self._ctr_heals_ok.inc()
                logger.warning(
                    "session heal: %s reconnected and re-keyed; flushing %d "
                    "queued message(s)",
                    peer_id[:8], len(self._outbox.get(peer_id, [])),
                )
                self._log("session_heal", peer=peer_id, success=True)
                obs_flight.record("heal_ok", peer=peer_id[:8],
                                  flushed=len(self._outbox.get(peer_id, [])))
                await self._flush_outbox(peer_id)
            else:
                # reconnected but could not re-key: the outbox must not
                # strand silently — drop it loudly, exactly like the
                # unreachable case above
                dropped = len(self._outbox.pop(peer_id, []))
                self._ctr_outbox_dropped.inc(dropped)
                self._ctr_heals_failed.inc()
                logger.warning(
                    "session heal: %s reconnected but re-handshake failed; "
                    "giving up (%d queued message(s) dropped)",
                    peer_id[:8], dropped,
                )
                self._log("session_heal", peer=peer_id, success=False)
                obs_flight.trigger("heal_giveup", peer=peer_id[:8],
                                   reason="rehandshake_failed", dropped=dropped)
        finally:
            self._healing.discard(peer_id)
            # a message queued in the window between the flush completing
            # and _healing clearing would otherwise sit until the next
            # outage: flush the tail now that the session is live
            if (
                self._outbox.get(peer_id)
                and self.verify_key_exchange_state(peer_id)
            ):
                self._spawn(self._flush_outbox(peer_id), "outbox tail flush")

    def _queue_outbound(self, peer_id: str, content: bytes, is_file: bool,
                        filename: str | None) -> Message | None:
        """Park an outbound message while its session heals (bounded)."""
        box = self._outbox.setdefault(peer_id, [])
        if len(box) >= OUTBOX_CAPACITY:
            self._ctr_outbox_dropped.inc()
            logger.warning("outbox for %s full; dropping message", peer_id[:8])
            return None
        self._ctr_outbox_queued.inc()
        message = Message(
            content=content,
            sender_id=self.node_id,
            recipient_id=peer_id,
            is_file=is_file,
            filename=filename,
            key_exchange_algo=self.kem.name,
            symmetric_algo=self.symmetric.name,
            signature_algo=self.signature.name,
        )
        box.append(message)
        return message

    async def _flush_outbox(self, peer_id: str) -> None:
        queued = self._outbox.pop(peer_id, [])
        for i, message in enumerate(queued):
            try:
                sent = await self._encrypt_and_send(peer_id, message)
            except Exception:
                logger.exception("outbox flush to %s failed", peer_id[:8])
                sent = False
            if not sent:
                # re-queue the unsent remainder: a send failure mid-flush
                # (connection flapped again) re-enters the heal cycle with
                # these messages still parked, not silently dropped
                remainder = queued[i:]
                self._outbox[peer_id] = remainder + self._outbox.pop(peer_id, [])
                logger.warning(
                    "outbox flush to %s failed; %d message(s) re-queued",
                    peer_id[:8], len(remainder),
                )
                # the eviction's disconnect event fired while peer_id was
                # still in _healing, so no new heal was spawned for it —
                # re-enter the cycle ourselves once the current heal exits
                # (bounded in practice: every cycle needs a successful
                # reconnect + re-handshake to reach this line again, pays
                # the full redial backoff, and logs loudly)
                if self.auto_heal and self.node.should_heal(peer_id):
                    self._spawn(self._reheal(peer_id), "session re-heal")
                else:
                    # no further heal possible (intentional disconnect,
                    # node stopping): never strand silently
                    dropped = len(self._outbox.pop(peer_id, []))
                    self._ctr_outbox_dropped.inc(dropped)
                    logger.warning(
                        "outbox for %s not healable; %d queued message(s) "
                        "dropped", peer_id[:8], dropped,
                    )
                return

    async def _reheal(self, peer_id: str) -> None:
        """Re-enter the heal cycle after a mid-flush connection flap (the
        flap's disconnect event was suppressed by the in-progress heal)."""
        while peer_id in self._healing:
            await asyncio.sleep(0.05)
        if (
            self.auto_heal
            and self._outbox.get(peer_id)
            and not self.node.is_connected(peer_id)
            and self.node.should_heal(peer_id)
        ):
            self._healing.add(peer_id)
            await self._heal_session(peer_id)

    # ----------------------------------------------------------- key exchange

    def verify_key_exchange_state(self, peer_id: str) -> bool:
        """Key present AND state established/confirmed AND peer connected."""
        return (
            peer_id in self.shared_keys
            and self.ke_state.get(peer_id)
            in (KeyExchangeState.CONFIRMED, KeyExchangeState.ESTABLISHED)
            and self.node.is_connected(peer_id)
        )

    async def initiate_key_exchange(self, peer_id: str,
                                    retries: int = KE_RETRY_ATTEMPTS) -> bool:
        """Initiator side of the 5-message handshake,
        with bounded retry-with-backoff on TRANSIENT failures (a timed-out
        exchange — e.g. one dropped datagram — or an invalid-signature
        rejection from one corrupted-in-flight message).  Structural
        failures (algorithm mismatch, keygen error, peer gone) fail fast.

        When a resumption ticket for this peer is held and the connection
        is fresh (docs/protocol.md "Session resumption"), the abbreviated
        1-RTT ticket resume runs FIRST — no KEM, no signatures, no device
        dispatch.  Any resume failure (hostile/expired/replayed ticket, a
        peer that never saw the STEK) falls back LOUDLY to the full
        handshake below — never a stall, never plaintext.
        """
        if self._resume_allowed(peer_id):
            status = await self._resume_once(peer_id)
            if status == "ok":
                return True
            self._ctr_resume_fallbacks.inc()
            logger.warning(
                "ticket resume with %s failed (%s); falling back to a "
                "full handshake", peer_id[:8], status,
            )
            obs_flight.record("ticket_fallback", peer=peer_id[:8],
                              reason=status)
        delay = KE_RETRY_BACKOFF_S
        for attempt in range(retries + 1):
            status = await self._initiate_once(peer_id)
            if status == "ok":
                return True
            # BUSY is the gateway's typed load-shed: the responder is over
            # its admission budget NOW but will drain — retry with backoff
            # exactly like a transient network fault
            transient = status in ("timeout", RejectReason.INVALID_SIGNATURE.value,
                                   RejectReason.BUSY.value)
            if not transient or attempt == retries or not self.node.is_connected(peer_id):
                if status != "already_in_flight":
                    # final failure: a flight-recorder trigger (auto-dumps a
                    # diagnostic bundle when armed) — a benign concurrent
                    # initiation is not a give-up
                    self._ctr_handshake_giveups.inc()
                    obs_flight.trigger(
                        "handshake_giveup", peer=peer_id[:8], status=status,
                        attempt=attempt + 1,
                    )
                return False
            logger.warning(
                "key exchange with %s failed (%s); retry %d/%d in %.2fs",
                peer_id[:8], status, attempt + 1, retries, delay,
            )
            await asyncio.sleep(delay)
            delay *= 2
        return False

    async def _initiate_once(self, peer_id: str) -> str:
        """One handshake attempt -> "ok" | "timeout" | a typed failure."""
        # node_scope: one process may host many engines (swarm benches) —
        # the span (and everything it parents) lands on THIS node's lane
        # in a merged multi-node flame graph (tools/trace_merge.py)
        with obs_trace.node_scope(self.node_id), \
                obs_trace.span("handshake.initiate", peer=peer_id[:8],
                               kem=self.kem.name,
                               sig=self.signature.name) as sp, \
                self._handshake_latency.time():
            status = await self._initiate_attempt(peer_id)
            sp.set_attr("status", status)
            return status

    async def _initiate_attempt(self, peer_id: str) -> str:
        if self.ke_state.get(peer_id) == KeyExchangeState.INITIATED:
            logger.info("handshake with %s already in flight", peer_id[:8])
            return "already_in_flight"
        # Compatibility pre-check against gossiped peer settings.
        peer_cfg = self.peer_settings.get(peer_id)
        if peer_cfg and peer_cfg.get("kem") != self.kem.name:
            logger.warning(
                "algorithm mismatch with %s: %s vs %s",
                peer_id[:8], self.kem.name, peer_cfg.get("kem"),
            )
            return RejectReason.ALGORITHM_MISMATCH.value

        message_id = str(uuid.uuid4())
        trips0 = self._trips_now()
        # priority lane for every queued op of THIS handshake: top priority
        # when re-keying an established peer, middle for a fresh one
        lane = self._hs_lane(peer_id)
        ke_data = {
            "message_id": message_id,
            "kem": self.kem.name,
            "aead": self.symmetric.name,
            "public_key": "",
            "sender": self.node_id,
            "recipient": peer_id,
            "timestamp": time.time(),
        }
        pk = sk = sig = None
        if self._bfused is not None:
            # Composite path: keygen + sign(init transcript) in ONE device
            # trip.  The transcript is shipped as a template — the canonical
            # JSON with a same-length placeholder where the device hex-
            # encodes the fresh public key — so the signed bytes are
            # identical to the per-op path's (wire-compatible).
            ke_data["public_key"] = "0" * (2 * self.kem.public_key_len)
            template = _canonical(ke_data)
            if len(template) <= self._bfused.algo.init_template_len:
                try:
                    pk, sk, sig = await self._bfused.keygen_sign(
                        self._sig_keypair[1], template, lane
                    )
                except Exception:
                    logger.exception("fused keygen_sign failed; per-op fallback")
                    pk = None
        if pk is None:
            try:
                pk, sk = await self._kem_keygen(lane)
            except Exception:
                logger.exception("ephemeral keygen failed")
                # sk is unbound here: this keygen raised before returning one
                return RejectReason.KEYGEN_ERROR.value
            ke_data["public_key"] = pk.hex()
            sig = await self._sign(_canonical(ke_data), lane)
        else:
            ke_data["public_key"] = pk.hex()
        self._ephemeral[message_id] = (peer_id, bytearray(sk))
        self.ke_state[peer_id] = KeyExchangeState.INITIATED

        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[message_id] = fut

        sent = await self.node.send_message(
            peer_id,
            "ke_init",
            ke_data=ke_data,
            sig=sig,
            sig_algo=self.signature.name,
            sig_pk=self._sig_keypair[0],
        )
        if not sent:
            self._cleanup_exchange(message_id, peer_id)
            return "send_failed"
        try:
            await asyncio.wait_for(fut, KEY_EXCHANGE_TIMEOUT)
            self._handshake_trips.record(self._trips_now() - trips0)
            return "ok"
        except asyncio.TimeoutError:
            # Timeout-but-key-exists recovery.
            if peer_id in self.shared_keys:
                return "ok"
            self._cleanup_exchange(message_id, peer_id)
            self._log("key_exchange", peer=peer_id, success=False, reason="timeout")
            return "timeout"
        except RuntimeError as e:
            # Typed rejection from the peer (ke_reject) or a local crypto
            # error; KeyExchangeFailed carries the reason as an attribute
            # so the retry loop classifies on the typed value, never on
            # message text.
            logger.warning("key exchange with %s failed: %s", peer_id[:8], e)
            self._cleanup_exchange(message_id, peer_id)
            return getattr(e, "reason", "error")

    def _cpu_fallback_kem(self):
        """cpu-backend twin of the active KEM when the engine was built with
        ``degrade=True``, arming the batch queue's degrade-don't-fail path
        (device slow/hung -> ops run on cpu instead of failing their
        protocol timeouts).  None otherwise, and when the active provider
        IS the cpu one — no point falling back to itself."""
        return self._cpu_twin(self.kem, get_kem) if self.degrade else None

    def _cpu_fallback_sig(self):
        """cpu-backend twin of the active signature (see _cpu_fallback_kem)."""
        return self._cpu_twin(self.signature, get_signature) if self.degrade else None

    @staticmethod
    def _cpu_twin(algo, get):
        """The "cpu" provider of a "cuda" one (the health gate's reference
        and the degrade fallback); None for any other provider."""
        if getattr(algo, "backend", "") != "cuda":
            return None
        try:
            return get(algo.name, "cpu")
        except Exception:
            logger.exception("no cpu twin for %s", algo.name)
            return None

    def _make_fused(self):
        """Composite-queue facade (provider.batched.BatchedFused) when the
        active (KEM, signature) pair advertises the fused-handshake
        capability, on "cuda" and on "cpu" alike — None (unregistered pair,
        batching off) keeps every step on the per-op queues.  The transcript
        offsets are protocol facts of THIS engine's canonical-JSON layout,
        computed here and baked into the facade."""
        if not self.use_batching:
            return None
        fused = get_fused(self.kem, self.signature)
        if fused is None:
            return None
        from ..provider.batched import BatchedFused
        from ..provider.fused_providers import init_pk_offset, resp_ct_offset

        max_batch, max_wait_ms = self._batch_cfg
        return BatchedFused(
            fused,
            pk_off=init_pk_offset(self.kem.name, self.symmetric.name),
            ct_off=resp_ct_offset(),
            max_batch=max_batch,
            max_wait_ms=max_wait_ms,
            fallback_kem=self._cpu_fallback_kem(),
            fallback_sig=self._cpu_fallback_sig(),
            scheduler=self._scheduler,
            bucket_floor=self._batch_floor,
            lane_capacity=self._lane_capacity,
        )

    def _make_batched_aead(self):
        """Batched-AEAD facade (provider.batched.BatchedAEAD) on the
        engine's backend when the active AEAD advertises the device
        capability — None (no capability, ``QRP2P_BATCH_AEAD=0``, or
        ``batch_aead=False``) keeps every seal/open on the scalar path.  The
        scalar AEAD serves oversized items, and with ``degrade=True`` is the
        degrade fallback.
        Shares the scheduler/lanes/breakers with the handshake facades, so a
        bulk AEAD flood sheds at the bulk lane and a sick device degrades
        the whole plane to cpu together."""
        if not self.use_batching or self._batch_aead is False:
            return None
        if os.environ.get("QRP2P_BATCH_AEAD", "1") == "0":
            return None
        from ..provider.registry import get_batched_aead

        device = get_batched_aead(self.symmetric, self.backend)
        if device is None:
            return None
        from ..provider.batched import BatchedAEAD

        max_batch, max_wait_ms = self._batch_cfg
        return BatchedAEAD(
            device, self.symmetric, max_batch, max_wait_ms,
            scheduler=self._scheduler, bucket_floor=self._batch_floor,
            lane_capacity=self._lane_capacity,
            fallback=self.symmetric if self.degrade else None,
        )

    async def _aead_encrypt(self, key: bytes, plaintext: bytes, ad: bytes,
                            lane: int = LANE_BULK) -> bytes:
        """Seal through the batched facade when armed, else scalar — the
        wire bytes are format-identical either way (KAT-pinned)."""
        if self._baead is not None:
            return await self._baead.encrypt(key, plaintext, ad, lane)
        return self.symmetric.encrypt(key, plaintext, ad)

    async def _aead_decrypt(self, key: bytes, data, ad: bytes,
                            lane: int = LANE_BULK) -> bytes:
        """Open through the batched facade when armed (``data`` may be a
        zero-copy memoryview off the binary wire), else scalar."""
        if self._baead is not None:
            return await self._baead.decrypt(key, data, ad, lane)
        return self.symmetric.decrypt(key, bytes(data), ad)

    def _trips_now(self) -> int:
        """Serial dispatch steps (device + fallback) so far on the breaker
        (or placement axis) the live queues actually share — swarm clients
        share another stack's queues, so the facade's scheduler/breaker is
        the truthful one.  Under a scheduler trips sum across every
        shard's breaker (docs/dispatch_budget.md per-shard ledger)."""
        if self._bkem is None:
            return 0
        sched = getattr(self._bkem, "scheduler", None)
        if sched is not None:
            return sched.total_trips()
        b = self._bkem.breaker
        return b.device_trips + b.fallback_trips

    def _collect_queues(self) -> dict[str, Any]:
        """Registry collector: the queue/breaker counters this engine's
        facades already keep, absorbed at snapshot time (obs/metrics.py —
        no second set of hot-path increments)."""
        out: dict[str, Any] = {}
        if self._bkem is None:
            return out
        out["kem_queue"] = self._bkem.stats()
        out["sig_queue"] = self._bsig.stats()
        if self._bfused is not None:
            out["fused_queue"] = self._bfused.stats()
        if self._baead is not None:
            # the data plane's seal/open queues (additive key, same
            # compatibility contract as fused_queue)
            out["aead_queue"] = self._baead.stats()
        b = self._bkem.breaker
        sched = getattr(self._bkem, "scheduler", None)
        if sched is not None:
            # legacy keys stay truthful across the placement axis: trips
            # and open/close counters SUM over every shard's breaker, and
            # breaker_state reports the WORST shard — a dashboard/alert
            # keyed on the documented legacy keys must fire when ANY
            # shard degrades, not only shard 0.  (Mesh-of-1: one shard,
            # so every value is identical to the old single breaker's.)
            out["device_trips"] = sum(
                s.breaker.device_trips for s in sched.shards)
            out["fallback_trips"] = sum(
                s.breaker.fallback_trips for s in sched.shards)
            out["breaker_trips"] = sum(s.breaker.trips for s in sched.shards)
            severity = {"closed": 0, "half_open": 1, "open": 2,
                        "quarantined": 3}
            out["breaker_state"] = max(
                (s.breaker.state for s in sched.shards),
                key=lambda st: severity.get(st, 0))
            out["breaker_opens"] = sum(s.breaker.opens for s in sched.shards)
            out["breaker_closes"] = sum(s.breaker.closes for s in sched.shards)
            # the placement axis, per shard (additive key: the legacy
            # layout above is a compatibility contract, tests/test_obs.py)
            out["shards"] = sched.stats()
        else:
            out["device_trips"] = b.device_trips
            out["fallback_trips"] = b.fallback_trips
            out["breaker_trips"] = b.trips
            out["breaker_state"] = b.state
            out["breaker_opens"] = b.opens
            out["breaker_closes"] = b.closes
        # the degradation gauge across every queue of this engine
        # (a device plane silently served by the cpu must be visible)
        total = fb = 0
        for fam_key in ("kem_queue", "sig_queue", "fused_queue",
                        "aead_queue"):
            for q in out.get(fam_key, {}).values():
                total += q["ops"]
                fb += q["fallback_ops"]
        out["device_served_fraction"] = (
            round((total - fb) / total, 4) if total else None
        )
        return out

    def _collect_opcaches(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for algo, key in ((self.kem, "kem_opcache"), (self.signature, "sig_opcache")):
            cache = getattr(algo, "opcache", None)
            if cache is not None:
                out[key] = cache.stats()
        return out

    def _build_slo_engine(self):
        """Declarative SLOs over the counters this engine already keeps
        (obs/slo.py; docs/observability.md "SLO specs"):

        * ``handshake_p99`` — initiated attempts complete within
          HANDSHAKE_SLO_THRESHOLD_S (timeouts count against the budget);
        * ``gateway_shed_rate`` — inbound work admitted vs shed across
          every admission boundary (connection / handshake / bulk lane);
        * per-shard ``device_served_shard<i>`` — dispatch steps the shard
          served from the device vs its cpu fallback (objective matches
          the 0.9 bench gate, thresholds sized to its burn ceiling);
        * ``breaker_availability`` — wall-time fraction the facade
          breaker's device path was closed.

        Probes read live objects that survive algorithm hot-swaps (the
        scheduler's shard breakers, registry instruments, the node), so
        the engine never needs re-wiring."""
        from ..obs import slo as obs_slo

        eng = obs_slo.SLOEngine(registry=self.registry)
        eng.add(obs_slo.SLOSpec(
            "handshake_p99", objective=0.99,
            probe=obs_slo.latency_probe(self._handshake_latency,
                                        HANDSHAKE_SLO_THRESHOLD_S),
            description=("initiated handshake attempts complete within "
                         f"{HANDSHAKE_SLO_THRESHOLD_S:g}s"),
        ))
        # session-admission SLI only, and SYMMETRIC per boundary: each
        # side of a counted decision must have its twin — connection
        # admissions (node.admitted) balance connection sheds
        # (node.sheds), handshake admissions balance handshake sheds.
        # Counting connection sheds against handshake admissions alone
        # turned a reconnect wave of admitted-but-not-yet-handshaking
        # peers into a ~100x false burn.  Bulk-lane sheds are
        # per-MESSAGE and deliberately excluded — a bulk flood shedding
        # 1% of 10k sends must not read as a 40x session-admission burn.
        eng.add(obs_slo.SLOSpec(
            "gateway_shed_rate", objective=0.99,
            probe=obs_slo.counter_pair_probe(
                lambda: (self._ctr_hs_admitted.value + self.node.admitted),
                lambda: (self._ctr_handshake_sheds.value + self.node.sheds)),
            description="admission decisions accepted vs shed (connection "
                        "+ handshake boundaries)",
            fast_burn=10.0, slow_burn=1.0,
        ))
        # ticket resumes (docs/protocol.md "Session resumption"): good =
        # resumes completed on either side, bad = typed rejects + client
        # fallbacks.  A reconnect wave that stops resuming (rotated-away
        # STEK, clock skew expiring tickets, a replay storm) burns here
        # long before it shows as handshake-latency or admission pain —
        # under the 1/(1-0.9) = 10x ceiling so it can actually fire.
        eng.add(obs_slo.SLOSpec(
            "resume_success", objective=0.9,
            probe=obs_slo.counter_pair_probe(
                lambda: (self._ctr_resumes_ok.value
                         + self._ctr_resumes_used.value),
                lambda: (self._ctr_resume_rejects.value
                         + self._ctr_resume_fallbacks.value)),
            description="ticket resumes completed vs rejected/fallen back "
                        "(both roles)",
            fast_burn=5.0, slow_burn=2.0,
        ))
        if self._scheduler is not None:
            for sh in self._scheduler.shards:
                eng.add(obs_slo.SLOSpec(
                    f"device_served_shard{sh.index}", objective=0.9,
                    probe=obs_slo.counter_pair_probe(
                        lambda b=sh.breaker: b.device_trips,
                        lambda b=sh.breaker: b.fallback_trips),
                    description=("dispatch steps this shard served from "
                                 "the device path (vs cpu fallback)"),
                    # a full outage burns at 1/(1-0.9) = 10x: thresholds
                    # must sit under that ceiling to ever fire
                    fast_burn=5.0, slow_burn=2.0,
                ))
            eng.add(obs_slo.SLOSpec(
                "breaker_availability", objective=0.95,
                probe=obs_slo.breaker_availability_probe(self._queue_breaker),
                description=("wall-time fraction the facade breaker's "
                             "device path was closed"),
                fast_burn=5.0, slow_burn=1.0,
            ))
        # evaluation rides the registry's collector hook so a gateway
        # monitored ONLY through Prometheus scrapes still advances the
        # burn windows, refreshes the slo_* gauges, and can fire the
        # slo_burn flight trigger mid-incident — metrics()/ /slo are not
        # the only readers that keep the engine honest.  The summary the
        # collector returns is the scrape-able roll-up; the full report
        # stays on metrics()["slo"].
        def _collect_slo() -> dict[str, Any]:
            specs = eng.evaluate()
            return {
                "alerts_total": sum(s["alerts"] for s in specs),
                "alerting_count": sum(1 for s in specs if s["alerting"]),
            }

        self.registry.register_collector("slo_health", _collect_slo)
        return eng

    def slo_status(self) -> dict[str, Any]:
        """Evaluate the SLO engine now and return its burn/budget report
        (also served as ``metrics()["slo"]`` and the CLI ``/slo``)."""
        return self.slo.status()

    # ------------------------------------------------------- live telemetry

    @property
    def telemetry_port(self) -> int | None:
        """The bound telemetry port (None when telemetry is disabled)."""
        return self.telemetry.port if self.telemetry is not None else None

    def stop_telemetry(self) -> None:
        """Close the telemetry listener (engine drain; idempotent)."""
        srv, self.telemetry = self.telemetry, None
        if srv is not None:
            srv.stop()

    def health_doc(self) -> dict[str, Any]:
        """The ``/healthz`` document: liveness + uptime (a process that
        answers at all is alive; readiness is :meth:`ready_status`)."""
        return {
            "ok": True,
            "node": self.node_id,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            # both halves of the handshake work: initiated attempts AND
            # inbound ke_inits admitted (a pure gateway only responds, so
            # a dashboard's hs/s must not read 0 off the initiator count)
            "handshake_attempts": self._handshake_latency.count,
            "handshakes_admitted": self._ctr_hs_admitted.value,
        }

    def ready_status(self) -> dict[str, Any]:
        """The ``/readyz`` document: ready = the background warm-up sweep
        finished without an error (every warm bucket ran once — a cold
        gateway builds and loads its kernel libraries inside its first
        flushes) AND no breaker is away from ``closed`` (an
        open/quarantined plane is serving degraded).  A load balancer keys
        on the 200/503 status; the body says WHY (a failed gate or warm-up
        adds ``warmup_error``)."""
        warm = self._warmup_thread is None or not self._warmup_thread.is_alive()
        breakers: dict[str, str] = {}
        if self._scheduler is not None:
            breakers = {f"shard{s.index}": s.breaker.state
                        for s in self._scheduler.shards}
        elif self._bkem is not None:
            breakers = {"breaker": self._bkem.breaker.state}
        degraded = sorted(k for k, st in breakers.items() if st != "closed")
        failed = self._warmup_error
        doc = {
            # a draining gateway answers 503 with the reason: the load
            # balancer routes around it and qrtop renders the DRAIN state
            # while the rolling restart is in flight
            "ready": warm and failed is None and not degraded and not self.draining,
            "warm": warm,
            "breakers": breakers,
            "degraded": degraded,
            "draining": self.draining,
            "drain_reason": self.drain_reason,
        }
        if failed is not None:
            doc["warmup_error"] = repr(failed)
        return doc

    def slo_report(self) -> dict[str, Any]:
        """The per-NODE SLO report document: one gateway process's burn
        evaluation plus the cumulative counters a fleet merge needs;
        :func:`obs.slo.merge_reports` folds N of them into one fleet report
        with worst-node attribution."""
        q = self._collect_queues()
        return {
            "node": self.node_id,
            "slo": self.slo.status(),
            "device_served_fraction": q.get("device_served_fraction"),
            "device_trips": q.get("device_trips", 0),
            "fallback_trips": q.get("fallback_trips", 0),
            "counters": {
                "handshakes_admitted": self._ctr_hs_admitted.value,
                "handshake_sheds": self._ctr_handshake_sheds.value,
                "connections_admitted": self.node.admitted,
                "connection_sheds": self.node.sheds,
                "handshake_giveups": self._ctr_handshake_giveups.value,
                "tickets_minted": self._ctr_tickets_minted.value,
                "resumes_ok": self._ctr_resumes_ok.value,
                "resume_rejects": self._ctr_resume_rejects.value,
            },
        }

    def metrics(self) -> dict[str, Any]:
        """Operational counters: per-queue stats, aggregate dispatch trips,
        operand-cache hit rates, and trips-per-initiated-handshake — read
        from the obs registry (obs/metrics.py), which is also what the
        Prometheus exporter and flight-recorder bundles serve.  The legacy
        key layout is a compatibility contract (tests/test_obs.py parity
        test): keys are never removed or renamed, only added."""
        out: dict[str, Any] = {
            "backend": self.backend,
            "batching": self.use_batching,
        }
        # the registry's collectors ARE the source; calling them directly
        # skips exporting every instrument just to read two dicts back
        out.update(self._collect_queues())
        out.update(self._collect_opcaches())
        t = self._handshake_trips
        out["handshake_trips"] = {
            "count": t.count,
            "last": int(t.last) if t.last is not None else None,
            "p50": t.percentile(50),
            "p99": t.percentile(99),
        }
        out["resilience"] = {
            "rekeys": self._ctr_rekeys.value,
            "heals_ok": self._ctr_heals_ok.value,
            "heals_failed": self._ctr_heals_failed.value,
            "outbox_queued": self._ctr_outbox_queued.value,
            "outbox_dropped": self._ctr_outbox_dropped.value,
            "handshake_giveups": self._ctr_handshake_giveups.value,
        }
        # the gateway section (docs/gateway.md; CLI /metrics): admission-
        # control state and the autotuner's live decisions — additive key,
        # same compatibility contract as "resilience"
        out["gateway"] = {
            "max_peers": self.node.max_peers,
            "connections_admitted": self.node.admitted,
            "connection_sheds": self.node.sheds,
            "busy_rejects": self.node.busy_rejects,
            "handshake_budget": self._hs_budget,
            "handshakes_in_flight": self._responding,
            "handshake_sheds": self._ctr_handshake_sheds.value,
            "bulk_sheds": self._ctr_bulk_sheds.value,
            "autotune": (self._autotuner.snapshot()
                         if self._autotuner is not None
                         else {"enabled": False}),
        }
        # the resumption/drain section (docs/protocol.md "Session
        # resumption") — additive key, same compatibility contract
        out["resumption"] = {
            "enabled": self.resumption,
            "tickets_minted": self._ctr_tickets_minted.value,
            "tickets_held": len(self._tickets),
            "resumes_ok": self._ctr_resumes_ok.value,
            "resume_rejects": self._ctr_resume_rejects.value,
            "resumes_used": self._ctr_resumes_used.value,
            "resume_fallbacks": self._ctr_resume_fallbacks.value,
            "replay_cache": len(self._replay),
            "draining": self.draining,
        }
        # the SLO section (docs/observability.md): burn rates and budget
        # remaining per objective — additive key, same compatibility
        # contract as "resilience"/"gateway".  This evaluates the engine,
        # as does the registry's "slo_health" collector on every
        # snapshot/Prometheus scrape — whichever surface a gateway is
        # watched through, the burn windows advance.
        out["slo"] = self.slo.status()
        # the device-cost ledger (obs/cost.py; docs/observability.md
        # "Reading the cost ledger") — additive key, same contract
        out["cost"] = self.cost.snapshot()
        return out

    def _spawn_warmup(self, kem: bool = True, sig: bool = True) -> None:
        """Gate the batched facades and run their warm buckets once in the
        background, so a live handshake never builds or loads a kernel
        library inside KEY_EXCHANGE_TIMEOUT.  Called at construction AND
        after an algorithm hot-swap (only for the swapped provider — the
        other is already warm).

        The health gate runs first, with the "cpu" providers as the CPU
        twins (the providers themselves on "cpu").  A failed family raises,
        or, when ``degrade`` armed the fallbacks, quarantines the shared
        breaker onto them; an exception of the gate or the warm-up is kept
        for :meth:`wait_ready` to raise.  Only "cuda" facades are warmed: a
        "cpu" one has nothing to build, and its warm-up would run real slow
        crypto."""
        import threading

        bkem = self._bkem if kem else None
        bsig = self._bsig if sig else None
        # the fused facade is rebuilt on every swap (it bakes in the pair AND
        # the transcript offsets), so whenever it exists it needs a gate and
        # a warm; likewise the batched-AEAD facade (rebuilt on every AEAD
        # swap)
        bfused = self._bfused
        baead = self._baead
        gated = [f for f in (bkem, bsig, bfused, baead) if f is not None]
        if not gated:
            return
        kem_algo, sig_algo = self.kem, self.signature

        def _warm():
            try:
                from ..provider import health

                cpu_kem = (kem_algo if getattr(kem_algo, "backend", "") == "cpu"
                           else self._cpu_twin(kem_algo, get_kem))
                cpu_sig = (sig_algo if getattr(sig_algo, "backend", "") == "cpu"
                           else self._cpu_twin(sig_algo, get_signature))
                health.gate_facades(*gated, cpu_kem=cpu_kem, cpu_sig=cpu_sig,
                                    scalar=self.symmetric)
                if gated[0].breaker.state == "quarantined":
                    # the facades share one breaker: a quarantine pins the
                    # cpu fallback for the process, so warming the device
                    # buckets would serve no traffic
                    logger.warning(
                        "device path quarantined by the health gate; "
                        "skipping device warmup"
                    )
                    return
                for facade in gated:
                    if getattr(facade.algo, "backend", "") == "cuda":
                        facade.warmup(WARMUP_SIZES)
            except Exception as exc:
                logger.exception("batched-provider warmup failed")
                if self._warmup_error is None:
                    self._warmup_error = exc

        self._warmup_thread = threading.Thread(
            target=_warm, name="qrp2p-warmup", daemon=True
        )
        self._warmup_thread.start()

    async def wait_ready(self, timeout: float | None = None) -> None:
        """Await background batched-provider warmup (no-op when batching
        off); raise RuntimeError if the health gate or the warm-up failed."""
        if self._warmup_thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._warmup_thread.join, timeout
            )
        if self._warmup_error is not None:
            raise RuntimeError(
                f"device gate or warm-up failed: {self._warmup_error!r}"
            ) from self._warmup_error

    def _drop_ephemeral(self, message_id: str) -> None:
        """Drop an exchange's ephemeral KEM sk, zeroizing it in place — the
        single chokepoint for every drop path, so a future path cannot
        forget the wipe.  In-flight decapsulations are safe: the handlers
        pass an immutable COPY of the sk to the crypto layer, never the
        wiped buffer itself."""
        entry = self._ephemeral.pop(message_id, None)
        if entry is not None:
            _wipe(entry[1])

    def _cleanup_exchange(self, message_id: str, peer_id: str) -> None:
        self._drop_ephemeral(message_id)
        self._pending.pop(message_id, None)
        if self.ke_state.get(peer_id) == KeyExchangeState.INITIATED:
            self.ke_state[peer_id] = KeyExchangeState.NONE

    async def _reject(self, peer_id: str, message_id: str, reason: RejectReason) -> None:
        await self.node.send_message(
            peer_id, "ke_reject", message_id=message_id, reason=reason.value
        )

    async def _check_common(self, peer_id: str, data: dict, sig: bytes, sig_pk: bytes,
                            sig_algo: str,
                            lane: int = LANE_HANDSHAKE) -> RejectReason | None:
        """Signature + identity + replay-window checks shared by init/response."""
        try:
            ok = await self._verify(sig_algo, sig_pk, _canonical(data), sig,
                                    lane)
        except LaneShed:
            # handshake-lane shed (a hand-capped lane): a typed, transient
            # BUSY — disjoint from any signature verdict
            return RejectReason.BUSY
        if ok is None:
            return RejectReason.ALGORITHM_MISMATCH
        if not ok:
            return RejectReason.INVALID_SIGNATURE
        return self._check_host(peer_id, data)

    def _check_host(self, peer_id: str, data: dict) -> RejectReason | None:
        """The host-side half of _check_common (identity + replay window).
        The fused handshake paths run these BEFORE dispatch and let the
        signature check ride the composite device program — so a message
        failing several checks at once may draw a different (equally valid)
        typed rejection than the per-op path would."""
        if data.get("sender") != peer_id or data.get("recipient") != self.node_id:
            return RejectReason.IDENTITY_MISMATCH
        if abs(time.time() - float(data.get("timestamp", 0))) > REPLAY_WINDOW:
            return RejectReason.TIMESTAMP_INVALID
        return None

    async def _handle_ke_init(self, peer_id: str, msg: dict) -> None:
        """Responder: verify, encapsulate, derive, reply.

        Admission control first: over the concurrent-handshake budget, the
        init draws a typed BUSY rejection — a fast, retryable shed instead
        of joining a pile-up that times every initiator out.  Re-keys of
        established peers are EXEMPT from the budget (they ride the top
        priority lane; shedding them would cost a live session)."""
        data = msg.get("ke_data") or {}
        message_id = data.get("message_id", "?")
        if self.draining:
            # draining: EVERYTHING new is shed (rekeys included — the
            # peers are being nudged to the ring successor); the typed
            # BUSY keeps the initiator's retry machinery in charge
            self._shed_handshake(peer_id)
            await self._reject(peer_id, message_id, RejectReason.BUSY)
            return
        budgeted = not self._is_rekey(peer_id)
        if (
            self._hs_budget
            and self._responding >= self._hs_budget
            and budgeted
        ):
            self._shed_handshake(peer_id)
            await self._reject(peer_id, message_id, RejectReason.BUSY)
            return
        self._responding += budgeted
        self._ctr_hs_admitted.inc()  # the shed-rate SLO's "good" side
        try:
            with obs_trace.span("handshake.respond", peer=peer_id[:8],
                                kem=self.kem.name):
                await self._handle_ke_init_inner(peer_id, msg, data, message_id)
        finally:
            self._responding -= budgeted

    def _shed_handshake(self, peer_id: str) -> None:
        self._ctr_handshake_sheds.inc()
        n = self._ctr_handshake_sheds.value
        if n == 1 or n % 64 == 0:
            logger.warning(
                "handshake budget reached (%d in flight, max %d): shedding "
                "ke_init from %s (%d shed so far)",
                self._responding, self._hs_budget, peer_id[:8], n,
            )
            obs_flight.record(
                "load_shed", where="handshake", peer=peer_id[:8],
                in_flight=self._responding, budget=self._hs_budget, sheds=n,
            )

    async def _handle_ke_init_inner(self, peer_id: str, msg: dict, data: dict,
                                    message_id: str) -> None:
        lane = self._hs_lane(peer_id)
        if await self._fused_handle_ke_init(peer_id, msg, data, message_id,
                                            lane):
            return
        err = await self._check_common(peer_id, data, msg.get("sig", b""),
                                 msg.get("sig_pk", b""), msg.get("sig_algo", ""),
                                 lane)
        if err is not None:
            await self._reject(peer_id, message_id, err)
            return
        if data.get("kem") != self.kem.name or data.get("aead") != self.symmetric.name:
            await self._reject(peer_id, message_id, RejectReason.ALGORITHM_MISMATCH)
            return
        try:
            ct, secret = await self._kem_encaps(bytes.fromhex(data["public_key"]),
                                                lane)
        except Exception:
            logger.exception("encapsulation failed")
            await self._reject(peer_id, message_id, RejectReason.ENCAPSULATION_ERROR)
            return
        resp = {
            "message_id": message_id,
            "ciphertext": ct.hex(),
            "sender": self.node_id,
            "recipient": peer_id,
            "timestamp": time.time(),
        }
        sig = await self._sign(_canonical(resp), lane)
        await self._respond_established(peer_id, secret, resp, sig)

    async def _respond_established(self, peer_id: str, secret: bytes,
                                   resp: dict, sig: bytes) -> None:
        """Responder success tail, shared by the per-op and fused ke_init
        paths (contractually wire-identical): adopt the shared secret and
        send the signed ke_response."""
        self._adopt_secret(peer_id, secret)
        self.shared_keys[peer_id] = derive_message_key(
            secret, self.node_id, peer_id, self.symmetric.name
        )
        self.ke_state[peer_id] = KeyExchangeState.RESPONDED
        # the resumption ticket rides INSIDE the ke_response frame (extra
        # unsigned sibling fields, negotiated-only — un-negotiated peers'
        # frames are byte-identical): the initiator holds the ticket in
        # the same instant it considers the session live, so a gateway
        # death/drain at ANY later point finds it already delivered.  (A
        # separate ticket frame left one loop-scheduling window where an
        # interrupted session reconnected ticketless — measured in the
        # roll storm.)  The initiator is already signature-authenticated
        # by its ke_init, and a tampered ticket field can only produce a
        # typed resume reject + full-handshake fallback later.  A DRAINING
        # responder still mints: a session established at drain onset is
        # exactly the one about to be nudged to the ring successor.
        extra: dict[str, Any] = {}
        if self._resumption_negotiated(peer_id):
            blob, expires_at = self._mint_ticket(peer_id)
            extra = {"ticket": blob, "ticket_expires": expires_at}
        await self.node.send_message(
            peer_id,
            "ke_response",
            ke_data=resp,
            sig=sig,
            sig_algo=self.signature.name,
            sig_pk=self._sig_keypair[0],
            **extra,
        )

    async def _fused_handle_ke_init(self, peer_id: str, msg: dict, data: dict,
                                    message_id: str,
                                    lane: int = LANE_HANDSHAKE) -> bool:
        """Composite responder step: verify(init) + encaps + sign(response)
        in ONE device trip.  True = handled (replied or rejected); False =
        not applicable (no capability, algorithm/shape mismatch, composite
        failure) — the caller falls through to the per-op path, which owns
        every typed rejection for malformed input."""
        f = self._bfused
        if f is None or msg.get("sig_algo", "") != self.signature.name:
            return False
        if data.get("kem") != self.kem.name or data.get("aead") != self.symmetric.name:
            return False  # per-op path sends ALGORITHM_MISMATCH
        err = self._check_host(peer_id, data)
        if err is not None:
            await self._reject(peer_id, message_id, err)
            return True
        try:
            peer_pk = bytes.fromhex(data.get("public_key", ""))
        except (TypeError, ValueError):  # non-str JSON value raises TypeError
            return False
        sig_pk, sig_in = msg.get("sig_pk", b""), msg.get("sig", b"")
        if (
            len(peer_pk) != self.kem.public_key_len
            or len(sig_pk) != self.signature.public_key_len
            or len(sig_in) != self.signature.signature_len
        ):
            return False
        resp = {
            "message_id": message_id,
            "ciphertext": "0" * (2 * self.kem.ciphertext_len),
            "sender": self.node_id,
            "recipient": peer_id,
            "timestamp": time.time(),
        }
        template = _canonical(resp)
        if len(template) > f.algo.resp_template_len:
            return False
        try:
            ok, ct, secret, sig = await f.encaps_verify_sign(
                peer_pk, sig_pk, _canonical(data), sig_in,
                self._sig_keypair[1], template, lane,
            )
        except Exception:
            logger.exception("fused encaps_verify_sign failed; per-op fallback")
            return False
        if not ok:
            _wipe(secret)  # encapsulated for a peer whose signature failed
            await self._reject(peer_id, message_id, RejectReason.INVALID_SIGNATURE)
            return True
        resp["ciphertext"] = ct.hex()
        await self._respond_established(peer_id, secret, resp, sig)
        return True

    async def _handle_ke_response(self, peer_id: str, msg: dict) -> None:
        """Initiator: verify, decapsulate, confirm + AEAD test."""
        data = msg.get("ke_data") or {}
        message_id = data.get("message_id", "?")
        entry = self._ephemeral.get(message_id)
        if entry is None or entry[0] != peer_id:
            logger.warning("ke_response for unknown exchange %s", message_id)
            return
        with obs_trace.span("handshake.confirm", peer=peer_id[:8]):
            await self._handle_ke_response_inner(peer_id, msg, data,
                                                 message_id, entry)

    async def _handle_ke_response_inner(self, peer_id: str, msg: dict,
                                        data: dict, message_id: str,
                                        entry) -> None:
        lane = self._hs_lane(peer_id)
        fused = await self._fused_handle_ke_response(
            peer_id, msg, data, message_id, entry, lane
        )
        if fused is _HANDLED:
            return
        if fused is not None:
            secret, sig = fused
        else:
            err = await self._check_common(peer_id, data, msg.get("sig", b""),
                                     msg.get("sig_pk", b""), msg.get("sig_algo", ""),
                                     lane)
            if err is not None:
                self._fail_pending(message_id, err.value)
                return
            try:
                # decapsulate a COPY: if the handshake timeout fires during
                # this await, _cleanup_exchange wipes the stored bytearray —
                # which must not zero the operand mid-decapsulation
                secret = await self._kem_decaps(bytes(entry[1]),
                                                bytes.fromhex(data["ciphertext"]),
                                                lane)
            except Exception:
                logger.exception("decapsulation failed")
                self._fail_pending(message_id, "decapsulation_error")
                return
            finally:
                # Delete AND zeroize the ephemeral secret key immediately
                # — decapsulation is done with it either way.
                self._drop_ephemeral(message_id)
            sig = None

        self._adopt_secret(peer_id, secret)
        key = derive_message_key(secret, self.node_id, peer_id, self.symmetric.name)
        self.shared_keys[peer_id] = key
        self.ke_state[peer_id] = KeyExchangeState.CONFIRMED
        self._save_peer_key(peer_id, secret)
        # the responder's resumption ticket rides this same frame: store
        # it in the same instant the session becomes live (no window in
        # which an interrupted session is established-but-ticketless)
        self._accept_ticket(peer_id, msg, secret)

        confirm = {
            "message_id": message_id,
            "sender": self.node_id,
            "recipient": peer_id,
            "timestamp": time.time(),
        }
        if sig is None:
            sig = await self._sign(_canonical(confirm), lane)
        else:
            # the fused step signed the confirm transcript it was handed
            confirm = self._fused_confirm.pop(message_id)
        await self.node.send_message(
            peer_id, "ke_confirm", ke_data=confirm, sig=sig,
            sig_algo=self.signature.name, sig_pk=self._sig_keypair[0],
        )
        test_ct = self.symmetric.encrypt(key, b"key-exchange-test", message_id.encode())
        await self.node.send_message(peer_id, "ke_test", ct=test_ct, message_id=message_id)

        self._log(
            "key_exchange", peer=peer_id, success=True,
            algorithm=self.kem.name, role="initiator",
        )
        fut = self._pending.pop(message_id, None)
        if fut is not None and not fut.done():
            fut.set_result(True)

    async def _fused_handle_ke_response(self, peer_id: str, msg: dict,
                                        data: dict, message_id: str, entry,
                                        lane: int = LANE_HANDSHAKE):
        """Composite initiator step: verify(response) + decaps +
        sign(confirm transcript) in ONE device trip.  Returns
        (shared_secret, confirm_sig) on success; ``_HANDLED`` when the
        exchange was failed here (the composite verify failing maps to
        INVALID_SIGNATURE, matching the per-op rejection for a bad response
        signature); None when not applicable (caller runs the per-op path).
        The signed confirm transcript is parked in ``_fused_confirm`` so
        the caller sends EXACTLY the signed bytes.
        """
        f = self._bfused
        if f is None or msg.get("sig_algo", "") != self.signature.name:
            return None
        err = self._check_host(peer_id, data)
        if err is not None:
            self._fail_pending(message_id, err.value)
            self._drop_ephemeral(message_id)
            return _HANDLED
        try:
            ct = bytes.fromhex(data.get("ciphertext", ""))
        except (TypeError, ValueError):  # non-str JSON value raises TypeError
            return None
        sig_pk, sig_in = msg.get("sig_pk", b""), msg.get("sig", b"")
        if (
            len(ct) != self.kem.ciphertext_len
            or len(sig_pk) != self.signature.public_key_len
            or len(sig_in) != self.signature.signature_len
        ):
            return None
        confirm = {
            "message_id": message_id,
            "sender": self.node_id,
            "recipient": peer_id,
            "timestamp": time.time(),
        }
        try:
            # COPY of the ephemeral sk: a timeout-path wipe racing this
            # await must not zero the composite dispatch's operand
            ok, secret, sig = await f.decaps_verify_sign(
                bytes(entry[1]), ct, sig_pk, _canonical(data), sig_in,
                self._sig_keypair[1], _canonical(confirm), lane,
            )
        except Exception:
            logger.exception("fused decaps_verify_sign failed; per-op fallback")
            return None
        if not ok:
            _wipe(secret)  # decapsulated under a signature that failed
            self._fail_pending(message_id, RejectReason.INVALID_SIGNATURE.value)
            self._drop_ephemeral(message_id)
            return _HANDLED
        self._drop_ephemeral(message_id)  # composite decaps used a copy
        self._fused_confirm[message_id] = confirm
        return secret, sig

    def _fail_pending(self, message_id: str, reason: str) -> None:
        fut = self._pending.pop(message_id, None)
        if fut is not None and not fut.done():
            fut.set_exception(KeyExchangeFailed(reason))

    async def _handle_ke_confirm(self, peer_id: str, msg: dict) -> None:
        data = msg.get("ke_data") or {}
        err = await self._check_common(peer_id, data, msg.get("sig", b""),
                                 msg.get("sig_pk", b""), msg.get("sig_algo", ""))
        if err is not None:
            logger.warning("bad ke_confirm from %s: %s", peer_id[:8], err.value)
            return
        if self.ke_state.get(peer_id) == KeyExchangeState.RESPONDED:
            self.ke_state[peer_id] = KeyExchangeState.ESTABLISHED
            secret = self.raw_secrets.get(peer_id)
            if secret is not None:
                self._save_peer_key(peer_id, secret)
            self._log(
                "key_exchange", peer=peer_id, success=True,
                algorithm=self.kem.name, role="responder",
            )

    async def _handle_ke_test(self, peer_id: str, msg: dict) -> None:
        key = self.shared_keys.get(peer_id)
        if key is None:
            return
        try:
            # bytes(): over the binary wire the ct is a zero-copy
            # memoryview, which stdlib scalar AEADs cannot concatenate
            pt = self.symmetric.decrypt(
                key, bytes(msg.get("ct", b"")),
                str(msg.get("message_id", "")).encode()
            )
        except ValueError:
            logger.warning("ke_test decrypt failed from %s", peer_id[:8])
            return
        if pt == b"key-exchange-test":
            sysmsg = Message(
                content=b"Secure connection established",
                sender_id=peer_id,
                recipient_id=self.node_id,
                is_system=True,
                key_exchange_algo=self.kem.name,
                symmetric_algo=self.symmetric.name,
                signature_algo=self.signature.name,
            )
            self._notify(peer_id, sysmsg)

    async def _handle_ke_reject(self, peer_id: str, msg: dict) -> None:
        """Typed rejection handling."""
        message_id = str(msg.get("message_id", ""))
        reason = str(msg.get("reason", "unknown"))
        logger.warning("key exchange rejected by %s: %s", peer_id[:8], reason)
        self._drop_ephemeral(message_id)
        self.ke_state[peer_id] = KeyExchangeState.NONE
        self._log("key_exchange", peer=peer_id, success=False, reason=reason)
        self._fail_pending(message_id, reason)

    def _adopt_secret(self, peer_id: str, secret: bytes) -> None:
        """Install a session's raw KEM shared secret, zeroizing any
        predecessor in place (rekey/re-handshake must not extend the old
        secret's lifetime)."""
        _wipe(self.raw_secrets.get(peer_id))
        self.raw_secrets[peer_id] = bytearray(secret)
        # this peer now has a completed session: its NEXT handshake (for
        # HAD_SESSION_TTL_S) is a re-key on the top-priority lane
        self._had_session[peer_id] = time.monotonic()
        # the connection's resume window closes with establishment: any
        # later handshake on this connection is an in-session rekey and
        # runs the full KEM exchange for fresh entropy
        self._resume_armed.discard(peer_id)

    def _save_peer_key(self, peer_id: str, secret: bytes) -> None:
        if self.key_storage is not None and getattr(self.key_storage, "is_unlocked", False):
            try:
                self.key_storage.save_peer_shared_key(peer_id, secret, self.kem.name)
            except Exception:
                logger.exception("failed to persist shared key")

    # ------------------------------------------------- session resumption
    #
    # docs/protocol.md "Session resumption": after a confirmed full
    # handshake the RESPONDER mints a STEK-sealed, self-contained ticket;
    # a reconnect presents it for a 1-RTT abbreviated exchange (HKDF over
    # the resumption secret + fresh nonces — no KEM, no signatures, no
    # device dispatch).  Hostile/expired/replayed tickets fall back loudly
    # to the full handshake, never to a stall; accepted resumes are
    # admission-EXEMPT, which is what keeps admission control survivable
    # during a reconnect storm (the gateway sheds full handshakes but
    # admits cheap resumes).

    def _resumption_negotiated(self, peer_id: str) -> bool:
        """True when BOTH sides offered resumption in their hellos (the
        same negotiation shape as the binary wire): an opted-out or older
        peer never sees a ticket/resume frame — its wire stays
        byte-identical to the pre-resumption protocol (pinned)."""
        return self.resumption and self.node.peer_resumption(peer_id)

    def _resume_allowed(self, peer_id: str) -> bool:
        """A resume may be attempted only on a FRESH connection (armed by
        the connect event, disarmed at establishment) with a live,
        unexpired ticket from this peer."""
        if not (self._resumption_negotiated(peer_id)
                and peer_id in self._resume_armed):
            return False
        return self.ticket_for(peer_id) is not None

    def ticket_for(self, peer_id: str) -> dict | None:
        """The held (unexpired) resumption ticket entry for ``peer_id``,
        or None.  Expired entries are dropped (secret wiped) here."""
        entry = self._tickets.get(peer_id)
        if entry is None:
            return None
        if entry["expires_at"] <= time.time():
            self._drop_ticket(peer_id)
            return None
        return entry

    def take_ticket(self, peer_id: str) -> dict | None:
        """Remove and return the held ticket entry for ``peer_id`` (the
        fleet-handoff transfer API: a ticket minted by a dead gateway is
        presented to its ring successor, which shares the STEK)."""
        return self._tickets.pop(peer_id, None)

    def adopt_ticket(self, peer_id: str, entry: dict | None) -> None:
        """Re-key a transferred ticket entry to a new peer (the successor
        half of :meth:`take_ticket`)."""
        if entry is not None:
            self._drop_ticket(peer_id)
            self._tickets[peer_id] = entry

    def _drop_ticket(self, peer_id: str) -> None:
        entry = self._tickets.pop(peer_id, None)
        if entry is not None:
            _wipe(entry["secret"])

    def _store_ticket(self, peer_id: str, blob: bytes, expires_at: float,
                      secret: bytes) -> None:
        """Install a received ticket (bounded; oldest-expiry eviction with
        secrets wiped — the client-side memory half of the ticket story)."""
        self._drop_ticket(peer_id)
        self._tickets[peer_id] = {
            "ticket": blob,
            "expires_at": expires_at,
            "secret": bytearray(secret),
        }
        if len(self._tickets) > TICKET_CAP:
            for pid, _e in sorted(self._tickets.items(),
                                  key=lambda kv: kv[1]["expires_at"])[
                    : TICKET_CAP // 2]:
                self._drop_ticket(pid)

    def _mint_ticket(self, peer_id: str) -> tuple[bytes, float]:
        """Responder: seal a fresh ticket for ``peer_id``'s live session
        (single-use nonce, current STEK, suite-bound) — attached to the
        ke_response frame by :meth:`_respond_established`."""
        secret = self.raw_secrets[peer_id]
        rsec = derive_resumption_secret(bytes(secret), self.node_id, peer_id)
        expires_at = time.time() + RESUME_TICKET_TTL_S
        blob = self.tickets.seal_ticket(mint_fields(
            peer_id, self.node_id, rsec, self.kem.name, self.symmetric.name,
            self.signature.name, expires_at))
        self._ctr_tickets_minted.inc()
        obs_flight.record("ticket_minted", peer=peer_id[:8],
                          epoch=self.tickets.current_epoch,
                          expires_at=round(expires_at, 3))
        _wipe(rsec)  # sealed into the ticket; the local copy is done
        return blob, expires_at

    def _accept_ticket(self, peer_id: str, msg: dict, secret: bytes) -> None:
        """Initiator: store the ticket riding a ke_response (with the
        locally re-derived resumption secret) for the next reconnect."""
        if not self._resumption_negotiated(peer_id):
            return
        blob = bytes(msg.get("ticket") or b"")
        if not blob or len(blob) > 4096:
            return
        rsec = derive_resumption_secret(bytes(secret), peer_id, self.node_id)
        self._store_ticket(peer_id, blob,
                           float(msg.get("ticket_expires") or 0.0), rsec)
        obs_flight.record("ticket_received", peer=peer_id[:8])

    async def _resume_once(self, peer_id: str) -> str:
        """One abbreviated 1-RTT resume attempt -> "ok" | a typed failure.
        The held ticket is consumed either way (single-use): success
        returns a fresh one, failure falls back to a full handshake whose
        confirm mints a fresh one."""
        with obs_trace.node_scope(self.node_id), \
                obs_trace.span("handshake.resume", peer=peer_id[:8]) as sp, \
                self._handshake_latency.time():
            status = await self._resume_attempt(peer_id)
            sp.set_attr("status", status)
            return status

    async def _resume_attempt(self, peer_id: str) -> str:
        entry = self._tickets.pop(peer_id, None)
        if entry is None:
            return "no_ticket"
        message_id = str(uuid.uuid4())
        client_nonce = os.urandom(16).hex()
        data = {
            "message_id": message_id,
            "sender": self.node_id,
            "recipient": peer_id,
            "timestamp": time.time(),
            "client_nonce": client_nonce,
            "aead": self.symmetric.name,
        }
        binder = resume_binder(bytes(entry["secret"]), _canonical(data),
                               entry["ticket"])
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[message_id] = fut
        self._resume_pending[message_id] = {
            "peer": peer_id,
            "secret": entry["secret"],
            "client_nonce": client_nonce,
        }
        self.ke_state[peer_id] = KeyExchangeState.INITIATED
        sent = await self.node.send_message(
            peer_id, "ke_resume", resume_data=data, ticket=entry["ticket"],
            binder=binder,
        )
        if not sent:
            self._cleanup_resume(message_id, peer_id)
            return "send_failed"
        try:
            await asyncio.wait_for(fut, KEY_EXCHANGE_TIMEOUT)
            return "ok"
        except asyncio.TimeoutError:
            self._cleanup_resume(message_id, peer_id)
            return "timeout"
        except RuntimeError as e:
            self._cleanup_resume(message_id, peer_id)
            return getattr(e, "reason", "error")

    def _cleanup_resume(self, message_id: str, peer_id: str) -> None:
        ctx = self._resume_pending.pop(message_id, None)
        if ctx is not None:
            _wipe(ctx["secret"])
        self._pending.pop(message_id, None)
        if self.ke_state.get(peer_id) == KeyExchangeState.INITIATED:
            self.ke_state[peer_id] = KeyExchangeState.NONE

    async def _handle_ke_resume(self, peer_id: str, msg: dict) -> None:
        """Responder: validate a presented ticket and run the abbreviated
        exchange.  EVERY failure is a typed ``ke_resume_reject`` the
        initiator maps to a full-handshake fallback — no plaintext, no
        stall; accepted resumes bypass the handshake admission budget
        (they are what admission control exists to protect)."""
        data = msg.get("resume_data") or {}
        message_id = str(data.get("message_id", "?"))
        with obs_trace.span("handshake.resume_respond", peer=peer_id[:8]):
            reason = await self._resume_respond(peer_id, msg, data,
                                                message_id)
        if reason is not None:
            self._ctr_resume_rejects.inc()
            logger.warning(
                "ticket resume from %s rejected (%s); peer falls back to a "
                "full handshake (%d rejected so far)",
                peer_id[:8], reason, self._ctr_resume_rejects.value,
            )
            obs_flight.record("ticket_reject", peer=peer_id[:8],
                              reason=reason)
            await self.node.send_message(peer_id, "ke_resume_reject",
                                         message_id=message_id,
                                         reason=reason)

    async def _resume_respond(self, peer_id: str, msg: dict, data: dict,
                              message_id: str) -> str | None:
        """-> None on success (reply sent), else the typed reject reason."""
        if not self._resumption_negotiated(peer_id):
            return "resumption_disabled"
        if self.draining:
            return "draining"
        err = self._check_host(peer_id, data)
        if err is not None:
            return err.value
        client_nonce = str(data.get("client_nonce", ""))
        if not client_nonce or len(client_nonce) > 64:
            return "malformed_ticket"
        blob = bytes(msg.get("ticket") or b"")
        # chaos seam (faults/plan.py "ticket" scope): a plan may corrupt
        # the presented blob or force the expiry/replay verdicts — each
        # exercises one typed reject + fallback path end-to-end
        forced = _faults.ticket_validation(self.node_id, peer_id)
        if "corrupt" in forced and blob:
            doctored = bytearray(blob)
            doctored[len(doctored) // 2] ^= 0xFF
            blob = bytes(doctored)
        try:
            fields, rsec = self.tickets.open_ticket(blob)
        except TicketError as e:
            return e.reason
        # every exit below — typed reject or success — drops the opened
        # resumption secret (the success path adopts a bytearray COPY)
        next_secret = b""
        try:
            expires_at = float(fields.get("expires_at") or 0.0)
            nonce = str(fields.get("nonce") or "")
            if not nonce:
                return "malformed_ticket"
            if "expire" in forced or expires_at <= time.time():
                return "expired_ticket"
            if fields.get("holder") != peer_id:
                return "holder_mismatch"
            if (fields.get("kem"), fields.get("aead"), fields.get("sig")) != (
                    self.kem.name, self.symmetric.name, self.signature.name):
                return "suite_mismatch"
            want = resume_binder(rsec, _canonical(data), blob)
            if not hmac.compare_digest(want, str(msg.get("binder", ""))):
                return "bad_binder"
            if "replay" in forced or self._replay.seen(nonce, expires_at,
                                                       time.time()):
                return "replayed_ticket"
            # accepted: derive, install, re-mint (single-use), confirm — the
            # whole exchange is host-side HKDF/HMAC, no device work
            server_nonce = os.urandom(16).hex()
            key = derive_resumed_key(rsec, client_nonce, server_nonce,
                                     self.symmetric.name)
            next_secret = ratchet_resumption_secret(rsec, client_nonce,
                                                    server_nonce)
            fresh_expires = time.time() + RESUME_TICKET_TTL_S
            fresh = self.tickets.seal_ticket(mint_fields(
                peer_id, self.node_id, next_secret, self.kem.name,
                self.symmetric.name, self.signature.name, fresh_expires))
            self._adopt_secret(peer_id, rsec)
            self.shared_keys[peer_id] = key
            self.ke_state[peer_id] = KeyExchangeState.ESTABLISHED
            self._ctr_resumes_ok.inc()
            self._ctr_tickets_minted.inc()
            obs_flight.record("ticket_resumed", peer=peer_id[:8],
                              role="responder")
            self._log("key_exchange", peer=peer_id, success=True,
                      algorithm="ticket_resume", role="responder")
            await self.node.send_message(
                peer_id, "ke_resume_ok", message_id=message_id,
                server_nonce=server_nonce,
                confirm=resume_confirm_tag(key, message_id, client_nonce,
                                           server_nonce),
                ticket=fresh, expires_at=fresh_expires,
            )
            return None
        finally:
            _wipe(rsec)
            _wipe(next_secret)

    async def _handle_ke_resume_ok(self, peer_id: str, msg: dict) -> None:
        """Initiator: verify the responder's proof-of-secret, install the
        resumed key, store the fresh ticket (ratcheted secret)."""
        message_id = str(msg.get("message_id", ""))
        ctx = self._resume_pending.get(message_id)
        if ctx is None or ctx["peer"] != peer_id:
            logger.warning("ke_resume_ok for unknown resume %s", message_id)
            return
        self._resume_pending.pop(message_id, None)
        server_nonce = str(msg.get("server_nonce", ""))
        rsec = bytes(ctx["secret"])
        key = derive_resumed_key(rsec, ctx["client_nonce"], server_nonce,
                                 self.symmetric.name)
        want = resume_confirm_tag(key, message_id, ctx["client_nonce"],
                                  server_nonce)
        if not (server_nonce and len(server_nonce) <= 64
                and hmac.compare_digest(want, str(msg.get("confirm", "")))):
            _wipe(ctx["secret"])
            self._fail_pending(message_id, "bad_confirm")
            return
        self._adopt_secret(peer_id, rsec)
        _wipe(ctx["secret"])
        self.shared_keys[peer_id] = key
        self.ke_state[peer_id] = KeyExchangeState.ESTABLISHED
        fresh = bytes(msg.get("ticket") or b"")
        if fresh:
            # ratchet only when there is a ticket to bind it to — no
            # fresh ticket means no stored secret to account for
            next_secret = ratchet_resumption_secret(rsec, ctx["client_nonce"],
                                                    server_nonce)
            self._store_ticket(peer_id, fresh,
                               float(msg.get("expires_at") or 0.0),
                               next_secret)
        self._ctr_resumes_used.inc()
        obs_flight.record("ticket_resumed", peer=peer_id[:8],
                          role="initiator")
        self._log("key_exchange", peer=peer_id, success=True,
                  algorithm="ticket_resume", role="initiator")
        fut = self._pending.pop(message_id, None)
        if fut is not None and not fut.done():
            fut.set_result(True)

    async def _handle_ke_resume_reject(self, peer_id: str, msg: dict) -> None:
        """Initiator: a typed resume rejection — release the parked
        context and fail the pending future (the caller falls back to the
        full handshake, loudly)."""
        message_id = str(msg.get("message_id", ""))
        reason = str(msg.get("reason", "unknown"))[:64]
        ctx = self._resume_pending.pop(message_id, None)
        if ctx is not None:
            _wipe(ctx["secret"])
        if self.ke_state.get(peer_id) == KeyExchangeState.INITIATED:
            self.ke_state[peer_id] = KeyExchangeState.NONE
        self._fail_pending(message_id, reason)

    # ---------------------------------------------------------- graceful drain

    async def drain(self, reason: str = "drain") -> dict[str, Any]:
        """Graceful drain (docs/robustness.md "Rolling restarts"): stop
        admitting (new handshakes shed BUSY, resumes draw a typed
        ``draining`` reject, /readyz answers 503), flush every healable
        outbox, then nudge every connected peer (``ke_rehome``) to resume
        on its ring successor — their held tickets make that reconnect a
        cheap 1-RTT resume instead of a full-handshake storm.  Idempotent."""
        if self.draining:
            return {"reason": self.drain_reason, "already_draining": True}
        self.draining = True
        self.drain_reason = reason
        peers = self.node.get_peers()
        obs_flight.trigger("drain_started", node=self.node_id[:8],
                           reason=reason, peers=len(peers))
        flushed = 0
        for peer_id in list(self._outbox):
            queued = len(self._outbox.get(peer_id, ()))
            if queued and self.verify_key_exchange_state(peer_id):
                await self._flush_outbox(peer_id)
                flushed += queued
        nudged = 0
        for peer_id in self.node.get_peers():
            if await self.node.send_message(peer_id, "ke_rehome",
                                            reason=reason):
                nudged += 1
        logger.warning(
            "draining (%s): admission stopped; %d queued message(s) "
            "flushed, %d peer(s) nudged to resume elsewhere",
            reason, flushed, nudged,
        )
        obs_flight.record("drain_done", node=self.node_id[:8], nudged=nudged,
                          flushed=flushed)
        return {"reason": reason, "nudged": nudged, "flushed": flushed}

    async def _handle_ke_rehome(self, peer_id: str, msg: dict) -> None:
        """A peer announced it is draining: the disconnect that follows is
        PLANNED — surfaced to listeners so apps can re-route proactively
        (the fleet storm clients re-route on the drop either way; their
        ticket makes the new gateway a 1-RTT resume)."""
        reason = str(msg.get("reason", ""))[:64]
        self._ctr_rehome_nudges.inc()
        obs_flight.record("rehome_nudge", peer=peer_id[:8], reason=reason)
        logger.info("peer %s is draining (%s); expect a planned disconnect",
                    peer_id[:8], reason)
        self._notify(peer_id, Message(
            content=b"Peer draining: reconnect will resume via ticket",
            sender_id=peer_id, recipient_id=self.node_id, is_system=True,
            key_exchange_algo=self.kem.name,
            symmetric_algo=self.symmetric.name,
            signature_algo=self.signature.name,
        ))

    # --------------------------------------------------------- secure message

    async def send_message(
        self,
        peer_id: str,
        content: bytes,
        is_file: bool = False,
        filename: str | None = None,
    ) -> Message | None:
        """Sign-then-encrypt send.

        While a dropped session is healing (reconnect + re-handshake in
        flight), the message is queued in the bounded outbox and delivered —
        encrypted under the POST-heal key — once the session re-establishes;
        the returned Message is the queued one.  With no heal in progress
        and no session, returns None as before (fail closed).
        """
        if not self.node.is_connected(peer_id) and peer_id in self._healing:
            return self._queue_outbound(peer_id, content, is_file, filename)
        if not self.verify_key_exchange_state(peer_id):
            ok = await self.initiate_key_exchange(peer_id)
            if not ok and peer_id in self._healing:
                return self._queue_outbound(peer_id, content, is_file, filename)
            if not ok and peer_id not in self.shared_keys:
                logger.warning("no shared key with %s; message not sent", peer_id[:8])
                return None
        message = Message(
            content=content,
            sender_id=self.node_id,
            recipient_id=peer_id,
            is_file=is_file,
            filename=filename,
            key_exchange_algo=self.kem.name,
            symmetric_algo=self.symmetric.name,
            signature_algo=self.signature.name,
        )
        if not await self._encrypt_and_send(peer_id, message):
            return None
        return message

    async def _encrypt_and_send(self, peer_id: str, message: Message) -> bool:
        """Sign-then-encrypt tail of send_message, shared with the outbox
        flush (which re-encrypts queued messages under the healed key)."""
        package = {
            "message": message.to_dict(),
            "sig_algo": self.signature.name,
        }
        try:
            # bulk lane: under a flood with a bulk bound armed, this send
            # is SHED here (loud, counted) — rekey/handshake ops sharing
            # the queue are untouched
            sig = await self._sign(_canonical(package["message"]), LANE_BULK)
        except LaneShed:
            self._ctr_bulk_sheds.inc()
            logger.warning(
                "bulk send to %s shed at the bulk-lane bound (%d total)",
                peer_id[:8], self._ctr_bulk_sheds.value,
            )
            return False
        package["sig"] = sig.hex()
        package["sig_pk"] = self._sig_keypair[0].hex()
        ad = _canonical(
            {
                "type": "secure_message",
                "message_id": message.message_id,
                "sender": self.node_id,
                "recipient": peer_id,
                "is_file": message.is_file,
            }
        )
        key = self.shared_keys.get(peer_id)
        if key is None:
            logger.warning("no shared key with %s; message not sent", peer_id[:8])
            return False
        try:
            # batched seal on the bulk lane (the DATA plane): coalesces
            # with every live session's seals into one device dispatch;
            # sheds exactly like the sign above under a bulk-lane bound
            ct = await self._aead_encrypt(key, _canonical(package), ad)
        except LaneShed:
            self._ctr_bulk_sheds.inc()
            logger.warning(
                "bulk seal to %s shed at the bulk-lane bound (%d total)",
                peer_id[:8], self._ctr_bulk_sheds.value,
            )
            return False
        sent = await self.node.send_message(peer_id, "secure_message", ct=ct, ad=ad)
        if not sent:
            return False
        self._log(
            "message_sent", peer=peer_id, size=len(message.content),
            algorithm=self.symmetric.name, is_file=message.is_file,
        )
        return True

    async def send_file(self, peer_id: str, path: str | Path) -> Message | None:
        p = Path(path)
        # Read on a worker thread: a large file would otherwise stall every
        # peer this loop is serving.
        content = await asyncio.get_running_loop().run_in_executor(None, p.read_bytes)
        return await self.send_message(peer_id, content, is_file=True, filename=p.name)

    async def _handle_secure_message(self, peer_id: str, msg: dict) -> None:
        """Decrypt -> verify -> cross-check -> dedup -> fan out."""
        key = self.shared_keys.get(peer_id)
        if key is None:
            logger.warning("secure message from %s without shared key", peer_id[:8])
            return
        ad: bytes = bytes(msg.get("ad", b""))
        try:
            # batched open on the bulk lane; over the binary wire ``ct`` is
            # a memoryview into the socket buffer — zero-copy into the
            # device batch (net/p2p_node.py binary framing)
            pt = await self._aead_decrypt(key, msg.get("ct", b""), ad)
        except LaneShed:
            # inbound bulk shed at its lane bound: loud and counted; the
            # message is dropped WITHOUT touching the AEAD-failure/rekey
            # machinery (a shed is load, not tampering)
            self._ctr_bulk_sheds.inc()
            logger.warning("inbound bulk-lane open shed (%d total)",
                           self._ctr_bulk_sheds.value)
            return
        except ValueError:
            # Corrupted/tampered ciphertext, or a desynchronised key.  Never
            # plaintext; after REKEY_AFTER_AEAD_FAILURES consecutive
            # failures, drop the session key and re-key automatically
            # instead of silently rejecting this peer's traffic forever.
            failures = self._aead_failures.get(peer_id, 0) + 1
            self._aead_failures[peer_id] = failures
            logger.warning("AEAD decrypt failed from %s (%d consecutive)",
                           peer_id[:8], failures)
            now = time.monotonic()
            if now - self._last_rekey.get(peer_id, -REKEY_COOLDOWN_S) < REKEY_COOLDOWN_S:
                # a rekey just happened: this is (very likely) an old-key
                # message still in flight — undecryptable either way, and
                # re-dropping the fresh key would churn forever under
                # steady traffic (and hand any peer a one-message DoS
                # lever forcing endless handshakes)
                return
            if failures >= REKEY_AFTER_AEAD_FAILURES:
                self._aead_failures[peer_id] = 0
                self._last_rekey[peer_id] = now
                logger.warning(
                    "dropping session key for %s after %d AEAD failure(s); "
                    "re-keying", peer_id[:8], failures,
                )
                self.shared_keys.pop(peer_id, None)
                _wipe(self.raw_secrets.pop(peer_id, None))
                self.ke_state[peer_id] = KeyExchangeState.NONE
                self._log("rekey", peer=peer_id, reason="aead_failures")
                self._ctr_rekeys.inc()
                obs_flight.record("rekey", peer=peer_id[:8],
                                  reason="aead_failures", failures=failures)
                self._spawn(self.initiate_key_exchange(peer_id), "rekey")
            return
        self._aead_failures.pop(peer_id, None)
        try:
            package = json.loads(pt)
            message = Message.from_dict(package["message"])
            ad_data = json.loads(ad)
        except (ValueError, KeyError, TypeError):
            logger.warning("malformed secure message from %s", peer_id[:8])
            return
        # Verify signature over the message body (bulk lane: inbound bulk
        # verification must not starve handshake ops either).
        if not await self._verify(
            package.get("sig_algo", ""),
            bytes.fromhex(package.get("sig_pk", "")),
            _canonical(package["message"]),
            bytes.fromhex(package.get("sig", "")),
            LANE_BULK,
        ):
            logger.warning("signature verification failed from %s", peer_id[:8])
            return
        # Associated-data cross-checks.
        if (
            ad_data.get("message_id") != message.message_id
            or ad_data.get("sender") != message.sender_id
            or message.sender_id != peer_id
            or ad_data.get("recipient") != self.node_id
        ):
            logger.warning("associated-data mismatch from %s", peer_id[:8])
            return
        if self._dedup(message.message_id):
            return
        self._log(
            "message_received", peer=peer_id, size=len(message.content),
            algorithm=self.symmetric.name, is_file=message.is_file,
        )
        self._notify(peer_id, message)

    # ------------------------------------------------------- settings gossip

    def get_settings(self) -> dict:
        return {
            "kem": self.kem.name,
            "aead": self.symmetric.name,
            "signature": self.signature.name,
        }

    async def notify_peers_of_settings_change(self) -> None:
        for peer_id in self.node.get_peers():
            await self.node.send_message(
                peer_id, "settings_update", settings=self.get_settings()
            )

    async def request_peer_settings(self, peer_id: str) -> None:
        await self.node.send_message(peer_id, "settings_request")
        await self.node.send_message(
            peer_id, "settings_update", settings=self.get_settings()
        )

    async def _handle_settings_update(self, peer_id: str, msg: dict) -> None:
        settings = msg.get("settings") or {}
        self.peer_settings[peer_id] = settings

    async def _handle_settings_request(self, peer_id: str, msg: dict) -> None:
        await self.node.send_message(
            peer_id, "settings_update", settings=self.get_settings()
        )

    def settings_match(self, peer_id: str) -> bool | None:
        peer = self.peer_settings.get(peer_id)
        if peer is None:
            return None
        mine = self.get_settings()
        return all(peer.get(k) == v for k, v in mine.items())

    # ------------------------------------------------------ algorithm hot-swap

    async def set_key_exchange_algorithm(self, name: str) -> None:
        """Drop all shared keys and re-handshake."""
        old_cache = getattr(self.kem, "opcache", None)
        if old_cache is not None:
            # the outgoing provider's operand cache pins key-derived device
            # state; the swap ends those keys' sessions, so end their cache
            # lifetime too
            old_cache.zeroize()
        self.kem = get_kem(name, self.backend, devices=self.mesh_devices)
        if self.use_batching:
            from ..provider.batched import BatchedKEM

            self._bkem = BatchedKEM(self.kem, *self._batch_cfg,
                                    fallback=self._cpu_fallback_kem(),
                                    scheduler=self._scheduler,
                                    bucket_floor=self._batch_floor,
                                    lane_capacity=self._lane_capacity)
            self._bfused = self._make_fused()
            self._attach_tuners()
            self._attach_cost()
            self._spawn_warmup(kem=True, sig=False)
        peers = list(self.shared_keys)
        self.shared_keys.clear()
        for stale in self.raw_secrets.values():
            _wipe(stale)
        self.raw_secrets.clear()
        for peer_id in peers:
            self.ke_state[peer_id] = KeyExchangeState.NONE
        self._log("crypto_settings_changed", component="kem", algorithm=name)
        # Neither our re-handshakes nor peer-initiated ones (triggered by the
        # gossip below) may race the fresh facades' gate and warm-up: wait
        # first.
        await self.wait_ready()
        await self.notify_peers_of_settings_change()
        for peer_id in peers:
            if self.node.is_connected(peer_id):
                self._spawn(self.initiate_key_exchange(peer_id), "re-handshake")

    async def set_symmetric_algorithm(self, name: str) -> None:
        """Re-derive per-peer keys from stored raw secrets."""
        self.symmetric = get_symmetric(name)
        if self.use_batching:
            # the data plane follows the AEAD: rebuild the batched facade
            # for the new algorithm (None when it has no device capability)
            self._baead = self._make_batched_aead()
            if self._bfused is not None:
                # the AEAD name sits BEFORE public_key in the canonical init
                # JSON, so the fused facade's baked-in pk offset just moved
                self._bfused = self._make_fused()
            self._attach_tuners()
            self._attach_cost()
            self._spawn_warmup(kem=False, sig=False)
        for peer_id, secret in self.raw_secrets.items():
            self.shared_keys[peer_id] = derive_message_key(
                secret, self.node_id, peer_id, name
            )
        self._log("crypto_settings_changed", component="aead", algorithm=name)
        await self.notify_peers_of_settings_change()

    async def set_signature_algorithm(self, name: str) -> None:
        """Lazily load-or-generate the new keypair."""
        old_cache = getattr(self.signature, "opcache", None)
        if old_cache is not None:
            old_cache.zeroize()  # sk-derived device precomputes die with the swap
        self.signature = get_signature(name, self.backend, devices=self.mesh_devices)
        if self.use_batching:
            from ..provider.batched import BatchedSignature

            self._bsig = BatchedSignature(self.signature, *self._batch_cfg,
                                           fallback=self._cpu_fallback_sig(),
                                           scheduler=self._scheduler,
                                           bucket_floor=self._batch_floor,
                                           lane_capacity=self._lane_capacity)
            self._bfused = self._make_fused()
            self._attach_tuners()
            self._attach_cost()
            self._spawn_warmup(kem=False, sig=True)
        self._sig_keypair = self._load_or_generate_sig_keypair()
        self._log("crypto_settings_changed", component="signature", algorithm=name)
        # peers adopting the new signature re-handshake through our _bsig;
        # don't gossip until it is warm
        await self.wait_ready()
        await self.notify_peers_of_settings_change()

    async def adopt_peer_settings(self, peer_id: str) -> bool:
        """Switch local algorithms to the peer's gossiped set."""
        peer = self.peer_settings.get(peer_id)
        if not peer:
            return False
        try:
            if peer.get("aead") and peer["aead"] != self.symmetric.name:
                await self.set_symmetric_algorithm(peer["aead"])
            if peer.get("signature") and peer["signature"] != self.signature.name:
                await self.set_signature_algorithm(peer["signature"])
            if peer.get("kem") and peer["kem"] != self.kem.name:
                await self.set_key_exchange_algorithm(peer["kem"])
        except KeyError as e:
            logger.warning("cannot adopt peer settings: %s", e)
            return False
        return True

    # ------------------------------------------------------------- shutdown

    def close(self) -> None:
        """Stop the telemetry listener and wait for the background gate and
        warm-up and for the scheduler's device workers (the port's addition;
        the engine is unusable after it): a process that exits while either
        is inside a kernel or a PyTorch call aborts.  The node is its
        owner's to stop."""
        self.stop_telemetry()
        if self._warmup_thread is not None:
            self._warmup_thread.join()
        if self._scheduler is not None:
            self._scheduler.close()
