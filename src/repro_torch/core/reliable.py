"""Reliable wire transport — the ACCL TCP/UDP stack choice as a protocol
layer (PyTorch port).

The paper's central configuration axis is the network stack itself: ACCL's
UDP stack wins on latency but gives up delivery guarantees; TCP pays
sequence/ack/retransmit overhead for a lossless wire.  This module is that
layer for the stacked-rank wire, the JAX package's protocol slot for slot:

- :class:`WireFaults` — deterministic, seeded chunk-level fault schedules
  (drop / duplicate / reorder), activated with :func:`inject`; every
  message drawn under the context gets its own reproducible outcome.
- :func:`simulate_delivery` — a host-side simulation of the sliding-window
  protocol: per-chunk sequence stamps, a bounded send window, receiver-side
  dedup + in-order reassembly flush, ack-timeout detection, and
  retransmission with capped exponential backoff.  The output is a static
  :class:`DeliveryPlan`: the exact slot schedule the wire executes, plus
  protocol counters.
- :func:`plan_for` — the entry point :mod:`repro_torch.core.streaming`
  calls per message.  Clean messages (or no active fault context) return
  ``None``, so the zero-fault path launches exactly what the unprotected
  pipeline launches; faulted messages return a memoized plan
  (:func:`repro_torch.core.plans._memo` kind ``"wire"``).
- :class:`PlanTape` — the plans of one runner build.  The JAX package draws
  a message's plan when it traces the step, once per compiled program, and
  every later call replays that program.  The port steps eagerly, so a
  runner's step plays its calls under a tape: the first call draws (and
  records into the ``wire.*`` counters) one plan per message site, and
  every later call — a CUDA graph's capture and replays included — takes
  the same plans back in issue order.  Calls outside a tape (the ring,
  serving, the sweep's microbenchmarks) draw per call.

Every slot of a plan — original transmission, lost transmission, dropped
duplicate, backoff hold — runs as a real permute round, so recovery has a
measurable latency price.

This module is host-pure (no torch imports): the protocol properties are
testable with hypothesis, and the executor lives in
:mod:`repro_torch.core.streaming`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
from typing import Iterable, Optional, Sequence

from repro_torch.core.config import CommConfig, Reliability
from repro_torch.obs import metrics as obs_metrics

# Slot actions.  Only DELIVER lands a chunk in the receiver's reassembly
# buffer; the other three are pure latency.
DELIVER = "deliver"  # transmission arrives and is accepted (first copy)
LOST = "lost"        # transmission executed, receiver never sees it
DUP = "dup"          # duplicate copy, discarded by sequence-number dedup
HOLD = "hold"        # sender stalled: ack wait or retransmit backoff


@dataclasses.dataclass(frozen=True)
class Slot:
    """One wire round: which sequence number is on the wire and its fate."""
    seq: int
    action: str
    attempt: int = 0  # 0 = original transmission, k = k-th retransmit


@dataclasses.dataclass(frozen=True)
class DeliveryPlan:
    """Static schedule of wire rounds that delivers every chunk exactly once.

    ``slots`` is what the streaming layer executes; the counters are what
    the protocol did to get there (fed into the ``wire.*`` metrics).
    """
    n_chunks: int
    slots: tuple  # tuple[Slot, ...]
    retransmits: int
    dup_dropped: int
    timeouts: int
    backoff_holds: int

    @property
    def extra_slots(self) -> int:
        """Wire rounds beyond the lossless minimum — the latency price."""
        return len(self.slots) - self.n_chunks

    def delivered_seqs(self) -> list:
        return [s.seq for s in self.slots if s.action == DELIVER]


def backoff_holds(attempt: int, base: int, cap: int) -> int:
    """Hold slots before retransmit ``attempt`` (1-indexed): capped
    exponential ``min(base * 2**(attempt-1), cap)``."""
    if attempt < 1:
        raise ValueError(f"attempt is 1-indexed, got {attempt}")
    return min(base * (2 ** (attempt - 1)), cap)


def simulate_delivery(n_chunks: int, *,
                      window: int,
                      ack_timeout: int,
                      max_retransmits: int,
                      backoff_base: int,
                      backoff_cap: int,
                      drops: Iterable[tuple] = (),
                      dups: Iterable[int] = (),
                      order: Optional[Sequence[int]] = None) -> DeliveryPlan:
    """Simulate the sliding-window protocol over a faulty wire.

    ``drops`` is a set of ``(seq, attempt)`` transmissions the wire loses
    (attempt 0 = the original send); ``dups`` is a set of seqs whose
    original transmission is duplicated on the wire; ``order`` is the
    transmission order of the original sends (a permutation of
    ``range(n_chunks)``).

    One transmission (or hold) occupies one slot; acks for delivered chunks
    arrive at the end of the same slot.  A lost transmission is noticed
    ``ack_timeout`` slots after it was sent, then retransmitted after
    ``backoff_holds(attempt)`` hold slots.  Raises ``ValueError`` if a drop
    schedule exceeds ``max_retransmits`` for any chunk (a GUARANTEED
    transport must deliver; :meth:`WireFaults.outcomes` never drops the
    final permitted attempt).
    """
    if n_chunks < 1:
        raise ValueError("n_chunks must be >= 1")
    order = list(range(n_chunks)) if order is None else list(order)
    if sorted(order) != list(range(n_chunks)):
        raise ValueError(f"order must be a permutation of range({n_chunks}), "
                         f"got {order!r}")
    drops = frozenset((int(s), int(a)) for s, a in drops)
    dups = frozenset(int(s) for s in dups)
    for seq, attempt in drops:
        if attempt > max_retransmits:
            raise ValueError(
                f"drop schedule loses seq {seq} at attempt {attempt} > "
                f"max_retransmits={max_retransmits}: undeliverable under the "
                f"retransmit cap")

    pending = list(order)      # original sends not yet on the wire
    dup_queue: list[int] = []  # duplicate copies queued behind the original
    # seq -> state of an unacked (lost) transmission awaiting recovery:
    #   sent: slot index of the lost transmission
    #   attempt: attempts used so far (1 = original send failed)
    #   holds_left: backoff holds still owed once the timeout has fired
    #   timed_out: ack_timeout expired, timeout counted
    unacked: dict = {}
    delivered: set = set()
    slots: list[Slot] = []
    retransmits = dup_dropped = timeouts = holds = 0

    def transmit(seq: int, attempt: int) -> None:
        nonlocal retransmits, dup_dropped
        if (seq, attempt) in drops:
            slots.append(Slot(seq, LOST, attempt))
            # A lost copy of an already-delivered chunk (a wire duplicate
            # trailing a successful retransmit) needs no recovery; arming
            # one would loop forever on deduped retries.
            if seq not in delivered:
                unacked[seq] = {"sent": len(slots) - 1,
                                "attempt": attempt + 1,
                                "holds_left": None, "timed_out": False}
        elif seq in delivered:
            slots.append(Slot(seq, DUP, attempt))
            dup_dropped += 1
            unacked.pop(seq, None)  # dup ack clears any stale recovery state
        else:
            slots.append(Slot(seq, DELIVER, attempt))
            delivered.add(seq)
            unacked.pop(seq, None)
        if attempt > 0:
            retransmits += 1

    while len(delivered) < n_chunks or dup_queue:
        now = len(slots)
        # 1) Timed-out chunks first: the window is stalled on these seqs.
        ready = None
        for seq in sorted(unacked):
            st = unacked[seq]
            if not st["timed_out"]:
                if now - st["sent"] >= ack_timeout:
                    st["timed_out"] = True
                    st["holds_left"] = backoff_holds(
                        st["attempt"], backoff_base, backoff_cap)
                    timeouts += 1
                else:
                    continue
            if st["holds_left"] > 0:
                st["holds_left"] -= 1
                holds += 1
                slots.append(Slot(seq, HOLD, st["attempt"]))
                ready = "held"
                break
            ready = seq
            break
        if ready == "held":
            continue
        if ready is not None:
            transmit(ready, unacked[ready]["attempt"])
            continue
        # 2) Window permitting, the next original transmission.
        if pending and len(unacked) < window:
            seq = pending.pop(0)
            transmit(seq, 0)
            if seq in dups:
                dup_queue.append(seq)
            continue
        # 3) Wire artifacts: duplicate copies trailing the originals.
        if dup_queue:
            transmit(dup_queue.pop(0), 0)
            continue
        # 4) Nothing sendable: the window is full of unacked chunks whose
        #    timeouts have not fired yet — the sender stalls a slot.
        stall_seq = min(unacked)
        holds += 1
        slots.append(Slot(stall_seq, HOLD, unacked[stall_seq]["attempt"]))

    plan = DeliveryPlan(n_chunks=n_chunks, slots=tuple(slots),
                        retransmits=retransmits, dup_dropped=dup_dropped,
                        timeouts=timeouts, backoff_holds=holds)
    seqs = plan.delivered_seqs()
    if sorted(seqs) != list(range(n_chunks)) or len(seqs) != n_chunks:
        raise AssertionError(f"protocol bug: delivered {seqs!r}")  # pragma: no cover
    return plan


# ----------------------------------------------------------------------
# Fault schedules + the injection context
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WireFaults:
    """A deterministic chunk-level fault schedule.

    Rates draw per-message outcomes from a string-seeded PRNG (stable
    across processes and packages); the ``*_events`` sets pin exact
    outcomes:

    - ``drop_events``: ``(msg, seq, attempt)`` transmissions the wire loses
    - ``dup_events``: ``(msg, seq)`` originals duplicated on the wire
    - ``order_events``: ``(msg, (s0, s1, ...))`` explicit tx order per msg

    ``msg`` is the draw-order message index within an :func:`inject`
    context (reset to 0 on entry, so two identical runs under the same
    schedule draw identical outcomes).
    """
    seed: int = 0
    drop: float = 0.0     # per-transmission loss probability
    dup: float = 0.0      # per-chunk duplicate probability
    reorder: float = 0.0  # per-adjacent-pair tx-order swap probability
    drop_events: frozenset = frozenset()
    dup_events: frozenset = frozenset()
    order_events: tuple = ()

    def __post_init__(self):
        for name in ("drop", "dup", "reorder"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} rate must be in [0, 1), got {v}")

    def lossy(self) -> bool:
        return bool(self.drop or self.dup or self.reorder
                    or self.drop_events or self.dup_events
                    or self.order_events)

    def outcomes(self, msg: int, n_chunks: int, max_retransmits: int
                 ) -> tuple:
        """``(drops, dups, order)`` for message ``msg`` — deterministic in
        (seed, msg).  Seeded drops never hit attempt ``max_retransmits``
        (the wire relents within the retransmit cap); explicit
        ``drop_events`` are taken as given and validated by
        :func:`simulate_delivery`."""
        rng = random.Random(f"wire:{self.seed}:{msg}")
        drops = {(s, a) for m, s, a in self.drop_events if m == msg}
        dups = {s for m, s in self.dup_events if m == msg}
        order = list(range(n_chunks))
        for m, o in self.order_events:
            if m == msg:
                order = list(o)
        if self.drop > 0.0:
            for seq in range(n_chunks):
                for attempt in range(max_retransmits):
                    if rng.random() < self.drop:
                        drops.add((seq, attempt))
                    else:
                        break  # this attempt succeeds; later ones unreachable
        if self.dup > 0.0:
            dups.update(s for s in range(n_chunks)
                        if rng.random() < self.dup)
        if self.reorder > 0.0:
            for i in range(n_chunks - 1):
                if rng.random() < self.reorder:
                    order[i], order[i + 1] = order[i + 1], order[i]
        return frozenset(drops), frozenset(dups), tuple(order)


_LOCK = threading.Lock()
_ACTIVE: Optional[WireFaults] = None
_MSG_COUNTER = 0
_TAPE: Optional["PlanTape"] = None


def active() -> Optional[WireFaults]:
    """The WireFaults schedule currently injected, or None (lossless)."""
    return _ACTIVE


@contextlib.contextmanager
def inject(faults: Optional[WireFaults]):
    """Activate a chunk-level fault schedule for every message drawn under
    the context.  Resets the message counter on entry, so a run under the
    same schedule is bitwise reproducible.  ``None`` activates the lossless
    wire (callers can thread an optional schedule unconditionally)."""
    global _ACTIVE, _MSG_COUNTER
    with _LOCK:
        prev, prev_ctr = _ACTIVE, _MSG_COUNTER
        _ACTIVE, _MSG_COUNTER = faults, 0
    try:
        yield faults
    finally:
        with _LOCK:
            _ACTIVE, _MSG_COUNTER = prev, prev_ctr


def _next_message_id() -> int:
    global _MSG_COUNTER
    with _LOCK:
        msg = _MSG_COUNTER
        _MSG_COUNTER += 1
    return msg


def message_count() -> int:
    """Message ids drawn since the innermost :func:`inject` was entered."""
    return _MSG_COUNTER


class PlanTape:
    """The delivery plans of one runner build, in issue order.

    :meth:`play` wraps one call of a step function: the first call records
    what :func:`plan_for` draws (``None`` for a clean message), every later
    call replays those entries in the same order without drawing or
    recording again — the port's counterpart of a step traced once and
    replayed as a compiled program."""

    def __init__(self):
        self.entries: Optional[list] = None   # [(n_chunks, plan-or-None)]
        self.replaying = False
        self._pos = 0

    @property
    def plans(self) -> list:
        """The recorded non-clean plans (empty before the first call)."""
        return [p for _, p in (self.entries or ()) if p is not None]

    @property
    def extra_slots(self) -> int:
        """Wire rounds one call adds beyond the lossless minimum."""
        return sum(p.extra_slots for p in self.plans)

    @contextlib.contextmanager
    def play(self):
        global _TAPE
        with _LOCK:
            prev, _TAPE = _TAPE, self
        recording = self.entries is None
        if recording:
            self.entries = []
        self.replaying = not recording
        self._pos = 0
        try:
            yield self
        except BaseException:
            if recording:
                self.entries = None   # a failed first call records nothing
            raise
        finally:
            with _LOCK:
                _TAPE = prev
        if not recording and self._pos != len(self.entries):
            raise RuntimeError(f"a replayed call issued {self._pos} messages, "
                               f"its first call {len(self.entries)}")

    def _take(self, n_chunks: int) -> Optional[DeliveryPlan]:
        if self._pos >= len(self.entries):
            raise RuntimeError("a replayed call issued more messages than its "
                               "first call")
        n, plan = self.entries[self._pos]
        if n != n_chunks:
            raise RuntimeError(f"message {self._pos} of a replayed call has "
                               f"{n_chunks} chunks, its first call {n}")
        self._pos += 1
        return plan


# ----------------------------------------------------------------------
# Plan cache + the streaming entry point
# ----------------------------------------------------------------------

def delivery_plan(n_chunks: int, cfg: CommConfig, drops: frozenset,
                  dups: frozenset, order: tuple) -> DeliveryPlan:
    """Memoized :func:`simulate_delivery` — retransmit schedules are static
    per (message geometry, reliability knobs, fault outcome), so they are
    plan-cacheable like chunk plans (kind ``"wire"``)."""
    from repro_torch.core import plans
    key = (int(n_chunks), int(cfg.window), int(cfg.ack_timeout),
           int(cfg.max_retransmits), int(cfg.backoff_base),
           int(cfg.backoff_cap), tuple(sorted(drops)), tuple(sorted(dups)),
           tuple(order))
    return plans._memo(
        "wire", key,
        lambda: simulate_delivery(
            n_chunks, window=cfg.window, ack_timeout=cfg.ack_timeout,
            max_retransmits=cfg.max_retransmits,
            backoff_base=cfg.backoff_base, backoff_cap=cfg.backoff_cap,
            drops=drops, dups=dups, order=order))


def _draw(cfg: CommConfig, n_chunks: int) -> Optional[DeliveryPlan]:
    faults = active()
    if faults is None or not faults.lossy():
        return None
    if cfg.reliability != Reliability.GUARANTEED:
        raise ValueError(
            "wire faults are injected but cfg.reliability is BEST_EFFORT: "
            "the UDP-like stack cannot recover lost chunks. Select "
            "Reliability.GUARANTEED (or remove the fault injection).")
    msg = _next_message_id()
    drops, dups, order = faults.outcomes(msg, n_chunks, cfg.max_retransmits)
    if not drops and not dups and order == tuple(range(n_chunks)):
        return None  # clean message under a lossy context: fast path
    plan = delivery_plan(n_chunks, cfg, drops, dups, order)
    record(plan, cfg)
    return plan


def plan_for(cfg: CommConfig, n_chunks: int) -> Optional[DeliveryPlan]:
    """Per-message protocol decision, called by the streaming layer.

    Returns ``None`` on the fast path (no active fault context, or a clean
    message): the caller then runs the unprotected pipeline unchanged.
    Raises for BEST_EFFORT under injected faults: the UDP-like stack has no
    recovery machinery.  A freshly drawn plan is recorded into the
    ``wire.*`` counters; under a replaying :class:`PlanTape` the recorded
    plan comes back with no draw and no record."""
    tape = _TAPE
    if tape is None:
        return _draw(cfg, n_chunks)
    if tape.replaying:
        return tape._take(n_chunks)
    plan = _draw(cfg, n_chunks)
    tape.entries.append((n_chunks, plan))
    return plan


def record(plan: DeliveryPlan, cfg: CommConfig, hw=None) -> None:
    """Feed one applied plan into the ``wire.*`` metrics.  Counters track
    protocol events; ``wire.backoff_ms`` observes the *modeled* stall time
    (hold slots x the Eq. 1 per-chunk wire time on ``hw``, default the
    H100's fitted constants)."""
    reg = obs_metrics.registry()
    reg.counter("wire.messages_recovered").inc()
    if plan.retransmits:
        reg.counter("wire.retransmits").inc(plan.retransmits)
    if plan.dup_dropped:
        reg.counter("wire.dup_dropped").inc(plan.dup_dropped)
    if plan.timeouts:
        reg.counter("wire.timeouts").inc(plan.timeouts)
    if plan.backoff_holds:
        from repro_torch.core import latmodel
        from repro_torch.core.config import H100
        hw = hw or H100
        slot_s = latmodel.l_k(cfg, hw) + cfg.chunk_bytes / hw.ici_bw
        reg.histogram("wire.backoff_ms").observe(
            plan.backoff_holds * slot_s * 1e3)


def wire_counters() -> dict:
    """Snapshot of the wire protocol counters (0 when never incremented)."""
    reg = obs_metrics.registry()
    return {name: int(reg.counter(f"wire.{name}").value)
            for name in ("retransmits", "dup_dropped", "timeouts",
                         "messages_recovered")}
