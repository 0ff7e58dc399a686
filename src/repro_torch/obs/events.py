"""Structured request-lifecycle event log.

Every span point of a request's life (queued -> routed -> admitted ->
prefill chunks -> first token -> finish, plus preemption / prefix / COW
instants) is one flat JSON-able record carrying the monotone engine step
index AND a wall-clock timestamp, so events join against step records no
matter how either window was trimmed. Kinds are schema-checked.

The log is bounded (``cap``): a long-running engine drops the OLDEST
events once full and counts the drops, so observability can never become
the memory leak it is meant to find.
"""
from __future__ import annotations

from typing import List, Optional

from . import schema


class EventLog:
    def __init__(self, cap: int = 65536):
        self.cap = cap
        self.events: List[dict] = []
        self.dropped = 0
        self._seq = 0                 # total ever emitted (monotone)

    def __len__(self) -> int:
        return len(self.events)

    def emit(self, kind: str, *, step: int, ts: float,
             rid: Optional[int] = None, **attrs) -> dict:
        schema.check_event_kind(kind)
        ev = {"seq": self._seq, "step": step, "ts": ts, "kind": kind,
              "rid": rid}
        if attrs:
            ev.update(attrs)
        self._seq += 1
        self.events.append(ev)
        if len(self.events) > self.cap:
            drop = len(self.events) - self.cap
            del self.events[:drop]
            self.dropped += drop
        return ev

    def for_request(self, rid: int) -> List[dict]:
        return [e for e in self.events if e["rid"] == rid]

    def of_kind(self, kind: str) -> List[dict]:
        return [e for e in self.events if e["kind"] == kind]

    # ---------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        return {"cap": self.cap, "events": [dict(e) for e in self.events],
                "dropped": self.dropped, "seq": self._seq}

    def load_state(self, state: dict):
        self.cap = state["cap"]
        self.events = [dict(e) for e in state["events"]]
        self.dropped = state["dropped"]
        self._seq = state["seq"]
        return self
