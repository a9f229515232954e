"""Event recording with defederation.

A copy of ``kubeadmiral_tpu/runtime/eventsink.py`` for the port's control
plane.

Controllers record Kubernetes Events against the objects they act on;
events recorded on a *federated* object are additionally re-targeted to
its source object so users watching `kubectl describe deployment` see
federation activity (reference: pkg/controllers/util/eventsink/
eventsink.go DefederatingRecorderMux — a mux of recorders where one
transform maps a federated object to its controller owner reference).

Events are objects in the host store's ``v1/events`` resource with the
usual involvedObject/reason/message/type/count shape; repeated identical
events bump ``count`` instead of piling up new objects.
"""

from __future__ import annotations

import time
from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.testing.fakekube import (
    AlreadyExists,
    Conflict,
    FakeKube,
    NotFound,
)

EVENTS = "v1/events"

# Bounded optimistic-concurrency retries for the count-bump path: two
# recorders bumping the same event race on resourceVersion; each retry
# re-reads and re-applies the increment, so no bump is silently lost
# (the real recorder serializes through a broadcaster and never races
# itself; this mux is called from many controller threads directly).
_BUMP_RETRIES = 8

# Set by the federate controller on every federated object it creates.
FEDERATED_OBJECT_ANNOTATION = C.FEDERATED_OBJECT


def _defederate_reference(obj: dict) -> Optional[dict]:
    """Federated object -> source-object reference (eventsink.go:68-98:
    the reference walks controller ownerReferences; source and federated
    objects share name/namespace here, so the de-federated kind is the
    template's)."""
    ann = obj.get("metadata", {}).get("annotations", {})
    if FEDERATED_OBJECT_ANNOTATION not in ann:
        return None
    template = obj.get("spec", {}).get("template", {})
    if not template.get("kind"):
        return None
    return {
        "apiVersion": template.get("apiVersion", ""),
        "kind": template["kind"],
        "namespace": obj["metadata"].get("namespace", ""),
        "name": obj["metadata"]["name"],
    }


class EventRecorder:
    """Records events into the host store (record.EventRecorder shape)."""

    def __init__(self, host: FakeKube, component: str, clock=time.time):
        self.host = host
        self.component = component
        self.clock = clock

    def _reference(self, obj: dict) -> dict:
        return {
            "apiVersion": obj.get("apiVersion", ""),
            "kind": obj.get("kind", ""),
            "namespace": obj.get("metadata", {}).get("namespace", ""),
            "name": obj.get("metadata", {}).get("name", ""),
        }

    def _record(self, ref: dict, event_type: str, reason: str, message: str) -> None:
        ns = ref.get("namespace", "")
        name = f"{ref['kind']}.{ref['name']}.{reason}".lower()
        key = f"{ns}/{name}" if ns else name
        # Bounded retry loop: a Conflict means another recorder updated
        # the same event between our read and write — re-read and
        # re-apply instead of dropping the bump (concurrent recorders
        # used to under-count; the regression test hammers this path
        # from many threads).
        for _ in range(_BUMP_RETRIES):
            existing = self.host.try_get(EVENTS, key)
            if existing is not None and existing.get("message") == message:
                existing["count"] = existing.get("count", 1) + 1
                existing["lastTimestamp"] = self.clock()
                try:
                    self.host.update(EVENTS, existing)
                    return
                except Conflict:
                    continue
                except NotFound:
                    continue  # deleted under us: recreate on re-read
            event = {
                "apiVersion": "v1",
                "kind": "Event",
                "metadata": {"name": name},
                "involvedObject": ref,
                "type": event_type,
                "reason": reason,
                "message": message,
                "source": {"component": self.component},
                "count": 1,
                "firstTimestamp": self.clock(),
                "lastTimestamp": self.clock(),
            }
            if ns:
                event["metadata"]["namespace"] = ns
            try:
                if existing is None:
                    self.host.create(EVENTS, event)
                else:
                    event["metadata"] = existing["metadata"]
                    self.host.update(EVENTS, event)
                return
            except (Conflict, NotFound, AlreadyExists):
                continue  # raced: re-read and retry
            except Exception:
                return  # event loss is tolerated, as with the real broadcaster

    def event(self, obj: dict, event_type: str, reason: str, message: str) -> None:
        self._record(self._reference(obj), event_type, reason, message)


class DefederatingRecorderMux(EventRecorder):
    """Records on the given object AND, for federated objects, on the
    de-federated source reference (eventsink.go NewDefederatingRecorderMux)."""

    def event(self, obj: dict, event_type: str, reason: str, message: str) -> None:
        super().event(obj, event_type, reason, message)
        source_ref = _defederate_reference(obj)
        if source_ref is not None:
            self._record(source_ref, event_type, reason, message)
