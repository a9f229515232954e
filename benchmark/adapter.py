"""Records (``benchmark/world.py``) -> the port's ``models.types`` objects.

The only file of the benchmark besides the harness that imports the
program.  Equal nested parts of records (affinities, toleration lists)
become one shared object each, as a policy's affinity and tolerations are
shared by the objects it binds.  ``unit`` makes a template once per
record; ``fresh`` copies it into the new object a tick hands the engine.
"""

from __future__ import annotations

from kubeadmiral_tpu_torch.models import types as T


def _term(term) -> T.SelectorTerm:
    return T.SelectorTerm(match_expressions=tuple(
        T.SelectorRequirement(key, op, tuple(values)) for key, op, values in term
    ))


class Adapter:
    """Converts records, one object for each distinct nested part."""

    def __init__(self):
        self._shared: dict[str, object] = {}

    def _memo(self, part, build):
        key = repr(part)
        got = self._shared.get(key)
        if got is None:
            got = build(part)
            self._shared[key] = got
        return got

    def _affinity(self, aff) -> T.ClusterAffinity:
        req = aff["required"]
        return T.ClusterAffinity(
            required=None if req is None else tuple(_term(t) for t in req),
            preferred=tuple(
                T.PreferredSchedulingTerm(weight=w, preference=_term(t))
                for w, t in aff["preferred"]
            ),
        )

    @staticmethod
    def _tolerations(tols) -> tuple:
        return tuple(T.Toleration(key=k, operator=o, value=v, effect=e) for k, o, v, e in tols)

    def unit(self, r: dict) -> T.SchedulingUnit:
        aff = r["affinity"]
        cap = r["capacity"]
        return T.SchedulingUnit(
            gvk=r["gvk"],
            namespace=r["namespace"],
            name=r["name"],
            scheduling_mode=r["mode"],
            desired_replicas=r["replicas"],
            resource_request=dict(r["request"]),
            current_clusters={},
            tolerations=self._memo(r["tolerations"], self._tolerations),
            affinity=None if aff is None else self._memo(aff, self._affinity),
            max_clusters=r["max_clusters"],
            avoid_disruption=r["avoid_disruption"],
            enabled_scores=None if r["scores"] is None else tuple(r["scores"]),
            auto_migration=None if cap is None else T.AutoMigrationSpec(
                estimated_capacity=dict(cap)
            ),
        )

    def units(self, records) -> list:
        return [self.unit(r) for r in records]

    @staticmethod
    def fresh(template: T.SchedulingUnit) -> T.SchedulingUnit:
        """A new unit equal to ``template``, as a reconcile builds one:
        another object, without the signature the engine memoises on a
        unit it has featurized (its immutable parts shared)."""
        unit = object.__new__(T.SchedulingUnit)
        unit.__dict__.update(template.__dict__)
        unit.__dict__.pop("_featurize_sig", None)
        return unit

    @staticmethod
    def cluster(r: dict) -> T.ClusterState:
        return T.ClusterState(
            name=r["name"],
            labels=dict(r["labels"]),
            taints=tuple(T.Taint(k, v, e) for k, v, e in r["taints"]),
            allocatable=dict(r["alloc"]),
            available=dict(r["avail"]),
            api_resources=frozenset(r["api"]),
        )
